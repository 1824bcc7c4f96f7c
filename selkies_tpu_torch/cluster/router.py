"""Capacity-aware signalling admission: serve locally or redirect.

The port's copy of ``selkies_tpu/cluster/router.py``, whole:
``ClusterRouter`` (scoring, codec capability, local pinning,
``pick_migration_target``, stats) and the redirect record the signalling
client follows (``Redirect``, ``parse_redirect``, ``ws_url_of``), with
its telemetry import pointed at the port. Decisions and scores equal
JAX's on the same digests.

The signalling server consults a :class:`ClusterRouter` on every
client HELLO that carries meta (browsers always do — PR 8.1's codec
preference list rides there; the in-process server-side clients never
do, so backend planes are never re-routed). The router reads the
freshest membership view (cluster/membership.py) and answers one of:

* **serve locally** (``None``) — the default whenever this host can:
  not draining, has a free session slot (or a shared small-slice carve,
  where capacity gating is off), or the HELLO belongs to a session
  already served here (a reconnecting client must NEVER be bounced off
  the host that holds its carved row and encoder state);
* **redirect** (:class:`Redirect`) — a ``REDIRECT <b64 json>`` record
  (host, reason, retry-after) the client's reconnect loop follows
  (signalling/client.py caps the chain so two hosts can never ping-pong
  a client forever).

Scoring prefers free capacity (free session slots), penalizes chronic
SLO burn (the PR 12 slow-window autoscaling signal — a host that keeps
missing its latency objectives is the WRONG place to add load even
when chips are free) and quarantined chips, and respects codec
capability: an AV1-preferring client is only redirected to a host
whose digest lists av1, and never lands on an h264-only host when an
av1 host with capacity exists. Every decision is recorded for
``/statz`` (``cluster.router``). The ``cluster:redirect`` fault site
fires where the record is SENT (signalling/server.py) — a dropped
record is a lost redirect the client's reconnect loop must survive.
"""

from __future__ import annotations

import base64
import json
import logging
import time
from collections import deque
from dataclasses import asdict, dataclass

from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("cluster.router")

__all__ = ["ClusterRouter", "Redirect", "parse_redirect", "ws_url_of"]

# scoring weights: one free slot outweighs one chronically-burning
# session (2x) and two quarantined chips; a top-preference codec match
# breaks ties between equally-free hosts
_W_CHRONIC = 2.0
_W_QUARANTINE = 0.5
_W_CODEC = 0.25


@dataclass(frozen=True)
class Redirect:
    """One server-initiated redirect record, as shipped on the wire.

    ``session`` is set on migrate-off redirects when the session landed
    on a DIFFERENT slot index than it held on the source: the client
    must re-register under the landing slot's peer id or it would pair
    with the wrong slot's signalling loop on the target."""

    host: str              # the target's advertised base URL
    reason: str = ""       # draining | capacity | codec | migrated
    retry_after_s: float = 0.5
    session: int | None = None  # landing slot index on the target

    def to_wire(self) -> str:
        blob = json.dumps(asdict(self), sort_keys=True).encode()
        return "REDIRECT " + base64.b64encode(blob).decode("ascii")


def parse_redirect(message: str) -> Redirect | None:
    """Inverse of :meth:`Redirect.to_wire`; None on anything malformed
    (a garbled record must never crash the client's dispatch loop)."""
    try:
        _, b64 = message.split(None, 1)
        data = json.loads(base64.b64decode(b64))
        session = data.get("session")
        return Redirect(host=str(data["host"]).rstrip("/"),
                        reason=str(data.get("reason", "")),
                        retry_after_s=float(data.get("retry_after_s", 0.5)),
                        session=int(session) if session is not None else None)
    except Exception:
        logger.warning("ignoring malformed redirect record %r", message[:80])
        return None


def ws_url_of(host: str) -> str:
    """A redirect target's signalling WebSocket URL from its advertised
    base URL (http(s) base -> ws(s)://…/ws; ws URLs pass through)."""
    host = host.rstrip("/")
    if host.startswith(("ws://", "wss://")):
        base, rest = host.split("://", 1)
        return host if "/" in rest else host + "/ws"
    if host.startswith("https://"):
        return "wss://" + host[len("https://"):] + "/ws"
    if host.startswith("http://"):
        return "ws://" + host[len("http://"):] + "/ws"
    return "ws://" + host + "/ws"


class ClusterRouter:
    """Admission routing over one node's membership view.

    ``is_local_session(uid)`` is the owner's hook saying "this HELLO
    uid belongs to a session currently served here" — those are never
    redirected (their encoder state, carve row and SLO windows live on
    this host)."""

    def __init__(self, node, *, is_local_session=None,
                 retry_after_s: float = 0.5):
        self.node = node
        self.is_local_session = is_local_session
        self.retry_after_s = float(retry_after_s)
        # /statz: the last routing decisions, newest last
        self.decisions: deque = deque(maxlen=16)
        self.redirects = 0

    # -- scoring --------------------------------------------------------

    @staticmethod
    def _prefs_of(meta) -> list[str]:
        if isinstance(meta, dict):
            prefs = meta.get("codecs")
            if isinstance(prefs, (list, tuple)):
                return [str(c).lower() for c in prefs if c]
        return []

    @staticmethod
    def _measured_headroom(digest: dict) -> int | None:
        """Sessions the host's MEASURED capacity curve still admits
        (``measured_max_sessions`` minus placed sessions), or None when
        the host reports no curve (fall back to structural slots)."""
        measured = int(digest.get("measured_max_sessions", 0) or 0)
        if measured <= 0:
            return None
        return max(0, measured - int(digest.get("sessions", 0)))

    @classmethod
    def _has_capacity(cls, digest: dict) -> bool:
        if digest.get("draining"):
            return False
        if not digest.get("has_placer"):
            # bare solo host: its one session is the whole capacity —
            # `busy` (set by the solo wiring) is its free/full bit
            return int(digest.get("busy", 0)) == 0
        headroom = cls._measured_headroom(digest)
        if headroom is not None and headroom <= 0:
            # the measured sessions-at-SLO ceiling binds even a shared
            # placer: structurally admissible ≠ servable within SLO
            return False
        return bool(digest.get("shared")) or int(
            digest.get("free_slots", 0)) > 0

    @classmethod
    def score(cls, digest: dict, prefs: list[str]) -> float:
        """Higher is better. Free slots up — clamped to the measured
        sessions-at-SLO headroom when the host ships a capacity curve
        (a shared placer's headroom replaces its slot count outright) —
        chronic SLO burn and quarantined chips down, small bonus for
        serving the client's top codec preference natively."""
        s = float(digest.get("free_slots", 0))
        headroom = cls._measured_headroom(digest)
        if headroom is not None:
            s = float(headroom) if digest.get("shared") else min(
                s, float(headroom))
        if not digest.get("has_placer"):
            s = 0.0 if digest.get("busy") else 1.0
        s -= _W_CHRONIC * len(digest.get("chronic_burn") or ())
        s -= _W_QUARANTINE * int(digest.get("quarantined_chips", 0))
        if prefs and prefs[0] in (digest.get("codecs") or ()):
            s += _W_CODEC
        return s

    def _candidates(self, prefs: list[str]) -> list[tuple[str, dict]]:
        """Alive, non-draining peers with capacity, codec-capable for
        the client (any preferred codec; every host serves h264)."""
        out = []
        for host, digest in self.node.alive_peers().items():
            if not self._has_capacity(digest):
                continue
            codecs = digest.get("codecs") or ["h264"]
            if prefs and not any(c in codecs for c in [*prefs, "h264"]):
                continue
            out.append((host, digest))
        return out

    def _best(self, prefs: list[str], *,
              migration: bool = False) -> tuple[str, dict] | None:
        """The one scoring truth for HELLO routing and drain
        migrate-off. ``migration=True`` tightens eligibility: the
        target must be placement-capable (``has_placer`` — a bare solo
        host wires no /cluster/migrate endpoint, shipping it a
        checkpoint can only 404) and must serve the codec natively."""
        cands = self._candidates(prefs)
        if migration:
            cands = [(h, d) for h, d in cands if d.get("has_placer")]
        if prefs:
            # hard capability rule, not a tiebreak: when ANY candidate
            # serves the client's top preference natively, only those
            # are eligible — an av1 client never lands on an h264-only
            # host while an av1 host with capacity exists. For a
            # migration the native set is the ONLY eligible set (the
            # session already runs that codec).
            native = [(h, d) for h, d in cands
                      if prefs[0] in (d.get("codecs") or ())]
            if native or migration:
                cands = native
        if not cands:
            return None
        # deterministic: score desc, then host asc — two routers with
        # the same view pick the same target
        return sorted(cands, key=lambda hd: (-self.score(hd[1], prefs),
                                             hd[0]))[0]

    # -- the admission decision ----------------------------------------

    def route(self, meta, *, uid: str = "") -> Redirect | None:
        """None = serve locally; a Redirect = answer the HELLO with it.

        Local-first: a host that can serve, serves — the cluster only
        moves clients OFF a host that is draining or full, or ONWARD to
        a host that natively serves the client's top codec preference
        when this one cannot. Reconnects into live local sessions are
        pinned here unconditionally."""
        if uid and self.is_local_session is not None:
            try:
                if self.is_local_session(uid):
                    return None
            except Exception:
                logger.exception("is_local_session(%r) failed; serving "
                                 "locally", uid)
                return None
        prefs = self._prefs_of(meta)
        local = self.node.self_digest()
        rd: Redirect | None = None
        reason = "local"
        if not self._has_capacity(local):
            best = self._best(prefs)
            if best is not None:
                reason = "draining" if local.get("draining") else "capacity"
                rd = Redirect(host=best[0], reason=reason,
                              retry_after_s=self.retry_after_s)
            else:
                reason = "no-peer"  # local admission queues/rejects it
        elif prefs and prefs[0] not in (local.get("codecs") or ["h264"]):
            # codec-capability routing: this host would degrade the
            # client to h264 — prefer a peer that serves the preference
            best = self._best(prefs)
            if best is not None and prefs[0] in (best[1].get("codecs") or ()):
                reason = "codec"
                rd = Redirect(host=best[0], reason="codec",
                              retry_after_s=self.retry_after_s)
        self.decisions.append({
            "ts": round(time.time(), 1), "uid": str(uid),
            "to": rd.host if rd is not None else "local",
            "reason": rd.reason if rd is not None else reason,
        })
        if rd is not None:
            self.redirects += 1
            logger.info("redirecting HELLO %s -> %s (%s)",
                        uid or "?", rd.host, rd.reason)
        return rd

    def pick_migration_target(self, codec: str = "h264") -> str | None:
        """Best host to migrate a live session to (drain migrate-off):
        alive, not draining, has capacity, serves the session's codec.
        None when the cluster has nowhere to put it (the session falls
        back to the checkpoint hand-off)."""
        best = self._best([str(codec).lower() or "h264"], migration=True)
        return best[0] if best is not None else None

    def stats(self) -> dict:
        """/statz ``cluster.router`` block."""
        return {"redirects": self.redirects,
                "decisions": list(self.decisions)}
