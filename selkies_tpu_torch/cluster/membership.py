"""Cluster membership: signed capacity heartbeats, leases, re-join.

The port's copy of ``selkies_tpu/cluster/membership.py``, whole: the env
readers, ``sign_blob`` / ``verify_blob``, the capacity rows of a
``bench.py --capacity`` record, ``build_digest`` and ``ClusterNode``, with
its imports pointed at the port's ``monitoring.telemetry`` and
``resilience``. The wire (heartbeat envelope, signature, digest fields) is
JAX's byte for byte, so a port host and a JAX host heartbeat each other.
``chips`` in a digest counts the devices the placer holds (CUDA cards on
the port), never a TPU chip count.

One host is a single point of failure and a hard capacity ceiling; the
reference platform's answer is Kubernetes (PAPER.md L6, `infra/gke`),
but this stack needs a control plane that understands its own
capacity vocabulary — healthy devices and free session rows
(`DevicePool` / `SessionPlacer`), chronic SLO burn (`monitoring/slo.py`),
codec capability, drain state. This module is the peer-to-peer
membership half of that plane:

* **capacity digest** — :func:`build_digest` is the ONE derivation of a
  host's machine-readable capacity/drain summary. ``/healthz`` and
  ``/statz`` surface it through ``telemetry.capacity_digest()`` (which
  delegates here), and the heartbeat ships the same dict — three
  surfaces, one truth, additive-only field changes.
* **heartbeats** — each host runs a :class:`ClusterNode` that POSTs its
  digest (HMAC-SHA256-signed when ``SELKIES_CLUSTER_SECRET`` is set) to
  the static seed list in ``SELKIES_CLUSTER_PEERS`` every
  ``SELKIES_CLUSTER_HEARTBEAT_S`` seconds. The transport is pluggable —
  production uses aiohttp against the peers' ``/cluster/heartbeat``
  endpoint; tests wire nodes together in-process.
* **leases** — a received heartbeat grants its sender a lease of
  ``SELKIES_CLUSTER_LEASE_S`` seconds (default 3 heartbeats); a peer
  whose lease expired is *dead* to the router until it heartbeats again.
  There is no gossip and no consensus: every host holds its own
  eventually-consistent view, which is exactly enough for capacity
  routing (a stale view costs one extra redirect hop, never
  correctness — admission on the target re-checks everything).
* **re-join** — a peer that refuses or times out gets capped-backoff
  retries (`resilience.Backoff`, the signalling reconnect policy), so a
  restarting peer is neither hammered nor forgotten.

Chaos: the ``cluster:heartbeat`` fault site fires per heartbeat send
(``drop`` = lost beat, the lease must expire; ``raise`` = send failure
driving the backoff; ``delay`` stretches the beat) and
``cluster:partition`` fires per receive (``drop`` = a one-way
partition) — a seeded ``SELKIES_FAULTS`` schedule makes lease expiry
and re-join deterministic (tests/test_cluster.py).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import logging
import os
import socket
import time

from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.resilience import Backoff, InjectedFault, get_injector

logger = logging.getLogger("cluster.membership")

__all__ = [
    "ENV_PEERS",
    "ClusterNode",
    "build_digest",
    "capacity_rows_from_env",
    "cluster_enabled",
    "cluster_peers_from_env",
    "cluster_self_from_env",
    "heartbeat_interval_from_env",
    "lease_from_env",
    "load_capacity_rows",
    "measured_max_sessions",
    "sign_blob",
    "verify_blob",
]

ENV_PEERS = "SELKIES_CLUSTER_PEERS"
ENV_SELF = "SELKIES_CLUSTER_SELF"
ENV_SECRET = "SELKIES_CLUSTER_SECRET"
ENV_HEARTBEAT = "SELKIES_CLUSTER_HEARTBEAT_S"
ENV_LEASE = "SELKIES_CLUSTER_LEASE_S"
ENV_CAPACITY = "SELKIES_CAPACITY_FILE"


def cluster_enabled() -> bool:
    """The cluster plane exists exactly when a peer seed list does."""
    return bool(os.environ.get(ENV_PEERS, "").strip())


def cluster_peers_from_env() -> list[str]:
    """Static seed list: comma-separated peer base URLs."""
    env = os.environ.get(ENV_PEERS, "")
    return [p.strip().rstrip("/") for p in env.split(",") if p.strip()]


def cluster_self_from_env() -> str:
    """This host's advertised base URL — what redirect records and the
    heartbeat envelope name. Defaults to the hostname on the stock
    port so a single-host lab config works unconfigured."""
    env = os.environ.get(ENV_SELF, "").strip().rstrip("/")
    return env or f"http://{socket.gethostname()}:8443"


def heartbeat_interval_from_env() -> float:
    env = os.environ.get(ENV_HEARTBEAT, "")
    if not env:
        return 2.0
    try:
        return max(0.05, float(env))
    except ValueError:
        logger.warning("%s=%r is not a number; using 2", ENV_HEARTBEAT, env)
        return 2.0


def lease_from_env(heartbeat_s: float) -> float:
    """Membership lease; default 3 heartbeats (one lost beat never
    flaps a peer dead, two in a row does by the next evaluation)."""
    env = os.environ.get(ENV_LEASE, "")
    if not env:
        return 3.0 * heartbeat_s
    try:
        return max(heartbeat_s, float(env))
    except ValueError:
        logger.warning("%s=%r is not a number; using 3x heartbeat",
                       ENV_LEASE, env)
        return 3.0 * heartbeat_s


def sign_blob(secret: str, body: str) -> str:
    """HMAC-SHA256 hex over the wire body; "" when unsigned (no secret
    configured — a closed lab network)."""
    if not secret:
        return ""
    return hmac.new(secret.encode(), body.encode(), hashlib.sha256).hexdigest()


def verify_blob(secret: str, body: str, signature: str) -> bool:
    return hmac.compare_digest(sign_blob(secret, body), signature or "")


# ---------------------------------------------------------------------------
# measured capacity curves (bench.py --capacity)
# ---------------------------------------------------------------------------


def load_capacity_rows(path: str) -> list[dict]:
    """Parse a ``bench.py --capacity`` record into capacity rows.

    Accepts the bench's native JSON-lines stream, a JSON array, or a
    driver wrapper dict (the ``BENCH_*.json`` shape, whose row rides in
    ``parsed``/``tail``). A capacity row is any object carrying a
    positive ``max_sessions_at_slo``; everything else in the file is
    ignored, and an unreadable file is an empty curve — the digest then
    falls back to structural free-slot counts, never an error."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        logger.warning("capacity file %s unreadable; using free slots", path)
        return []
    docs: list = []
    try:
        docs.append(json.loads(text))
    except ValueError:
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    docs.append(json.loads(line))
                except ValueError:
                    continue
    rows: list[dict] = []

    def _walk(obj) -> None:
        if isinstance(obj, dict):
            if obj.get("max_sessions_at_slo"):
                rows.append(obj)
                return
            for key in ("parsed", "rows"):
                _walk(obj.get(key))
            tail = obj.get("tail")
            if isinstance(tail, str):
                for line in tail.splitlines():
                    if line.startswith("{"):
                        try:
                            _walk(json.loads(line))
                        except ValueError:
                            continue
        elif isinstance(obj, list):
            for item in obj:
                _walk(item)

    _walk(docs)
    return rows


_capacity_cache: tuple[str, float, list[dict]] | None = None


def capacity_rows_from_env() -> list[dict]:
    """Capacity rows from ``SELKIES_CAPACITY_FILE`` (cached by path and
    mtime, so a re-run bench is picked up without a restart)."""
    global _capacity_cache
    path = os.environ.get(ENV_CAPACITY, "").strip()
    if not path:
        return []
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        mtime = -1.0
    if _capacity_cache is not None and _capacity_cache[:2] == (path, mtime):
        return _capacity_cache[2]
    rows = load_capacity_rows(path)
    _capacity_cache = (path, mtime, rows)
    return rows


def measured_max_sessions(rows: list[dict], *, chips: int,
                          codecs: list[str] | None = None) -> int:
    """The measured sessions-at-SLO ceiling for a host shape, 0 when
    the curve has no applicable row (= not measured; callers fall back
    to structural free-slot counts).

    Selection is conservative: rows must name a codec this host serves;
    occupancy-mode rows win over lockstep ones when both exist (the
    production scheduler runs overlapped); an exact chip-count match
    wins over scaling, otherwise the ceiling scales linearly with the
    chip ratio (floored, min 1 — capacity curves are near-linear in
    chips until the host core saturates, PERF.md); and the MIN across
    scenario mixes is taken, so a host never advertises headroom its
    worst measured mix can't serve."""
    served = {str(c).lower() for c in (codecs or ["h264"])}
    usable = []
    for row in rows:
        try:
            ceiling = int(row.get("max_sessions_at_slo", 0))
        except (TypeError, ValueError):
            continue
        if ceiling <= 0:
            continue
        codec = str(row.get("codec", "h264")).lower()
        if codec not in served:
            continue
        usable.append(row)
    if not usable:
        return 0
    overlap = [r for r in usable
               if str(r.get("mode", "overlap")).lower() != "lockstep"]
    if overlap:
        usable = overlap
    exact = [r for r in usable if int(r.get("chips", 0) or 0) == chips]
    per_mix: dict[str, int] = {}
    for row in (exact or usable):
        ceiling = int(row["max_sessions_at_slo"])
        row_chips = int(row.get("chips", 0) or 0)
        if not exact and chips > 0 and row_chips > 0 and row_chips != chips:
            ceiling = max(1, (ceiling * chips) // row_chips)
        mix = str(row.get("mix", row.get("metric", "?")))
        prev = per_mix.get(mix)
        per_mix[mix] = ceiling if prev is None else min(prev, ceiling)
    return min(per_mix.values())


# ---------------------------------------------------------------------------
# the capacity digest — ONE derivation for /healthz, /statz, heartbeat
# ---------------------------------------------------------------------------


def build_digest(*, host: str = "", drain=None, placer=None,
                 devices_view: dict | None = None,
                 slo_views: dict | None = None,
                 codecs: list[str] | None = None,
                 capacity_rows: list[dict] | None = None) -> dict:
    """The machine-readable capacity/drain summary of one host.

    Pure: every source is injected, so two in-process test hosts can
    build digests off their own placers while production feeds the
    process-global registrations (``telemetry.capacity_digest()``).
    Fields are a wire contract shared by ``/healthz`` (``capacity``
    block), ``/statz`` and the cluster heartbeat — additive changes
    only. ``has_placer=False`` marks a host without a placement plane
    (bare solo); the router treats it as one free slot unless draining.

    ``measured_max_sessions`` is the sessions-at-SLO ceiling from this
    host's measured capacity curve (``bench.py --capacity`` via
    ``capacity_rows`` or ``SELKIES_CAPACITY_FILE``); 0 means not
    measured, and routers fall back to the structural ``free_slots``.
    """
    d = {
        "host": host,
        "ts": round(time.time(), 3),
        "draining": False,
        "drain_state": "serving",
        "chips": 0,
        "healthy_chips": 0,
        "quarantined_chips": 0,
        "capacity": 1.0,
        "bands": 1,
        "shared": False,
        "has_placer": False,
        "free_chips": 0,
        "free_slots": 0,
        "sessions": 0,
        "busy": 0,
        "queue": 0,
        "chronic_burn": [],
        "codecs": list(codecs) if codecs is not None else ["h264"],
        "measured_max_sessions": 0,
    }
    if devices_view:
        d["chips"] = int(devices_view.get("chips", 0))
        d["healthy_chips"] = int(devices_view.get("healthy", 0))
        d["quarantined_chips"] = len(devices_view.get("quarantined") or ())
        d["capacity"] = float(devices_view.get("capacity", 1.0))
    if drain is not None:
        state = getattr(drain, "state", "serving")
        d["drain_state"] = state
        d["draining"] = state != "serving"
        if placer is None:
            placer = getattr(drain, "placer", None)
    if placer is not None:
        st = placer.stats()
        states = placer.states()
        d["has_placer"] = True
        d["bands"] = int(getattr(placer, "bands", 1))
        d["shared"] = bool(st.get("shared"))
        d["draining"] = d["draining"] or bool(st.get("draining"))
        d["free_chips"] = int(st.get("free", 0))
        d["sessions"] = len(st.get("carve") or ())
        d["queue"] = len(st.get("queue") or ())
        d["busy"] = sum(1 for s in states.values() if s == "busy")
        idle = sum(1 for s in states.values() if s == "serving")
        d["free_slots"] = idle + (
            0 if d["shared"] else d["free_chips"] // max(1, d["bands"]))
        if d["chips"] == 0:
            # no device health plane registered: the placer's carve is
            # the only chip truth this host has
            d["chips"] = int(st.get("chips", 0))
            d["quarantined_chips"] = len(st.get("quarantined") or ())
            d["healthy_chips"] = d["chips"] - d["quarantined_chips"]
            d["capacity"] = (round(d["healthy_chips"] / d["chips"], 3)
                             if d["chips"] else 1.0)
    if slo_views:
        d["chronic_burn"] = sorted(
            s for s, v in slo_views.items()
            if isinstance(v, dict) and v.get("chronic"))
    rows = (capacity_rows if capacity_rows is not None
            else capacity_rows_from_env())
    if rows:
        d["measured_max_sessions"] = measured_max_sessions(
            rows, chips=d["chips"], codecs=d["codecs"])
    return d


# ---------------------------------------------------------------------------
# per-peer membership state
# ---------------------------------------------------------------------------


class _PeerState:
    __slots__ = ("url", "digest", "lease_until", "last_seq", "last_boot",
                 "backoff", "next_send", "sent", "ok", "failed", "received",
                 "rejected")

    def __init__(self, url: str):
        self.url = url
        self.digest: dict | None = None
        self.lease_until = 0.0
        self.last_seq = -1
        self.last_boot = ""
        # capped-backoff re-join: a dead/refusing peer decays to ~30 s
        # retries instead of a hot loop, and heals to the heartbeat
        # cadence on the first success
        self.backoff = Backoff(base=0.5, cap=30.0, jitter=0.0)
        self.next_send = 0.0
        self.sent = self.ok = self.failed = 0
        self.received = self.rejected = 0


class ClusterNode:
    """One host's membership agent: heartbeat out, leases in.

    ``transport`` is ``async (peer_url, body, signature) -> bool``;
    the default POSTs to ``{peer}/cluster/heartbeat`` (the signalling
    server routes that path here when the orchestrators wire the
    plane). ``digest_fn`` builds this host's capacity digest — the
    production wiring passes ``telemetry.capacity_digest``.
    """

    # non-seed senders are tracked so asymmetric seed configs converge,
    # but the table is bounded: every tracked host is a permanent
    # _PeerState plus a Prometheus peer-label series, and in unsigned
    # mode anything that can reach /cluster/heartbeat can name a fresh
    # host per POST — without a cap one scanner grows memory and scrape
    # size without bound. Dead non-seed peers are evicted to make room.
    MAX_TRACKED_PEERS = 64

    def __init__(self, host: str, peers: list[str], *, secret: str = "",
                 heartbeat_s: float | None = None, lease_s: float | None = None,
                 digest_fn=None, transport=None, clock=time.monotonic):
        self.host = host.rstrip("/")
        self.secret = secret
        self.heartbeat_s = (heartbeat_interval_from_env()
                            if heartbeat_s is None else max(0.05, heartbeat_s))
        self.lease_s = (lease_from_env(self.heartbeat_s)
                        if lease_s is None else max(self.heartbeat_s, lease_s))
        self._digest_fn = digest_fn or telemetry.capacity_digest
        self._transport = transport or self._http_send
        self._clock = clock
        self._peers: dict[str, _PeerState] = {
            p: _PeerState(p) for p in (u.rstrip("/") for u in peers)
            if p and p != self.host}
        self._seeds = frozenset(self._peers)
        self._seq = 0
        # per-process boot id: receivers pair it with the seq so a
        # captured beat from this boot can never be replayed past a
        # newer one, while a genuine restart (new boot id, seq reset)
        # re-joins immediately
        self._boot = os.urandom(8).hex()
        self._task: asyncio.Task | None = None
        self._http = None

    @classmethod
    def from_env(cls, *, digest_fn=None, transport=None) -> "ClusterNode":
        return cls(cluster_self_from_env(), cluster_peers_from_env(),
                   secret=os.environ.get(ENV_SECRET, ""),
                   digest_fn=digest_fn, transport=transport)

    # -- outbound -------------------------------------------------------

    def self_digest(self) -> dict:
        d = dict(self._digest_fn() or {})
        d["host"] = self.host
        return d

    def envelope(self) -> tuple[str, str]:
        """(body, signature) of one heartbeat."""
        self._seq += 1
        body = json.dumps({"host": self.host, "seq": self._seq,
                           "boot": self._boot,
                           "digest": self.self_digest()}, sort_keys=True)
        return body, sign_blob(self.secret, body)

    async def heartbeat_once(self) -> None:
        """One beat to every seed peer that is not backing off. Failures
        arm the peer's capped backoff; success heals it. The
        ``cluster:heartbeat`` site fires once per (beat, peer) send."""
        body, sig = self.envelope()
        now = self._clock()
        fi = get_injector()
        for st in self._peers.values():
            if now < st.next_send:
                continue
            if fi is not None:
                try:
                    act = fi.check("cluster:heartbeat")
                except InjectedFault:
                    self._send_failed(st, "injected")
                    continue
                if act is not None:
                    kind, ms = act
                    if kind in ("drop", "flap"):
                        continue  # the beat is lost in flight: no backoff,
                        # the peer's lease on US simply ages toward expiry
                    if kind == "delay":
                        await asyncio.sleep(ms / 1e3)
            st.sent += 1
            try:
                ok = await self._transport(st.url, body, sig)
            except Exception as exc:
                logger.info("heartbeat to %s failed: %r", st.url, exc)
                ok = False
            if ok:
                st.ok += 1
                st.backoff.reset()
                st.next_send = 0.0
                if telemetry.enabled:
                    telemetry.count("selkies_cluster_heartbeats_total",
                                    peer=st.url, result="ok")
            else:
                self._send_failed(st, "send")
        self._export_gauges()

    def _send_failed(self, st: _PeerState, why: str) -> None:
        st.failed += 1
        delay = st.backoff.next_delay()
        st.next_send = self._clock() + delay
        logger.info("peer %s unreachable (%s); re-join retry in %.1fs",
                    st.url, why, delay)
        if telemetry.enabled:
            telemetry.count("selkies_cluster_heartbeats_total",
                            peer=st.url, result="fail")

    async def _http_send(self, peer: str, body: str, sig: str) -> bool:
        import aiohttp

        if self._http is None or self._http.closed:
            self._http = aiohttp.ClientSession()
        url = peer.rstrip("/") + "/cluster/heartbeat"
        async with self._http.post(
                url, data=body,
                headers={"x-selkies-cluster-sig": sig,
                         "Content-Type": "application/json"},
                timeout=aiohttp.ClientTimeout(total=2.0)) as r:
            return r.status == 200

    # -- inbound --------------------------------------------------------

    def receive(self, body: str, signature: str = "") -> bool:
        """One inbound heartbeat: verify, refresh the sender's lease,
        store its digest. Unknown (but correctly signed) senders are
        tracked too — the seed list bounds who WE beat to, not who may
        beat to us, so asymmetric seed configs still converge — up to
        ``MAX_TRACKED_PEERS``, beyond which new hosts are refused
        (dead non-seed entries are evicted first). The
        ``cluster:partition`` site drops inbound beats (a one-way
        partition the lease must surface)."""
        fi = get_injector()
        if fi is not None:
            try:
                act = fi.check("cluster:partition")
            except InjectedFault:
                act = ("drop", 0.0)
            if act is not None and act[0] in ("drop", "flap"):
                return False
        if not verify_blob(self.secret, body, signature):
            logger.warning("rejecting unsigned/mis-signed heartbeat")
            if telemetry.enabled:
                telemetry.count("selkies_cluster_heartbeats_total",
                                peer="?", result="rejected")
            return False
        try:
            data = json.loads(body)
            host = str(data["host"]).rstrip("/")
            seq = int(data.get("seq", 0))
            boot = str(data.get("boot", ""))
            digest = dict(data.get("digest") or {})
        except Exception:
            logger.warning("rejecting malformed heartbeat body")
            return False
        if host == self.host:
            return True  # self-echo (a seed list including ourselves)
        st = self._peers.get(host)
        if st is None:
            if len(self._peers) >= self.MAX_TRACKED_PEERS:
                self._evict_dead_nonseed()
            if len(self._peers) >= self.MAX_TRACKED_PEERS:
                logger.warning("peer table full (%d tracked, all alive or "
                               "seeds); dropping heartbeat from unknown "
                               "host %s", len(self._peers), host)
                if telemetry.enabled:
                    telemetry.count("selkies_cluster_heartbeats_total",
                                    peer="?", result="rejected")
                return False
            st = self._peers[host] = _PeerState(host)
            st.next_send = float("inf")  # not in OUR seed list: track only
        was_alive = st.lease_until > self._clock()
        if boot == st.last_boot and seq <= st.last_seq:
            # stale duplicate / replay from the peer's CURRENT boot: an
            # out-of-order beat must not roll the digest back (a delayed
            # pre-drain digest would keep routers sending clients to a
            # draining host), and a captured beat must not revive a dead
            # peer's lease — alive or not, same-boot seqs only move
            # forward. A genuinely restarted peer arrives with a fresh
            # boot id (seq reset is fine) and re-joins immediately.
            # Residual: a replay of a beat from an OLDER, never/last-
            # unseen boot is indistinguishable from a restart without
            # timestamped envelopes; the digest it installs ages out
            # within one lease.
            return True
        st.digest = digest
        st.last_seq = seq
        st.last_boot = boot
        st.lease_until = self._clock() + self.lease_s
        st.received += 1
        if telemetry.enabled:
            telemetry.count("selkies_cluster_heartbeats_total",
                            peer=host, result="received")
            if not was_alive:
                telemetry.event("cluster", host=host, action="peer_alive",
                                seq=seq)
        if not was_alive:
            logger.info("peer %s alive (lease %.1fs)", host, self.lease_s)
        return True

    def _evict_dead_nonseed(self) -> None:
        """Drop lease-expired peers we never beat to (not in the seed
        list): they exist only because they once heartbeated us, and a
        full table must prefer live members over dead strangers."""
        now = self._clock()
        for url in [u for u, st in self._peers.items()
                    if u not in self._seeds and st.lease_until <= now]:
            del self._peers[url]
            logger.info("evicted dead non-seed peer %s (table full)", url)

    async def http_handler(self, request):
        """aiohttp handler for ``/cluster/heartbeat`` (registered into
        SignallingServer.ws_routes by the orchestrators; HMAC replaces
        basic auth on this path)."""
        from aiohttp import web

        body = await request.text()
        sig = request.headers.get("x-selkies-cluster-sig", "")
        ok = self.receive(body, sig)
        return web.json_response({"ok": ok}, status=200 if ok else 403)

    # -- read side ------------------------------------------------------

    def alive_peers(self) -> dict[str, dict]:
        """host -> last digest, for peers whose lease is unexpired and
        who have reported a digest at all."""
        now = self._clock()
        return {st.url: st.digest for st in self._peers.values()
                if st.digest is not None and st.lease_until > now}

    def peer_alive(self, host: str) -> bool:
        st = self._peers.get(host.rstrip("/"))
        return st is not None and st.lease_until > self._clock()

    def stats(self) -> dict:
        """/statz ``cluster.membership`` block."""
        now = self._clock()
        return {
            "self": self.host,
            "heartbeat_s": self.heartbeat_s,
            "lease_s": self.lease_s,
            "signed": bool(self.secret),
            "peers": {
                st.url: {
                    "alive": st.lease_until > now,
                    "lease_s": round(max(0.0, st.lease_until - now), 1),
                    "sent": st.sent, "ok": st.ok, "failed": st.failed,
                    "received": st.received,
                    "backoff_s": round(max(0.0, st.next_send - now), 1)
                    if st.next_send not in (0.0, float("inf")) else 0.0,
                    "free_slots": (st.digest or {}).get("free_slots"),
                    "draining": (st.digest or {}).get("draining"),
                }
                for st in sorted(self._peers.values(), key=lambda s: s.url)
            },
        }

    def _export_gauges(self) -> None:
        if not telemetry.enabled:
            return
        now = self._clock()
        alive = sum(1 for st in self._peers.values()
                    if st.lease_until > now)
        telemetry.gauge("selkies_cluster_peers", alive, state="alive")
        telemetry.gauge("selkies_cluster_peers",
                        len(self._peers) - alive, state="dead")

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._heartbeat_loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._http is not None:
            await self._http.close()
            self._http = None

    async def _heartbeat_loop(self) -> None:
        while True:
            try:
                await self.heartbeat_once()
            except Exception:
                logger.exception("heartbeat round failed; next beat rides")
            await asyncio.sleep(self.heartbeat_s)
