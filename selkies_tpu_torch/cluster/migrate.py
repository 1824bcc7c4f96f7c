"""Cross-host live migration: checkpoint → ship → restore → redirect.

The port's copy of ``selkies_tpu/cluster/migrate.py``, whole, restoring
into the port's ``SessionFleet`` through the port's
``parallel/lifecycle.restore_session``. The checkpoint JSON is the only
state that crosses hosts, so a JAX host and a port host migrate sessions
to each other in both directions. ``migration_stats`` counts this
package's migrations only.

PR 6's `checkpoint_session`/`restore_session` made a session's minimal
encoder state a JSON blob whose restore opens with a recovery IDR
byte-identical to an uninterrupted oracle's. This module drives that
blob **between hosts** over an authenticated channel, with the ordering
that makes a mid-migration peer death safe:

1. the **source** checkpoints the session (read-only — the session
   keeps serving; the existing ``migrate:<k>`` fault site fires here);
2. the checkpoint is **shipped** to the target's ``/cluster/migrate``
   endpoint (HMAC-signed with the cluster secret; the ``cluster:ship``
   site injects slow ships and mid-migration deaths);
3. the **target** restores it into a freshly-admitted slot and forces
   the recovery IDR, answering with the landing session id. The slot is
   held under a **claim window** (``SELKIES_CLUSTER_CLAIM_S``): if the
   client never follows its redirect, the slot auto-releases — an
   ack lost on the way back can park capacity, never leak it;
4. only on a positive ack does the source **release** its placement
   and redirect the client (signalling/server.py ``redirect_peer``).

Failure at any step before (4) leaves the session serving on the
source untouched — a migration can be retried or abandoned, but a
session is never in two serving places (the target's restored slot is
*pending*, not connected, until the client actually arrives) and never
in zero (the source releases only after the target acked).

:class:`~selkies_tpu_torch.parallel.lifecycle.DrainController`'s migrate hook
runs this for every connected session before the checkpoint hand-off,
so SIGTERM empties a host into the cluster (migrate-off-then-stop)
instead of dropping its sessions.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from collections import deque

from selkies_tpu_torch.cluster.membership import sign_blob, verify_blob
from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.resilience import get_injector

logger = logging.getLogger("cluster.migrate")

__all__ = [
    "HttpMigrationChannel",
    "LocalMigrationChannel",
    "MigrationError",
    "MigrationTarget",
    "claim_window_from_env",
    "migrate_session",
    "migration_stats",
    "ship_checkpoint",
]

ENV_CLAIM = "SELKIES_CLUSTER_CLAIM_S"

# process-wide migration counters for /statz (monotonic; in_flight is
# the only gauge-like member)
_stats = {"out_ok": 0, "out_fail": 0, "in_ok": 0, "in_fail": 0,
          "in_flight": 0, "claims_expired": 0}


def migration_stats() -> dict:
    return dict(_stats)


def claim_window_from_env() -> float:
    """Seconds a migrated-in session waits for its client before the
    target releases the slot (the lost-ack capacity bound)."""
    env = os.environ.get(ENV_CLAIM, "")
    if not env:
        return 10.0
    try:
        return max(0.5, float(env))
    except ValueError:
        logger.warning("%s=%r is not a number; using 10", ENV_CLAIM, env)
        return 10.0


class MigrationError(RuntimeError):
    """A cross-host migration step failed; the session keeps serving on
    the source."""


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------


class HttpMigrationChannel:
    """Production inter-host channel: HMAC-signed POST to the target's
    ``/cluster/migrate``."""

    def __init__(self, secret: str = ""):
        self.secret = secret
        self._http = None

    async def send(self, host: str, payload: dict) -> dict:
        import aiohttp

        if self._http is None or self._http.closed:
            self._http = aiohttp.ClientSession()
        body = json.dumps(payload, sort_keys=True)
        url = host.rstrip("/") + "/cluster/migrate"
        try:
            async with self._http.post(
                    url, data=body,
                    headers={"x-selkies-cluster-sig": sign_blob(self.secret,
                                                                body),
                             "Content-Type": "application/json"},
                    timeout=aiohttp.ClientTimeout(total=10.0)) as r:
                if r.status != 200:
                    raise MigrationError(
                        f"migrate to {host} refused: HTTP {r.status}")
                return await r.json()
        except MigrationError:
            raise
        except Exception as exc:
            raise MigrationError(f"migrate ship to {host} failed: "
                                 f"{exc!r}") from exc

    async def close(self) -> None:
        if self._http is not None:
            await self._http.close()
            self._http = None


class LocalMigrationChannel:
    """In-process channel for multi-host tests and single-machine sims:
    a host-label -> async handler registry."""

    def __init__(self):
        self.handlers: dict[str, object] = {}

    def register(self, host: str, handler) -> None:
        self.handlers[host.rstrip("/")] = handler

    async def send(self, host: str, payload: dict) -> dict:
        handler = self.handlers.get(host.rstrip("/"))
        if handler is None:
            raise MigrationError(f"no migration handler for {host}")
        result = handler(payload)
        if asyncio.iscoroutine(result):
            result = await result
        return result


async def ship_checkpoint(channel, host: str, ck, *, source: str = "") -> dict:
    """Ship one checkpoint; the ``cluster:ship`` site fires per ship
    (``delay:<ms>`` = a slow ship eating the drain deadline,
    ``drop``/``raise`` = mid-migration peer death)."""
    fi = get_injector()
    if fi is not None:
        act = fi.check("cluster:ship")  # raises InjectedFault on `raise`
        if act is not None:
            kind, ms = act
            if kind == "delay":
                await asyncio.sleep(ms / 1e3)
            else:  # drop / flap: the ship never reaches the peer
                raise MigrationError("checkpoint ship dropped (injected)")
    # the nonce rides inside the signed body: a captured ship can be
    # replayed byte-for-byte but never re-nonced without the secret,
    # so the target's seen-nonce window shuts replays out
    ack = await channel.send(host, {"checkpoint": ck.to_json(),
                                    "source": source,
                                    "nonce": os.urandom(16).hex()})
    if not isinstance(ack, dict) or not ack.get("ok"):
        raise MigrationError(f"target {host} refused the checkpoint: {ack!r}")
    return ack


# ---------------------------------------------------------------------------
# target (inbound) half
# ---------------------------------------------------------------------------


class MigrationTarget:
    """The receiving host: admit a slot, restore the checkpoint, hold a
    claim window for the redirected client."""

    def __init__(self, fleet=None, *, secret: str = "", advertise: str = "",
                 restore=None, claim_s: float | None = None,
                 clock=time.monotonic):
        self.fleet = fleet
        self.secret = secret
        self.advertise = advertise
        self._restore = restore or self._restore_into_fleet
        self.claim_s = (claim_window_from_env()
                        if claim_s is None else max(0.0, claim_s))
        self._clock = clock
        # session id -> claim deadline for restored-but-unclaimed slots
        self.pending_claims: dict[int, float] = {}
        # replay window: the HMAC authenticates a ship but (unlike the
        # heartbeat's boot+seq) carries no ordering, so a captured
        # signed POST would re-verify forever — refusing recently-seen
        # nonces bounds the damage to nothing (every legitimate ship
        # mints a fresh nonce inside the signed body)
        self._seen_nonces: deque = deque(maxlen=256)

    def handle(self, payload: dict) -> dict:
        """Restore one shipped checkpoint; returns the ack the source
        acts on. Never raises — a refusal is an ack with ok=False so
        the source keeps serving the session."""
        from selkies_tpu_torch.parallel.lifecycle import SessionCheckpoint

        nonce = str(payload.get("nonce", ""))
        if nonce:
            if nonce in self._seen_nonces:
                _stats["in_fail"] += 1
                logger.warning("refusing replayed migrate ship (nonce "
                               "already seen)")
                if telemetry.enabled:
                    telemetry.count("selkies_cluster_migrations_total",
                                    direction="in", result="fail")
                return {"ok": False, "error": "replayed ship (nonce seen)"}
            self._seen_nonces.append(nonce)
        try:
            ck = SessionCheckpoint.from_json(payload["checkpoint"])
            k = self._restore(ck)
        except Exception as exc:
            _stats["in_fail"] += 1
            logger.exception("inbound migration refused")
            if telemetry.enabled:
                telemetry.count("selkies_cluster_migrations_total",
                                direction="in", result="fail")
            return {"ok": False, "error": repr(exc)}
        _stats["in_ok"] += 1
        if self.claim_s > 0:
            self.pending_claims[k] = self._clock() + self.claim_s
            self._arm_claim_timer(k)
        if telemetry.enabled:
            telemetry.count("selkies_cluster_migrations_total",
                            direction="in", result="ok")
            telemetry.event("cluster", session=str(k), action="migrate_in",
                            source=str(payload.get("source", "")))
        logger.warning("migrated session landed as slot %d (from %s)",
                       k, payload.get("source", "?"))
        return {"ok": True, "session": k, "host": self.advertise}

    def _restore_into_fleet(self, ck) -> int:
        """Default restore: the checkpoint's OWN slot index first (the
        client's signalling peer id encodes it — landing on the same
        index keeps the redirect's uid binding trivial), else the first
        unconnected slot admission accepts; GOP/RC state applied,
        recovery IDR forced. The landing index rides the ack so a
        cross-index landing re-targets the client's peer id."""
        from selkies_tpu_torch.parallel.lifecycle import restore_session

        fleet = self.fleet
        if fleet is None:
            raise MigrationError("no fleet wired on this target")
        order = [int(ck.session)] if 0 <= int(ck.session) < len(fleet.slots) \
            else []
        order += [k for k in range(len(fleet.slots)) if k not in order]
        for k in order:
            slot = fleet.slots[k]
            if slot.connected or k in self.pending_claims:
                continue
            adm = fleet.admit_client(k)
            if not adm.accepted:
                continue
            try:
                restore_session(ck, fleet.service, k, slot=slot)
            except Exception:
                # the slot was already admitted: release it or this
                # failed restore parks its chips forever (the module's
                # "never leak capacity" promise) — the source keeps
                # serving either way (it only releases on a positive ack)
                try:
                    fleet.release_session(k)
                except Exception:
                    logger.exception("releasing slot %d after a failed "
                                     "restore also failed", k)
                raise
            return k
        raise MigrationError("no slot with capacity for the migration")

    # -- claim window ---------------------------------------------------

    def _arm_claim_timer(self, k: int) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # sync callers (tests) drive expire_claims directly
        loop.call_later(self.claim_s + 0.05, self.expire_claims)

    def expire_claims(self, now: float | None = None) -> list[int]:
        """Release restored slots whose client never arrived (lost ack
        or lost redirect): parked capacity returns to the pool instead
        of leaking. Returns the expired session ids."""
        now = self._clock() if now is None else now
        expired = []
        for k, deadline in list(self.pending_claims.items()):
            if self.fleet is not None and self.fleet.slots[k].connected:
                self.pending_claims.pop(k, None)  # claimed: keep serving
                continue
            if now >= deadline:
                self.pending_claims.pop(k, None)
                expired.append(k)
                _stats["claims_expired"] += 1
                logger.warning("migrated-in session %d unclaimed for %.1fs;"
                               " releasing the slot", k, self.claim_s)
                if self.fleet is not None:
                    try:
                        self.fleet.release_session(k)
                    except Exception:
                        logger.exception("releasing unclaimed slot %d "
                                         "failed", k)
                if telemetry.enabled:
                    telemetry.event("cluster", session=str(k),
                                    action="claim_expired")
        return expired

    async def http_handler(self, request):
        """aiohttp handler for ``/cluster/migrate`` (HMAC-gated)."""
        from aiohttp import web

        body = await request.text()
        sig = request.headers.get("x-selkies-cluster-sig", "")
        if not verify_blob(self.secret, body, sig):
            return web.json_response({"ok": False, "error": "bad signature"},
                                     status=403)
        try:
            payload = json.loads(body)
        except Exception:
            return web.json_response({"ok": False, "error": "bad body"},
                                     status=400)
        return web.json_response(self.handle(payload))


# ---------------------------------------------------------------------------
# source (outbound) half
# ---------------------------------------------------------------------------


async def migrate_session(fleet, k: int, host: str, channel, *,
                          source: str = "") -> dict:
    """Move fleet session ``k`` to ``host``: checkpoint, ship, and ON
    ACK release the local placement. Raises MigrationError (or the
    injected fault) with the session untouched when any step before the
    ack fails — the caller decides between retry and checkpoint
    hand-off. The client redirect is the CALLER's step (it owns the
    signalling peer)."""
    _stats["in_flight"] += 1
    try:
        from selkies_tpu_torch.parallel.lifecycle import checkpoint_session

        ck = checkpoint_session(fleet.service, k, slot=fleet.slots[k])
        ack = await ship_checkpoint(channel, host, ck, source=source)
    except Exception:
        _stats["out_fail"] += 1
        if telemetry.enabled:
            telemetry.count("selkies_cluster_migrations_total",
                            direction="out", result="fail")
        raise
    finally:
        _stats["in_flight"] -= 1
    # the target holds the session now: free the local carve (queued
    # sessions may promote into it) — the caller redirects the client
    fleet.release_session(k)
    _stats["out_ok"] += 1
    if telemetry.enabled:
        telemetry.count("selkies_cluster_migrations_total",
                        direction="out", result="ok")
        telemetry.event("cluster", session=str(k), action="migrate_out",
                        target=host, landed=ack.get("session"))
    logger.warning("session %d migrated to %s (landing slot %s)",
                   k, host, ack.get("session"))
    return ack
