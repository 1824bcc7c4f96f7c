"""Fleet session lifecycle control plane: admission, drain, re-carve, migrate.

The port's copy of ``selkies_tpu/parallel/lifecycle.py``, on the port's
own telemetry bus, tracer, fault injector and device pool. The
:class:`SessionPlacer` owns the sessions x bands device carve as
**mutable state**:

* **admission** — ``admit(session)`` accepts / queues / rejects a client
  against live capacity: free chips, pack-pool headroom (host cores vs
  the CAVLC workers already committed to busy sessions), and the per-slot
  health registry (``telemetry.health()``).
* **dynamic re-carve** — ``borrow(session)`` moves an idle session's band
  chips to a busy one and ``return_borrowed`` gives them back under
  pressure (a lender's client reconnecting reclaims its row). The serving
  layer rebuilds the affected encoders; byte continuity is guaranteed by
  the forced IDR that a rebuilt encoder always opens with.
* **graceful drain** — :class:`DrainController` is the K8s ``preStop``
  path: stop admitting, force an IDR so every client holds a decodable
  recovery point, flush in-flight groups, checkpoint sessions for
  hand-off, then exit — all inside ``SELKIES_DRAIN_TIMEOUT`` seconds.
* **live migration** — :func:`checkpoint_session` serializes the minimal
  encoder state (GOP phase + IDR pic-id parity, rate-control, tile-cache
  epoch, congestion estimate, LTR slot metadata) as JSON;
  :func:`restore_session` applies it to another slot or process and
  forces an IDR, so the client sees at worst one recovery GOP.

Every transition is observable (``selkies_admission_total`` /
``selkies_lifecycle_events_total`` / ``selkies_placement_chips`` /
``selkies_drain_state`` + the ``admit``/``recarve``/``drain``/``migrate``
tracer spans) and chaos-testable through the ``admission``, ``recarve``,
``migrate`` and ``drain`` fault sites. With ``devices=None`` the placer
owns the device pool's chips (``resilience/devhealth.py``: CUDA devices,
raising without a card). On one card every carve of more than one chip
is the shared carve: rows alias the card and ``borrow`` returns ``[]``.
Checkpoints equal JAX's field for field (tests/test_torch_lifecycle.py).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import logging
import os
import signal as _signal
import threading
import time
from dataclasses import asdict, dataclass, field

from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.monitoring.tracing import tracer
from selkies_tpu_torch.resilience import InjectedFault, chip_key, get_injector

logger = logging.getLogger("selkies_tpu_torch.parallel.lifecycle")

__all__ = [
    "Admission",
    "DrainController",
    "SessionCheckpoint",
    "SessionPlacer",
    "checkpoint_session",
    "drain_timeout_from_env",
    "install_signal_handlers",
    "restore_session",
]

ENV_DRAIN_TIMEOUT = "SELKIES_DRAIN_TIMEOUT"
ENV_ADMISSION_QUEUE = "SELKIES_ADMISSION_QUEUE"


def drain_timeout_from_env() -> float:
    """Drain deadline in seconds (the K8s terminationGracePeriod budget
    this process actually honors; default 10)."""
    env = os.environ.get(ENV_DRAIN_TIMEOUT, "")
    if not env:
        return 10.0
    try:
        return max(0.1, float(env))
    except ValueError:
        logger.warning("%s=%r is not a number; using 10", ENV_DRAIN_TIMEOUT, env)
        return 10.0


def _queue_limit_from_env() -> int:
    env = os.environ.get(ENV_ADMISSION_QUEUE, "")
    if not env:
        return 8
    try:
        return max(0, int(env))
    except ValueError:
        logger.warning("%s=%r is not an integer; using 8",
                       ENV_ADMISSION_QUEUE, env)
        return 8


@dataclass(frozen=True)
class Admission:
    """One admission decision: ``accept`` | ``queue`` | ``reject``."""

    decision: str
    reason: str = ""

    @property
    def accepted(self) -> bool:
        return self.decision == "accept"


class SessionPlacer:
    """Owns the sessions × bands device carve as mutable state.

    Thread-safe: admission runs on the event loop while re-carve and
    release may be driven from supervisor callbacks on worker threads.
    The core invariant — **every chip is in exactly one place** (the free
    pool or one session's row) — is asserted after every mutation
    (``assert_consistent``), so admission can never over-commit and no
    transition can leak chips. On a slice too small for the requested
    carve (the CPU-mesh fallback case) the placer degrades to *shared*
    accounting: rows round-robin over the chips that exist, capacity
    gating is disabled (the encoders byte-identically share devices,
    parallel/bands.py), and only drain/health gating remains.
    """

    def __init__(self, devices=None, *, bands: int = 1,
                 grid: tuple[int, int] | None = None,
                 host_cores: int | None = None,
                 queue_limit: int | None = None,
                 health=None):
        preq: tuple[str, ...] = ()
        if devices is None:
            # the device health plane is the single source of chip
            # enumeration (resilience/devhealth.py): the placer owns ALL
            # chips — quarantine is a first-class placement location —
            # and pre-applies whatever the pool already quarantined, so
            # placement and health can never disagree about the chip set
            from selkies_tpu_torch.resilience import get_device_pool

            pool = get_device_pool()
            devices = pool.all_devices()
            preq = tuple(pool.quarantined_keys())
        self.devices = list(devices)
        self.bands = max(1, int(bands))
        # 2D tile-grid carve shape (SELKIES_TILE_GRID=RxC): purely
        # descriptive here — the placer's unit stays CHIPS per session
        # (bands == rows*cols for a grid carve), so every admission /
        # borrow / gauge path below is shape-agnostic; the shape is
        # surfaced through stats()/'/statz' so operators can see how a
        # session's chip row folds into its (band, col) mesh
        self.grid = (int(grid[0]), int(grid[1])) if grid is not None else None
        if self.grid is not None and self.grid[0] * self.grid[1] != self.bands:
            raise ValueError(
                f"grid {self.grid[0]}x{self.grid[1]} does not match "
                f"{self.bands} chips per session")
        self.host_cores = host_cores if host_cores is not None else (
            os.cpu_count() or 4)
        self.queue_limit = (_queue_limit_from_env()
                            if queue_limit is None else int(queue_limit))
        self._health = health or (lambda: telemetry.health().get("status", "ok"))
        self._lock = threading.RLock()
        self._free: list = list(self.devices)
        self._rows: dict[int, list] = {}
        # quarantined chips: the third first-class location (free pool /
        # a row / quarantine) the every-chip-in-exactly-one-place
        # invariant covers. _quarantine_home remembers which session's
        # row a chip was pulled from so readmit can restore the carve.
        self._quarantined: dict[str, object] = {}
        self._quarantine_home: dict[str, int | None] = {}
        self._key_map: dict[str, object] = {
            chip_key(d): d for d in self.devices}
        # borrower -> [(lender, chips), ...]; lenders' rows sit empty
        # ("lent") until the borrower returns or releases
        self._debts: dict[int, list[tuple[int, list]]] = {}
        self._busy: set[int] = set()
        self._queue: list[int] = []
        # per-session negotiated codec (signalling/negotiate.py): the
        # DURABLE placement-side record — a supervisor service rebuild
        # reconstructs each session's encoder from this, so a restart
        # mid-AV1-session comes back as AV1, not the h264 default
        self._codecs: dict[int, str] = {}
        self._codec_series: set[str] = {"h264"}  # gauge series ever emitted
        self.shared = False  # degenerate small-slice carve (no capacity math)
        self.draining = False
        self.counters: dict[str, int] = {
            "accepts": 0, "rejects": 0, "queued": 0, "reclaims": 0,
            "releases": 0, "borrows": 0, "returns": 0,
        }
        # wired by the serving layer: called with a session id when a
        # queued session gains capacity on someone else's release
        self.on_admitted = None
        for key in preq:  # pool-known quarantines predate this carve
            self.quarantine(key)

    # -- initial carve --------------------------------------------------

    def place_initial(self, n_sessions: int, bands: int | None = None) -> list[list]:
        """The startup carve (replaces the one-shot partition_devices):
        n_sessions rows of ``bands`` chips, registered as mutable
        placements. Falls back to shared round-robin rows when the slice
        is too small — mirroring TorchBandedFleetService's single-device
        fallback (identical bytes, no parallelism)."""
        bands = self.bands if bands is None else max(1, int(bands))
        with self._lock:
            need = n_sessions * bands
            if len(self._free) < need or self._rows:
                if self._rows:
                    raise RuntimeError("place_initial called on a live carve")
                self.shared = True
                # round-robin over the HEALTHY chips: a quarantine that
                # pre-dates the carve (pool preq) must not pin a shared
                # session to a dead chip — shared mode has no later
                # quarantine transition to move it off
                devs = self._shared_devs_locked()
                self._rows = {
                    k: [devs[k % len(devs)]] for k in range(n_sessions)}
                logger.info(
                    "placer: %d sessions x %d bands needs %d chips, have %d "
                    "— shared single-device rows (capacity gating off)",
                    n_sessions, bands, need, len(devs))
            else:
                self._rows = {
                    k: [self._free.pop(0) for _ in range(bands)]
                    for k in range(n_sessions)
                }
            rows = [list(self._rows[k]) for k in range(n_sessions)]
        self._export_gauges()
        self.assert_consistent()
        return rows

    # -- admission ------------------------------------------------------

    def admit(self, session: int, *, bands: int | None = None) -> Admission:
        """Can ``session`` take a client now? Checks, in order: injected
        faults, drain state, fleet health, lent-out chips (the caller
        reclaims and retries), then chip + pack-pool capacity for a
        session that has no row yet."""
        with tracer.span("admit"):
            adm = self._admit_inner(session, bands)
        if adm.accepted:
            self.counters["accepts"] += 1
        elif adm.decision != "queue":
            self.counters["rejects"] += 1
        elif adm.reason == "chips-lent":
            # not actually enqueued — the caller reclaims and retries;
            # counting it as "queued" would make the counter diverge
            # from the real queue depth on every reclaim
            self.counters["reclaims"] += 1
        else:
            self.counters["queued"] += 1
        if telemetry.enabled:
            telemetry.count("selkies_admission_total",
                            decision=adm.decision, reason=adm.reason or "ok")
            # ring event with the SESSION attached so the decision shows
            # up in that session's black-box window, not just "0"'s
            telemetry.event("admission", session=str(session),
                            decision=adm.decision, reason=adm.reason or "ok")
        self._export_gauges()
        self.assert_consistent()
        return adm

    def _admit_inner(self, session: int, bands: int | None) -> Admission:
        fi = get_injector()
        if fi is not None:
            try:
                act = fi.check("admission")
            except InjectedFault:
                return Admission("reject", "fault-injected")
            if act is not None and act[0] == "drop":
                return Admission("reject", "fault-injected")
        with self._lock:
            if self.draining:
                return Admission("reject", "draining")
            row = self._rows.get(session)
            if row is not None:
                if not row:  # its chips are lent out: caller reclaims
                    return Admission("queue", "chips-lent")
                if self.shared or session in self._busy:
                    return Admission("accept", "placed")
                # a placed-but-idle session taking a client still commits
                # pack workers, so the headroom gate applies to it exactly
                # as to a new placement — the wired fleet pre-carves a row
                # for every session at startup, and without this check the
                # pack-pool gate would be unreachable in production. The
                # HEALTH gate stays new-placements-only (below).
                if self._committed_workers() + len(row) > \
                        max(2, 2 * self.host_cores):
                    return self._enqueue(session, "pack-pool")
                if session in self._queue:
                    self._queue.remove(session)
                return Admission("accept", "placed")
            # the health gate refuses NEW placements only: a client
            # reconnecting into its already-carved session must get
            # through even while the fleet recovers (refusing reconnects
            # on a down fleet with no ticks would deadlock recovery)
            try:
                health = self._health()
            except Exception:
                health = "ok"
            if health == "down":
                return Admission("reject", "unhealthy")
            need = self.bands if bands is None else max(1, int(bands))
            if self.shared:
                devs = self._shared_devs_locked()
                self._rows[session] = [devs[session % len(devs)]]
                return Admission("accept", "shared")
            if self._committed_workers() + need > max(2, 2 * self.host_cores):
                return self._enqueue(session, "pack-pool")
            if len(self._free) >= need:
                self._rows[session] = [self._free.pop(0) for _ in range(need)]
                if session in self._queue:
                    self._queue.remove(session)
                return Admission("accept", "placed")
            return self._enqueue(session, "capacity")

    def _shared_devs_locked(self) -> list:
        """Shared-carve round-robin candidates (lock held): healthy
        chips only, falling back to every owned chip when quarantine
        has emptied the healthy set (serve degraded over serve
        nothing)."""
        healthy = [d for d in self.devices
                   if chip_key(d) not in self._quarantined]
        return healthy or list(self.devices)

    def _committed_workers(self) -> int:
        """CAVLC pack workers committed to busy sessions (lock held)."""
        return sum(len(self._rows[k]) for k in self._busy if k in self._rows)

    def _borrowed(self) -> int:
        """Chips currently on loan across all debts (lock held)."""
        return sum(len(c) for d in self._debts.values() for _, c in d)

    def _enqueue(self, session: int, reason: str) -> Admission:
        if session in self._queue:
            return Admission("queue", reason)
        if len(self._queue) >= self.queue_limit:
            return Admission("reject", reason)
        self._queue.append(session)
        return Admission("queue", reason)

    def set_busy(self, session: int, busy: bool) -> None:
        """A connected client makes its session *busy*: busy sessions
        commit pack workers and never lend their chips."""
        with self._lock:
            (self._busy.add if busy else self._busy.discard)(session)

    def release(self, session: int) -> None:
        """Session torn down (recycle rung, migration away): its debts
        are settled, its chips return to the pool, and queued sessions
        are promoted into the freed capacity."""
        promoted: list[int] = []
        with self._lock:
            # a releasing borrower returns what it holds first
            self._settle_debts(session)
            # a releasing LENDER orphans its outstanding loans: the
            # lent chips must settle to the POOL on return, not to
            # whatever row this session id is re-admitted into later
            # (that would grow a re-carved row past the bands carve and
            # strand the chips with no debt record to reclaim them by)
            for b, debts in self._debts.items():
                self._debts[b] = [(l if l != session else None, c)
                                  for l, c in debts]
            row = self._rows.pop(session, None)
            if row and not self.shared:
                self._free.extend(row)
            # the codec record belongs to the DEPARTING client — a
            # re-admitted slot must not be rebuilt with it before the
            # next client's negotiation runs
            self._codecs.pop(session, None)
            self._busy.discard(session)
            if session in self._queue:
                self._queue.remove(session)
            # a released session's quarantine homes are orphaned: a chip
            # readmitted later must settle to the POOL, never into
            # whatever row this session id is re-admitted into
            for key, home in self._quarantine_home.items():
                if home == session:
                    self._quarantine_home[key] = None
            self.counters["releases"] += 1
            promoted = self._promote_locked()
        if telemetry.enabled:
            telemetry.count("selkies_lifecycle_events_total", event="release")
        self._export_gauges()
        self.assert_consistent()
        for sid in promoted:
            if self.on_admitted is not None:
                try:
                    self.on_admitted(sid)
                except Exception:
                    logger.exception("on_admitted(%d) failed", sid)

    # -- dynamic re-carve ----------------------------------------------

    def borrow(self, borrower: int) -> list:
        """Move one idle session's row to ``borrower`` (more band chips
        for the busy session). Returns the borrowed chips, or [] when no
        idle lender exists. Raises InjectedFault on a scheduled
        ``recarve`` fault BEFORE any state moves — a failed re-carve
        must leave the carve exactly as it was."""
        with tracer.span("recarve"):
            fi = get_injector()
            if fi is not None:
                fi.check("recarve")  # raises on a scheduled fault
            with self._lock:
                if self.shared or borrower not in self._rows:
                    return []
                lender = next(
                    (k for k, row in self._rows.items()
                     if row and k != borrower and k not in self._busy
                     and k not in self._debts
                     and not self._is_lender(k)),
                    None)
                if lender is None:
                    return []
                chips = self._rows[lender]
                self._rows[lender] = []
                self._rows[borrower] = self._rows[borrower] + chips
                self._debts.setdefault(borrower, []).append((lender, chips))
                self.counters["borrows"] += 1
        if telemetry.enabled:
            telemetry.count("selkies_lifecycle_events_total",
                            event="recarve_borrow")
            telemetry.event("recarve", session=str(borrower),
                            action="borrow", lender=lender,
                            chips=len(chips))
        self._export_gauges()
        self.assert_consistent()
        return list(chips)

    def return_borrowed(self, borrower: int) -> list[tuple[int, list]]:
        """Give every borrowed chip back to its lender (or to the free
        pool when the lender released meanwhile). Returns the settled
        (lender, chips) pairs."""
        with tracer.span("recarve"):
            with self._lock:
                settled = self._settle_debts(borrower)
                if settled:
                    self.counters["returns"] += 1
        if settled and telemetry.enabled:
            telemetry.count("selkies_lifecycle_events_total",
                            event="recarve_return")
            telemetry.event("recarve", session=str(borrower),
                            action="return", settled=len(settled))
        self._export_gauges()
        self.assert_consistent()
        return settled

    def _settle_debts(self, borrower: int) -> list[tuple[int, list]]:
        settled = self._debts.pop(borrower, [])
        for lender, chips in settled:
            row = self._rows.get(borrower, [])
            self._rows[borrower] = [d for d in row if d not in chips]
            # lender None: the loan was orphaned by the lender's release
            if lender is not None and lender in self._rows:
                self._rows[lender] = self._rows[lender] + chips
            else:
                self._free.extend(chips)
        return settled

    def _is_lender(self, session: int) -> bool:
        return any(lender == session
                   for debts in self._debts.values()
                   for lender, _ in debts)

    def borrowers_from(self, lender: int) -> list[int]:
        """Who currently holds ``lender``'s chips (pressure path: the
        lender's client is back and wants its row reclaimed)."""
        with self._lock:
            return [b for b, debts in self._debts.items()
                    if any(l == lender for l, _ in debts)]

    def _promote_locked(self) -> list[int]:
        """Grant freed capacity to CAPACITY-queued sessions (lock held);
        a pack-pool-queued session already holds a row (carving it
        another would leak the old one) and gets in via its client's
        reconnect retry once headroom frees. Returns the promoted ids —
        the caller fires ``on_admitted`` outside the lock."""
        promoted: list[int] = []
        if self.shared:
            return promoted
        while len(self._free) >= self.bands:
            sid = next((s for s in self._queue
                        if not self._rows.get(s)), None)
            if sid is None:
                break
            self._queue.remove(sid)
            self._rows[sid] = [self._free.pop(0)
                               for _ in range(self.bands)]
            promoted.append(sid)
        return promoted

    # -- device quarantine (the health plane's placement half) ----------

    def quarantine(self, chip) -> list[int]:
        """Pull one chip out of circulation — from the free pool, a
        session's row, or a live borrow debt — into the quarantine
        location. Returns the sessions whose rows shrank (the serving
        layer re-carves them on the smaller carve; an emptied row is its
        caller's poison-path signal). Accepts a device object or its
        ``chip_key``. No-op in the shared small-slice carve (rows alias
        chips and there is no capacity math to shrink)."""
        key = chip if isinstance(chip, str) else chip_key(chip)
        affected: list[int] = []
        with self._lock:
            if self.shared or key in self._quarantined:
                return []
            dev = self._key_map.get(key)
            if dev is None:
                return []  # not a chip this placer owns
            home: int | None = None
            if dev in self._free:
                self._free.remove(dev)
            else:
                for k, row in self._rows.items():
                    if dev in row:
                        self._rows[k] = [d for d in row if d != dev]
                        affected.append(k)
                        home = k
                        break
                # a chip on loan sits in the borrower's row (removed
                # above) AND in a debt record: shrink the debt too, or
                # settling it would resurrect the quarantined chip into
                # the lender's row. The LENDER is the home — the chip
                # belongs to its carve, not the borrower's — and an
                # orphaned loan (lender already released, recorded as
                # None) homes to the POOL: readmitting it into the
                # borrower's row would grow it past the bands carve
                # with no debt record to reclaim the chip by.
                for b, debts in self._debts.items():
                    fixed = []
                    for lender, cs in debts:
                        if dev in cs:
                            cs = [c for c in cs if c != dev]
                            home = lender
                        fixed.append((lender, cs))
                    self._debts[b] = fixed
            self._quarantined[key] = dev
            self._quarantine_home[key] = home
        logger.error("placer: chip %s quarantined (home session %s, "
                     "%d rows shrank)", key, home, len(affected))
        if telemetry.enabled:
            telemetry.count("selkies_lifecycle_events_total",
                            event="quarantine")
            telemetry.event("device", chip=key, action="placer_quarantine",
                            sessions=affected)
        self._export_gauges()
        self.assert_consistent()
        return affected

    def readmit(self, chip) -> int | None:
        """A quarantined chip passed probation: restore it to its home
        session's row when that session still holds a live row (the
        caller re-carves it back up — and a later borrow can hand the
        chip out again), otherwise to the free pool, where it may
        promote a queued session. Returns the session it rejoined, or
        None."""
        key = chip if isinstance(chip, str) else chip_key(chip)
        promoted: list[int] = []
        home_out: int | None = None
        with self._lock:
            dev = self._quarantined.pop(key, None)
            if dev is None:
                return None
            home = self._quarantine_home.pop(key, None)
            if (home is not None and not self.shared
                    and home in self._rows):
                if self._rows[home]:
                    self._rows[home] = self._rows[home] + [dev]
                    home_out = home
                else:
                    # the home row is EMPTY: either its chips are lent
                    # out (this chip was quarantined off a live loan —
                    # rejoin the outstanding DEBT so the eventual
                    # return restores the lender's full carve, instead
                    # of silently shrinking it forever) or quarantine
                    # itself emptied the row (give the chip back).
                    borrower = next(
                        (b for b, debts in self._debts.items()
                         if any(l == home for l, _ in debts)), None)
                    if borrower is not None:
                        self._rows[borrower] = self._rows[borrower] + [dev]
                        self._debts[borrower] = [
                            ((l, cs + [dev]) if l == home else (l, cs))
                            for l, cs in self._debts[borrower]]
                        home_out = borrower
                    else:
                        self._rows[home] = [dev]
                        home_out = home
            else:
                self._free.append(dev)
                promoted = self._promote_locked()
        logger.warning("placer: chip %s readmitted (%s)", key,
                       f"session {home_out}" if home_out is not None
                       else "free pool")
        if telemetry.enabled:
            telemetry.count("selkies_lifecycle_events_total",
                            event="readmit")
            telemetry.event("device", chip=key, action="placer_readmit",
                            home=home_out)
        self._export_gauges()
        self.assert_consistent()
        for sid in promoted:
            if self.on_admitted is not None:
                try:
                    self.on_admitted(sid)
                except Exception:
                    logger.exception("on_admitted(%d) failed", sid)
        return home_out

    def is_quarantined(self, chip) -> bool:
        key = chip if isinstance(chip, str) else chip_key(chip)
        with self._lock:
            return key in self._quarantined

    def owns(self, chip) -> bool:
        key = chip if isinstance(chip, str) else chip_key(chip)
        return key in self._key_map

    def quarantined_keys(self) -> list[str]:
        with self._lock:
            return sorted(self._quarantined)

    # -- read side ------------------------------------------------------

    def row(self, session: int) -> list:
        with self._lock:
            return list(self._rows.get(session, ()))

    def set_codec(self, session: int, codec: str) -> None:
        """Record session's negotiated codec (the placement-side truth;
        serving rebuilds read it back through ``codec``)."""
        with self._lock:
            self._codecs[int(session)] = str(codec).lower() or "h264"
        self._export_gauges()

    def codec(self, session: int) -> str:
        with self._lock:
            return self._codecs.get(int(session), "h264")

    def codec_counts(self) -> dict[str, int]:
        """sessions-per-codec rollup (selkies_codec_sessions)."""
        with self._lock:
            out: dict[str, int] = {}
            for k in self._rows:
                c = self._codecs.get(k, "h264")
                out[c] = out.get(c, 0) + 1
            return out

    def borrowed_chips(self) -> int:
        with self._lock:
            return self._borrowed()

    def states(self) -> dict[str, str]:
        """Per-session placement state for /healthz: serving | busy |
        lent | queued."""
        with self._lock:
            out = {}
            for k, row in self._rows.items():
                out[str(k)] = ("lent" if not row
                               else ("busy" if k in self._busy else "serving"))
            for k in self._queue:
                out[str(k)] = "queued"
            return out

    def stats(self) -> dict:
        """/statz placement rollup: the live carve map, admission
        counters, queue depth, and the borrowed-chip count."""
        with self._lock:
            return {
                "chips": len(self.devices),
                "free": len(self._free) if not self.shared else 0,
                "quarantined": sorted(self._quarantined),
                "grid": (f"{self.grid[0]}x{self.grid[1]}"
                         if self.grid is not None else None),
                "shared": self.shared,
                "draining": self.draining,
                "borrowed": self._borrowed(),
                "queue": list(self._queue),
                "carve": {str(k): [str(getattr(d, "id", d)) for d in row]
                          for k, row in sorted(self._rows.items())},
                "codecs": {str(k): self._codecs.get(k, "h264")
                           for k in sorted(self._rows)},
                **self.counters,
            }

    def assert_consistent(self) -> None:
        """The no-over-commit / no-leak invariant: in a non-shared carve
        every device sits in exactly one place (free pool, one row, or
        quarantine)."""
        if self.shared:
            return
        with self._lock:
            seen: list = list(self._free)
            for row in self._rows.values():
                seen.extend(row)
            seen.extend(self._quarantined.values())
            if len(seen) != len(self.devices) or \
                    {id(d) for d in seen} != {id(d) for d in self.devices}:
                raise AssertionError(
                    f"placer carve inconsistent: {len(seen)} placed chips vs "
                    f"{len(self.devices)} owned ({self.stats()})")

    def _export_gauges(self) -> None:
        if not telemetry.enabled:
            return
        with self._lock:
            if self.shared:
                # shared small-slice carve: rows round-robin over the
                # same chips, so summing them would double-count — every
                # owned chip is in use and nothing is free or borrowable
                # (matching stats()/'/statz', which forces free=0)
                free, borrowed, quarantined = 0, 0, 0
                assigned = len(self.devices)
            else:
                free = len(self._free)
                borrowed = self._borrowed()
                assigned = sum(len(r) for r in self._rows.values()) - borrowed
                quarantined = len(self._quarantined)
        telemetry.gauge("selkies_placement_chips", free, state="free")
        telemetry.gauge("selkies_placement_chips", assigned, state="assigned")
        telemetry.gauge("selkies_placement_chips", borrowed, state="borrowed")
        telemetry.gauge("selkies_placement_chips", quarantined,
                        state="quarantined")
        # emit zeros for every codec that ever had a session too —
        # Prometheus gauges keep their last value, so dropping the series
        # when the last av1 session releases would freeze it at 1
        counts = self.codec_counts()
        with self._lock:
            self._codec_series.update(counts)
        for codec in self._codec_series:
            telemetry.gauge("selkies_codec_sessions", counts.get(codec, 0),
                            codec=codec)


# ---------------------------------------------------------------------------
# Live session migration: checkpoint / restore
# ---------------------------------------------------------------------------


@dataclass
class SessionCheckpoint:
    """The minimal state that makes a resumed stream seamless-after-one-
    IDR: GOP phase (``idr_pic_id`` parity keeps the recovery IDR's slice
    header byte-identical to an uninterrupted encoder's), rate-control,
    and the congestion estimate — all of which restore_session applies.
    ``tile_epoch`` and ``ltr`` are carried as informational context for
    the successor only: pixel state cannot cross a move, so the target's
    tile cache starts empty (no stale remap can ever match) and its LTR
    slots reset at the recovery IDR regardless. JSON-serializable so a
    hand-off can cross processes/hosts."""

    session: int
    codec: str = "h264"
    width: int = 0
    height: int = 0
    fps: float = 0.0
    qp: int = 28
    frames_since_idr: int = 0
    idr_pic_id: int = 0
    rc: dict = field(default_factory=dict)
    congestion: dict = field(default_factory=dict)
    tile_epoch: int = 0
    ltr: dict = field(default_factory=dict)
    wall_time: float = 0.0

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, blob: str) -> "SessionCheckpoint":
        data = json.loads(blob)
        known = inspect.signature(cls).parameters
        return cls(**{k: v for k, v in data.items() if k in known})


def _session_gop(service, session: int):
    """(qp, frames_since_idr, idr_pic_id, width, height, fps, obj) from
    either fleet service shape: TorchMultiSessionH264Service keeps per-session
    _SessionState, TorchBandedFleetService keeps whole per-session encoders."""
    if hasattr(service, "sessions"):  # TorchMultiSessionH264Service
        s = service.sessions[session]
        p = service.params
        return (int(s.qp), int(s.frames_since_idr), int(s.idr_pic_id),
                p.width, p.height, float(p.fps), s)
    if hasattr(service, "encoders"):  # TorchBandedFleetService
        e = service.encoders[session]
        return (int(getattr(e, "qp", 28)),
                int(getattr(e, "_frames_since_idr", 0)),
                int(getattr(e, "_idr_pic_id", 0)),
                int(getattr(e, "width", 0)), int(getattr(e, "height", 0)),
                float(getattr(e, "fps", 0.0)), e)
    # a bare encoder object (solo path)
    e = service
    return (int(getattr(e, "qp", 28)),
            int(getattr(e, "_frames_since_idr", 0)),
            int(getattr(e, "_idr_pic_id", 0)),
            int(getattr(e, "width", 0)), int(getattr(e, "height", 0)),
            float(getattr(e, "fps", 0.0)), e)


def checkpoint_session(service, session: int, *, slot=None) -> SessionCheckpoint:
    """Serialize session ``session``'s minimal encoder state off a live
    fleet service (or a bare encoder). ``slot`` (a fleet SessionSlot or
    anything with ``rc``/``gcc``) contributes rate-control and congestion
    state. The ``migrate`` fault site fires here — a kill-slot-mid-
    migration schedule raises before any state is read."""
    with tracer.span("migrate"):
        fi = get_injector()
        if fi is not None:
            fi.check(f"migrate:{session}")
        qp, fsi, ipi, w, h, fps, obj = _session_gop(service, session)
        ck = SessionCheckpoint(
            session=int(session), codec=getattr(obj, "codec", "h264"),
            width=w, height=h, fps=fps, qp=qp,
            frames_since_idr=fsi, idr_pic_id=ipi,
            tile_epoch=int(getattr(obj, "tile_epoch", 0)),
            wall_time=time.time(),
        )
        # LTR slot metadata: which long-term indices were assigned at
        # checkpoint time (informational — the target's slots reset at
        # the recovery IDR and repopulate from post-resume marks)
        slots = getattr(obj, "_ltr_slots", None)
        if slots:
            ck.ltr = {str(i): (s.get("tag", i) if isinstance(s, dict) else i)
                      for i, s in enumerate(slots) if s is not None}
        if slot is not None:
            rc = getattr(slot, "rc", None)
            if rc is not None:
                ck.rc = {"bitrate_kbps": int(rc.bitrate_kbps),
                         "fps": float(rc.fps), "qp": int(rc.qp),
                         "fullness": float(getattr(rc, "_fullness", 0.0))}
            gcc = getattr(slot, "gcc", None)
            if gcc is not None:
                ck.congestion = {"estimate_kbps": float(gcc.estimate_kbps),
                                 "max_kbps": int(gcc.max_kbps),
                                 "min_kbps": int(gcc.min_kbps)}
    if telemetry.enabled:
        telemetry.count("selkies_lifecycle_events_total", event="checkpoint")
        telemetry.event("migrate", session=str(ck.session),
                        action="checkpoint")
    return ck


def restore_session(ck: SessionCheckpoint, service, session: int | None = None,
                    *, slot=None) -> None:
    """Apply a checkpoint to another slot/service and force an IDR: the
    resumed stream opens with a recovery IDR whose ``idr_pic_id`` parity
    continues the original's, so from that IDR the bytes are identical
    to an uninterrupted encoder fed the same frames."""
    session = ck.session if session is None else int(session)
    with tracer.span("migrate"):
        fi = get_injector()
        if fi is not None:
            fi.check(f"migrate:{session}")
        if hasattr(service, "sessions"):
            s = service.sessions[session]
            s.qp = int(ck.qp)
            s.idr_pic_id = int(ck.idr_pic_id)
            s.frames_since_idr = int(ck.frames_since_idr)
            s.force_idr = True
        else:
            e = (service.encoders[session]
                 if hasattr(service, "encoders") else service)
            if hasattr(e, "set_qp"):
                e.set_qp(int(ck.qp))
            if hasattr(e, "_idr_pic_id"):
                e._idr_pic_id = int(ck.idr_pic_id)
            if hasattr(e, "_frames_since_idr"):
                e._frames_since_idr = int(ck.frames_since_idr)
            if hasattr(e, "force_keyframe"):
                e.force_keyframe()
        if slot is not None:
            rc = getattr(slot, "rc", None)
            if rc is not None and ck.rc:
                rc.set_bitrate(int(ck.rc.get("bitrate_kbps",
                                             rc.bitrate_kbps)))
                rc.set_framerate(float(ck.rc.get("fps", rc.fps)))
                rc.qp = int(ck.rc.get("qp", rc.qp))
                rc._fullness = float(ck.rc.get("fullness", 0.0))
            gcc = getattr(slot, "gcc", None)
            if gcc is not None and ck.congestion:
                est = float(ck.congestion.get("estimate_kbps",
                                              gcc.estimate_kbps))
                gcc.estimate_kbps = min(max(est, gcc.min_kbps), gcc.max_kbps)
    if telemetry.enabled:
        telemetry.count("selkies_lifecycle_events_total", event="restore")
        telemetry.event("migrate", session=str(session), action="restore")


# ---------------------------------------------------------------------------
# Graceful drain (the K8s preStop path)
# ---------------------------------------------------------------------------


class DrainController:
    """SERVING → DRAINING → DRAINED, under a deadline.

    ``drain()`` is idempotent and concurrency-safe: the first caller runs
    the sequence, later callers await the same completion. The sequence:
    stop admitting (placer.draining), force-IDR every session (each
    client holds a decodable recovery point), await ``flush()`` (bounded
    — in-flight encode groups land on the wire), run ``handoff()``
    (checkpoint sessions; the checkpoints are kept on
    ``self.checkpoints`` for the successor), then ``on_drained()`` (stop
    loops / the server so the entrypoint exits). /healthz reports 503
    the moment draining begins, so a load balancer stops routing new
    clients before the in-flight ones are flushed."""

    def __init__(self, name: str = "fleet", *, placer: SessionPlacer | None = None,
                 deadline_s: float | None = None, force_idr=None, flush=None,
                 handoff=None, on_drained=None, migrate=None):
        self.name = name
        self.placer = placer
        self.deadline_s = (drain_timeout_from_env()
                           if deadline_s is None else float(deadline_s))
        self._force_idr = force_idr
        self._flush = flush
        self._handoff = handoff
        self._on_drained = on_drained
        # migrate-off-then-stop (selkies_tpu/cluster): an async callable
        # run after the flush that live-migrates connected sessions to
        # cluster peers, returning the moved session ids; sessions it
        # can't place stay for the checkpoint hand-off. SIGTERM then
        # empties a host into the cluster instead of dropping sessions.
        self._migrate = migrate
        self.state = "serving"
        self.checkpoints: list[SessionCheckpoint] = []
        self.migrated: list[int] = []
        self.completed_in_deadline: bool | None = None
        self._done = asyncio.Event()
        telemetry.register_lifecycle(self)
        if telemetry.enabled:  # the documented 0=serving baseline sample
            telemetry.gauge("selkies_drain_state", 0)

    @property
    def draining(self) -> bool:
        return self.state != "serving"

    def health_view(self) -> dict:
        """Folded into telemetry.health() → /healthz (503 while
        draining): process drain state + per-slot placement state."""
        view = {"state": self.state, "deadline_s": self.deadline_s}
        if self.placer is not None:
            view["slots"] = self.placer.states()
        return view

    def begin(self) -> None:
        """Synchronous half (safe from a signal handler): stop admitting
        and flip /healthz to 503 immediately."""
        if self.state != "serving":
            return
        self.state = "draining"
        if self.placer is not None:
            self.placer.draining = True
        logger.warning("%s: drain started (deadline %.1fs)",
                       self.name, self.deadline_s)
        if telemetry.enabled:
            telemetry.count("selkies_lifecycle_events_total",
                            event="drain_begin")
            telemetry.event("drain", state="draining",
                            deadline_s=self.deadline_s)
            telemetry.gauge("selkies_drain_state", 1)

    async def drain(self) -> bool:
        """Run (or await) the drain. True when the whole sequence landed
        inside the deadline."""
        if self.state == "drained":
            return bool(self.completed_in_deadline)
        if self.state == "draining" and self._done.is_set() is False and \
                getattr(self, "_running", False):
            await self._done.wait()
            return bool(self.completed_in_deadline)
        self._running = True
        self.begin()
        t0 = time.monotonic()
        ok = True
        with tracer.span("drain"):
            fi = get_injector()
            if fi is not None:
                try:
                    act = fi.check("drain")
                except InjectedFault:
                    act = None
                    ok = False  # injected drain failure: still drain, report
                if act is not None and act[0] == "delay":
                    await asyncio.sleep(act[1] / 1000.0)
            if self._force_idr is not None:
                try:
                    self._force_idr()
                except Exception:
                    logger.exception("%s: drain force-IDR failed", self.name)
            if self._flush is not None:
                remaining = self.deadline_s - (time.monotonic() - t0)
                try:
                    await asyncio.wait_for(self._flush(),
                                           timeout=max(0.05, remaining))
                except asyncio.TimeoutError:
                    ok = False
                    logger.error("%s: drain flush missed the %.1fs deadline",
                                 self.name, self.deadline_s)
                except Exception:
                    ok = False
                    logger.exception("%s: drain flush failed", self.name)
            if self._migrate is not None:
                # migrate-off before the hand-off: every session a peer
                # accepts leaves with its client redirected; leftovers
                # (no cluster capacity, ship failures) still checkpoint
                remaining = self.deadline_s - (time.monotonic() - t0)
                try:
                    self.migrated = list(await asyncio.wait_for(
                        self._migrate(), timeout=max(0.05, remaining)) or [])
                except asyncio.TimeoutError:
                    ok = False
                    logger.error("%s: drain migrate-off missed the %.1fs "
                                 "deadline", self.name, self.deadline_s)
                except Exception:
                    ok = False
                    logger.exception("%s: drain migrate-off failed", self.name)
            if self._handoff is not None:
                try:
                    self.checkpoints = list(self._handoff() or [])
                except Exception:
                    ok = False
                    logger.exception("%s: drain handoff failed", self.name)
        elapsed = time.monotonic() - t0
        self.completed_in_deadline = ok and elapsed <= self.deadline_s
        self.state = "drained"
        if telemetry.enabled:
            telemetry.count(
                "selkies_lifecycle_events_total",
                event="drain_done" if self.completed_in_deadline
                else "drain_timeout")
            telemetry.event("drain", state="drained",
                            in_deadline=bool(self.completed_in_deadline),
                            elapsed_s=round(elapsed, 2),
                            checkpoints=len(self.checkpoints),
                            migrated=len(self.migrated))
            telemetry.gauge("selkies_drain_state", 2)
        logger.warning("%s: drain %s in %.2fs (%d checkpoints)", self.name,
                       "completed" if self.completed_in_deadline else
                       "finished PAST DEADLINE", elapsed, len(self.checkpoints))
        if self._on_drained is not None:
            try:
                result = self._on_drained()
                if asyncio.iscoroutine(result):
                    await result
            except Exception:
                logger.exception("%s: on_drained failed", self.name)
        self._done.set()
        return bool(self.completed_in_deadline)


def install_signal_handlers(drain, *, loop=None,
                            signals=(_signal.SIGTERM, _signal.SIGINT)):
    """Route SIGTERM/SIGINT through the drain path instead of abrupt
    cancellation: the first signal schedules ``drain()`` (a coroutine
    function) on the loop; a second signal falls back to the default
    disposition so a stuck drain can still be killed. Returns an
    uninstall callable."""
    loop = loop or asyncio.get_running_loop()
    fired = {"n": 0}

    def _on_signal(signame: str) -> None:
        fired["n"] += 1
        if fired["n"] > 1:
            logger.error("second %s during drain: restoring default "
                         "disposition", signame)
            _uninstall()
            return
        logger.warning("%s received: draining", signame)
        loop.create_task(drain())

    installed: list = []
    for sig in signals:
        try:
            loop.add_signal_handler(sig, _on_signal, sig.name)
            installed.append(sig)
        except (NotImplementedError, RuntimeError):
            logger.info("cannot install %s handler on this loop", sig.name)

    def _uninstall() -> None:
        for sig in installed:
            try:
                loop.remove_signal_handler(sig)
            except (NotImplementedError, RuntimeError):
                pass
        installed.clear()

    return _uninstall
