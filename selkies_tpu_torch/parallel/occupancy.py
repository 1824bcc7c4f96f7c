"""Per-session occupancy scheduling: overlap host work with device steps.

The port's copy of ``selkies_tpu/parallel/occupancy.py``. The serial
fleet tick runs every session's whole chain — host front end, device
step, fetch, pack — behind one barrier, so the card idles while the host
packs and the host idles while the card steps. This module runs the SAME
work as two explicit stages per session:

* **dispatch** — the host front end (static scan, BGRx->I420 conversion,
  the pinned upload) and the device step, enqueued: PyTorch returns
  before the card finishes, and each downlink copy is enqueued behind its
  step between two events (``device.Fetch``), so the moment session A's
  dispatch returns, A's step is on the card and the host is free.
* **complete** — the wait on those events (where the device wait lives),
  the host unpack and pack.

:class:`OccupancyScheduler.encode_tick` walks the units in order, running
dispatches back to back on the caller's thread while each dispatched
unit's completion runs on a completion worker. Every session issues its
work on the card's legacy default stream, in the order the dispatch lane
enqueues it; a completion waits on its own events only and makes no
synchronising call, so it never waits for the steps dispatched after it.
The native converters and packers release the GIL (ctypes), which is
where host work overlaps.

Byte contract: every session's AU stream is sha256-identical to its
serial tick, since ``dispatch + complete`` IS ``encode_frame`` split at
the device-handle seam and sessions share no state
(tests/test_torch_occupancy.py, and against JAX's scheduler).
``SELKIES_OCCUPANCY=0`` switches ``MixedTenancyService`` back to the
serial tick.

With tracing on (``monitoring/tracing.py``), each unit's dispatch on the
lane is a ``unit-dispatch`` span and the lane's wait on its completion a
``complete_wait`` span.

Units, not sessions, are what is scheduled: a :class:`SessionPipeline`
is one banded session, a :class:`BatchPipeline` a whole lockstep batch
service (its batched step is one device dispatch), and
:class:`MixedTenancyService` composes both behind the fleet service
interface so banded and batch sessions share one card's timeline.

Chaos: the ``sched:<k>`` fault site fires per session per tick at the
scheduling decision — ``drop`` skips the session's dispatch for that tick
(the frame is never encoded; later frames still deliver in order),
``delay:<ms>`` wedges the session's own completion (other sessions' lanes
keep flowing), ``raise`` fails the session; the scheduler finishes every
other session's stages before re-raising the first error, as the serial
tick fails.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.monitoring.tracing import tracer
from selkies_tpu_torch.resilience.faultinject import InjectedFault, get_injector

logger = logging.getLogger("selkies_tpu_torch.parallel.occupancy")

__all__ = ["occupancy_enabled", "SessionPipeline", "BatchPipeline",
           "OccupancyScheduler", "MixedTenancyService"]

ENV_VAR = "SELKIES_OCCUPANCY"


def occupancy_enabled() -> bool:
    """Overlapped scheduling is ON by default; ``SELKIES_OCCUPANCY=0``
    falls back to the serial lockstep tick (the byte oracle)."""
    return os.environ.get(ENV_VAR, "1").strip().lower() not in (
        "0", "false", "off", "no")


class SessionPipeline:
    """One session's capture→classify→upload→step→fetch→pack chain as an
    independently schedulable unit.

    Wraps a per-session-encoder service (``TorchBandedFleetService``
    shape: ``service.encoders[local]``), resolving the encoder LAZILY each
    stage — re-carves swap entries in that list live, and the unit must
    always drive the encoder that currently owns the session's row.
    Encoders with the dispatch/complete split (``dispatch_frame``) get
    true two-stage scheduling; an encoder without it runs its whole
    encode in the completion stage, the concurrency the serial tick's
    pool gave it.
    """

    def __init__(self, service, session: int, local: int | None = None):
        self.service = service
        self.session = session          # global slot index (frames row)
        self.local = session if local is None else local
        self.sessions = [session]

    def dispatch(self, frames: np.ndarray):
        enc = self.service.encoders[self.local]
        if enc is None:
            return None  # parked: chips lent away, no client
        frame = frames[self.session]
        if hasattr(enc, "dispatch_frame"):
            return ("split", enc, enc.dispatch_frame(frame))
        return ("thunk", enc, frame)

    def complete(self, token) -> list[bytes]:
        if token is None:
            return [b""]
        kind, enc, payload = token
        if kind == "split":
            return [enc.complete_frame(payload)]
        return [enc.encode_frame(payload)]

    def sync_bookkeeping(self) -> None:
        """Mirror the serial tick's per-session last_idrs/last_modes
        updates on the wrapped service (fleet framing + downlink
        attribution read these off the service, not the scheduler)."""
        svc, k = self.service, self.local
        enc = svc.encoders[k]
        stats = getattr(enc, "last_stats", None) if enc is not None else None
        svc.last_idrs[k] = bool(stats.idr) if stats is not None else False
        svc.last_modes[k] = (getattr(stats, "downlink_mode", "")
                             if stats is not None else "")


class BatchPipeline:
    """A lockstep batch group as ONE schedulable unit: its batched step
    is a single device dispatch covering every member session, so the
    group dispatches and completes together — but its host-side convert
    and pack now overlap OTHER units' device time on the shared card's
    timeline (the mixed-tenancy case)."""

    def __init__(self, service, sessions: list[int] | None = None):
        self.service = service          # TorchMultiSessionH264Service shape
        self.sessions = (list(range(service.n)) if sessions is None
                         else list(sessions))
        if len(self.sessions) != service.n:
            raise ValueError(
                f"batch unit covers {service.n} sessions, got "
                f"{len(self.sessions)} slot indices")

    def dispatch(self, frames: np.ndarray):
        if self.sessions == list(range(frames.shape[0])):
            sub = frames
        else:
            sub = frames[self.sessions]
        return self.service.dispatch_tick(sub)

    def complete(self, token) -> list[bytes]:
        return self.service.complete_tick(token)

    def sync_bookkeeping(self) -> None:
        pass  # complete_tick already maintains last_idrs on the service


class OccupancyScheduler:
    """Overlapped drop-in for ``service.encode_tick``: same frames in,
    byte-identical AUs out, with session A's host front-end/pack
    overlapping session B's device step via double-buffered dispatch
    across the placer's rows.

    The dispatch lane is the caller's thread — host front-ends run
    back-to-back in unit order (on a shared-core host, serializing them
    beats N threads thrashing one core), each one overlapping every
    previously dispatched unit's device step. Completions (fetch+pack)
    are handed to the completion pool the moment their dispatch
    returns, so they overlap later dispatches AND other device steps.
    Failure semantics match the serial tick: every healthy session's
    stages still run, then the first error re-raises so the fleet
    supervisor's ladder and device-failure classification see exactly
    what they see today.
    """

    def __init__(self, units: list, n: int):
        self.units = list(units)
        self.n = int(n)
        covered = sorted(s for u in self.units for s in u.sessions)
        if covered != list(range(self.n)):
            raise ValueError(f"units cover sessions {covered}, want 0..{n - 1}")
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, len(self.units)),
            thread_name_prefix="occ-complete")
        self._lock = threading.Lock()
        self.ticks = 0
        self.last_overlap = 0.0
        self.overlap_ewma = 0.0
        self.last_errors: dict[int, BaseException] = {}
        self._wait_ewma: dict[int, float] = {}

    @classmethod
    def for_service(cls, service) -> "OccupancyScheduler | None":
        """Build a scheduler over a fleet service, or None when the
        service has no schedulable shape: units per session for a
        ``TorchBandedFleetService`` (``encoders`` + ``recarve``), one
        batch unit for a ``TorchMultiSessionH264Service``
        (``dispatch_tick``), the composed units of a
        ``MixedTenancyService``."""
        if isinstance(service, MixedTenancyService):
            return cls(service.units(), service.n)
        if hasattr(service, "encoders") and hasattr(service, "recarve"):
            units = [SessionPipeline(service, k) for k in range(service.n)]
            return cls(units, service.n)
        if hasattr(service, "dispatch_tick"):
            return cls([BatchPipeline(service)], service.n)
        return None

    def encode_tick(self, frames: np.ndarray) -> list[bytes]:
        if frames.shape[0] != self.n:
            raise ValueError(f"expected {self.n} frames, got {frames.shape[0]}")
        fi = get_injector()
        t_tick = time.perf_counter()
        aus: list[bytes] = [b""] * self.n
        errors: dict[int, BaseException] = {}
        stage_s = [0.0] * len(self.units)   # per-unit dispatch+complete time
        waits: dict[int, float] = {}
        futures = []

        def _complete(idx: int, unit, token, delay_ms: float):
            t0 = time.perf_counter()
            if delay_ms > 0.0:
                # a sched delay wedges THIS session's completion lane;
                # every other unit's stages keep flowing around it
                time.sleep(delay_ms / 1e3)
            out = unit.complete(token)
            stage_s[idx] += time.perf_counter() - t0
            return out

        for idx, unit in enumerate(self.units):
            # sched_wait: how long the unit's dispatch sat behind earlier
            # units on the dispatch lane this tick
            wait_ms = (time.perf_counter() - t_tick) * 1e3
            for s in unit.sessions:
                waits[s] = wait_ms
            delay_ms = 0.0
            dropped = False
            if fi is not None:
                try:
                    for s in unit.sessions:
                        hit = fi.check(f"sched:{s}")
                        if hit is not None:
                            action, ms = hit
                            if action == "drop":
                                dropped = True
                            elif action == "delay":
                                delay_ms = max(delay_ms, ms)
                except InjectedFault as exc:
                    for s in unit.sessions:
                        errors.setdefault(s, exc)
                    continue
            if dropped:
                continue  # frame never dispatched; AU stays b""
            t0 = time.perf_counter()
            try:
                with tracer.span("unit-dispatch"):
                    token = unit.dispatch(frames)
            except Exception as exc:  # noqa: BLE001 — re-raised post-gather
                stage_s[idx] += time.perf_counter() - t0
                for s in unit.sessions:
                    errors.setdefault(s, exc)
                continue
            stage_s[idx] += time.perf_counter() - t0
            futures.append((idx, unit, self._pool.submit(
                _complete, idx, unit, token, delay_ms)))

        for idx, unit, fut in futures:
            try:
                with tracer.span("complete_wait"):
                    outs = fut.result()
            except Exception as exc:  # noqa: BLE001 — re-raised post-gather
                for s in unit.sessions:
                    errors.setdefault(s, exc)
                continue
            for s, au in zip(unit.sessions, outs):
                aus[s] = au
            unit.sync_bookkeeping()
        wall_s = time.perf_counter() - t_tick
        self._note_tick(wall_s, stage_s, waits, errors)
        if errors:
            # serial-parity failure semantics: the supervisor ladder and
            # the device-failure classification act on the tick error
            raise next(iter(errors.values()))
        return aus

    def _note_tick(self, wall_s: float, stage_s: list[float],
                   waits: dict[int, float],
                   errors: dict[int, BaseException]) -> None:
        serial_s = sum(stage_s)
        # fraction of the serialized stage time hidden by overlap: 0 on
        # a fully serial tick, approaching 1 - 1/N when N equal units
        # overlap perfectly
        overlap = max(0.0, 1.0 - wall_s / serial_s) if serial_s > 0 else 0.0
        with self._lock:
            self.ticks += 1
            self.last_overlap = overlap
            a = 0.1
            self.overlap_ewma = (overlap if self.ticks == 1
                                 else (1 - a) * self.overlap_ewma + a * overlap)
            for s, ms in waits.items():
                prev = self._wait_ewma.get(s)
                self._wait_ewma[s] = (ms if prev is None
                                      else (1 - a) * prev + a * ms)
            self.last_errors = dict(errors)
        if telemetry.enabled:
            telemetry.gauge("selkies_occupancy_overlap_ratio", overlap)
            for s, ms in waits.items():
                telemetry.stage_ms("sched_wait", ms, session=str(s))

    def stats(self) -> dict:
        """/statz rollup (fleet registers this under ``occupancy``)."""
        with self._lock:
            return {
                "enabled": True,
                "units": len(self.units),
                "sessions": self.n,
                "ticks": self.ticks,
                "overlap_ratio": round(self.overlap_ewma, 4),
                "last_overlap": round(self.last_overlap, 4),
                "sched_wait_ms": {str(s): round(ms, 3)
                                  for s, ms in sorted(self._wait_ewma.items())},
                "errors": {str(s): repr(e)
                           for s, e in sorted(self.last_errors.items())},
            }

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class MixedTenancyService:
    """Banded and batch sessions sharing one card's timeline, behind the
    fleet service interface (encode_tick / set_qp / force_keyframe /
    last_idrs / last_modes / close).

    Slots ``[0, batch.n)`` ride the lockstep batch service (one batched
    step over every batch session); slots ``[batch.n, n)`` ride the
    banded per-session service, whose rows sit on the SAME card. Under
    the occupancy scheduler the batch group's host convert/pack overlaps
    the banded sessions' device steps and vice versa — the card's
    timeline interleaves both tenancies instead of the fleet forcing a
    same-geometry carve.
    Serial fallback (``SELKIES_OCCUPANCY=0``) runs batch then banded
    sequentially: the byte oracle, since sessions are independent.
    """

    def __init__(self, batch_service, banded_service):
        self.batch = batch_service
        self.banded = banded_service
        self.n = batch_service.n + banded_service.n
        self._sched: OccupancyScheduler | None = None

    def units(self) -> list:
        units: list = [BatchPipeline(self.batch,
                                     list(range(self.batch.n)))]
        units.extend(SessionPipeline(self.banded, self.batch.n + j, j)
                     for j in range(self.banded.n))
        return units

    def _route(self, session: int):
        if session < self.batch.n:
            return self.batch, session
        return self.banded, session - self.batch.n

    def set_qp(self, session: int, qp: int) -> None:
        svc, k = self._route(session)
        svc.set_qp(k, qp)

    def force_keyframe(self, session: int) -> None:
        svc, k = self._route(session)
        svc.force_keyframe(k)

    @property
    def last_idrs(self) -> list[bool]:
        return list(self.batch.last_idrs) + list(self.banded.last_idrs)

    @property
    def last_modes(self) -> list[str]:
        return list(self.batch.last_modes) + list(self.banded.last_modes)

    def encode_tick(self, frames: np.ndarray) -> list[bytes]:
        if frames.shape[0] != self.n:
            raise ValueError(f"expected {self.n} frames, got {frames.shape[0]}")
        if occupancy_enabled():
            if self._sched is None:
                self._sched = OccupancyScheduler(self.units(), self.n)
            return self._sched.encode_tick(frames)
        aus = list(self.batch.encode_tick(frames[:self.batch.n]))
        for j in range(self.banded.n):
            enc = self.banded.encoders[j]
            aus.append(enc.encode_frame(frames[self.batch.n + j])
                       if enc is not None else b"")
        for j in range(self.banded.n):
            SessionPipeline(self.banded, self.batch.n + j, j).sync_bookkeeping()
        return aus

    def scheduler(self) -> OccupancyScheduler | None:
        return self._sched

    def close(self) -> None:
        if self._sched is not None:
            self._sched.close()
        self.batch.close()
        self.banded.close()
