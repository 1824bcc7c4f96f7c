"""Per-slot supervisor: a tick-deadline watchdog driving a recovery ladder.

The port's copy of ``selkies_tpu/resilience/supervisor.py``, on the port's
telemetry bus.

Serving loops report two events per slot — ``tick_ok()`` when a frame was
encoded and handed to the transport, ``failure(exc)`` when the tick threw —
and periodically call ``check_deadline()`` so a *silent* stall (a wedged
device call that neither returns nor raises) also counts against the slot.
The supervisor turns the failure streak into ladder actions:

    rung 1 WARN       log loudly (first failure is often transient)
    rung 2 FORCE_IDR  next delivered frame restarts the decode chain
    rung 3 RESTART    rebuild the slot's encoder, capped exponential backoff
    rung 4 DEGRADE    shed load: halve fps → step resolution down → fall
                      back to the software x264 row (models/x264enc.py)
    rung 5 RECYCLE    tear the session down and re-arm for a fresh client

Sustained health walks the ladder back down: after ``recover_after``
consecutive healthy ticks one degradation level is reversed, so a slot that
rode out a transient device fault returns to full fps/resolution/device
encode instead of serving degraded forever.

Everything is injectable (clock, thresholds, actions) so the ladder is
unit-testable with a fake clock (tests/test_resilience.py).
"""

from __future__ import annotations

import enum
import logging
import time
from typing import Callable, Protocol

from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("resilience.supervisor")

__all__ = ["Rung", "Backoff", "RecoveryActions", "SlotSupervisor"]


class Rung(enum.IntEnum):
    HEALTHY = 0
    WARN = 1
    FORCE_IDR = 2
    RESTART = 3
    DEGRADE = 4
    RECYCLE = 5


class Backoff:
    """Capped exponential backoff with optional deterministic jitter.

    ``jitter`` is a fraction of the computed delay; the jitter source is an
    injectable callable returning [0, 1) so tests stay deterministic.
    """

    def __init__(self, base: float = 0.5, cap: float = 8.0, *,
                 jitter: float = 0.0,
                 rand: Callable[[], float] | None = None):
        if base <= 0 or cap < base:
            raise ValueError(f"bad backoff window base={base} cap={cap}")
        self.base = float(base)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self._rand = rand
        self.attempts = 0

    def next_delay(self) -> float:
        # exponent clamped: attempts grows unboundedly on a persistently
        # failing slot, and 2.0**1024 raises OverflowError — inside the
        # very loops that must never die
        delay = min(self.cap, self.base * (2.0 ** min(self.attempts, 63)))
        self.attempts += 1
        if self.jitter and self._rand is not None:
            delay += delay * self.jitter * self._rand()
        return delay

    def reset(self) -> None:
        self.attempts = 0


class RecoveryActions(Protocol):
    """What a serving context knows how to do at each rung. Implementations
    live next to the loop they repair (pipeline/app.py, parallel/fleet.py);
    all callbacks are synchronous and must not block the event loop."""

    def warn(self, msg: str) -> None: ...

    def force_idr(self) -> None: ...

    def restart_encoder(self) -> None: ...

    def degrade(self, level: int) -> None:
        """Apply degradation ``level`` (1=halve fps, 2=resolution step down,
        3=software x264 fallback). Levels are cumulative."""
        ...

    def undegrade(self, level: int) -> None:
        """Reverse degradation back TO ``level`` (0 = fully restored)."""
        ...

    def recycle(self) -> None: ...


class SlotSupervisor:
    """Escalation ladder for one serving slot.

    Thresholds are consecutive-failure counts; a healthy tick resets the
    streak but NOT the applied degradation — that only reverses after
    ``recover_after`` consecutive healthy ticks (one level at a time).
    """

    MAX_DEGRADE_LEVEL = 3

    def __init__(self, name: str, actions: RecoveryActions, *,
                 fps: float = 60.0,
                 warn_after: int = 1,
                 idr_after: int = 2,
                 restart_after: int = 6,
                 degrade_after: int = 12,
                 degrade_every: int = 6,
                 recycle_after: int = 30,
                 deadline_ticks: float = 600.0,
                 arm_after: int = 3,
                 recover_after: int = 300,
                 backoff: Backoff | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if not (warn_after <= idr_after <= restart_after
                <= degrade_after <= recycle_after):
            raise ValueError("ladder thresholds must be non-decreasing")
        self.name = name
        self.actions = actions
        self.fps = float(fps)
        self.warn_after = warn_after
        self.idr_after = idr_after
        self.restart_after = restart_after
        self.degrade_after = degrade_after
        self.degrade_every = max(1, degrade_every)
        self.recycle_after = recycle_after
        self.deadline_ticks = float(deadline_ticks)
        self.arm_after = arm_after
        self.recover_after = recover_after
        self.backoff = backoff or Backoff()
        self.clock = clock

        self.rung = Rung.HEALTHY
        self.failures = 0          # consecutive
        self.healthy_streak = 0
        self.degrade_level = 0
        self.last_ok = self.clock()
        self.counters: dict[str, int] = {
            "failures": 0, "deadline_misses": 0, "idrs_forced": 0,
            "restarts": 0, "degrades": 0, "undegrades": 0, "recycles": 0,
            "slo_warns": 0,
        }
        # sessions currently holding the slot on the WARN rung for an
        # SLO breach (monitoring/slo.py) — refcounted by session key so
        # one fleet slot's recovery can't clear another's breach
        self._slo_pressure: set[str] = set()
        self._next_restart_at = 0.0
        self._total_ok = 0  # lifetime, arms the deadline watchdog
        # escalation hook (telemetry/black-box wiring): called with
        # (rung, reason) whenever failure() applies an action PAST warn;
        # the default path also asks the telemetry bus to dump the
        # slot's flight-recorder ring (monitoring/flightrecorder.py)
        self.on_escalation: Callable[[Rung, str], None] | None = None
        telemetry.register_slot(name, self)  # /healthz visibility

    def _emit(self, event: str) -> None:
        """Fold a ladder event into the telemetry counters (one attribute
        read when telemetry is off)."""
        if telemetry.enabled:
            telemetry.count("selkies_supervisor_events_total",
                            slot=self.name, event=event)
            telemetry.gauge("selkies_supervisor_rung", int(self.rung),
                            slot=self.name)

    # -- events --------------------------------------------------------

    def tick_ok(self) -> None:
        now = self.clock()
        self.last_ok = now
        self.failures = 0
        self.healthy_streak += 1
        self._total_ok += 1
        if self.rung != Rung.HEALTHY and self.degrade_level == 0:
            # push the rung gauge back down: alerts on an escalated rung
            # must clear when the slot recovers, not on the next failure.
            # An SLO breach holds WARN — and only WARN — sticky across
            # healthy ticks (the loop is fine, the objective isn't; only
            # slo_clear() releases it): a transient failure's higher
            # rung still steps down to the held WARN on recovery
            if self._slo_pressure:
                if self.rung > Rung.WARN:
                    self.rung = Rung.WARN
                    self._emit("recovered")
            else:
                self.rung = Rung.HEALTHY
                self._emit("recovered")
        if self.healthy_streak >= self.recover_after:
            self.healthy_streak = 0
            self.backoff.reset()
            if self.degrade_level > 0:
                self.degrade_level -= 1
                self.counters["undegrades"] += 1
                self._apply("undegrade",
                            lambda: self.actions.undegrade(self.degrade_level))
                logger.info("%s: sustained health; degradation reversed to "
                            "level %d", self.name, self.degrade_level)
                if self.degrade_level == 0:
                    self.rung = Rung.HEALTHY
                self._emit("undegrade")

    def failure(self, exc: BaseException | None = None,
                reason: str = "tick") -> Rung:
        """Record one failed tick; apply whatever the streak now warrants.
        Returns the rung the slot sits on after escalation."""
        now = self.clock()
        self.failures += 1
        self.healthy_streak = 0
        self.counters["failures"] += 1
        n = self.failures
        escalations: list[str] = []  # actions applied past WARN this call
        if n == self.warn_after:
            self.rung = max(self.rung, Rung.WARN)
            self._apply("warn", lambda: self.actions.warn(
                f"{self.name}: {reason} failure #{n}: {exc!r}"))
            self._emit("warn")
        if n == self.idr_after:
            self.rung = max(self.rung, Rung.FORCE_IDR)
            self.counters["idrs_forced"] += 1
            self._apply("force_idr", self.actions.force_idr)
            self._emit("force_idr")
            escalations.append("force_idr")
        if n >= self.restart_after and now >= self._next_restart_at:
            self.rung = max(self.rung, Rung.RESTART)
            self._next_restart_at = now + self.backoff.next_delay()
            self.counters["restarts"] += 1
            logger.warning("%s: restarting encoder (failure #%d, next "
                           "restart gated until +%.2fs)", self.name, n,
                           self._next_restart_at - now)
            self._apply("restart_encoder", self.actions.restart_encoder)
            self._emit("restart")
            escalations.append("restart")
        if (n >= self.degrade_after
                and self.degrade_level < self.MAX_DEGRADE_LEVEL
                and (n - self.degrade_after) % self.degrade_every == 0):
            self.rung = max(self.rung, Rung.DEGRADE)
            self.degrade_level += 1
            self.counters["degrades"] += 1
            logger.warning("%s: degrading to level %d (failure #%d)",
                           self.name, self.degrade_level, n)
            self._apply("degrade",
                        lambda: self.actions.degrade(self.degrade_level))
            self._emit("degrade")
            escalations.append("degrade")
        if n >= self.recycle_after:
            self.rung = Rung.RECYCLE
            self.counters["recycles"] += 1
            logger.error("%s: recycling session after %d consecutive "
                         "failures", self.name, n)
            self._apply("recycle", self.actions.recycle)
            self._emit("recycle")
            escalations.append("recycle")
            # a recycled session starts a fresh ladder climb, but the
            # restart gate keeps its backoff so a crash-looping slot
            # cannot hot-loop encoder rebuilds
            self.failures = 0
        if escalations:
            # black-box hook: anything past WARN is evidence worth
            # keeping — dump the flight recorder (rate-limited per slot)
            # and notify any custom hook; neither may kill the loop
            why = (f"{reason}: {'+'.join(escalations)} at failure #{n} "
                   f"({exc!r})")
            if self.on_escalation is not None:
                self._apply("on_escalation",
                            lambda: self.on_escalation(self.rung, why))
            telemetry.escalation(self.name, why)
        return self.rung

    def slo_warn(self, reason: str, key: str = "slo") -> None:
        """SLO-plane breach (monitoring/slo.py): put the slot on the
        WARN rung WITHOUT counting a tick failure — the serving loop is
        healthy, the latency/fps/byte objective isn't, and escalating
        past WARN (forced IDRs, encoder restarts) would make the
        latency worse, not better. Sticky until :meth:`slo_clear` for
        the same ``key`` (fleet mode refcounts one supervisor across
        many sessions' SLOs)."""
        self._slo_pressure.add(key)
        self.counters["slo_warns"] += 1
        self.rung = max(self.rung, Rung.WARN)
        self._apply("warn", lambda: self.actions.warn(
            f"{self.name}: {reason}"))
        self._emit("warn")

    def slo_clear(self, key: str = "slo") -> None:
        """The keyed SLO breach recovered; releases the sticky WARN once
        every key has cleared (and nothing else holds the rung up)."""
        self._slo_pressure.discard(key)
        if self._slo_pressure:
            return
        if (self.rung == Rung.WARN and self.failures == 0
                and self.degrade_level == 0):
            self.rung = Rung.HEALTHY
            self._emit("recovered")

    def note_idle(self) -> None:
        """No work expected (no connected client): keep the deadline clock
        from counting idle time as a stall."""
        self.last_ok = self.clock()

    def check_deadline(self, now: float | None = None) -> bool:
        """Watchdog: no healthy tick for ``deadline_ticks`` tick intervals
        counts as a failure even though nothing raised (wedged device call,
        stalled capture thread). Fires at most once per deadline window.
        Armed only after ``arm_after`` lifetime healthy ticks so first-use
        jit compiles (tens of seconds on the CPU mesh) don't trip it."""
        now = self.clock() if now is None else now
        if self._total_ok < self.arm_after:
            return False
        if now - self.last_ok <= self.deadline_ticks / self.fps:
            return False
        self.counters["deadline_misses"] += 1
        self._emit("deadline_miss")
        self.last_ok = now  # re-arm: one escalation per missed window
        self.failure(None, reason="tick deadline")
        return True

    # -- helpers -------------------------------------------------------

    def _apply(self, what: str, fn: Callable[[], None]) -> None:
        """A broken recovery action must not take down the serving loop —
        the ladder's whole point is that the loop survives; log and keep
        climbing instead."""
        try:
            fn()
        except Exception:
            logger.exception("%s: recovery action %r failed", self.name, what)

    def stats(self) -> dict[str, int | str]:
        return {"rung": self.rung.name, "degrade_level": self.degrade_level,
                "slo_pressure": sorted(self._slo_pressure),
                **self.counters}
