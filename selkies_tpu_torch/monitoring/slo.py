"""Per-session serving SLOs: objectives, multi-window burn rates, hooks.

The port's copy of ``selkies_tpu/monitoring/slo.py``, on the port's
telemetry bus and flight recorder.

PERF.md's scenario rounds made p50 frame latency the product-defining
number, but until now nothing in the serving stack *stated* an
objective — every regression was rediscovered by the next bench round.
This module is the missing SLO plane, built on the telemetry bus:

**Objectives** (:class:`SLOTargets`) are per-session and scenario-
scoped: frame p50/p95 latency ceilings, an fps floor, and a downlink
byte budget. Defaults per scenario class live next to the knob matrices
in ``policy/presets.py`` (``SLO_TARGETS``) — an idle desktop and a
full-motion game are different products and carry different promises.
When the scenario policy engine is armed its transitions
retarget the live objectives (``PolicyEngine.on_scenario``); without it
a session is judged by the ``unknown`` row.

**Burn-rate evaluation** (:class:`SessionSLO`) follows the SRE
multi-window pattern: every encoded frame lands in a per-second bin
(latency-objective violations, frame count, bytes), and two rolling
windows read the bins — a **fast** window (default 60 s) that catches
an acute regression within a minute, and a **slow** window (default
30 min) that tracks chronic budget burn. The burn rate of an objective
is ``observed badness / allowed badness`` (a p95 objective allows 5 %
of frames over the ceiling, so 15 % bad burns at 3x; the fps and bytes
objectives burn as ``floor/measured`` and ``measured/budget``). A
session is **breached** (acute) while the fast window burns at or above
its threshold; it is **chronic** while the slow window does. Acute
breaches drive actuation, chronic breaches are the autoscaling /
capacity signal (ROADMAP item 4) — a 28-minute-old sin keeps the slow
burn elevated by design, which is exactly why relief is judged on the
fast window only.

**Hooks.** On an acute breach entering, ``on_pressure`` fires — the
solo app wires it to the same byte-shedding downscale the policy
congestion overlay uses (pressure BEFORE fps-halving), the fleet sheds
the slot's bitrate target — and the slot's supervisor is put on the
WARN rung (``SlotSupervisor.slo_warn``: sticky, not a tick failure).
When every objective has recovered for ``recovery_evals`` consecutive
evaluations, ``on_relief`` fires and the WARN clears.

**Outlier capture.** Independent of the windows, every observed frame
feeds a rolling-quantile :class:`~selkies_tpu_torch.monitoring.flightrecorder
.OutlierTrigger`; a p99-outlier frame dumps a rate-limited black-box
bundle tagged with that frame's correlation id — post-mortem evidence
for tail latency even when no supervisor escalation ever happens
(before this, the flight recorder only saw sessions that already
failed).

Everything is off by default: ``SELKIES_SLO=1`` opts in, and the app /
fleet wiring then also enables the telemetry bus (the SLO plane *is* a
telemetry consumer — burn gauges, ring events and outlier bundles all
ride it). Observation never touches the data plane; encoded bytes are
byte-identical either way.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from selkies_tpu_torch.monitoring.flightrecorder import OutlierTrigger
from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("slo")

__all__ = ["SLOTargets", "SessionSLO", "OBJECTIVES", "slo_enabled",
           "scenario_targets", "ENV_VAR"]

ENV_VAR = "SELKIES_SLO"

# objective vocabulary (the `objective` label of the selkies_slo_*
# families); each burns against its own allowance. "quality" is the
# optional min-PSNR floor fed by the sampled decode-and-compare probe
# (monitoring/quality.py) — unbudgeted (never burns) unless the
# scenario's SLOTargets sets psnr_floor_db > 0 AND a probe is wired.
OBJECTIVES = ("latency_p50", "latency_p95", "fps", "downlink", "quality")

# default burn-rate thresholds per objective: (fast-window, slow-window).
# Half the frames over a p50 ceiling is burn 1.0 — the SLO exactly
# spent. The p50 burn SATURATES at 2.0 (every frame bad), so its acute
# threshold sits at 1.5 (75% of the last minute's frames over the
# ceiling) — a threshold of 2.0 would only ever fire at exactly-100%-
# bad, where one good frame per window suppresses it forever. p95's
# burn ranges to 20, so 2.0 (10% bad) is meaningful there; fps and
# bytes are absolute-rate objectives where burn 1.0 already means
# "below floor" / "over budget", so their fast thresholds sit at the
# line.
DEFAULT_BURN: dict[str, tuple[float, float]] = {
    "latency_p50": (1.5, 1.0),
    "latency_p95": (2.0, 1.0),
    "fps": (1.0, 1.0),
    "downlink": (1.25, 1.0),
    # quality allows 5% of SAMPLES below the PSNR floor (the p95
    # shape: burn = bad_fraction / 0.05, range 0..20) — one soft
    # frame per ~100 s at the default sampling rate is budget, a
    # sustained slump is a breach
    "quality": (2.0, 1.0),
}


@dataclass(frozen=True)
class SLOTargets:
    """One scenario class's objectives. ``down_kbps=0`` leaves the
    downlink unbudgeted (the objective never burns); ``psnr_floor_db=0``
    likewise leaves the quality objective unbudgeted — it only arms
    when a scenario states a floor AND the SELKIES_QUALITY probe is
    feeding samples (docs/quality.md)."""

    p50_ms: float = 250.0
    p95_ms: float = 600.0
    fps_floor: float = 10.0
    down_kbps: float = 0.0
    psnr_floor_db: float = 0.0


def slo_enabled() -> bool:
    """``SELKIES_SLO=1`` opts in; unset/0 means no SLO object is ever
    constructed (byte-identical to a pre-SLO build by construction)."""
    return os.environ.get(ENV_VAR, "0").strip().lower() in (
        "1", "true", "on", "yes")


def scenario_targets() -> dict[str, SLOTargets]:
    """The per-scenario default objectives (policy/presets.SLO_TARGETS),
    keyed by scenario value string. Imported lazily — the policy package
    pulls in the whole actuation surface."""
    from selkies_tpu_torch.policy.presets import SLO_TARGETS

    return {s.value: t for s, t in SLO_TARGETS.items()}


class _ObjectiveState:
    __slots__ = ("breached", "chronic", "ok_evals", "fast_burn", "slow_burn")

    def __init__(self):
        self.breached = False   # acute: fast window at/over threshold
        self.chronic = False    # slow window at/over threshold
        self.ok_evals = 0
        self.fast_burn = 0.0
        self.slow_burn = 0.0


class SessionSLO:
    """One session's objectives, windows, and breach state machine.

    Single-threaded by contract: ``observe_frame``/``evaluate`` run on
    the serving loop that owns the session (solo video loop / fleet
    tick), like the policy engine.
    """

    def __init__(self, session: str = "0", *,
                 targets: dict[str, SLOTargets] | None = None,
                 scenario: str = "unknown",
                 fast_s: float = 60.0, slow_s: float = 1800.0,
                 burn_thresholds: dict[str, tuple[float, float]] | None = None,
                 recovery_evals: int = 3,
                 eval_interval_s: float = 1.0,
                 min_frames: int = 16,
                 min_quality_samples: int = 4,
                 supervisor=None,
                 outlier: OutlierTrigger | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.session = str(session)
        self._targets_map = targets  # None -> lazy scenario_targets()
        self.scenario = scenario
        self.targets = self._resolve_targets(scenario)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.burn = dict(DEFAULT_BURN)
        if burn_thresholds:
            self.burn.update(burn_thresholds)
        self.recovery_evals = max(1, int(recovery_evals))
        self.eval_interval_s = float(eval_interval_s)
        # windows shorter than min_frames of traffic don't judge: a
        # session's first seconds (cold compiles, no client) are not an
        # SLO violation, and an fps floor over an empty window is noise
        self.min_frames = int(min_frames)
        # the quality probe samples sparsely (one frame in ~300), so the
        # quality objective has its own, much smaller traffic gate
        self.min_quality_samples = max(1, int(min_quality_samples))
        self.supervisor = supervisor
        self.outlier = outlier if outlier is not None else OutlierTrigger()
        self.clock = clock
        # per-second bins: [sec:int, frames, bad_p50, bad_p95, bytes]
        self._bins: deque[list] = deque()
        # quality sample bins: [sec:int, samples, below_floor]
        self._qbins: deque[list] = deque()
        self.quality_samples = 0
        self._state = {obj: _ObjectiveState() for obj in OBJECTIVES}
        self._last_eval = -1e18
        self.frames = 0
        self.breaches = 0       # acute entries, lifetime
        self.outliers = 0
        self.evaluations = 0
        # hooks (wired by the app/fleet): fired on the AGGREGATE edge —
        # pressure when the first objective goes acute, relief when the
        # last one recovers. Both must be idempotent and cheap.
        self.on_pressure: Callable[[], None] | None = None
        self.on_relief: Callable[[], None] | None = None

    # -- targets --------------------------------------------------------

    def _resolve_targets(self, scenario: str) -> SLOTargets:
        m = self._targets_map
        if m is None:
            try:
                m = self._targets_map = scenario_targets()
            except Exception:  # policy package unavailable: flat default
                logger.exception("scenario SLO targets unavailable")
                m = self._targets_map = {"unknown": SLOTargets()}
        return m.get(scenario) or m.get("unknown") or SLOTargets()

    def set_scenario(self, scenario: str) -> None:
        """Retarget the objectives (PolicyEngine.on_scenario). Applies
        to frames observed from now on — bins store judgments, not
        latencies, so a retarget never rewrites history."""
        scenario = str(scenario)
        if scenario == self.scenario:
            return
        self.scenario = scenario
        self.targets = self._resolve_targets(scenario)
        telemetry.event("slo_retarget", session=self.session,
                        scenario=scenario)

    # -- intake ---------------------------------------------------------

    def observe_frame(self, latency_ms: float, nbytes: int, *,
                      fid: int = 0, now: float | None = None) -> None:
        """One delivered frame: bin its objective judgments and feed the
        outlier trigger. ``latency_ms`` is capture-begin -> access-unit
        -ready (the solo pipeline's per-frame ledger; the fleet uses the
        lockstep tick's wall time)."""
        now = self.clock() if now is None else now
        t = self.targets
        sec = int(now)
        bins = self._bins
        if bins and bins[-1][0] == sec:
            b = bins[-1]
            b[1] += 1
            b[2] += latency_ms > t.p50_ms
            b[3] += latency_ms > t.p95_ms
            b[4] += nbytes
        else:
            bins.append([sec, 1, int(latency_ms > t.p50_ms),
                         int(latency_ms > t.p95_ms), nbytes])
        cutoff = sec - int(self.slow_s) - 1
        while bins and bins[0][0] < cutoff:
            bins.popleft()
        self.frames += 1
        if self.outlier.observe(latency_ms):
            self.outliers += 1
            p99 = self.outlier.quantile_ms()
            logger.warning(
                "session %s latency outlier: frame %d took %.0f ms "
                "(rolling p99 %.0f ms)", self.session, fid, latency_ms, p99)
            if telemetry.enabled:
                telemetry.count("selkies_slo_outliers_total",
                                session=self.session)
                telemetry.outlier_dump(
                    self.session,
                    f"latency outlier: {latency_ms:.0f} ms vs rolling "
                    f"p99 {p99:.0f} ms",
                    extra_meta={"frame_id": fid,
                                "latency_ms": round(latency_ms, 1),
                                "rolling_p99_ms": round(p99, 1)})

    def observe_quality(self, psnr_db: float,
                        now: float | None = None) -> None:
        """One scored quality sample from the decode-and-compare probe
        (monitoring/quality.QualityProbe, thread-safe append shape:
        the probe's background worker calls this). Judged against the
        scenario's ``psnr_floor_db`` AT OBSERVATION TIME, like the
        latency bins — a retarget never rewrites history."""
        now = self.clock() if now is None else now
        floor = self.targets.psnr_floor_db
        bad = int(floor > 0 and psnr_db < floor)
        sec = int(now)
        bins = self._qbins
        if bins and bins[-1][0] == sec:
            bins[-1][1] += 1
            bins[-1][2] += bad
        else:
            bins.append([sec, 1, bad])
        cutoff = sec - int(self.slow_s) - 1
        while bins and bins[0][0] < cutoff:
            bins.popleft()
        self.quality_samples += 1

    # -- burn computation ------------------------------------------------

    def _window(self, now: float, span_s: float) -> tuple[int, int, int, int, float]:
        """(frames, bad50, bad95, bytes, observed_span_s) over the last
        ``span_s`` seconds."""
        cutoff = now - span_s
        frames = bad50 = bad95 = nbytes = 0
        first = None
        for sec, n, b50, b95, by in reversed(self._bins):
            if sec < cutoff:
                break
            frames += n
            bad50 += b50
            bad95 += b95
            nbytes += by
            first = sec
        span = min(span_s, max(1.0, now - first)) if first is not None else 0.0
        return frames, bad50, bad95, nbytes, span

    def _quality_window(self, now: float, span_s: float) -> tuple[int, int]:
        """(samples, below_floor) over the last ``span_s`` seconds."""
        cutoff = now - span_s
        samples = bad = 0
        for sec, n, b in reversed(self._qbins):
            if sec < cutoff:
                break
            samples += n
            bad += b
        return samples, bad

    def _burns(self, now: float, span_s: float) -> dict[str, float]:
        frames, bad50, bad95, nbytes, span = self._window(now, span_s)
        t = self.targets
        out = dict.fromkeys(OBJECTIVES, 0.0)
        # the quality objective gates on ITS OWN sparse sample count,
        # not the frame gate — a probe at 1-in-300 sampling would never
        # clear min_frames
        if t.psnr_floor_db > 0:
            qs, qbad = self._quality_window(now, span_s)
            if qs >= self.min_quality_samples:
                out["quality"] = (qbad / qs) / 0.05
        if frames < self.min_frames or span <= 0:
            return out
        out["latency_p50"] = (bad50 / frames) / 0.50
        out["latency_p95"] = (bad95 / frames) / 0.05
        measured_fps = frames / span
        if t.fps_floor > 0 and measured_fps > 0:
            out["fps"] = t.fps_floor / measured_fps
        if t.down_kbps > 0:
            out["downlink"] = (nbytes / span) / (t.down_kbps * 125.0)
        return out

    # -- evaluation ------------------------------------------------------

    def evaluate(self, now: float | None = None) -> dict[str, float] | None:
        """One burn-rate evaluation pass; internally time-gated to
        ``eval_interval_s``. Returns the fast-window burns when a pass
        ran, None when gated. Never raises out (the serving loop calls
        this inline)."""
        now = self.clock() if now is None else now
        if now - self._last_eval < self.eval_interval_s:
            return None
        self._last_eval = now
        try:
            return self._evaluate(now)
        except Exception:
            logger.exception("SLO evaluation failed on session %s",
                             self.session)
            return None

    def _evaluate(self, now: float) -> dict[str, float]:
        fast = self._burns(now, self.fast_s)
        slow = self._burns(now, self.slow_s)
        self.evaluations += 1
        was_breached = self._any_breached()
        for obj in OBJECTIVES:
            st = self._state[obj]
            f_thr, s_thr = self.burn[obj]
            st.fast_burn, st.slow_burn = fast[obj], slow[obj]
            if slow[obj] >= s_thr:
                if not st.chronic:
                    st.chronic = True
                    self._count_breach(obj, "slow")
            else:
                st.chronic = False
            if fast[obj] >= f_thr:
                st.ok_evals = 0
                if not st.breached:
                    st.breached = True
                    self.breaches += 1
                    self._count_breach(obj, "fast")
                    logger.warning(
                        "session %s SLO breach: %s fast-window burn %.2f "
                        ">= %.2f (scenario %s)", self.session, obj,
                        fast[obj], f_thr, self.scenario)
                    telemetry.event("slo_breach", session=self.session,
                                    objective=obj,
                                    burn=round(fast[obj], 3),
                                    scenario=self.scenario)
            elif st.breached:
                st.ok_evals += 1
                if st.ok_evals >= self.recovery_evals:
                    st.breached = False
                    logger.info("session %s SLO recovered: %s fast-window "
                                "burn %.2f", self.session, obj, fast[obj])
                    telemetry.event("slo_recovery", session=self.session,
                                    objective=obj)
            if telemetry.enabled:
                telemetry.gauge("selkies_slo_burn_rate", round(fast[obj], 4),
                                session=self.session, objective=obj,
                                window="fast")
                telemetry.gauge("selkies_slo_burn_rate", round(slow[obj], 4),
                                session=self.session, objective=obj,
                                window="slow")
                telemetry.gauge(
                    "selkies_slo_breached",
                    2 if st.breached else (1 if st.chronic else 0),
                    session=self.session, objective=obj)
        self._edge(was_breached, self._any_breached())
        return fast

    def _count_breach(self, obj: str, window: str) -> None:
        if telemetry.enabled:
            telemetry.count("selkies_slo_breaches_total",
                            session=self.session, objective=obj,
                            window=window)

    def _any_breached(self) -> bool:
        return any(st.breached for st in self._state.values())

    def _edge(self, was: bool, is_now: bool) -> None:
        """Aggregate acute edge: hooks + supervisor WARN. While breached
        the pressure hook is RE-ASSERTED once per evaluation (~1/s) —
        the policy congestion overlay's pattern: another controller's
        relief (the policy link overlay exiting, an engine disarm) can
        strip the shed mid-breach, and the hook is idempotent, so
        re-firing re-applies it once the other controller lets go.
        Guarded — a broken hook must not take down the serving loop."""
        if was and is_now:
            if self.on_pressure is not None:
                try:
                    self.on_pressure()
                except Exception:
                    logger.exception("SLO pressure re-assert failed")
            return
        if is_now and not was:
            if self.supervisor is not None:
                breached = [o for o in OBJECTIVES
                            if self._state[o].breached]
                try:
                    self.supervisor.slo_warn(
                        f"SLO breach on session {self.session}: "
                        f"{'+'.join(breached)} (scenario {self.scenario})",
                        key=self.session)
                except Exception:
                    logger.exception("supervisor slo_warn failed")
            if self.on_pressure is not None:
                try:
                    self.on_pressure()
                except Exception:
                    logger.exception("SLO pressure hook failed")
        elif was and not is_now:
            if self.supervisor is not None:
                try:
                    self.supervisor.slo_clear(key=self.session)
                except Exception:
                    logger.exception("supervisor slo_clear failed")
            if self.on_relief is not None:
                try:
                    self.on_relief()
                except Exception:
                    logger.exception("SLO relief hook failed")

    def reset(self) -> None:
        """The session's client departed (fleet disconnect / release /
        poison-eject): the next client must not inherit this one's
        windows, breach state, or the sticky WARN rung — a breach
        belongs to the traffic that caused it (as a fleet session's
        codec record does). Lifetime counters survive for /statz; the owner
        restores its own shed (the fleet's _slo_restore) — reset never
        fires on_relief."""
        was = self._any_breached()
        self._bins.clear()
        self._qbins.clear()
        self._state = {obj: _ObjectiveState() for obj in OBJECTIVES}
        self._last_eval = -1e18
        self.outlier.reset()
        if telemetry.enabled:
            # zero the exported series too: _evaluate never runs again
            # for a departed session, so without this the acute-breach
            # gauge stays latched at 2 forever (the sticky-gauge class
            # of bug once fixed for selkies_codec_sessions)
            for obj in OBJECTIVES:
                telemetry.gauge("selkies_slo_breached", 0,
                                session=self.session, objective=obj)
                for window in ("fast", "slow"):
                    telemetry.gauge("selkies_slo_burn_rate", 0.0,
                                    session=self.session, objective=obj,
                                    window=window)
        if was and self.supervisor is not None:
            try:
                self.supervisor.slo_clear(key=self.session)
            except Exception:
                logger.exception("supervisor slo_clear failed on reset")

    # -- read side -------------------------------------------------------

    def health_view(self) -> dict:
        """The /healthz detail: compact enough for a probe body."""
        acute = [o for o in OBJECTIVES if self._state[o].breached]
        chronic = [o for o in OBJECTIVES if self._state[o].chronic]
        return {"scenario": self.scenario, "breached": acute,
                "chronic": chronic}

    def stats(self) -> dict:
        """The /statz ``slo`` block (telemetry provider)."""
        t = self.targets
        return {
            "scenario": self.scenario,
            "targets": {"p50_ms": t.p50_ms, "p95_ms": t.p95_ms,
                        "fps_floor": t.fps_floor,
                        "down_kbps": t.down_kbps,
                        "psnr_floor_db": t.psnr_floor_db},
            "frames": self.frames,
            "quality_samples": self.quality_samples,
            "evaluations": self.evaluations,
            "breaches": self.breaches,
            "outliers": self.outliers,
            "objectives": {
                obj: {"fast_burn": round(st.fast_burn, 3),
                      "slow_burn": round(st.slow_burn, 3),
                      "breached": st.breached, "chronic": st.chronic}
                for obj, st in self._state.items()
            },
        }
