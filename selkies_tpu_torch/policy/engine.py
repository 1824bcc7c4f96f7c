"""The per-session policy engine: observe -> classify -> actuate.

The port's copy of ``selkies_tpu/policy/engine.py``.

:class:`PolicyEngine` owns the rolling :class:`SignalWindow`, the
hysteresis + dwell state machine over :func:`classify_window`, and the
congestion overlay; :class:`PolicyRuntime` binds an engine to an
:class:`~selkies_tpu_torch.policy.actuation.EncoderActuator` and is the ONE
object the serving loops talk to — its :meth:`PolicyRuntime.tick`
never raises (a wedged engine disarms itself back to static knobs
instead of stalling the loop; the chaos suite proves it through the
``policy`` fault site).

Anti-flap discipline (docs/policy.md):

* **hysteresis** — a candidate scenario must win ``confirm``
  consecutive evaluations before it transitions (a single-frame blip
  can never flip the knobs);
* **dwell** — after a transition the engine holds the scenario for at
  least ``dwell`` evaluations; the expensive actuation rung
  (device-entropy retune, which rebuilds jitted partials) can
  therefore fire at most once per dwell window.

Congestion overlay: independent of the content scenario, a sustained
link-bottleneck signal (loss, or the GCC estimate pinned at its floor)
fires ``on_link_pressure`` — the solo app wires that to the
degradation ladder's RESOLUTION rung (DownscaleSource) so the stream
sheds link bytes BEFORE any fps-halving, and ``on_link_relief``
reverses it once the link has been clean for the exit dwell.
"""

from __future__ import annotations

import logging

from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.policy.actuation import EncoderActuator
from selkies_tpu_torch.policy.classifier import (
    Scenario,
    SignalWindow,
    categorize_frame,
    classify_window,
)
from selkies_tpu_torch.policy.presets import KnobPlan, plan_for
from selkies_tpu_torch.resilience.faultinject import get_injector

logger = logging.getLogger("policy")

__all__ = ["PolicyEngine", "PolicyRuntime"]

# congestion overlay thresholds (evaluations ~= frames)
CONG_LOSS = 0.05           # sustained loss fraction that marks the link
CONG_FLOOR_FRAC = 1.25     # GCC estimate pinned within 25% of its floor
CONG_ENTER = 60            # ~1 s at 60 fps of continuous pressure
CONG_EXIT = 300            # ~5 s clean before undoing the downscale


class PolicyEngine:
    """Per-session scenario state machine. All methods are cheap and
    exception-free by design except :meth:`decide`, whose failures the
    runtime counts toward disarm."""

    def __init__(self, session: str = "0", preset: str = "balanced", *,
                 window: int = 48, confirm: int = 6, dwell: int = 120,
                 total_mbs: int = 0, congestion=None,
                 fault_site: str = "policy"):
        self.session = str(session)
        self.preset = preset
        self.window = SignalWindow(window)
        self.confirm = max(1, int(confirm))
        self.dwell = max(0, int(dwell))
        self.total_mbs = int(total_mbs)
        # congestion provider: () -> {"rtt_ms", "loss", "target_kbps",
        # "min_kbps"} or None (no congestion signal on this host)
        self.congestion = congestion
        self.fault_site = fault_site
        self.scenario = Scenario.UNKNOWN
        self._candidate: Scenario | None = None
        self._streak = 0
        # pre-loaded with the dwell so the FIRST classification (out of
        # UNKNOWN) is gated only by the confirmation streak
        self._since_transition = self.dwell
        self.transitions: dict[str, int] = {}
        self.frames = 0
        self.failures = 0
        self.dead = False
        # congestion overlay
        self.congested = False
        self._cong_streak = 0
        self._clear_streak = 0
        self.on_link_pressure = None   # () -> None; app wires downscale
        self.on_link_relief = None
        # scenario-change hook: the SLO plane (monitoring/slo.py) wires
        # SessionSLO.set_scenario here so a transition retargets the
        # session's objectives; called with the new scenario's value
        self.on_scenario = None
        # skip-fraction fallback arming: rows that never report a single
        # skipped MB (the software x264/x265 rows hardcode 0) carry no
        # skip signal at all — without this gate an idle desktop on such
        # a row would read as full-frame motion (GAME) forever
        self._skip_seen = False

    # -- signal intake --------------------------------------------------

    def observe(self, *, upload_kind: str = "", dirty_frac: float = 0.0,
                remap_frac: float = 0.0, skipped_mbs: int = 0,
                interval_ms: float = 0.0) -> None:
        """Fold one encoded frame's signals into the window."""
        if skipped_mbs > 0:
            self._skip_seen = True
        skip_frac = (skipped_mbs / self.total_mbs
                     if (not upload_kind and self.total_mbs > 0
                         and self._skip_seen) else None)
        cat = categorize_frame(upload_kind, dirty_frac, remap_frac,
                               skip_frac)
        self.window.push(cat, dirty_frac, interval_ms)
        self.frames += 1

    # -- decisions ------------------------------------------------------

    def decide(self) -> KnobPlan | None:
        """One evaluation: returns the scenario's knob plan ON a
        transition, None otherwise. Also advances the congestion
        overlay. The ``policy`` fault site fires here: ``raise`` is an
        engine crash (runtime counts toward disarm), ``drop`` skips
        this evaluation, ``flap`` forces a misclassification — the
        hysteresis must absorb a single flap without a transition."""
        if self.dead:
            return None
        flap = False
        fi = get_injector()
        if fi is not None:
            act = fi.check(self.fault_site)  # raises on a scheduled raise
            if act is not None:
                action, _delay = act
                if action == "drop":
                    return None
                flap = action == "flap"
        self._since_transition += 1
        self._check_congestion()
        cand = classify_window(self.window)
        if flap:
            # deterministic misclassification: rotate to the "worst"
            # wrong answer (full-motion knobs while interactive)
            cand = (Scenario.GAME if cand != Scenario.GAME
                    else Scenario.TYPING)
        if cand == Scenario.UNKNOWN or cand == self.scenario:
            self._candidate, self._streak = None, 0
            return None
        if cand != self._candidate:
            self._candidate, self._streak = cand, 1
        else:
            self._streak += 1
        if self._streak < self.confirm or self._since_transition < self.dwell:
            return None
        return self._transition(cand)

    def _transition(self, cand: Scenario) -> KnobPlan:
        prev = self.scenario
        self.scenario = cand
        self._candidate, self._streak = None, 0
        self._since_transition = 0
        self.transitions[cand.value] = self.transitions.get(cand.value, 0) + 1
        logger.info("session %s scenario %s -> %s (preset %s)",
                    self.session, prev.value, cand.value, self.preset)
        if telemetry.enabled:
            telemetry.count("selkies_policy_transitions_total",
                            session=self.session, scenario=cand.value)
            # first-class ring event so the transition appears in dumped
            # black-box bundles next to the frames it retuned
            telemetry.event("policy_transition", session=self.session,
                            scenario=cand.value, prev=prev.value,
                            preset=self.preset)
            for s in Scenario:
                telemetry.gauge("selkies_policy_scenario",
                                1 if s is cand else 0,
                                session=self.session, scenario=s.value)
        if self.on_scenario is not None:
            try:
                self.on_scenario(cand.value)
            except Exception:
                logger.exception("scenario hook failed on session %s",
                                 self.session)
        return plan_for(self.preset, cand)

    def _check_congestion(self) -> None:
        if self.congestion is None:
            return
        try:
            sig = self.congestion() or {}
        except Exception:
            logger.exception("congestion provider failed; overlay disabled")
            self.congestion = None
            return
        loss = float(sig.get("loss", 0.0))
        target = float(sig.get("target_kbps", 0.0))
        floor = float(sig.get("min_kbps", 0.0))
        pressed = loss >= CONG_LOSS or (
            floor > 0 and 0 < target <= CONG_FLOOR_FRAC * floor)
        if pressed:
            self._cong_streak += 1
            self._clear_streak = 0
        else:
            self._clear_streak += 1
            self._cong_streak = 0
        if (self.congested and pressed
                and self._cong_streak % CONG_ENTER == 0
                and self.on_link_pressure is not None):
            # LEVEL re-assertion, not just the entry edge: the failure
            # ladder's own undegrade can strip the policy downscale while
            # the link is still pressed (the two controllers hand the
            # source back and forth) — the callback is idempotent, so
            # re-firing while congested re-applies it once the
            # supervisor releases the source
            self.on_link_pressure()
            return
        if not self.congested and self._cong_streak >= CONG_ENTER:
            self.congested = True
            self.transitions["congested"] = (
                self.transitions.get("congested", 0) + 1)
            logger.warning("session %s link congested (loss=%.3f "
                           "target=%.0f floor=%.0f): shedding bytes "
                           "before fps", self.session, loss, target, floor)
            if telemetry.enabled:
                telemetry.count("selkies_policy_transitions_total",
                                session=self.session, scenario="congested")
                telemetry.gauge("selkies_policy_scenario", 1,
                                session=self.session, scenario="congested")
            if self.on_link_pressure is not None:
                self.on_link_pressure()
        elif self.congested and self._clear_streak >= CONG_EXIT:
            self.congested = False
            logger.info("session %s link recovered", self.session)
            if telemetry.enabled:
                telemetry.gauge("selkies_policy_scenario", 0,
                                session=self.session, scenario="congested")
            if self.on_link_relief is not None:
                self.on_link_relief()

    # -- read side ------------------------------------------------------

    def stats(self) -> dict:
        """The /statz policy block (telemetry provider)."""
        return {
            "scenario": self.scenario.value,
            "preset": self.preset,
            "congested": self.congested,
            "frames": self.frames,
            "transitions": dict(self.transitions),
            "disarmed": self.dead,
            "failures": self.failures,
            "window": self.window.stats(),
        }


class PolicyRuntime:
    """Engine + actuator behind ONE never-raising tick() for the serving
    loops. Contract: whatever the engine or an actuation does, the
    serving loop's frame flow is untouched — after ``MAX_FAILURES``
    consecutive decide/apply failures the runtime disarms the engine
    and restores the encoder's constructed static knobs."""

    MAX_FAILURES = 3

    def __init__(self, engine: PolicyEngine, actuator: EncoderActuator):
        self.engine = engine
        self.actuator = actuator

    def tick(self, stats_list, interval_ms: float = 0.0) -> None:
        eng = self.engine
        if eng.dead:
            return
        try:
            enc_changed = self.actuator.refresh()
            for s in stats_list:
                eng.observe(
                    upload_kind=getattr(s, "upload_kind", "") or "",
                    dirty_frac=float(getattr(s, "dirty_frac", 0.0)),
                    remap_frac=float(getattr(s, "remap_frac", 0.0)),
                    skipped_mbs=int(getattr(s, "skipped_mbs", 0)),
                    interval_ms=interval_ms,
                )
            plan = eng.decide()
            if plan is None and enc_changed and eng.scenario is not Scenario.UNKNOWN:
                # a rebuilt/swapped encoder comes up with static knobs:
                # re-apply the scenario it is serving
                plan = plan_for(eng.preset, eng.scenario)
            if plan is not None:
                applied = self.actuator.apply(plan)
                if applied and telemetry.enabled:
                    telemetry.event("policy_actuation", session=eng.session,
                                    scenario=plan.scenario,
                                    knobs=list(applied))
                    for knob in applied:
                        telemetry.count("selkies_policy_actuations_total",
                                        session=eng.session, knob=knob)
            eng.failures = 0
        except Exception:
            eng.failures += 1
            logger.exception(
                "policy tick failed (%d/%d) on session %s",
                eng.failures, self.MAX_FAILURES, eng.session)
            if eng.failures >= self.MAX_FAILURES:
                self._disarm()

    def _disarm(self) -> None:
        """Wedged engine: back to static knobs, stop deciding. The
        serving loop keeps streaming exactly as a SELKIES_POLICY=0 run
        would."""
        eng = self.engine
        eng.dead = True
        logger.error("policy engine for session %s disarmed after %d "
                     "failures; static knobs restored", eng.session,
                     eng.failures)
        try:
            self.actuator.restore_defaults()
        except Exception:
            logger.exception("restoring static knobs failed; encoder keeps "
                             "its last-applied knobs (all byte-safe)")
        if eng.congested:
            # the overlay dies with the engine: a dead engine can never
            # fire on_link_relief, so an applied downscale would outlive
            # the congestion forever — undo it now (the callback is a
            # no-op if the failure ladder owns the source)
            eng.congested = False
            try:
                if eng.on_link_relief is not None:
                    eng.on_link_relief()
            except Exception:
                logger.exception("undoing the congestion overlay failed")
        if telemetry.enabled:
            telemetry.count("selkies_policy_transitions_total",
                            session=eng.session, scenario="disarmed")
            for s in Scenario:
                telemetry.gauge("selkies_policy_scenario", 0,
                                session=eng.session, scenario=s.value)
            telemetry.gauge("selkies_policy_scenario", 0,
                            session=eng.session, scenario="congested")
