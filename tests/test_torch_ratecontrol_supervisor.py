"""The port's rate controller and recovery ladder against JAX's.

``selkies_tpu_torch/models/h264/ratecontrol.py`` (``CbrRateController``)
and ``selkies_tpu_torch/resilience/supervisor.py`` (``Backoff``,
``SlotSupervisor``) against their ``selkies_tpu`` originals: the same
operations give the same state after every step, exactly. The rate
controller is driven by ``hypothesis`` (derandomized, so a run repeats
itself); the supervisor by the event scripts of tests/test_resilience.py
(``tick_ok``, ``failure``, ``check_deadline``, ``note_idle``, the SLO
warn) on a fake clock, and by seeded random scripts.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from selkies_tpu.models.h264 import ratecontrol as jrc
from selkies_tpu.resilience import supervisor as jsup
from selkies_tpu_torch.models.h264 import ratecontrol as trc
from selkies_tpu_torch.resilience import supervisor as tsup

# -- CbrRateController --------------------------------------------------------

_OPS = st.one_of(
    st.tuples(st.just("update"), st.integers(0, 400_000), st.booleans()),
    st.tuples(st.just("set_bitrate"), st.integers(-50, 50_000)),
    st.tuples(st.just("set_framerate"), st.floats(-5.0, 240.0, allow_nan=False)),
)


def _rc_state(rc) -> tuple:
    return (rc.qp, rc.frame_qp(), rc.fullness, rc._fullness, rc.frame_budget_bits,
            rc.vbv_size_bits, rc.bitrate_kbps, rc.fps)


def _rc_step(rc, op):
    """-> (result or exception type name) of one operation."""
    name, *args = op
    try:
        return getattr(rc, name)(*args)
    except ValueError as exc:
        return type(exc).__name__


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(bitrate=st.integers(1, 50_000), fps=st.floats(1.0, 240.0, allow_nan=False),
       qp=st.integers(10, 51), ops=st.lists(_OPS, max_size=60))
def test_rate_controller_matches_jax(bitrate, fps, qp, ops):
    j = jrc.CbrRateController(bitrate_kbps=bitrate, fps=fps, qp=qp)
    t = trc.CbrRateController(bitrate_kbps=bitrate, fps=fps, qp=qp)
    assert _rc_state(t) == _rc_state(j)
    for op in ops:
        assert _rc_step(t, op) == _rc_step(j, op), op
        assert _rc_state(t) == _rc_state(j), op


@pytest.mark.parametrize("kw", [{}, {"vbv_frames": 3.0, "min_qp": 20, "max_qp": 40},
                                {"keyframe_budget_frames": 2.0}],
                         ids=["defaults", "vbv3-qp20-40", "keyframe2"])
def test_rate_controller_fields_match_jax(kw):
    """The dataclass fields and a seeded IDR/P byte trace with a live
    bitrate drop and a framerate halving (the GCC and ladder retunes)."""
    j = jrc.CbrRateController(bitrate_kbps=2000, fps=60, **kw)
    t = trc.CbrRateController(bitrate_kbps=2000, fps=60, **kw)
    rng = np.random.default_rng(7)
    for i in range(120):
        if i == 40:
            j.set_bitrate(300), t.set_bitrate(300)
        if i == 80:
            j.set_framerate(30), t.set_framerate(30)
        nbytes, idr = int(rng.integers(100, 60_000)), i % 50 == 0
        assert t.update(nbytes, idr=idr) == j.update(nbytes, idr=idr)
        assert _rc_state(t) == _rc_state(j)


# -- Backoff ------------------------------------------------------------------

@pytest.mark.parametrize("base,cap,jitter", [(0.5, 8.0, 0.0), (1.0, 1.0, 0.0), (0.25, 30.0, 0.5)])
def test_backoff_matches_jax(base, cap, jitter):
    vals = np.random.default_rng(3).random(200).tolist()
    jb = jsup.Backoff(base, cap, jitter=jitter, rand=iter(vals).__next__)
    tb = tsup.Backoff(base, cap, jitter=jitter, rand=iter(vals).__next__)
    for i in range(80):
        if i == 50:
            jb.reset(), tb.reset()
        assert tb.next_delay() == jb.next_delay()
        assert tb.attempts == jb.attempts


@pytest.mark.parametrize("base,cap", [(0.0, 1.0), (2.0, 1.0), (-1.0, 5.0)])
def test_backoff_rejects_bad_window_like_jax(base, cap):
    for mod in (jsup, tsup):
        with pytest.raises(ValueError):
            mod.Backoff(base, cap)


# -- SlotSupervisor -----------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class RecordingActions:
    """RecoveryActions double: records every call; ``fail_in`` names raise."""

    def __init__(self, fail_in=()):
        self.calls: list[tuple] = []
        self.fail_in = set(fail_in)

    def _rec(self, name, *args):
        self.calls.append((name, *args))
        if name in self.fail_in:
            raise RuntimeError(f"action {name} broken")

    def warn(self, msg):
        self._rec("warn", msg)

    def force_idr(self):
        self._rec("force_idr")

    def restart_encoder(self):
        self._rec("restart_encoder")

    def degrade(self, level):
        self._rec("degrade", level)

    def undegrade(self, level):
        self._rec("undegrade", level)

    def recycle(self):
        self._rec("recycle")


# tests/test_resilience.py's make_supervisor thresholds
_SMALL = dict(warn_after=1, idr_after=2, restart_after=3, degrade_after=5, degrade_every=2,
              recycle_after=10, recover_after=4)


def _make(mod, kw, fail_in=()):
    acts, clock = RecordingActions(fail_in), FakeClock()
    kw = dict(kw)
    backoff = kw.pop("backoff", (1.0, 8.0))
    sup = mod.SlotSupervisor("test", acts, fps=30.0, clock=clock,
                             backoff=mod.Backoff(*backoff), **kw)
    escal = []
    sup.on_escalation = lambda rung, why: escal.append((int(rung), why))
    return sup, acts, clock, escal


def _sup_state(sup) -> tuple:
    return (int(sup.rung), sup.rung.name, sup.degrade_level, sup.failures, sup.healthy_streak,
            sup.last_ok, sup._next_restart_at, sup._total_ok, sup.backoff.attempts,
            sorted(sup._slo_pressure), dict(sup.counters), sup.stats())


def _run_script(mod, kw, script, fail_in=()):
    """Play ``script`` on a fresh supervisor of package ``mod`` -> the
    state after every event, each event's return, the action calls and
    the escalation hook's calls."""
    sup, acts, clock, escal = _make(mod, kw, fail_in)
    trail = []
    for ev, *args in script:
        if ev == "ok":
            ret = sup.tick_ok()
        elif ev == "fail":
            ret = sup.failure(RuntimeError(args[0]) if args else None)
            ret = int(ret)
        elif ev == "deadline":
            ret = sup.check_deadline(*args)
        elif ev == "idle":
            ret = sup.note_idle()
        elif ev == "advance":
            clock.t += args[0]
            ret = None
        elif ev == "slo_warn":
            ret = sup.slo_warn("burn", key=args[0])
        elif ev == "slo_clear":
            ret = sup.slo_clear(key=args[0])
        else:
            raise AssertionError(ev)
        trail.append((ev, ret, _sup_state(sup)))
    return trail, acts.calls, escal


def _fails(n, tag="f"):
    return [("fail", f"{tag}{i}") for i in range(n)]


# test_resilience.py's ladder scripts, as event lists
_SCRIPTS = {
    "ladder_escalates_in_order": (_SMALL, [
        ("fail", "a"), ("fail", "b"), ("fail", "c"), ("advance", 100), ("fail", "d"),
        ("fail", "e"), ("fail", "f"), ("fail", "g"), ("advance", 100), ("fail", "h"),
        ("fail", "h"), ("fail", "h")]),
    "healthy_tick_resets_streak_not_degradation": (_SMALL, [
        *_fails(5), ("ok",), ("fail", "x"), ("ok",), ("ok",)]),
    "degradation_reverses_after_sustained_health": (_SMALL, [
        *_fails(5), ("advance", 100), *_fails(2, "g"), *[("ok",)] * 9]),
    "restart_backoff_gates_rebuilds": (dict(_SMALL, idr_after=1, restart_after=1, degrade_after=50,
                                            recycle_after=100), [
        ("fail", "a"), ("fail", "b"), ("advance", 0.5), ("fail", "c"), ("advance", 0.6),
        ("fail", "d"), ("fail", "e"), ("advance", 2.0), ("fail", "f")]),
    "sustained_health_resets_restart_backoff": (dict(_SMALL, idr_after=1, restart_after=1,
                                                     degrade_after=50, recycle_after=100), [
        ("fail", "a"), ("advance", 1.1), ("fail", "b"), *[("ok",)] * 4, ("advance", 0.1),
        ("fail", "c")]),
    "deadline_requires_arming": (dict(_SMALL, deadline_ticks=30, arm_after=2), [
        ("advance", 100), ("deadline",), ("ok",), ("ok",), ("advance", 2.0), ("deadline",),
        ("deadline",), ("advance", 0.5), ("deadline",), ("advance", 1.1), ("deadline",)]),
    "note_idle_suppresses_deadline": (dict(_SMALL, deadline_ticks=30, arm_after=1), [
        ("ok",), ("advance", 0.9), ("idle",), ("advance", 0.9), ("deadline",),
        ("advance", 1.1), ("deadline",)]),
    "slo_warn_is_sticky_and_keyed": (_SMALL, [
        ("slo_warn", "s0"), ("ok",), ("slo_warn", "s1"), *_fails(3), ("ok",),
        ("slo_clear", "s0"), ("ok",), ("slo_clear", "s1"), ("ok",)]),
    "broken_actions_keep_climbing": (_SMALL, [*_fails(11)]),
    # the solo app's thresholds (TorchWebRTCApp builds SlotSupervisor with
    # only fps): 24 failures reach degrade level 3, then recovery
    "app_defaults_to_level_3_and_back": (dict(recover_after=4), [
        *_fails(24), *[("ok",)] * 14, *_fails(30, "r")]),
}


@pytest.mark.parametrize("name", list(_SCRIPTS))
def test_supervisor_script_matches_jax(name):
    kw, script = _SCRIPTS[name]
    fail_in = ("force_idr", "restart_encoder", "degrade") if name.startswith("broken") else ()
    assert _run_script(tsup, kw, script, fail_in) == _run_script(jsup, kw, script, fail_in)


@pytest.mark.parametrize("seed", range(6))
def test_supervisor_random_script_matches_jax(seed):
    """Seeded random mixes of every event over both threshold sets."""
    rng = np.random.default_rng(seed)
    evs = []
    for i in range(300):
        r = rng.random()
        if r < 0.45:
            evs.append(("fail", f"e{i}"))
        elif r < 0.80:
            evs.append(("ok",))
        elif r < 0.87:
            evs.append(("advance", float(rng.choice([0.1, 0.6, 2.5, 30.0]))))
        elif r < 0.92:
            evs.append(("deadline",))
        elif r < 0.95:
            evs.append(("idle",))
        elif r < 0.98:
            evs.append(("slo_warn", f"s{int(rng.integers(2))}"))
        else:
            evs.append(("slo_clear", f"s{int(rng.integers(2))}"))
    kw = _SMALL if seed % 2 else dict(recover_after=8, deadline_ticks=60.0)
    assert _run_script(tsup, kw, evs) == _run_script(jsup, kw, evs)


def test_supervisor_rejects_bad_thresholds_like_jax():
    for mod in (jsup, tsup):
        with pytest.raises(ValueError):
            mod.SlotSupervisor("x", RecordingActions(), warn_after=3, idr_after=2)


def test_resilience_package_exports():
    """The port's resilience package exports the ladder's names, as JAX's."""
    import selkies_tpu.resilience as jres
    import selkies_tpu_torch.resilience as tres

    for name in ("Rung", "Backoff", "SlotSupervisor"):
        assert name in jres.__all__ and name in tres.__all__
    assert tres.RecoveryActions is tsup.RecoveryActions
    assert [(r.name, int(r)) for r in tres.Rung] == [(r.name, int(r)) for r in jres.Rung]
