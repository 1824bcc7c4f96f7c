"""The port's policy engine and SLO plane against JAX's.

``selkies_tpu_torch/policy/`` (classifier, presets, actuation, engine, the
package switches) and ``selkies_tpu_torch/monitoring/slo.py`` against their
``selkies_tpu`` originals, exactly:

- the classifier's categories and window verdicts, every preset's plan,
  the SLO targets and the env switches;
- ``PolicyEngine`` + ``EncoderActuator`` + ``PolicyRuntime`` fed the same
  ``EncodedFrame`` stream (each package's own dataclass): the knob calls on
  a recording encoder, the engine's ``stats()``, the scenario and link
  hooks, also under ``policy`` fault rules; then on the real encoders at
  320x192 on the CPU (the port's and JAX's, grouped at depth 0 so what
  comes back does not depend on the clock): the knob calls, the knob state
  and the AUs;
- ``SessionSLO`` on an injected clock: ``stats()`` and ``health_view()``
  after every evaluation, the breach and relief hooks, the supervisor's
  sticky WARN, the telemetry gauges and events;
- the compile sentinels fed the same build events on an injected clock.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from selkies_tpu import policy as jpol
from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu.monitoring import flightrecorder as jfr
from selkies_tpu.monitoring import jitprof as jjit
from selkies_tpu.monitoring import slo as jslo
from selkies_tpu.monitoring.telemetry import telemetry as jtele
from selkies_tpu.pipeline import elements as jel
from selkies_tpu.policy import classifier as jcls
from selkies_tpu.policy import presets as jpre
from selkies_tpu.resilience import faultinject as jfi
from selkies_tpu.resilience import supervisor as jsup
from selkies_tpu_torch import policy as tpol
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
from selkies_tpu_torch.monitoring import flightrecorder as tfr
from selkies_tpu_torch.monitoring import jitprof as tjit
from selkies_tpu_torch.monitoring import slo as tslo
from selkies_tpu_torch.monitoring.telemetry import telemetry as ttele
from selkies_tpu_torch.pipeline import elements as tel
from selkies_tpu_torch.policy import classifier as tcls
from selkies_tpu_torch.policy import presets as tpre
from selkies_tpu_torch.resilience import faultinject as tfi
from selkies_tpu_torch.resilience import supervisor as tsup
from test_torch_ratecontrol_supervisor import FakeClock, RecordingActions

W, H = 320, 192
# (policy package, EncodedFrame module, fault injector, slo, supervisor,
#  telemetry bus, flight recorder, sentinel)
JAX = dict(pol=jpol, el=jel, fi=jfi, slo=jslo, sup=jsup, tele=jtele, fr=jfr, jit=jjit)
PORT = dict(pol=tpol, el=tel, fi=tfi, slo=tslo, sup=tsup, tele=ttele, fr=tfr, jit=tjit)
PACKAGES = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Each package's injector unset, telemetry off, one torch thread;
    the switches the policy and the encoders read cleared."""
    for k in ("SELKIES_FAULTS", "SELKIES_POLICY", "SELKIES_POLICY_PRESET", "SELKIES_SLO",
              "SELKIES_FRAME_BATCH", "SELKIES_PIPELINE_DEPTH", "SELKIES_ENTROPY_CODER",
              "SELKIES_DEVICE_ENTROPY", "SELKIES_BANDS", "SELKIES_TILE_GRID",
              "SELKIES_TELEMETRY"):
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for p in PACKAGES:
        p["fi"].reset_faults()
    yield
    for p in PACKAGES:
        p["fi"].reset_faults()
        p["tele"].enabled = False
        p["tele"].reset()
    torch.set_num_threads(threads)


# -- classifier, presets, switches ---------------------------------------------

_KINDS = ("", "static", "full", "delta", "other")
_FRACS = (0.0, 0.004, 0.02, 0.05, 0.2, 0.5, 0.9, 1.0)


def test_categorize_frame_matches_jax():
    for kind in _KINDS:
        for dirty in _FRACS:
            for remap in _FRACS:
                for skip in (None, 0.0, 0.02, 0.5, 0.97, 1.0):
                    args = (kind, dirty, remap, skip)
                    assert tcls.categorize_frame(*args) == jcls.categorize_frame(*args), args


@pytest.mark.parametrize("seed", range(8))
def test_classify_window_matches_jax(seed):
    """Seeded category streams, each biased toward one scenario's shape:
    the window's fractions, stats and verdict after every push."""
    rng = np.random.default_rng(seed)
    cats = ("static", "tiny", "remap", "busy", "full", "other", "bogus")
    bias = rng.dirichlet(np.full(len(cats), 0.4))
    jw = jcls.SignalWindow(int(rng.integers(8, 64)))
    tw = tcls.SignalWindow(jw.size)
    for i in range(300):
        cat = cats[int(rng.choice(len(cats), p=bias))]
        dirty, iv = float(rng.random() * 0.3), float(rng.choice([0.0, 16.6, 33.3, 50.0]))
        jw.push(cat, dirty, iv)
        tw.push(cat, dirty, iv)
        assert tw.stats() == jw.stats()
        assert tcls.classify_window(tw).value == jcls.classify_window(jw).value
        if i == 150:
            jw.clear(), tw.clear()


def _plan(p) -> dict:
    return dataclasses.asdict(p)


def test_presets_plans_and_targets_match_jax():
    assert list(tpre.PRESETS) == list(jpre.PRESETS)
    for preset in (*jpre.PRESETS, "no-such-preset"):
        for s in jcls.Scenario:
            t = tpre.plan_for(preset, tcls.Scenario(s.value))
            assert _plan(t) == _plan(jpre.plan_for(preset, s)), (preset, s)
    assert {s.value: dataclasses.asdict(t) for s, t in tpre.SLO_TARGETS.items()} == \
        {s.value: dataclasses.asdict(t) for s, t in jpre.SLO_TARGETS.items()}
    assert {k: dataclasses.asdict(v) for k, v in tslo.scenario_targets().items()} == \
        {k: dataclasses.asdict(v) for k, v in jslo.scenario_targets().items()}
    d_kw = dict(tile_cache=True, batch_cap="max", device_entropy=False, bits_min_mbs=512,
                keyframe_interval=0)
    for s in jcls.Scenario:
        jm = jpre.plan_for("balanced", s).merged_over(jpre.KnobPlan("defaults", **d_kw))
        tm = tpre.plan_for("balanced", tcls.Scenario(s.value)).merged_over(
            tpre.KnobPlan("defaults", **d_kw))
        assert _plan(tm) == _plan(jm)
    assert (tpre.BATCH_MIN, tpre.BATCH_HALF, tpre.BATCH_MAX, tpre.FULL_MOTION_GOP) == \
        (jpre.BATCH_MIN, jpre.BATCH_HALF, jpre.BATCH_MAX, jpre.FULL_MOTION_GOP)


@pytest.mark.parametrize("policy,preset,slo", [
    (None, None, None), ("1", "latency", "1"), ("0", "warp-speed", "0"),
    ("true", "throughput", "on"), ("yes", "", "no"), (" ON ", "balanced", "TRUE")])
def test_switches_match_jax(monkeypatch, policy, preset, slo):
    for k, v in (("SELKIES_POLICY", policy), ("SELKIES_POLICY_PRESET", preset),
                 ("SELKIES_SLO", slo)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    assert tpol.policy_enabled() == jpol.policy_enabled()
    assert tpol.preset_from_env() == jpol.preset_from_env()
    assert tslo.slo_enabled() == jslo.slo_enabled()


# -- the engine and the actuator over a recording encoder ----------------------

# (upload_kind, dirty_frac, remap_frac, skipped_mbs) per frame of each
# scenario, shaped like tests/test_policy.py's recorded traces
def _signals(name: str, n: int):
    out = []
    for i in range(n):
        if name == "idle":
            out.append(("delta", 0.004, 0.0, 0) if i % 30 == 0 else ("static", 0.0, 0.0, 0))
        elif name == "typing":
            out.append(("delta", 0.01, 0.0, 0) if i % 3 == 0 else ("static", 0.0, 0.0, 0))
        elif name == "scroll":
            out.append(("delta", 0.12, 0.92, 0))
        elif name == "drag":
            out.append(("delta", 0.03, 0.95, 0))
        elif name == "video":
            out.append(("delta", 0.25, 0.0, 0) if i % 2 == 0 else ("static", 0.0, 0.0, 0))
        elif name == "game":
            out.append(("full", 1.0, 0.0, 0))
        elif name == "skips":  # a row without upload attribution
            out.append(("", 0.0, 0.0, 100 if i % 4 else 240))
        else:
            raise ValueError(name)
    return out


_STREAM = [s for name, n in (("typing", 60), ("scroll", 70), ("video", 80), ("game", 90),
                             ("drag", 60), ("idle", 120), ("skips", 60), ("typing", 40))
           for s in _signals(name, n)]


def _ef(mod, i, sig):
    kind, dirty, remap, skipped = sig
    return mod.EncodedFrame(au=b"\x00\x00\x00\x01" + bytes([i % 251]), timestamp_90k=1500 * i,
                            wall_time=0.0, idr=i == 0, qp=28, device_ms=1.0, pack_ms=0.5,
                            upload_kind=kind, dirty_frac=dirty, remap_frac=remap,
                            skipped_mbs=skipped, frame_id=i)


class KnobEncoder:
    """The actuator's encoder surface with the registry row's constructed
    knobs; records every knob call and attribute set."""

    def __init__(self, frame_batch=4):
        self.calls: list[tuple] = []
        self.frame_batch = frame_batch
        self._tcache = object()
        self.device_entropy = False
        self.bits_min_mbs = 512
        self._kf = 0

    @property
    def keyframe_interval(self):
        return self._kf

    @keyframe_interval.setter
    def keyframe_interval(self, v):
        self.calls.append(("keyframe_interval", v))
        self._kf = v

    def set_tile_cache(self, on):
        self.calls.append(("set_tile_cache", on))
        changed = (self._tcache is not None) != bool(on)
        self._tcache = object() if on else None
        return changed

    def set_batch_cap(self, n):
        self.calls.append(("set_batch_cap", n))
        return True

    def retune_entropy(self, device_entropy=None, bits_min_mbs=None):
        self.calls.append(("retune_entropy", device_entropy, bits_min_mbs))
        self.device_entropy = bool(device_entropy)
        if bits_min_mbs is not None:
            self.bits_min_mbs = bits_min_mbs
        return True


def _congestion(i_ref):
    """A link signal that presses over frames 100-169 and 500-569."""
    def sig():
        i = i_ref[0]
        loss = 0.2 if 100 <= i < 170 or 500 <= i < 570 else 0.0
        return {"loss": loss, "target_kbps": 2000.0, "min_kbps": 200.0}
    return sig


def _drive_engine(pkg, stream, *, preset="balanced", spec=None, swap_at=None):
    """One package's runtime over the EncodedFrame stream -> everything
    it did: knob calls per encoder, hook calls, engine stats per tick."""
    pol = pkg["pol"]
    pkg["fi"].reset_faults()
    if spec:
        pkg["fi"].configure_faults(spec)
    encs = [KnobEncoder()]
    i_ref = [0]
    eng = pol.PolicyEngine(session="0", preset=preset, confirm=4, dwell=24,
                           total_mbs=240, congestion=_congestion(i_ref))
    hooks = []
    eng.on_link_pressure = lambda: hooks.append(("pressure", i_ref[0]))
    eng.on_link_relief = lambda: hooks.append(("relief", i_ref[0]))
    eng.on_scenario = lambda s: hooks.append(("scenario", s, i_ref[0]))
    drains = []
    act = pol.EncoderActuator(lambda: encs[-1], drain=lambda: drains.append(i_ref[0]))
    rt = pol.PolicyRuntime(eng, act)
    trail = []
    for i, sig in enumerate(stream):
        i_ref[0] = i
        if i == swap_at:  # a ladder rebuild: the scenario is re-applied
            encs.append(KnobEncoder(frame_batch=2))
        rt.tick([_ef(pkg["el"], i, sig)], interval_ms=16.6)
        trail.append(eng.stats())
    pkg["fi"].reset_faults()
    return [e.calls for e in encs], hooks, drains, trail, _plan(act.defaults())


@pytest.mark.parametrize("preset", ["balanced", "latency", "throughput"])
def test_engine_and_actuator_match_jax(preset):
    j = _drive_engine(JAX, _STREAM, preset=preset, swap_at=300)
    t = _drive_engine(PORT, _STREAM, preset=preset, swap_at=300)
    assert t == j
    calls, hooks = t[0], t[1]
    assert calls[0] and calls[1]  # both encoders were actuated
    assert {h[1] for h in hooks if h[0] == "scenario"} >= {"typing", "scroll", "video", "game"}
    assert {"pressure", "relief"} <= {h[0] for h in hooks}


@pytest.mark.parametrize("spec", ["policy@30,31,80:flap", "policy@100-140:drop",
                                  "policy@1-99:raise", "policy@50,51,53:raise"])
def test_engine_under_policy_faults_matches_jax(spec):
    """``flap`` absorbed by the confirm streak, ``drop`` skipping decisions,
    ``raise`` counted toward the disarm (which restores the defaults)."""
    j = _drive_engine(JAX, _STREAM[:240], spec=spec)
    t = _drive_engine(PORT, _STREAM[:240], spec=spec)
    assert t == j
    if spec == "policy@1-99:raise":
        assert t[3][-1]["disarmed"]


# -- the engine over the real encoders ------------------------------------------

def _desktop_frames(n: int, seed: int = 5):
    """Typing, then a full-motion run, then typing again at 320x192."""
    rng = np.random.default_rng(seed)
    cur = np.full((H, W, 4), 230, np.uint8)
    cur[: H // 10] = (70, 60, 60, 0)
    frames = []
    for i in range(n):
        if i < n // 3 or i >= 2 * n // 3:
            if i % 3 == 0:
                r = 32 + (i // 3 * 16) % (H - 64)
                cur[r: r + 12, 16: 96, :3] = rng.integers(0, 255, (12, 80, 3), np.uint8)
            frames.append(cur.copy())
        else:
            frames.append(rng.integers(0, 255, (H, W, 4), np.uint8))
    return frames


def _spy(enc, calls):
    """Record the actuator's knob calls on a real encoder."""
    for name in ("set_tile_cache", "set_batch_cap", "retune_entropy"):
        orig = getattr(enc, name)

        def call(*a, _o=orig, _n=name, **k):
            r = _o(*a, **k)
            calls.append((_n, a, tuple(sorted(k.items())), r))
            return r
        setattr(enc, name, call)


def _run_real(pkg, enc):
    """The runtime over what ``enc`` returns for the trace, frame by
    frame: -> (AU sha256s, knob calls, engine stats, knob state)."""
    pol = pkg["pol"]
    calls, aus = [], []
    _spy(enc, calls)
    eng = pol.PolicyEngine(session="0", window=16, confirm=3, dwell=6,
                           total_mbs=(W // 16) * (H // 16))
    eng.on_scenario = lambda s: calls.append(("scenario", s))
    pipe = pkg["el"].VideoPipeline(source=None, encoder=enc, rate_controller=None,
                                   sink=None, fps=60)

    def drain():
        for au, st, m in enc.flush():
            aus.append(hashlib.sha256(au).hexdigest())

    rt = pol.PolicyRuntime(eng, pol.EncoderActuator(lambda: enc, drain=drain))
    for i, f in enumerate(_desktop_frames(96)):
        outs = enc.submit(f, 28, i)
        aus += [hashlib.sha256(au).hexdigest() for au, _, _ in outs]
        efs = [pipe._ef_from_stats(au, st, m, m) for au, st, m in outs]
        rt.tick(efs, 16.6)
    drain()
    state = (enc._batch_cap, enc._tcache is not None, enc.device_entropy, enc.bits_min_mbs,
             enc.keyframe_interval)
    enc.close()
    return aus, calls, eng.stats(), state


def test_engine_on_real_encoders_matches_jax():
    """The registry row's knobs (groups of 4, the tile cache) at depth 0,
    where what each submit returns does not depend on the clock: typing ->
    full motion (tile cache off, full groups, the GOP posture) -> typing."""
    kw = dict(qp=28, frame_batch=4, pipeline_depth=0, scene_qp_boost=6)
    j = _run_real(JAX, TPUH264Encoder(W, H, **kw))
    t = _run_real(PORT, TorchH264Encoder(W, H, device="cpu", **kw))
    assert t == j
    scen = [c[1] for c in t[1] if c[0] == "scenario"]
    assert scen[0] == scen[-1] == "typing" and "game" in scen
    assert any(c[0] == "set_tile_cache" and c[1] == (False,) for c in t[1])


# -- SessionSLO on an injected clock --------------------------------------------

@pytest.fixture
def tele_on(tmp_path):
    """Both packages' telemetry on, each recorder writing under tmp_path."""
    for p, name in ((JAX, "jax"), (PORT, "port")):
        p["tele"].reset()
        p["tele"].enabled = True
        p["tele"].recorder = p["fr"].FlightRecorder(out_dir=str(tmp_path / name))
    yield


def _slo_counters(pkg) -> dict:
    roll = pkg["tele"].rollup()
    pick = {}
    for sect in ("counters", "gauges"):
        for k, v in roll.get(sect, {}).items():
            if k.startswith(("selkies_slo", "selkies_supervisor")):
                pick[(sect, k)] = v
    return pick


def _slo_script(pkg, *, with_quality: bool):
    """Good traffic, an acute latency burst, recovery, a retarget to
    typing (a downlink budget and a PSNR floor), byte overrun, quality
    samples under the floor, a reset: -> every step's view."""
    clock = FakeClock()
    acts = RecordingActions()
    sup = pkg["sup"].SlotSupervisor("slot", acts, clock=clock)
    slo = pkg["slo"].SessionSLO(
        "0", fast_s=10.0, slow_s=60.0, recovery_evals=2, min_frames=16, clock=clock,
        supervisor=sup, outlier=pkg["fr"].OutlierTrigger(window=64, warmup=32, factor=2.0,
                                                          floor_ms=5.0))
    hooks = []
    slo.on_pressure = lambda: hooks.append(("pressure", round(clock.t, 3)))
    slo.on_relief = lambda: hooks.append(("relief", round(clock.t, 3)))
    views = []
    rng = np.random.default_rng(11)

    def feed(n, lat, nbytes, fps=30.0):
        for k in range(n):
            clock.t += 1.0 / fps
            slo.observe_frame(float(lat + rng.random()), int(nbytes), fid=len(views) + k)
            burns = slo.evaluate()
            if burns is not None:
                views.append((round(clock.t, 3), burns, slo.stats(), slo.health_view(),
                              int(sup.rung), sup.stats()))

    feed(600, 10.0, 1000)
    feed(300, 900.0, 1000)
    feed(600, 10.0, 1000)
    slo.set_scenario("typing")
    feed(300, 20.0, 40_000)
    if with_quality:
        for k in range(12):
            clock.t += 0.5
            slo.observe_quality(25.0 if k % 3 else 40.0)
            slo.evaluate()
    feed(120, 12.0, 100, fps=5.0)
    slo.reset()
    feed(60, 12.0, 1000)
    return views, hooks, acts.calls, _slo_counters(pkg), slo.frames, slo.outliers


@pytest.mark.parametrize("with_quality", [False, True], ids=["latency-bytes", "with-quality"])
def test_session_slo_matches_jax(tele_on, with_quality):
    j = _slo_script(JAX, with_quality=with_quality)
    t = _slo_script(PORT, with_quality=with_quality)
    assert t == j
    views, hooks = t[0], t[1]
    assert any(v[3]["breached"] for v in views) and ("relief" in {h[0] for h in hooks})


def test_slo_ring_events_match_jax(tele_on):
    """The breach / recovery / retarget events the flight recorder rings
    for the session, in order (their clock stamps aside)."""
    def events(pkg):
        _slo_script(pkg, with_quality=False)
        evs = pkg["tele"].recorder.events("0")
        return [{k: v for k, v in e.items() if k not in ("t", "ts", "mono", "wall")}
                for e in evs if str(e.get("ev", "")).startswith("slo")]

    got = events(PORT)
    assert got == events(JAX)
    assert {e["ev"] for e in got} >= {"slo_breach", "slo_recovery", "slo_retarget"}


# -- the compile sentinels ------------------------------------------------------

def _sentinel_run(pkg, event: str) -> list:
    clock = FakeClock()
    s = pkg["jit"].CompileSentinel(storm_n=3, storm_window_s=60.0, mark_ttl_s=5.0,
                                   startup_grace_s=10.0, clock=clock)
    out = []
    for step, (dt, what) in enumerate([
            (1.0, "build"), (2.0, "build"), (20.0, ("mark", "actuation", "entropy-retune")),
            (1.0, "build"), (1.0, "build"), (1.0, "build"), (30.0, "build"),
            (0.0, ("scope", "restart", "undegrade")), (120.0, "build"), (1.0, "hit"),
            (1.0, ("mark", "resize", "960x528")), (1.0, "build"), (10.0, "build")]):
        clock.t += dt
        if what == "build":
            s.on_duration(event, 0.25 + step / 100)
        elif what == "hit":
            s.on_event(pkg["jit"].CACHE_HIT_EVENT)
        elif what[0] == "mark":
            s.mark(what[1], what[2])
        else:
            with s.scope(what[1], what[2]):
                s.on_duration(event, 0.5)
        out.append(s.stats())
    return out


def test_compile_sentinel_same_events_match_jax(tele_on):
    """The same build events (each package's own compile event name) on an
    injected clock give the same counts, attribution and storms; the
    storm counters reach both buses."""
    j = _sentinel_run(JAX, jjit.COMPILE_EVENT)
    t = _sentinel_run(PORT, tjit.COMPILE_EVENT)
    assert t == j
    assert t[-1]["storms"] >= 1
    jc, tc = (p["tele"].rollup()["counters"] for p in (JAX, PORT))
    assert tc["selkies_compile_storms_total"] == jc["selkies_compile_storms_total"]
    assert tc["selkies_compile_total"] == jc["selkies_compile_total"]
