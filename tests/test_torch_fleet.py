"""The port's fleet serving core against JAX's, on the CPU.

``selkies_tpu_torch/parallel/fleet.py`` (``SessionSlot``, ``SessionFleet``,
``dryrun``) against ``selkies_tpu/parallel/fleet.py`` at 192x128, the
geometry of tests/test_fleet.py, with 2 and 4 sessions:

- tick by tick (``_capture_batch`` + ``_encode_tick``, the slots' rate
  controllers updated as ``_run`` updates them) on the batch service, the
  banded service (``SELKIES_BANDS=2``) and the tile grid
  (``SELKIES_TILE_GRID=2x2``), with the occupancy scheduler on and off:
  equal AUs by sha256, ``last_idrs``, QPs and downlink modes; the port's
  fleet also equals its own bare service fed the slots' QPs;
- the supervised loop (``start`` / ``_run`` / ``stop``) with every slot
  connected through a recorder WebSocket plane: equal EncodedFrames; with
  no slot connected the service is never called;
- the recovery ladder under an ``encoder`` raise schedule with the
  supervisors' clocks frozen (force-IDR, restart, degrade 1-3 with the
  pinned libx264 software service, the reversal): the same rungs, fps and
  service classes tick for tick, equal AUs;
- the per-slot accounting (capture faults, ejection, send drops, a capture
  of the wrong geometry, a parked session, the deferred and the forced
  restart), codec negotiation, checkpoints carried from JAX's fleet into
  the port's, and the policy and SLO planes.

JAX's fleets run on tier-1's 8 virtual CPU devices; the port's on
``devices=[torch.device("cpu")]`` (one device: the banded carves are the
shared carve, which gives the same bytes). Every comparison is exact.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import hashlib
import json
import time

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.models import x264enc as jx264
from selkies_tpu.monitoring import slo as jslo
from selkies_tpu.monitoring.telemetry import telemetry as jtele
from selkies_tpu.parallel import fleet as jfleet
from selkies_tpu.pipeline import elements as jel
from selkies_tpu.resilience import configure_faults as jconfigure
from selkies_tpu.resilience import reset_faults as jreset
from selkies_tpu.signalling import negotiate as jneg
from selkies_tpu_torch.models import x264enc as tx264
from selkies_tpu_torch.monitoring import slo as tslo
from selkies_tpu_torch.monitoring.telemetry import telemetry as ttele
from selkies_tpu_torch.parallel import fleet as tfleet
from selkies_tpu_torch.parallel.lifecycle import SessionCheckpoint, restore_session
from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
from selkies_tpu_torch.pipeline import elements as tel
from selkies_tpu_torch.resilience import configure_faults as tconfigure
from selkies_tpu_torch.resilience import reset_device_pool
from selkies_tpu_torch.resilience import reset_faults as treset
from selkies_tpu_torch.signalling import negotiate as tneg
from test_torch_gpu import FakeTransport
from test_torch_library_rows import _pinned

W, H = 192, 128  # tests/test_fleet.py's geometry: 12 x 8 MBs
CPU = torch.device("cpu")
_ENV = ("SELKIES_BANDS", "SELKIES_TILE_GRID", "SELKIES_OCCUPANCY", "SELKIES_FAULTS",
        "SELKIES_POLICY", "SELKIES_POLICY_PRESET", "SELKIES_SLO", "SELKIES_CODEC",
        "SELKIES_TILE_COLS", "SELKIES_FRAME_BATCH", "SELKIES_PIPELINE_DEPTH",
        "SELKIES_ENTROPY_CODER", "SELKIES_DEVICE_ENTROPY", "SELKIES_BAND_HALO",
        "SELKIES_TILE_HALO", "SELKIES_FRONTEND_WORKERS", "SELKIES_PARALLEL_FRONTEND",
        "SELKIES_DAMAGE_FULL_SCAN", "SELKIES_RECOVERY", "SELKIES_TELEMETRY")
# JAX's service class -> the port's
CLASSES = {"MultiSessionH264Service": "TorchMultiSessionH264Service",
           "BandedFleetService": "TorchBandedFleetService",
           "SoftwareFleetService": "SoftwareFleetService"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Every switch the fleet, its services and its encoders read cleared,
    both injectors unset, one torch intra-op thread."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jreset()
    treset()
    yield
    jreset()
    treset()
    for tele in (jtele, ttele):
        tele.disable()
        tele.reset()
    torch.set_num_threads(threads)


def _sha(au: bytes) -> str:
    return hashlib.sha256(au).hexdigest()


def make_fleet(pkg: str, n: int, *, fps: int = 30, connected: bool = False,
               jax_devices=None, **kw):
    """n slots with recorder WebSocket planes and a SessionFleet over them:
    JAX's on tier-1's virtual devices (``jax_devices``, default all), the
    port's on the CPU."""
    mod = jfleet if pkg == "jax" else tfleet
    slots = []
    for k in range(n):
        if pkg == "jax":
            slot = mod.SessionSlot(k, bitrate_kbps=2000, fps=fps)
            slot.transport.ws = slot.ws = FakeTransport()  # the mux routes here: no peer
        else:
            slot = mod.SessionSlot(k, bitrate_kbps=2000, fps=fps, ws=FakeTransport())
        slot.connected = connected
        slots.append(slot)
    devices = jax_devices if pkg == "jax" else [CPU]
    return mod.SessionFleet(slots, width=W, height=H, fps=fps, devices=devices, **kw)


def frames_of(fleet) -> list:
    return [[(_sha(f.au), f.idr, f.qp) for f in s.ws.frames] for s in fleet.slots]


# tick -> ops before it: ("key", session) / ("kbps", session, kbps)
OPS = {1: [("key", 1)], 2: [("kbps", 0, 900)]}


def drive(fleet, ticks=4, ops=OPS, hook=None) -> list:
    """Tick ``fleet`` by hand as ``_run`` does (capture, encode, the slots'
    rate controllers updated, parked sessions skipped) -> per tick (AU
    sha256s, last_idrs, QPs, downlink modes)."""
    out = []
    for t in range(ticks):
        for op in ops.get(t, ()):
            if op[0] == "key":
                fleet.force_keyframe(op[1])
            else:
                fleet.set_session_bitrate(op[1], op[2])
        if hook is not None:
            hook(t)
        fleet._note_capture_failures(fleet._capture_batch())
        aus, idrs, qps, _ = fleet._encode_tick()
        for slot, au, idr in zip(fleet.slots, aus, idrs):
            if au:
                slot.rc.update(len(au), idr=idr)
        out.append(([_sha(a) for a in aus], list(idrs), qps, list(fleet._last_modes)))
    return out


def close(fleet) -> None:
    if fleet._occ is not None:
        fleet._occ.close()
        fleet._occ = None
    fleet.service.close()


@functools.lru_cache(maxsize=None)
def batch_run(pkg: str, n: int):
    fleet = make_fleet(pkg, n)
    try:
        return drive(fleet), type(fleet.service).__name__
    finally:
        close(fleet)


# -- 1. tick by tick on the batch service -------------------------------------

@pytest.mark.parametrize("tick", range(4))
@pytest.mark.parametrize("n", [2, 4])
def test_batch_fleet_tick_matches_jax(n, tick):
    """The all-IDR tick, a forced keyframe on session 1, a bitrate retune
    on session 0, a P tick: equal AUs, IDR flags, QPs and modes."""
    (jrun, jcls), (trun, tcls) = batch_run("jax", n), batch_run("port", n)
    assert (CLASSES[jcls], tcls) == ("TorchMultiSessionH264Service",) * 2
    assert trun[tick] == jrun[tick]


def test_batch_fleet_trace_covers_the_ops():
    run, _ = batch_run("port", 4)
    assert all(run[0][1]) and run[1][1] == [False, True, False, False]
    assert not any(run[3][1])
    # the retune moved session 0's QP off session 2's (same start, no op)
    assert run[3][2][0] != run[3][2][2] or run[2][2][0] != run[2][2][2]


def test_fleet_streams_bit_exact_vs_service():
    """tests/test_fleet.py's check on the port: the fleet's stream for each
    session equals a bare TorchMultiSessionH264Service fed the same frames
    and each slot's QP."""
    n = 2
    fleet = make_fleet("port", n)
    ref = TorchMultiSessionH264Service(n, W, H, qp=28, fps=30, device="cpu")
    try:
        sources = [tel.SyntheticSource(W, H, seed=k) for k in range(n)]
        for t in range(4):
            for op in OPS.get(t, ()):
                if op[0] == "key":
                    fleet.force_keyframe(op[1])
                    ref.force_keyframe(op[1])
                else:
                    fleet.set_session_bitrate(op[1], op[2])
            fleet._capture_batch()
            aus, idrs, qps, _ = fleet._encode_tick()
            for k, slot in enumerate(fleet.slots):
                ref.set_qp(k, slot.rc.frame_qp())
                slot.rc.update(len(aus[k]), idr=idrs[k])
            want = ref.encode_tick(np.stack([s.capture() for s in sources]))
            assert [bytes(a) for a in aus] == [bytes(a) for a in want], t
            assert list(ref.last_idrs) == idrs
    finally:
        close(fleet)
        ref.close()


def test_sources_match_jax():
    for seed in (0, 3):
        js, ts = jel.SyntheticSource(W, H, seed=seed), tel.SyntheticSource(W, H, seed=seed)
        for _ in range(3):
            np.testing.assert_array_equal(ts.capture(), js.capture())


# -- 2. the banded service and the tile grid, occupancy on and off -------------

CARVES = {"bands2": ("SELKIES_BANDS", "2"), "grid2x2": ("SELKIES_TILE_GRID", "2x2")}


@pytest.mark.parametrize("occupancy", ["1", "0"], ids=["occupancy", "serial"])
@pytest.mark.parametrize("carve", sorted(CARVES))
def test_banded_fleet_matches_jax(monkeypatch, carve, occupancy):
    monkeypatch.setenv(*CARVES[carve])
    monkeypatch.setenv("SELKIES_OCCUPANCY", occupancy)
    runs, scheds = {}, {}
    for pkg in ("jax", "port"):
        fleet = make_fleet(pkg, 2)
        try:
            runs[pkg] = drive(fleet)
            scheds[pkg] = (type(fleet.service).__name__, fleet.bands, fleet.grid,
                           fleet._occ is not None)
        finally:
            close(fleet)
    assert runs["port"] == runs["jax"]
    jcls, *jrest = scheds["jax"]
    assert [CLASSES[jcls], *jrest] == list(scheds["port"])
    assert scheds["port"][0] == "TorchBandedFleetService"
    assert scheds["port"][3] == (occupancy == "1")
    # the banded rows code P frames with a downlink mode
    assert any(m for _, _, _, modes in runs["port"][2:] for m in modes)


# -- 3. the supervised loop ------------------------------------------------------

async def _wait(cond, timeout: float = 120.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.01)
    return False


def _serve(fleet, until, timeout: float = 120.0):
    """start(), run until ``until(fleet)`` holds, stop()."""

    async def go():
        await fleet.start()
        try:
            assert await _wait(lambda: until(fleet), timeout), (
                fleet.ticks, [len(s.ws.frames) for s in fleet.slots])
            assert fleet._task is not None and not fleet._task.done()
        finally:
            await fleet.stop()
    asyncio.run(go())


LIVE_FRAMES = 6


@functools.lru_cache(maxsize=None)
def live_run(pkg: str):
    fleet = make_fleet(pkg, 2, fps=60, connected=True)
    _serve(fleet, lambda f: all(len(s.ws.frames) >= LIVE_FRAMES for s in f.slots))
    return frames_of(fleet), fleet.supervisor.counters["failures"]


@pytest.mark.parametrize("session", [0, 1])
def test_live_loop_frames_match_jax(session):
    """start() / _run / stop() with both slots connected: each slot's first
    frames (AU, IDR, QP) equal JAX's, and no tick failed."""
    (jf, jfail), (tf, tfail) = live_run("jax"), live_run("port")
    assert tfail == jfail == 0
    assert tf[session][:LIVE_FRAMES] == jf[session][:LIVE_FRAMES]
    assert tf[session][0][1] and not tf[session][1][1]


def test_live_loop_frames_equal_the_ticks_by_hand():
    """The loop's frames are the hand-driven ticks' (no ops): the loop adds
    nothing to the bytes."""
    fleet = make_fleet("port", 2, fps=60)
    try:
        run = drive(fleet, ticks=LIVE_FRAMES, ops={})
    finally:
        close(fleet)
    live, _ = live_run("port")
    for k in range(2):
        assert [f[0] for f in live[k][:LIVE_FRAMES]] == [r[0][k] for r in run]
        assert [f[2] for f in live[k][:LIVE_FRAMES]] == [r[2][k] for r in run]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_idle_fleet_never_calls_the_service(pkg):
    """No slot connected: the loop captures nothing and encodes nothing."""
    fleet = make_fleet(pkg, 2, fps=120)
    calls = []
    for name in ("_capture_batch", "_encode_tick"):
        real = getattr(fleet, name)
        setattr(fleet, name, lambda real=real, name=name: (calls.append(name), real())[1])
    svc = fleet.service
    real_tick = svc.encode_tick
    svc.encode_tick = lambda *a, **k: (calls.append("service"), real_tick(*a, **k))[1]

    async def go():
        await fleet.start()
        await asyncio.sleep(0.3)
        await fleet.stop()
    asyncio.run(go())
    assert calls == [] and fleet.ticks == 0


# -- 4. the ladder ------------------------------------------------------------------

# 24 encoder raises in a row from the third tick: warn, force-IDR (2),
# restart (6), degrade 1 (12), 2 (18) and 3, the software service (24);
# then recover_after=3 healthy ticks reverse one level each
LADDER_SPEC = "encoder@3-26:raise"
LADDER_EVENTS = 38


def _ladder_run(pkg: str, monkeypatch):
    (jconfigure if pkg == "jax" else tconfigure)(LADDER_SPEC)
    fleet = make_fleet(pkg, 2, fps=60, connected=True)
    sup = fleet.supervisor
    sup.clock = lambda: 0.0
    sup.last_ok = 0.0
    sup.recover_after = 3
    events = []
    for name in ("tick_ok", "failure"):
        real = getattr(sup, name)

        def wrapped(*a, _real=real, _name=name, **k):
            r = _real(*a, **k)
            cls = type(fleet.service).__name__
            events.append((_name, sup.rung.name, sup.degrade_level, fleet.fps,
                           CLASSES.get(cls, cls), fleet.software_mode, fleet._restart_pending))
            return r
        setattr(sup, name, wrapped)
    try:
        _serve(fleet, lambda f: len(events) >= LADDER_EVENTS, timeout=300.0)
    finally:
        (jreset if pkg == "jax" else treset)()
    return events[:LADDER_EVENTS], frames_of(fleet), sup.counters


def test_ladder_matches_jax(monkeypatch):
    """The same rungs, degrade levels, fps and service classes tick for
    tick, and equal AUs, with the software rung on the pinned libx264."""
    if not tx264.x264_available():
        pytest.skip("libx264 not loadable")
    _pinned(monkeypatch, "x264")
    jev, jframes, jcount = _ladder_run("jax", monkeypatch)
    tev, tframes, tcount = _ladder_run("port", monkeypatch)
    assert tev == jev
    assert tcount == jcount
    for k in range(2):
        n = min(len(jframes[k]), len(tframes[k]))
        assert n >= LADDER_EVENTS - 24 and tframes[k][:n] == jframes[k][:n]
    rungs = [e[1] for e in tev]
    assert rungs.index("WARN") < rungs.index("FORCE_IDR") < rungs.index("RESTART") \
        < rungs.index("DEGRADE")
    assert [e[2] for e in tev if e[0] == "failure"][-1] == 3
    assert {e[3] for e in tev} == {60, 30, 15} and tev[-1][2:4] == (0, 60)
    classes = [e[4] for e in tev]
    sw = classes.index("SoftwareFleetService")
    assert "TorchMultiSessionH264Service" in classes[sw:] and classes[-1] != classes[sw]
    assert tcount["restarts"] == 1 and tcount["degrades"] == 3 and tcount["undegrades"] == 3


def test_ladder_degraded_software_rung_matches_jax(monkeypatch):
    """Without libx264 (the card machine's case) the software rung serves
    solo tpuh264enc rows in both packages: the same events and AUs."""
    for mod in (jx264, tx264):
        monkeypatch.setattr(mod, "x264_available", lambda: False)
    jev, jframes, _ = _ladder_run("jax", monkeypatch)
    tev, tframes, _ = _ladder_run("port", monkeypatch)
    assert tev == jev
    for k in range(2):
        n = min(len(jframes[k]), len(tframes[k]))
        assert n >= LADDER_EVENTS - 24 and tframes[k][:n] == jframes[k][:n]


# -- 5. per-slot accounting --------------------------------------------------------

def _capture_faults(pkg: str):
    (jconfigure if pkg == "jax" else tconfigure)("capture:1@2-6:raise")
    fleet = make_fleet(pkg, 2, connected=True)
    fleet.CAPTURE_FAILURE_LIMIT = 4
    poisoned = []
    default = fleet.on_slot_poisoned
    fleet.on_slot_poisoned = lambda k: (poisoned.append((k, fleet.ticks)), default(k))
    state = []

    def hook(t):
        fleet.ticks = t  # drive() does not count ticks; the eject stamps them
        state.append((fleet.slots[1].capture_failures, fleet.slots[1].connected,
                      _sha(fleet._batch[1].tobytes())))
    try:
        run = drive(fleet, ticks=8, ops={}, hook=hook)
    finally:
        close(fleet)
        (jreset if pkg == "jax" else treset)()
    return run, state, poisoned, fleet.slots[1].capture_failures


def test_capture_faults_ride_the_previous_frame_and_eject_like_jax():
    j, t = _capture_faults("jax"), _capture_faults("port")
    assert t == j
    run, state, poisoned, failures = t
    # the faulted ticks re-encode slot 1's previous frame: a static repeat
    assert state[2][2] == state[3][2] and poisoned == [(1, 4)] and failures == 0
    assert not state[-1][1]


def _send_drops(pkg: str):
    (jconfigure if pkg == "jax" else tconfigure)("send:0@1-999:drop")
    fleet = make_fleet(pkg, 2, fps=60, connected=True)
    fleet.SEND_FAILURE_LIMIT = 3
    poisoned = []
    default = fleet.on_slot_poisoned
    fleet.on_slot_poisoned = lambda k: (poisoned.append((k, fleet.ticks)), default(k))
    try:
        _serve(fleet, lambda f: len(f.slots[1].ws.frames) >= 5)
    finally:
        (jreset if pkg == "jax" else treset)()
    return (poisoned, fleet.slots[0].connected, fleet.slots[0].send_failures,
            frames_of(fleet)[0], frames_of(fleet)[1][:5], fleet.supervisor.counters["failures"])


def test_send_drops_eject_the_slot_like_jax():
    j, t = _send_drops("jax"), _send_drops("port")
    assert t == j
    poisoned, connected, failures, frames0, _, sup_failures = t
    assert poisoned == [(0, 3)] and not connected and failures == 0
    assert frames0 == [] and sup_failures == 0


def test_wrong_geometry_capture_is_fitted_like_jax():
    out = {}
    for pkg, el in (("jax", jel), ("port", tel)):
        fleet = make_fleet(pkg, 2)
        fleet.sources[1] = el.SyntheticSource(W // 2, H // 2, seed=9)
        fleet.sources[0] = el.SyntheticSource(W + 32, H + 16, seed=7)
        try:
            out[pkg] = (drive(fleet, ticks=2, ops={}), sorted(fleet._geometry_warned),
                        _sha(fleet._batch.tobytes()))
        finally:
            close(fleet)
    assert out["port"] == out["jax"]
    assert out["port"][1] == [0, 1]


def _parked(pkg: str, monkeypatch):
    monkeypatch.setenv("SELKIES_BANDS", "2")
    fleet = make_fleet(pkg, 2, fps=60, connected=True)
    fleet.service.recarve(1, [])  # session 1's chips lent away: parked
    rc = fleet.slots[1].rc
    before = (rc.qp, rc._fullness)
    _serve(fleet, lambda f: len(f.slots[0].ws.frames) >= 4)
    return frames_of(fleet)[0][:4], frames_of(fleet)[1], before, (rc.qp, rc._fullness)


def test_parked_session_skips_its_rate_controller_like_jax(monkeypatch):
    j, t = _parked("jax", monkeypatch), _parked("port", monkeypatch)
    assert t == j
    assert t[1] == [] and t[2] == t[3]


def _restarts(pkg: str):
    fleet = make_fleet(pkg, 2)
    try:
        first = fleet.service
        drive(fleet, ticks=2, ops={})
        fleet._tick_in_flight = True
        fleet._tick_started_at = time.monotonic()
        fleet.restart_service()
        deferred = (fleet._restart_pending, fleet.service is first)
        fleet._tick_started_at = time.monotonic() - fleet.FORCE_RESTART_STALL_S - 1.0
        fleet.restart_service()
        forced = (fleet._restart_pending, fleet.service is first,
                  type(fleet.service).__name__)
        fleet._tick_in_flight = False
        return deferred, (*forced[:2], CLASSES.get(forced[2], forced[2])), drive(
            fleet, ticks=2, ops={})
    finally:
        close(fleet)


def test_restart_is_deferred_then_forced_like_jax():
    """restart_service() with a tick in flight only sets _restart_pending;
    past FORCE_RESTART_STALL_S it rebuilds under the tick. The rebuilt
    service opens with IDRs, as JAX's does."""
    j, t = _restarts("jax"), _restarts("port")
    assert t == j
    assert t[0] == (True, True) and t[1] == (False, False, "TorchMultiSessionH264Service")
    assert all(t[2][0][1])


def test_pending_restart_applies_at_the_next_tick():
    """The loop applies a requested restart before its next capture."""
    fleet = make_fleet("port", 2, fps=60, connected=True)
    first = fleet.service

    async def go():
        await fleet.start()
        try:
            assert await _wait(lambda: fleet.ticks >= 2)
            fleet._restart_pending = True
            assert await _wait(lambda: fleet.service is not first and fleet.ticks >= 4)
            assert not fleet._restart_pending
        finally:
            await fleet.stop()
    asyncio.run(go())
    idrs = [f.idr for f in fleet.slots[0].ws.frames]
    assert idrs[0] and sum(idrs) >= 2


# -- 6. codec negotiation ------------------------------------------------------------

PREFS = [[], ["av1", "h264"], ["vp9"], ["h265", "h264"], ["vp8"], ["bogus", "av1"], ["H264"],
         ["av1"], None]


@pytest.mark.parametrize("carve", [True, False], ids=["per-session", "lockstep"])
@pytest.mark.parametrize("chips", [1, 2, 4])
def test_resolve_matches_jax(chips, carve):
    for prefs in PREFS:
        got = tneg.resolve(prefs, session_chips=chips, per_session_carve=carve)
        want = jneg.resolve(prefs, session_chips=chips, per_session_carve=carve)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), prefs


def test_server_preferences_and_availability_match_jax(monkeypatch):
    for codec in ("h264", "av1", "vp9", "vp8", "h265", "bogus"):
        assert tneg.codec_available(codec) == jneg.codec_available(codec), codec
    for env in ("", "av1, H264", "vp9,,h265"):
        monkeypatch.setenv("SELKIES_CODEC", env)
        assert tneg.server_preferences() == jneg.server_preferences()
        got = tneg.resolve([], session_chips=2)
        assert dataclasses.asdict(got) == dataclasses.asdict(jneg.resolve([], session_chips=2))
    monkeypatch.setenv("SELKIES_TILE_COLS", "1")
    assert dataclasses.asdict(tneg.resolve(["av1"], session_chips=4)) == \
        dataclasses.asdict(jneg.resolve(["av1"], session_chips=4))


def _negotiated(pkg: str, monkeypatch):
    monkeypatch.setenv("SELKIES_BANDS", "2")
    # JAX's shared carve (one chip for both sessions), as the port's one
    # device gives: the AV1 session's column budget is one chip in both
    fleet = make_fleet(pkg, 2, jax_devices=jax.devices()[:1])
    try:
        run = drive(fleet, ticks=2, ops={})
        n = fleet.negotiate_session(1, ["av1", "h264"])
        run += drive(fleet, ticks=3, ops={})
        return (dataclasses.asdict(n), fleet.session_codec(1), fleet.placer.codec(1),
                fleet.placer.shared, run)
    finally:
        close(fleet)


def test_negotiate_session_rebuilds_as_av1_like_jax(monkeypatch):
    if not tneg.codec_available("av1"):
        pytest.skip("libaom not loadable")
    j, t = _negotiated("jax", monkeypatch), _negotiated("port", monkeypatch)
    assert t == j
    assert t[0]["codec"] == "av1" and t[1] == t[2] == "av1" and t[3]
    # session 1's rebuilt AV1 encoder opens with a keyframe; session 0 rides on
    assert t[4][2][1] == [False, True] and t[4][3][1] == [False, False]


def test_negotiate_on_the_batch_fleet_stays_h264_like_jax():
    out = {}
    for pkg in ("jax", "port"):
        fleet = make_fleet(pkg, 2)
        try:
            out[pkg] = dataclasses.asdict(fleet.negotiate_session(0, ["av1", "h264"]))
        finally:
            close(fleet)
    assert out["port"] == out["jax"] and out["port"]["codec"] == "h264"


# -- 7. checkpoints carried across ---------------------------------------------------

HANDOFF = 3


def _continued(pkg: str):
    """A fleet ticked HANDOFF times, checkpointed, then carried on with a
    keyframe forced on every session (the recovery IDR a restore opens
    with) -> (checkpoint JSON, the later ticks)."""
    fleet = make_fleet(pkg, 2, connected=True)
    try:
        drive(fleet, ticks=HANDOFF, ops={})
        cks = [ck.to_json() for ck in fleet.checkpoint_all()]
        for k in range(2):
            fleet.force_keyframe(k)
        return cks, drive(fleet, ticks=3, ops={})
    finally:
        close(fleet)


def _restored(cks: list[str]):
    """The port's fresh fleet, its sources advanced past the hand-off,
    restored from ``cks`` -> its ticks."""
    fleet = make_fleet("port", 2, connected=True)
    try:
        for src in fleet.sources:
            for _ in range(HANDOFF):
                src.capture()
        for blob in cks:
            ck = SessionCheckpoint.from_json(blob)
            restore_session(ck, fleet.service, slot=fleet.slots[ck.session])
        return drive(fleet, ticks=3, ops={})
    finally:
        close(fleet)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_checkpoint_restores_into_the_port_fleet(source):
    cks, want = _continued(source)
    assert len(cks) == 2 and json.loads(cks[0])["idr_pic_id"] >= 0
    got = _restored(cks)
    assert got == want
    if source == "port":
        jcks, jwant = _continued("jax")
        assert want == jwant
        assert [_state(c) for c in cks] == [_state(c) for c in jcks]


def _state(blob: str) -> dict:
    """A checkpoint's fields but its wall-clock stamp."""
    return {k: v for k, v in json.loads(blob).items() if k != "wall_time"}


def test_checkpoint_all_skips_unconnected_slots():
    fleet = make_fleet("port", 2)
    try:
        fleet.slots[1].connected = True
        assert [ck.session for ck in fleet.checkpoint_all()] == [1]
    finally:
        close(fleet)


# -- 8. the policy and SLO planes ------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _planes(pkg: str, monkeypatch):
    """The banded fleet with SELKIES_POLICY=1 and SELKIES_SLO=1: each tick
    runs the policy inside _encode_tick, then the SLO intake as _run does,
    with a scripted latency (a burst on session 0) on a fake clock."""
    for k, v in (("SELKIES_BANDS", "2"), ("SELKIES_POLICY", "1"), ("SELKIES_SLO", "1")):
        monkeypatch.setenv(k, v)
    fleet = make_fleet(pkg, 2, connected=True)
    clock = FakeClock()
    # latency and bytes only: the fps floor needs whole seconds of frames in
    # its window, more ticks than a CPU test takes
    targets = (jslo if pkg == "jax" else tslo).SLOTargets(fps_floor=0.0)
    for slo in fleet.slos:
        slo._targets_map = {"unknown": targets}
        slo.targets = targets
        slo.clock = clock
        slo.fast_s, slo.slow_s, slo.eval_interval_s = 1.0, 60.0, 0.2
        slo.min_frames, slo.recovery_evals = 4, 1
    views = []

    def lat(t, k):
        return 900.0 if k == 0 and 8 <= t < 14 else 5.0

    def hook(t):
        if t == 0:
            return
        clock.t += 0.08
        for k, slo in enumerate(fleet.slos):
            slo.observe_frame(lat(t, k), 1000 + t, fid=t)
            slo.evaluate()
        views.append((t, [s.rc.bitrate_kbps for s in fleet.slots], dict(fleet._slo_shed_kbps),
                      [s.rc.qp for s in fleet.slots]))
    try:
        run = drive(fleet, ticks=34, ops={}, hook=hook)
        return (run, views, fleet._policy_rollup(), fleet._slo_rollup(),
                fleet._slo_health(), fleet.supervisor.stats())
    finally:
        close(fleet)


def test_policy_and_slo_planes_match_jax(monkeypatch):
    j, t = _planes("jax", monkeypatch), _planes("port", monkeypatch)
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert t[2] == j[2] and t[3] == j[3] and t[4] == j[4] and t[5] == j[5]
    views = t[1]
    shed = [v for v in views if v[2]]
    # session 0's burst shed its bitrate (2000 -> 1000), relief restored it
    assert shed and shed[0][1][0] == 1000 and views[-1][1] == [2000, 2000]
    assert t[2]["0"]["frames"] > 0 and t[3]["0"]["breaches"] >= 1


# -- 10. device and imports ------------------------------------------------------------

def test_devices_none_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    reset_device_pool()
    slots = [tfleet.SessionSlot(k, bitrate_kbps=2000, fps=30, ws=FakeTransport()) for k in range(2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet.SessionFleet(slots, width=W, height=H, fps=30)


def test_dryrun_on_cpu_devices():
    tfleet.dryrun(4, devices=[CPU])


def test_slot_planes_default_and_absent_peer():
    from selkies_tpu_torch.orchestrator import AbsentPeerPlane
    from selkies_tpu_torch.transport.websocket import WebSocketTransport

    slot = tfleet.SessionSlot(3, bitrate_kbps=1000, fps=30, codec="av1")
    assert isinstance(slot.ws, WebSocketTransport) and slot.ws.session == "3"
    assert isinstance(slot.webrtc, AbsentPeerPlane) and slot.webrtc.codec == "av1"
    assert slot.transport.active is slot.ws and slot.transport.fault_site == "send:3"
    assert not slot.transport.data_channel_ready
    assert slot.transport.frames_sent == slot.transport.bytes_sent == 0
    with pytest.raises(NotImplementedError, match="queue 1"):
        slot.transport.set_remote_sdp("offer", "v=0")
    with pytest.raises(NotImplementedError, match="queue 1"):
        slot.transport.add_remote_ice(0, "candidate:1")
    # the control vocabulary reaches the WS plane when it is ready
    rec = FakeTransport()
    slot = tfleet.SessionSlot(0, bitrate_kbps=1000, fps=30, ws=rec)
    slot.send_codec("h264")
    slot.send_latency_time(12.5)
    jslot = jfleet.SessionSlot(0, bitrate_kbps=1000, fps=30)
    jslot.transport.ws = jrec = FakeTransport()
    jslot.send_codec("h264")
    jslot.send_latency_time(12.5)
    assert rec.messages == jrec.messages and len(rec.messages) == 2
    assert (tfleet.browser_peer_id(3), tfleet.server_client_id(3)) == \
        (jfleet.browser_peer_id(3), jfleet.server_client_id(3))


def test_fleet_module_imports_without_aiohttp():
    import subprocess
    import sys

    code = ("import sys; sys.modules['aiohttp'] = None\n"
            "import selkies_tpu_torch.parallel.fleet as f\n"
            "import torch\n"
            "class P:\n"
            "    session = '0'; frames_sent = bytes_sent = 0; data_channel_ready = False\n"
            "s = f.SessionSlot(0, bitrate_kbps=1000, fps=30, ws=P())\n"
            "print(type(s.webrtc).__name__)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "AbsentPeerPlane", proc.stderr


def test_host_scan_sees_the_new_modules():
    from test_torch_host import REPO, _port_sources

    seen = {str(p.relative_to(REPO)) for p in _port_sources()}
    for rel in ("config.py", "orchestrator.py", "parallel/fleet.py", "signalling/__init__.py",
                "signalling/negotiate.py", "transport/__init__.py", "transport/congestion.py",
                "transport/recovery.py", "transport/websocket.py"):
        assert f"selkies_tpu_torch/{rel}" in seen, rel
