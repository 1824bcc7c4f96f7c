"""The occupancy scheduler in the port (selkies_tpu_torch/parallel/
occupancy.py) against the port's serial tick and JAX's scheduler: per
session sha256 over a trace of IDR, P and static frames for the banded
service, the batch unit and mixed tenancy; a wedged session; the
``sched:<k>`` drop and raise semantics beside JAX's under the same spec;
a failed dispatch; ``for_service`` shapes, the env switch, the stats and
telemetry, and the banded encoder's in-flight guard (the ported forms of
tests/test_occupancy.py).
"""

from __future__ import annotations

import functools
import hashlib
import threading

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.monitoring.telemetry import telemetry as jtelemetry
from selkies_tpu.parallel.occupancy import MixedTenancyService as JaxMixed
from selkies_tpu.parallel.occupancy import OccupancyScheduler as JaxScheduler
from selkies_tpu.parallel.serving import BandedFleetService, MultiSessionH264Service
from selkies_tpu.resilience import configure_faults as jax_configure
from selkies_tpu.resilience import reset_faults as jax_reset
from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
from selkies_tpu_torch.parallel.occupancy import (
    BatchPipeline,
    MixedTenancyService,
    OccupancyScheduler,
    SessionPipeline,
    occupancy_enabled,
)
from selkies_tpu_torch.parallel.serving import (
    TorchBandedFleetService,
    TorchMultiSessionH264Service,
)
from selkies_tpu_torch.resilience import configure_faults, reset_faults

W, H = 192, 128  # tests/test_occupancy.py's geometry
CPU = torch.device("cpu")
_ENV = ("SELKIES_FRONTEND_WORKERS", "SELKIES_PARALLEL_FRONTEND", "SELKIES_DAMAGE_FULL_SCAN",
        "SELKIES_BANDS", "SELKIES_TILE_GRID", "SELKIES_ENTROPY_CODER",
        "SELKIES_DEVICE_ENTROPY", "SELKIES_FAULTS", "SELKIES_OCCUPANCY")


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    reset_faults()
    jax_reset()


def _traces(n: int, frames: int, seed: int = 3) -> list[list[np.ndarray]]:
    """tests/test_occupancy.py's traces: each session rewrites a 16-row
    band on its own cadence and repeats a frame in between (IDR, P and the
    static short-circuit)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        cur = np.full((H, W, 4), 150 + 17 * s, np.uint8)
        frs = []
        for t in range(frames):
            if (t + s) % 3 != 2:
                cur = cur.copy()
                row = 16 * ((t + 2 * s) % (H // 16))
                cur[row:row + 16] = rng.integers(0, 255, (16, W, 4), np.uint8)
            frs.append(cur)
        out.append(frs)
    return out


def _drive(tick, traces, ticks=None):
    n, frames = len(traces), len(traces[0])
    streams = [[] for _ in range(n)]
    for t in ticks if ticks is not None else range(frames):
        aus = tick(np.stack([tr[t] for tr in traces]))
        for s in range(n):
            streams[s].append(aus[s])
    return streams


def _sha(stream: list[bytes]) -> str:
    return hashlib.sha256(b"".join(stream)).hexdigest()


def _banded(n: int, bands: int = 1):
    return TorchBandedFleetService(n, W, H, bands=bands, rows=[[CPU] * bands] * n)


# -- byte identity ----------------------------------------------------------------

N3, F6 = 3, 6


@functools.lru_cache(maxsize=None)
def scheduled_banded():
    svc = _banded(N3)
    sched = OccupancyScheduler.for_service(svc)
    try:
        got = _drive(sched.encode_tick, _traces(N3, F6))
        return [_sha(s) for s in got], list(svc.last_idrs), list(svc.last_modes), sched.stats()
    finally:
        sched.close()
        svc.close()


@functools.lru_cache(maxsize=None)
def serial_banded():
    svc = _banded(N3)
    try:
        got = _drive(svc.encode_tick, _traces(N3, F6))
        return [_sha(s) for s in got], list(svc.last_idrs), list(svc.last_modes)
    finally:
        svc.close()


@functools.lru_cache(maxsize=None)
def jax_scheduled_banded():
    svc = BandedFleetService(N3, W, H, bands=1)
    sched = JaxScheduler.for_service(svc)
    try:
        got = _drive(sched.encode_tick, _traces(N3, F6))
        return [_sha(s) for s in got], list(svc.last_idrs), list(svc.last_modes)
    finally:
        sched.close()
        svc.close()


@pytest.mark.parametrize("session", range(N3))
def test_overlap_streams_equal_serial_and_jax(session):
    got, want, jax_got = scheduled_banded(), serial_banded(), jax_scheduled_banded()
    assert got[0][session] == want[0][session] == jax_got[0][session]


def test_overlap_bookkeeping_and_stats():
    got, want, jax_got = scheduled_banded(), serial_banded(), jax_scheduled_banded()
    assert got[1:3] == want[1:] == jax_got[1:]
    st = got[3]
    assert st["ticks"] == F6 and st["units"] == N3 and st["sessions"] == N3
    assert 0.0 <= st["overlap_ratio"] < 1.0 and 0.0 <= st["last_overlap"] < 1.0
    assert set(st["sched_wait_ms"]) == {str(s) for s in range(N3)}
    assert st["errors"] == {} and st["enabled"]


@functools.lru_cache(maxsize=None)
def batch_runs():
    """The lockstep batch service as one unit, its serial tick, and JAX's
    service (its scheduled run is slow-marked in tests/test_occupancy.py;
    its serial tick is the same bytes)."""
    traces = _traces(2, F6, seed=9)
    svc = TorchMultiSessionH264Service(2, W, H, qp=26, device="cpu")
    sched = OccupancyScheduler.for_service(svc)
    try:
        got = [_sha(s) for s in _drive(sched.encode_tick, traces)]
        units = [type(u) for u in sched.units]
    finally:
        sched.close()
        svc.close()
    oracle = TorchMultiSessionH264Service(2, W, H, qp=26, device="cpu")
    try:
        want = [_sha(s) for s in _drive(oracle.encode_tick, traces)]
    finally:
        oracle.close()
    jsvc = MultiSessionH264Service(2, W, H, qp=26, devices=jax.devices()[:2])
    try:
        jwant = [_sha(s) for s in _drive(jsvc.encode_tick, traces)]
    finally:
        jsvc.close()
    return got, want, jwant, units


@pytest.mark.parametrize("session", range(2))
def test_batch_unit_equals_serial_lockstep(session):
    got, want, jwant, units = batch_runs()
    assert units == [BatchPipeline]
    assert got[session] == want[session] == jwant[session]


def _mixed_port(on: bool, monkeypatch):
    monkeypatch.setenv("SELKIES_OCCUPANCY", "1" if on else "0")
    batch = TorchMultiSessionH264Service(1, W, H, qp=26, device="cpu")
    svc = MixedTenancyService(batch, TorchBandedFleetService(1, W, H, bands=1, rows=[[CPU]]))
    try:
        got = _drive(svc.encode_tick, _traces(2, 5, seed=5))
        assert (svc.scheduler() is not None) == on
        return [_sha(s) for s in got], list(svc.last_idrs), list(svc.last_modes)
    finally:
        svc.close()


def test_mixed_tenancy_on_one_device_matches_serial_and_jax(monkeypatch):
    """Banded + batch sessions sharing one device's timeline: the
    scheduled and the SELKIES_OCCUPANCY=0 runs give the same bytes, and
    JAX's mixed tenancy on one device the same again."""
    on = _mixed_port(True, monkeypatch)
    off = _mixed_port(False, monkeypatch)
    monkeypatch.setenv("SELKIES_OCCUPANCY", "1")
    dev = jax.devices()[0]
    jsvc = JaxMixed(MultiSessionH264Service(1, W, H, qp=26, devices=[dev]),
                    BandedFleetService(1, W, H, bands=1, rows=[[dev]]))
    try:
        jgot = [_sha(s) for s in _drive(jsvc.encode_tick, _traces(2, 5, seed=5))]
        jbook = (list(jsvc.last_idrs), list(jsvc.last_modes))
    finally:
        jsvc.close()
    assert on == off
    assert on[0] == jgot and on[1:] == jbook
    assert len(on[1]) == 2 and len(on[2]) == 2


def test_mixed_tenancy_routes_per_session_knobs():
    batch = TorchMultiSessionH264Service(2, W, H, qp=26, device="cpu")
    banded = TorchBandedFleetService(1, W, H, bands=1, rows=[[CPU]])
    svc = MixedTenancyService(batch, banded)
    try:
        assert svc.n == 3
        svc.set_qp(1, 33)
        svc.set_qp(2, 31)
        svc.force_keyframe(2)
        assert batch.sessions[1].qp == 33 and banded.encoders[0].qp == 31
        assert banded.encoders[0]._force_idr
        assert [type(u) for u in svc.units()] == [BatchPipeline, SessionPipeline]
        with pytest.raises(ValueError):
            svc.encode_tick(np.zeros((2, H, W, 4), np.uint8))
    finally:
        svc.close()


# -- isolation ----------------------------------------------------------------


def test_wedged_session_does_not_stall_others():
    """Session 0's completion wedges mid-tick; session 1's completion must
    still run to the end while 0 is stuck. 0 is released only after 1
    finished, so a scheduler that serialised completions behind the wedge
    would time out."""
    traces = _traces(2, 3, seed=7)
    svc = _banded(2)
    sched = OccupancyScheduler.for_service(svc)
    try:
        _drive(sched.encode_tick, traces, ticks=range(2))  # warm
        done1 = threading.Event()
        enc0, enc1 = svc.encoders[0], svc.encoders[1]
        orig0, orig1 = enc0.complete_frame, enc1.complete_frame

        def wedged(pending):
            assert done1.wait(timeout=30), \
                "session 1 never completed while session 0 was wedged"
            return orig0(pending)

        def observed(pending):
            out = orig1(pending)
            done1.set()
            return out

        enc0.complete_frame = wedged
        enc1.complete_frame = observed
        aus = sched.encode_tick(np.stack([tr[2] for tr in traces]))
        assert done1.is_set()
        assert aus[0] and aus[1]  # the wedged frame still delivered
    finally:
        sched.close()
        svc.close()


def _sched_run(pkg: str, spec: str, seed: int, frames: int = 4):
    """Drive 2 banded sessions through each package's scheduler under
    ``spec`` (in that package's own injector): per tick the AUs, or the
    exception type's name."""
    traces = _traces(2, frames, seed=seed)
    if pkg == "jax":
        fi = jax_configure(spec)
        svc = BandedFleetService(2, W, H, bands=1, rows=[[d] for d in jax.devices()[:2]])
        sched = JaxScheduler.for_service(svc)
    else:
        fi = configure_faults(spec)
        svc = _banded(2)
        sched = OccupancyScheduler.for_service(svc)
    out = []
    try:
        for t in range(frames):
            try:
                out.append([_sha([a]) for a in sched.encode_tick(
                    np.stack([tr[t] for tr in traces]))])
            except Exception as exc:  # noqa: BLE001 — recorded for comparison
                out.append(type(exc).__name__)
                out.append(sorted(sched.stats()["errors"]))
        return out, [tuple(x) for x in fi.injected]
    finally:
        sched.close()
        svc.close()
        reset_faults()
        jax_reset()


def _oracle(seed: int, session: int, ticks, frames: int = 4):
    """One session's solo stream over the given ticks of the trace."""
    traces = _traces(2, frames, seed=seed)
    svc = _banded(1)
    try:
        return [_sha(svc.encode_tick(traces[session][t][None])) for t in ticks]
    finally:
        svc.close()


def test_sched_drop_matches_jax_and_keeps_streams_in_order():
    """sched:0@2:drop: session 0's second frame is never encoded (an empty
    AU), its later frames equal an oracle that never saw it, session 1 is
    untouched; JAX's scheduler under the same spec gives the same."""
    got, injected = _sched_run("torch", "sched:0@2:drop", seed=11)
    want, jinjected = _sched_run("jax", "sched:0@2:drop", seed=11)
    assert got == want and injected == jinjected == [("sched:0", 2, "drop")]
    assert got[1][0] == _sha([b""])
    assert [got[t][0] for t in (0, 2, 3)] == _oracle(11, 0, (0, 2, 3))
    assert [got[t][1] for t in range(4)] == _oracle(11, 1, range(4))


def test_sched_raise_matches_jax_with_serial_failure_semantics():
    """sched:1@2:raise: the tick re-raises InjectedFault after session 0's
    stages ran (its GOP advanced), the error shows in stats, and both
    streams line up with their oracles afterwards; as JAX's."""
    got, injected = _sched_run("torch", "sched:1@2:raise", seed=13)
    want, jinjected = _sched_run("jax", "sched:1@2:raise", seed=13)
    assert got == want and injected == jinjected
    assert got[1:3] == ["InjectedFault", ["1"]]
    ticks = [got[0], got[3], got[4]]
    all0 = _oracle(13, 0, range(4))
    assert [t[0] for t in ticks] == [all0[0], all0[2], all0[3]]
    assert [t[1] for t in ticks] == _oracle(13, 1, (0, 2, 3))


def test_sched_delay_wedges_only_its_lane():
    got, injected = _sched_run("torch", "sched:0@2:delay:30", seed=14)
    want, _ = _sched_run("torch", "sched:0@99:drop", seed=14)
    assert got == want and injected == [("sched:0", 2, "delay")]


def test_failed_dispatch_finishes_the_others_then_raises():
    """A dispatch that raises (not injected): the other session's stages
    still run, and the first error re-raises after the tick."""
    traces = _traces(2, 3, seed=15)
    svc = _banded(2)
    sched = OccupancyScheduler.for_service(svc)
    try:
        first = sched.encode_tick(np.stack([tr[0] for tr in traces]))
        enc0 = svc.encoders[0]
        orig = enc0.dispatch_frame

        def boom(frame):
            enc0.dispatch_frame = orig
            raise RuntimeError("dispatch failed")

        enc0.dispatch_frame = boom
        with pytest.raises(RuntimeError, match="dispatch failed"):
            sched.encode_tick(np.stack([tr[1] for tr in traces]))
        assert list(sched.stats()["errors"]) == ["0"]
        third = sched.encode_tick(np.stack([tr[2] for tr in traces]))
    finally:
        sched.close()
        svc.close()
    assert [_sha([a]) for a in (first[1], third[1])] == [
        _oracle(15, 1, (0,), frames=3)[0], _oracle(15, 1, range(3), frames=3)[2]]


# -- shapes, knobs, telemetry --------------------------------------------------------


def test_for_service_shapes():
    svc = _banded(2)
    batch = TorchMultiSessionH264Service(1, W, H, device="cpu")
    mixed = MixedTenancyService(TorchMultiSessionH264Service(1, W, H, device="cpu"), _banded(1))
    try:
        s1 = OccupancyScheduler.for_service(svc)
        s2 = OccupancyScheduler.for_service(batch)
        s3 = OccupancyScheduler.for_service(mixed)
        assert [type(u) for u in s1.units] == [SessionPipeline, SessionPipeline]
        assert [u.sessions for u in s1.units] == [[0], [1]]
        assert [type(u) for u in s2.units] == [BatchPipeline]
        assert [u.sessions for u in s3.units] == [[0], [1]]
        for s in (s1, s2, s3):
            s.close()

        class SerialOnly:  # encode_tick only: nothing to overlap
            n = 1

            def encode_tick(self, frames):
                return [b""]

        assert OccupancyScheduler.for_service(SerialOnly()) is None
        assert OccupancyScheduler.for_service(object()) is None
        with pytest.raises(ValueError, match="units cover"):
            OccupancyScheduler([SessionPipeline(svc, 0)], 2)
        with pytest.raises(ValueError, match="batch unit covers"):
            BatchPipeline(batch, [0, 1])
    finally:
        svc.close()
        batch.close()
        mixed.close()


@pytest.mark.parametrize("value,on", [(None, True), ("1", True), ("on", True), ("0", False),
                                      ("false", False), ("OFF", False), ("no", False)])
def test_occupancy_env_switch(monkeypatch, value, on):
    from selkies_tpu.parallel.occupancy import occupancy_enabled as jax_enabled

    if value is None:
        monkeypatch.delenv("SELKIES_OCCUPANCY", raising=False)
    else:
        monkeypatch.setenv("SELKIES_OCCUPANCY", value)
    assert occupancy_enabled() is on is jax_enabled()


def test_dispatch_inflight_guard():
    """The banded encoder holds at most one frame in flight: a second
    dispatch before complete_frame raises; the guard clears after."""
    enc = TorchBandedH264Encoder(W, H, qp=28, bands=1, device="cpu")
    try:
        frame = np.full((H, W, 4), 128, np.uint8)
        pending = enc.dispatch_frame(frame)
        with pytest.raises(RuntimeError, match="in flight"):
            enc.dispatch_frame(frame)
        enc.complete_frame(pending)
        enc.complete_frame(enc.dispatch_frame(frame))
    finally:
        enc.close()


def test_scheduler_telemetry_as_jax():
    """With telemetry on, a tick sets the overlap gauge and records a
    sched_wait stage per session, in both packages."""
    def fams(tel):
        return ({fam for (fam, _) in tel._gauges},
                {lbl for (fam, lbl) in tel._hists if fam == "selkies_stage_ms"})

    out = []
    for tel, make, sched_cls in (
            (telemetry, lambda: _banded(2), OccupancyScheduler),
            (jtelemetry, lambda: BandedFleetService(2, W, H, bands=1,
                                                    rows=[[d] for d in jax.devices()[:2]]),
             JaxScheduler)):
        tel.reset()
        tel.enabled = True
        svc = make()
        sched = sched_cls.for_service(svc)
        try:
            sched.encode_tick(np.stack([tr[0] for tr in _traces(2, 1)]))
            gauges, stages = fams(tel)
            out.append(("selkies_occupancy_overlap_ratio" in gauges,
                        sorted(str(s) for s in stages if "sched_wait" in str(s))))
        finally:
            sched.close()
            svc.close()
            tel.enabled = False
            tel.reset()
    assert out[0] == out[1] and out[0][0] and len(out[0][1]) == 2
