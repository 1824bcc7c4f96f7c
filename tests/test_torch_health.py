"""The port's device health plane and fault injector against JAX's.

``selkies_tpu_torch/resilience/`` (``faultinject.py``, ``devhealth.py``)
against ``selkies_tpu/resilience/``: the same spec strings and the same
call sequences give the same raises, actions, pool transitions, stats and
ticks (the pool machine follows tests/test_device_faults.py). Then the
port's own parts: ``chip_key`` and the probe over torch devices, the CUDA
error shapes, the pool's enumeration, the banded encoder's carve through
the pool and the session device, and the ``device:<chip>`` site on the
banded encoder and the session service, each against its JAX class under
the same spec (AUs by sha256).

Each package's injector and pool are process-wide singletons of their
own: the fixtures reset both packages' after every test.
"""

from __future__ import annotations

import hashlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.parallel.bands import BandedH264Encoder
from selkies_tpu.parallel.serving import MultiSessionH264Service
from selkies_tpu.resilience import devhealth as jdh
from selkies_tpu.resilience import faultinject as jfi
from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
from selkies_tpu_torch.parallel.serving import TorchMultiSessionH264Service
from selkies_tpu_torch.parallel.sessions import TorchMultiSessionEncoder
from selkies_tpu_torch.resilience import devhealth as tdh
from selkies_tpu_torch.resilience import faultinject as tfi

CPU = torch.device("cpu")
JAX = SimpleNamespace(dh=jdh, fi=jfi)
PORT = SimpleNamespace(dh=tdh, fi=tfi)
PACKAGES = [JAX, PORT]


@pytest.fixture(autouse=True)
def _reset_singletons(monkeypatch):
    """Both packages' injectors and pools start and end unset; the env
    knobs the pool reads are cleared; one torch intra-op thread."""
    for k in ("SELKIES_FAULTS", "SELKIES_DEVICE_FAIL_THRESHOLD", "SELKIES_DEVICE_PROBATION_S",
              "SELKIES_BANDS", "SELKIES_TILE_GRID", "SELKIES_FRONTEND_WORKERS",
              "SELKIES_PARALLEL_FRONTEND", "SELKIES_DAMAGE_FULL_SCAN", "SELKIES_ENTROPY_CODER",
              "SELKIES_DEVICE_ENTROPY", "SELKIES_PACK_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for p in PACKAGES:
        p.fi.reset_faults()
        p.dh.reset_device_pool()
    yield
    for p in PACKAGES:
        p.fi.reset_faults()
        p.dh.reset_device_pool()
    torch.set_num_threads(threads)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def chips(n=8):
    return [f"chip{i}" for i in range(n)]


# -- the pool machine: one scenario, both packages ---------------------------

def _threshold_and_streak_reset(m):
    p = m.dh.DevicePool(devices=chips(3), fail_threshold=3, probation_s=10, clock=_Clock())
    out = [p.note_failure("chip1"), p.note_failure("chip1")]
    p.note_ok("chip1")
    out += [p.note_failure("chip1"), p.note_failure("chip1"), p.note_failure("chip1")]
    out += [p.is_quarantined("chip1"), p.healthy_devices(), p.quarantined_keys(),
            p.note_failure("chip1"), p.has_quarantined()]
    return out


def _stale_streak_restarts(m):
    clk = _Clock()
    p = m.dh.DevicePool(devices=chips(2), fail_threshold=2, probation_s=10, clock=clk)
    out = [p.note_failure("chip0")]
    clk.t += 100.0
    out += [p.note_failure("chip0"), p.is_quarantined("chip0"), p.note_failure("chip0")]
    return out


def _probation_backoff_and_readmit(m):
    clk = _Clock()
    probes = []

    def probe(dev):
        probes.append(dev)
        return True

    p = m.dh.DevicePool(devices=chips(2), fail_threshold=1, probation_s=10, readmit_after=3,
                        clock=clk, probe=probe)
    out = [p.note_failure("chip0"), p.tick(), list(probes)]
    clk.t += 11.0
    out += [p.tick(), list(probes), p.tick(), p.tick(), p.healthy_devices()]
    out += [p.quarantine("chip0"), p.stats()]
    for _ in range(6):
        p.readmit("chip0")
        p.quarantine("chip0")
    out += [p.stats(), p.health_view()]
    return out


def _failed_probe_extends_probation(m):
    clk = _Clock()
    p = m.dh.DevicePool(devices=chips(1), fail_threshold=1, probation_s=10, readmit_after=1,
                        clock=clk, probe=lambda d: False)
    out = [p.note_failure("chip0")]
    clk.t += 11.0
    out += [p.tick(), p.stats(), p.is_quarantined("chip0")]
    clk.t += 21.0
    out += [p.tick(), p.stats()]
    return out


def _unknown_chips_lazily(m):
    p = m.dh.DevicePool(devices=chips(2), fail_threshold=1, probation_s=5, clock=_Clock())
    return [p.note_failure("ghost"), p.is_quarantined("ghost"), p.healthy_devices(),
            p.stats(), p.health_view(), p.readmit("ghost"), p.readmit("ghost")]


def _fault_site_kill_wedge_flap(m):
    pool = m.dh.set_device_pool(m.dh.DevicePool(devices=["c1", "c2", "c3"], fail_threshold=3,
                                                probation_s=10, clock=_Clock()))
    m.fi.configure_faults("device:c1@2:raise;device:c2@1,2:flap;device:c3@1:delay:30")
    t0 = time.perf_counter()
    m.dh.check_device_faults(["c1", "c2", "c3"])
    out = [time.perf_counter() - t0 >= 0.025, pool.stats()["failures"]]
    with pytest.raises(m.dh.DeviceFault) as ei:
        m.dh.check_device_faults(["c1", "c2", "c3"])
    wrapped = RuntimeError("tick failed")
    wrapped.__cause__ = ei.value
    out += [ei.value.chip, type(ei.value.__cause__).__name__, pool.is_quarantined("c2"),
            pool.attribute(wrapped), pool.attribute(RuntimeError("host bug")),
            m.fi.get_injector().injected]
    return out


def _drop_and_flap_quarantine(m):
    pool = m.dh.set_device_pool(m.dh.DevicePool(devices=["d0", "d1"], fail_threshold=2,
                                                probation_s=10, clock=_Clock()))
    m.fi.configure_faults("device:d0@every:1:flap;device:d1@2:drop")
    out = []
    for _ in range(3):
        try:
            m.dh.check_device_faults(["d0", "d1"])
            out.append(None)
        except m.dh.DeviceFault as e:
            out.append((e.chip, str(e)))
    out += [pool.quarantined_keys(), pool.stats()["failures"],
            m.fi.get_injector().tick_of("device:d0"), m.fi.get_injector().tick_of("device:d1")]
    return out


def _probe_consults_fault_site(m):
    clk = _Clock()
    p = m.dh.DevicePool(devices=["c9"], fail_threshold=1, probation_s=10, readmit_after=1,
                        clock=clk)
    m.fi.configure_faults("device:c9@1:raise")
    out = [p.note_failure("c9")]
    clk.t += 11.0
    out.append(p.tick())
    clk.t += 21.0
    out.append(p.tick())
    return out


def _note_tick_failure(m):
    m.dh.set_device_pool(m.dh.DevicePool(devices=["c0", "c1"], fail_threshold=2,
                                         probation_s=10, clock=_Clock()))
    m.fi.configure_faults("device:c1@1-2:raise")
    out = [m.dh.note_tick_failure(ValueError("host"), ["c0", "c1"])]
    for _ in range(2):
        try:
            m.dh.check_device_faults(["c0", "c1"])
        except m.dh.DeviceFault as e:
            chained = RuntimeError("tick")
            chained.__context__ = e
            out += [m.dh.fault_chip(chained), m.dh.note_tick_failure(chained, ["c0", "c1"])]
    out.append(m.dh.get_device_pool().quarantined_keys())
    return out


POOL_CASES = {
    "threshold_and_streak_reset": _threshold_and_streak_reset,
    "stale_streak_restarts": _stale_streak_restarts,
    "probation_backoff_and_readmit": _probation_backoff_and_readmit,
    "failed_probe_extends_probation": _failed_probe_extends_probation,
    "unknown_chips_lazily": _unknown_chips_lazily,
    "fault_site_kill_wedge_flap": _fault_site_kill_wedge_flap,
    "drop_and_flap_quarantine": _drop_and_flap_quarantine,
    "probe_consults_fault_site": _probe_consults_fault_site,
    "note_tick_failure": _note_tick_failure,
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_machine_matches_jax(case):
    got = POOL_CASES[case](PORT)
    tfi.reset_faults()
    tdh.reset_device_pool()
    want = POOL_CASES[case](JAX)
    assert got == want


def test_pool_machine_spot_values():
    """A few of the transitions above, stated outright."""
    assert _threshold_and_streak_reset(PORT)[4:8] == [True, True, ["chip0", "chip2"], ["chip1"]]
    st = _probation_backoff_and_readmit(PORT)
    assert st[3:6] == [[], ["chip0"], []] and st[6] == ["chip0"]
    assert st[9]["quarantined"]["chip0"]["probation_s"] == 20.0  # doubled
    assert st[10]["quarantined"]["chip0"]["probation_s"] == 80.0  # capped at 8x
    assert _probe_consults_fault_site(PORT) == [True, [], ["c9"]]
    assert _note_tick_failure(PORT)[-1] == ["c1"]


def test_env_knobs_match_jax(monkeypatch):
    for thr, prob in (("5", "2.5"), ("junk", "junk"), ("0", "0.01"), ("", "")):
        monkeypatch.setenv("SELKIES_DEVICE_FAIL_THRESHOLD", thr)
        monkeypatch.setenv("SELKIES_DEVICE_PROBATION_S", prob)
        assert tdh.fail_threshold_from_env() == jdh.fail_threshold_from_env()
        assert tdh.probation_from_env() == jdh.probation_from_env()
    pool = tdh.DevicePool(devices=[CPU])
    assert (pool.fail_threshold, pool.probation_s) == (3, 30.0)


# -- the fault grammar and schedules ------------------------------------------

SPECS = [
    "encoder@5,9,13:raise",
    "send@20-24:drop",
    "signalling@2:flap",
    "capture@p:0.01,seed:7:raise",
    "net:loss@p:0.05,seed:3:drop",
    "frontend@4,9:raise",
    "device:0@every:3:flap;device@2-4:delay:1.5",
    "device:chip3@5:raise;device@every:2:flap",
    " frontend@1:raise ; ; send@2:drop ",
]
BAD_SPECS = ["nope", "x@1:explode", "x@:raise", "x@3-1:raise", "x@every:0:raise",
             "x@p:2:raise", "x@1:delay", "x@1:raise:3", "x@p:abc:raise"]


def _rules(fi, spec):
    return [(r.site, r.action, r.delay_ms, sorted(r.ticks), r.ranges, r.every, r.prob)
            for r in fi.parse_faults(spec)]


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_matches_jax(spec):
    assert _rules(tfi, spec) == _rules(jfi, spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_spec_raises_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jfi.parse_faults(spec)
    with pytest.raises(ValueError) as got:
        tfi.parse_faults(spec)
    assert str(got.value) == str(want.value)


def _schedule(fi, spec, sites, n=40):
    inj = fi.FaultInjector(spec)
    out = []
    for _ in range(n):
        for site in sites:
            try:
                out.append(inj.check(site))
            except fi.InjectedFault as e:
                out.append(("raised", str(e)))
    return out, inj.injected, {s: inj.tick_of(s) for s in sites}


@pytest.mark.parametrize("spec", ["frontend@4,9:raise", "device:0@every:3:flap;device@7-9:drop",
                                  "send@p:0.2,seed:11:drop;send:2@3:delay:2",
                                  "policy:1@p:0.5:flap"])
def test_schedules_match_jax(spec):
    sites = ["frontend", "device:0", "device:1", "send:1", "send:2", "policy:1"]
    assert _schedule(tfi, spec, sites) == _schedule(jfi, spec, sites)


def test_env_spec_is_read_once_and_shared(monkeypatch):
    """One SELKIES_FAULTS string drives both packages, each with its own
    injector and counters; a malformed env spec is ignored by both."""
    monkeypatch.setenv("SELKIES_FAULTS", "frontend@2:raise")
    ti, ji = tfi.get_injector(), jfi.get_injector()
    assert ti is not None and ji is not None and ti is tfi.get_injector()
    assert ti.check("frontend") is None
    with pytest.raises(tfi.InjectedFault):
        ti.check("frontend")
    assert ji.tick_of("frontend") == 0  # the JAX injector counted nothing
    tfi.configure_faults("send@1:drop")
    assert tfi.get_injector().check("send") == ("drop", 0.0)
    tfi.reset_faults()
    jfi.reset_faults()
    monkeypatch.setenv("SELKIES_FAULTS", "garbage")
    assert tfi.get_injector() is None and jfi.get_injector() is None


# -- the port's device shapes --------------------------------------------------

def test_chip_key_matches_jax():
    assert tdh.chip_key(CPU) == jdh.chip_key(jax.devices("cpu")[0]) == "0"
    assert tdh.chip_key(torch.device("cuda", 3)) == "3"
    assert tdh.chip_key(torch.device("cuda", 0)) == "0"
    for double in ("chip1", "c9", 7):
        assert tdh.chip_key(double) == jdh.chip_key(double)


class _AcceleratorLike(RuntimeError):
    pass


DEVICE_ERRORS = {
    "cuda_error": RuntimeError("CUDA error: an illegal memory access was encountered"),
    "cublas": RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm"),
    "cudnn": RuntimeError("cuDNN error: CUDNN_STATUS_INTERNAL_ERROR"),
    "device_assert": RuntimeError("CUDA kernel errors: device-side assert triggered"),
    "oom": torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
}
HOST_ERRORS = {
    "key": KeyError("frame"),
    "value": ValueError("qp 60 out of range"),
    "runtime_host": RuntimeError("retune_entropy with frames in flight; flush first"),
    "type": TypeError("bad argument"),
    "device_fault": tdh.DeviceFault("0"),
}


@pytest.mark.parametrize("name", list(DEVICE_ERRORS))
def test_cuda_shaped_errors_look_like_device_errors(name):
    assert tdh.looks_device_error(DEVICE_ERRORS[name])


@pytest.mark.parametrize("name", list(HOST_ERRORS))
def test_host_shaped_errors_do_not(name):
    assert not tdh.looks_device_error(HOST_ERRORS[name])


def test_accelerator_error_looks_like_a_device_error():
    accel = getattr(torch, "AcceleratorError", None)
    if accel is None:
        pytest.skip("this torch has no torch.AcceleratorError")
    assert tdh.looks_device_error(accel.__new__(accel))


def test_attribution_probes_only_on_cuda_shaped_errors():
    probed = []

    def probe(dev):
        probed.append(dev)
        return False

    pool = tdh.set_device_pool(tdh.DevicePool(devices=["c0"], fail_threshold=1,
                                              probation_s=10, clock=_Clock(), probe=probe))
    assert tdh.note_tick_failure(KeyError("x"), ["c0"]) is None and probed == []
    assert tdh.note_tick_failure(DEVICE_ERRORS["cuda_error"], ["c0"]) == "c0"
    assert probed == ["c0"] and pool.quarantined_keys() == ["c0"]


def test_default_probe():
    assert tdh._default_probe(CPU) is True
    assert tdh._default_probe("a double") is True
    # a device the probe cannot reach fails it, never passes it
    assert tdh._default_probe(torch.device("cuda", 0)) is torch.cuda.is_available()


def test_pool_enumeration_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the pool enumerates it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdh.DevicePool()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdh.get_device_pool()
    assert tdh.peek_device_pool() is None
    pool = tdh.DevicePool(devices=[CPU])
    assert pool.all_devices() == [CPU] and pool.health_view()["chips"] == 1
    assert pool.probe("0")


# -- the banded encoder's carve and the session device through the pool ------

BW, BH = 320, 192


def _banded_frames(seed=3, n=6):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (BH, BW, 4), np.uint8)
    frames = [f]
    for i in range(1, n):
        f = np.roll(f, 3 * i, 0).copy()
        f[16 * i:16 * i + 16, 40:120] = rng.integers(0, 256, (16, 80, 4), np.uint8)
        frames.append(f)
    frames.insert(3, frames[2].copy())  # a static repeat
    return frames


def _sha(au: bytes) -> str:
    return hashlib.sha256(au).hexdigest()


def _pool_pair(quarantine: bool):
    """The same one-device pool in both packages, its device quarantined
    or not."""
    tp = tdh.set_device_pool(tdh.DevicePool(devices=[CPU], fail_threshold=1))
    jp = jdh.set_device_pool(jdh.DevicePool(devices=jax.devices()[:1], fail_threshold=1))
    if quarantine:
        assert tp.quarantine("0") and jp.quarantine("0")
    return tp, jp


@pytest.mark.parametrize("quarantine", [False, True], ids=["healthy", "quarantined"])
@pytest.mark.parametrize("bands,cols", [(4, 1), (2, 2)], ids=["bands4", "grid2x2"])
def test_banded_carve_through_the_pool_matches_jax(quarantine, bands, cols):
    """device=None carves through the pool as JAX's devices=None: healthy,
    the requested carve on the card; with the only card quarantined, the
    carve shrinks to one band-row and the device list is empty (no fault
    check), the work staying on the pool's card."""
    _pool_pair(quarantine)
    enc = TorchBandedH264Encoder(BW, BH, bands=bands, cols=cols)
    jenc = BandedH264Encoder(BW, BH, bands=bands, cols=cols)
    try:
        assert (enc.bands, enc.cols) == (jenc.bands, jenc.cols)
        assert [tdh.chip_key(d) for d in enc.devices] == [jdh.chip_key(d) for d in jenc.devices]
        assert enc.device == CPU
        assert enc.bands == (1 if quarantine else bands)
    finally:
        enc.close()
        jenc.close()


def test_shrunk_carve_encodes_as_one_band_with_no_fault_check():
    _pool_pair(quarantine=True)
    tfi.configure_faults("device:0@every:1:raise")
    enc = TorchBandedH264Encoder(BW, BH, bands=4)
    assert enc.bands == 1 and enc.devices == []
    ref = TorchBandedH264Encoder(BW, BH, bands=1, device="cpu")
    try:
        frames = _banded_frames()
        got = [_sha(enc.encode_frame(f)) for f in frames]
        assert tfi.get_injector().tick_of("device:0") == 0
        tfi.reset_faults()
        assert got == [_sha(ref.encode_frame(f)) for f in frames]
    finally:
        enc.close()
        ref.close()


@pytest.mark.parametrize("quarantine", [False, True], ids=["healthy", "quarantined"])
def test_session_device_from_the_pool(quarantine):
    """The sessions take the pool's healthy card; with none healthy, the
    full enumeration (JAX's "never raises short" rule)."""
    _pool_pair(quarantine)
    enc = TorchMultiSessionEncoder(2, 32, 32)
    assert enc.device == CPU
    svc = TorchMultiSessionH264Service(2, 32, 32)
    try:
        assert svc.device == CPU and svc.devices == [CPU]
    finally:
        svc.close()


# -- the device:<chip> site on the encoders, against JAX -----------------------

# ticks 1-2 flap, tick 3 raises (the frame is never encoded), tick 4 flaps:
# with a threshold of 3 and the raise noted, the card is quarantined at
# tick 3 and the encode goes on
DEVICE_SPEC = "device:0@3:raise;device:0@every:1:flap"


def _drive_with_faults(enc, frames, dh, encode):
    out = []
    for i, f in enumerate(frames):
        try:
            out.append(_sha(encode(enc, f)))
        except dh.DeviceFault as e:
            out.append(("fault", e.chip, dh.note_tick_failure(e)))
        out.append(dh.get_device_pool().quarantined_keys())
    return out


def test_banded_device_faults_match_jax():
    frames = _banded_frames(seed=5)
    tdh.set_device_pool(tdh.DevicePool(devices=[CPU], fail_threshold=3))
    tfi.configure_faults(DEVICE_SPEC)
    enc = TorchBandedH264Encoder(BW, BH, bands=2, device="cpu")
    got = _drive_with_faults(enc, frames, tdh, lambda e, f: e.encode_frame(f))
    enc.close()
    jdh.set_device_pool(jdh.DevicePool(devices=jax.devices()[:1], fail_threshold=3))
    jfi.configure_faults(DEVICE_SPEC)
    jenc = BandedH264Encoder(BW, BH, bands=2, devices=jax.devices()[:1])
    want = _drive_with_faults(jenc, frames, jdh, lambda e, f: e.encode_frame(f))
    jenc.close()
    assert got == want
    assert got[4] == ("fault", "0", "0") and got[5] == ["0"]
    assert all(isinstance(x, str) for x in got[6::2])  # every later frame encodes


N_SESS, SW, SH = 2, 64, 48


def _session_ticks(n_ticks=5, seed=9):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (N_SESS, SH, SW + 32, 4), np.uint8)
    return [np.ascontiguousarray(base[:, :, 4 * t:4 * t + SW]) for t in range(n_ticks)]


def _drive_service_with_faults(svc, dh):
    out = []
    for frames in _session_ticks():
        try:
            out.append([_sha(a) for a in svc.encode_tick(frames)])
        except dh.DeviceFault as e:
            out.append(("fault", e.chip, dh.note_tick_failure(e)))
    return out


def test_service_device_fault_matches_jax():
    """``device:0@3:raise``: tick 3 raises DeviceFault("0") before any
    conversion in both packages (JAX checks one chip per session, the port
    its one card: a device:0 rule hits both), note_tick_failure names the
    card at threshold 1, and the later ticks' AUs are JAX's."""
    spec = "device:0@3:raise"
    tdh.set_device_pool(tdh.DevicePool(devices=[CPU], fail_threshold=1))
    tfi.configure_faults(spec)
    svc = TorchMultiSessionH264Service(N_SESS, SW, SH, qp=26, device="cpu")
    got = _drive_service_with_faults(svc, tdh)
    svc.close()
    jdh.set_device_pool(jdh.DevicePool(devices=jax.devices()[:N_SESS], fail_threshold=1))
    jfi.configure_faults(spec)
    jsvc = MultiSessionH264Service(N_SESS, SW, SH, qp=26, devices=jax.devices()[:N_SESS])
    want = _drive_service_with_faults(jsvc, jdh)
    jsvc.close()
    assert got == want
    assert got[2] == ("fault", "0", "0") and len(got) == 5


def test_service_fault_leaves_no_tick_in_flight():
    """The raise comes before conversion: the service's state is as if the
    tick never came, so a fresh service fed the other ticks gives the same
    AUs."""
    tfi.configure_faults("device:0@2:raise")
    svc = TorchMultiSessionH264Service(N_SESS, SW, SH, device="cpu")
    ticks = _session_ticks(4)
    got = []
    for t, frames in enumerate(ticks):
        if t == 1:
            with pytest.raises(tdh.DeviceFault):
                svc.dispatch_tick(frames)
            assert svc._inflight == 0
            continue
        got.append([_sha(a) for a in svc.encode_tick(frames)])
    svc.close()
    tfi.reset_faults()
    ref = TorchMultiSessionH264Service(N_SESS, SW, SH, device="cpu")
    want = [[_sha(a) for a in ref.encode_tick(f)] for t, f in enumerate(ticks) if t != 1]
    ref.close()
    assert got == want
