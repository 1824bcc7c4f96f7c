"""The fleet's banded service in the port: TorchBandedFleetService against
JAX's BandedFleetService by sha256 per session and tick — bands 1 and 2,
a 2x2 grid and the shared carve under set_qp / force_keyframe; the
re-carve round trip of tests/test_lifecycle.py (borrow onto an enlarged
4-band row, return), a quarantine-shrunk row, parking and un-parking;
``vp8`` degrading to h264 and ``av1`` / ``vp9`` raising; the recompile
marks; a failed restore; the carve through the device pool.

JAX runs on tier-1's 8 virtual CPU devices (each session's row is a
mesh); the port's rows are lists of ``torch.device("cpu")`` of the same
length, since a port row runs on its first device.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.monitoring import jitprof as jjitprof
from selkies_tpu.parallel.lifecycle import SessionPlacer as JaxPlacer
from selkies_tpu.parallel.serving import BandedFleetService
from selkies_tpu.resilience import InjectedFault as JaxInjectedFault
from selkies_tpu.resilience import configure_faults as jax_configure
from selkies_tpu.resilience import reset_faults as jax_reset
from selkies_tpu_torch.monitoring import jitprof as tjitprof
from selkies_tpu_torch.parallel.lifecycle import SessionPlacer
from selkies_tpu_torch.parallel.serving import TorchBandedFleetService
from selkies_tpu_torch.resilience import (
    DevicePool,
    InjectedFault,
    configure_faults,
    reset_device_pool,
    reset_faults,
    set_device_pool,
)

W, H = 192, 128  # tests/test_occupancy.py's geometry: 12 x 8 MBs
CPU = torch.device("cpu")
_ENV = ("SELKIES_FRONTEND_WORKERS", "SELKIES_PARALLEL_FRONTEND", "SELKIES_DAMAGE_FULL_SCAN",
        "SELKIES_BANDS", "SELKIES_TILE_GRID", "SELKIES_BAND_HALO", "SELKIES_TILE_HALO",
        "SELKIES_ENTROPY_CODER", "SELKIES_DEVICE_ENTROPY", "SELKIES_FAULTS")


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
    reset_device_pool()


def _trace(n: int, ticks: int, w: int = W, h: int = H, seed: int = 3):
    """Per tick an (n, h, w, 4) batch: each session rewrites a 16-row band
    on its own cadence and repeats a frame every third tick (IDR, P and
    the static short-circuit)."""
    rng = np.random.default_rng(seed)
    cur = [np.full((h, w, 4), 150 + 17 * s, np.uint8) for s in range(n)]
    out = []
    for t in range(ticks):
        for s in range(n):
            if (t + s) % 3 != 2:
                cur[s] = cur[s].copy()
                row = 16 * ((t + 2 * s) % (h // 16))
                cur[s][row:row + 16] = rng.integers(0, 255, (16, w, 4), np.uint8)
        out.append(np.stack(cur))
    return out


def _sha(au: bytes) -> str:
    return hashlib.sha256(au).hexdigest()


# tick -> ops before it: ("qp", session, qp) / ("key", session)
OPS = {2: [("qp", 1, 34)], 3: [("key", 0)], 4: [("qp", 0, 22), ("key", 1)]}
TICKS = 6


def _drive(svc, trace, ops=OPS):
    """-> per tick (the sessions' AU sha256s, last_idrs, last_modes)."""
    out = []
    for t, batch in enumerate(trace):
        for op in ops.get(t, ()):
            if op[0] == "qp":
                svc.set_qp(op[1], op[2])
            else:
                svc.force_keyframe(op[1])
        aus = svc.encode_tick(batch)
        out.append(([_sha(a) for a in aus], list(svc.last_idrs), list(svc.last_modes)))
    return out


def _jax_rows(n: int, k: int):
    devs = jax.devices()
    return [devs[i * k:(i + 1) * k] for i in range(n)]


# name -> (kwargs of both, chips per JAX row; 0 = the shared carve)
CONFIGS = {
    "bands1": ({"bands": 1}, 1),
    "bands2": ({"bands": 2}, 2),
    "grid2x2": ({"bands": 2, "cols": 2}, 4),
    "shared_bands2": ({"bands": 2}, 0),
}


@functools.lru_cache(maxsize=None)
def jax_run(name: str):
    kw, k = CONFIGS[name]
    if k:
        svc = BandedFleetService(2, W, H, qp=28, rows=_jax_rows(2, k), **kw)
    else:
        svc = BandedFleetService(2, W, H, qp=28, devices=jax.devices()[:1], **kw)
    try:
        return _drive(svc, _trace(2, TICKS)), svc.bands, svc.shared_carve
    finally:
        svc.close()


@functools.lru_cache(maxsize=None)
def port_run(name: str):
    kw, k = CONFIGS[name]
    if k:
        svc = TorchBandedFleetService(2, W, H, qp=28, rows=[[CPU] * k] * 2, **kw)
    else:
        svc = TorchBandedFleetService(2, W, H, qp=28, devices=[CPU], **kw)
    try:
        return _drive(svc, _trace(2, TICKS)), svc.bands, svc.shared_carve
    finally:
        svc.close()


@pytest.mark.parametrize("tick", range(TICKS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_fleet_service_matches_jax(name, tick):
    got, want = port_run(name), jax_run(name)
    assert got[0][tick] == want[0][tick]
    assert got[1:] == want[1:]


def test_fleet_trace_covers_every_kind():
    out, bands, shared = port_run("bands2")
    idrs = [i for _, i, _ in out]
    modes = [m for _, _, m in out]
    assert idrs[0] == [True, True] and idrs[3] == [True, False] and idrs[4] == [False, True]
    assert "coeff" in {m for row in modes for m in row} and "" in modes[1] + modes[2]
    assert bands == 2 and not shared
    assert port_run("shared_bands2")[1:] == (2, True)


def test_carve_partitions_explicit_devices():
    """No rows: partition_devices carves the devices into n rows of
    bands x cols, as JAX's does over its devices."""
    svc = TorchBandedFleetService(2, W, H, bands=2, devices=[CPU] * 4)
    jsvc = BandedFleetService(2, W, H, bands=2, devices=jax.devices()[:4])
    try:
        assert not svc.shared_carve and not jsvc.shared_carve
        assert [e.bands for e in svc.encoders] == [e.bands for e in jsvc.encoders] == [2, 2]
        assert [e.device for e in svc.encoders] == [CPU, CPU]
    finally:
        svc.close()
        jsvc.close()


# -- _row_bands: the enlarge and shrink rules ---------------------------------


class _Stub:
    def __init__(self, bands_req, cols, shared):
        self._bands_req, self.cols, self.shared_carve = bands_req, cols, shared


@pytest.mark.parametrize("row_len", [0, 1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("bands_req,cols,shared", [(2, 1, False), (2, 1, True), (1, 1, False),
                                                   (2, 2, False), (3, 1, False)])
def test_row_bands_matches_jax(row_len, bands_req, cols, shared):
    row = [CPU] * row_len
    assert (TorchBandedFleetService._row_bands(_Stub(bands_req, cols, shared), row)
            == BandedFleetService._row_bands(_Stub(bands_req, cols, shared), row))


# -- re-carve: borrow onto an enlarged row, return, shrink ---------------------

RW, RH = 64, 192  # 12 MB rows: an enlarged 4-chip row really slices 4 bands


def _recarve_frames(n=8):
    rng = np.random.default_rng(1)
    return [rng.integers(0, 255, (2, RH, RW, 4), np.uint8) for _ in range(n)]


def _recarve_run(pkg: str):
    """tests/test_lifecycle.py's round trip (borrow then return), then a
    quarantine-shrunk row: per tick the re-carved service's AU sha256s and
    its oracle's, the band counts and the recompile mark of each rebuild.
    The placer's chips are stand-ins; the service gets rows of its own
    devices of the same lengths."""
    frames = _recarve_frames()
    if pkg == "jax":
        devs = jax.devices()
        placer = JaxPlacer(devices=[f"chip{i}" for i in range(8)], bands=2, host_cores=8)
        to_row = {f"chip{i}": d for i, d in enumerate(devs)}.__getitem__

        def make(rows):
            return BandedFleetService(2, RW, RH, qp=28, fps=30, bands=2, rows=rows)

        oracle_rows = [[devs[4], devs[5]], [devs[6], devs[7]]]
        jp = jjitprof
    else:
        placer = SessionPlacer(devices=[f"chip{i}" for i in range(8)], bands=2, host_cores=8)

        def to_row(_):
            return CPU

        def make(rows):
            return TorchBandedFleetService(2, RW, RH, qp=28, fps=30, bands=2, rows=rows)

        oracle_rows = [[CPU] * 2] * 2
        jp = tjitprof

    def row(k):
        return [to_row(c) for c in placer.row(k)]

    rows = placer.place_initial(2, 2)
    svc = make([[to_row(c) for c in r] for r in rows])
    oracle = make(oracle_rows)
    out = {"ticks": [], "bands": [], "marks": []}

    def tick(t):
        a, b = svc.encode_tick(frames[t]), oracle.encode_tick(frames[t])
        out["ticks"].append(([_sha(x) for x in a], [_sha(x) for x in b], list(svc.last_idrs)))

    try:
        for t in range(2):
            tick(t)
        placer.set_busy(0, True)
        # the dynamic qp must carry over without entering the rebuilt
        # encoder's StreamParams
        svc.set_qp(0, 34)
        oracle.set_qp(0, 34)
        assert len(placer.borrow(0)) == 2
        svc.recarve(0, row(0))
        out["marks"].append(jp.sentinel._mark[:2])
        svc.recarve(1, row(1))  # the lender parks on its empty row
        out["bands"].append([e.bands if e is not None else 0 for e in svc.encoders])
        oracle.force_keyframe(0)
        for t in range(2, 4):
            tick(t)
        placer.return_borrowed(0)
        svc.recarve(0, row(0))
        svc.recarve(1, row(1))
        out["bands"].append([e.bands for e in svc.encoders])
        oracle.force_keyframe(0)
        oracle.force_keyframe(1)
        for t in range(4, 6):
            tick(t)
        # a quarantine shrinks session 1's row to one chip: one band
        placer.quarantine(placer.row(1)[1])
        svc.recarve(1, row(1))
        out["bands"].append([e.bands for e in svc.encoders])
        for t in range(6, 8):
            tick(t)
        placer.assert_consistent()
        out["borrowed"] = placer.borrowed_chips()
    finally:
        svc.close()
        oracle.close()
    return out


@functools.lru_cache(maxsize=None)
def recarve_run(pkg: str):
    return _recarve_run(pkg)


def test_recarve_round_trip_matches_jax():
    got, want = recarve_run("torch"), recarve_run("jax")
    assert got == want
    assert got["bands"] == [[4, 0], [2, 2], [2, 1]]
    assert got["marks"] == [("recarve", "session-0")]
    assert got["borrowed"] == 0


@pytest.mark.parametrize("tick", range(8))
def test_recarve_round_trip_against_oracle(tick):
    """The borrower's bytes equal a never-re-carved oracle forced a
    keyframe at each re-carve while its band count is unchanged; the
    enlarged 4-band row (ticks 2-3) is a re-slice with the same IDR / P
    structure; the parked lender sends nothing and comes back on a fresh
    GOP (no checkpoint of a parked session: only its IDR's idr_pic_id
    differs, so the P frame after it is equal again); the shrunk row
    re-slices into 1 band (ticks 6-7)."""
    shas, oracle, idrs = recarve_run("torch")["ticks"][tick]
    if tick < 2:
        assert shas == oracle
    elif tick < 4:
        assert shas[0] != oracle[0] and shas[1] == _sha(b"")
        assert idrs == [tick == 2, False]
    elif tick < 6:
        assert shas[0] == oracle[0] and (shas[1] == oracle[1]) == (tick == 5)
        assert idrs == [tick == 4, tick == 4]
    else:
        assert shas[0] == oracle[0] and shas[1] != oracle[1]
        assert idrs == [False, tick == 6]


# -- parking, codecs, failures ---------------------------------------------------


def _park_run(make, rows_of, frames):
    svc = make()
    out = []
    try:
        for t, batch in enumerate(frames):
            if t == 2:
                svc.recarve(1, [])
            if t == 4:
                svc.recarve(1, rows_of(1))
            aus = svc.encode_tick(batch)
            out.append(([_sha(a) for a in aus], list(svc.last_idrs), list(svc.last_modes),
                        svc.encoders[1] is None))
    finally:
        svc.close()
    return out


def test_park_and_unpark_match_jax():
    frames = _trace(2, 6, seed=8)
    devs = jax.devices()
    want = _park_run(lambda: BandedFleetService(2, W, H, bands=2, rows=_jax_rows(2, 2)),
                     lambda k: [devs[2 * k], devs[2 * k + 1]], frames)
    got = _park_run(lambda: TorchBandedFleetService(2, W, H, bands=2, rows=[[CPU] * 2] * 2),
                    lambda k: [CPU] * 2, frames)
    assert got == want
    assert [g[0][1] for g in got[2:4]] == [_sha(b"")] * 2
    assert [g[1][1] for g in got] == [True, False, False, False, True, False]
    assert [g[3] for g in got] == [False, False, True, True, False, False]


def test_vp8_session_degrades_to_h264_as_jax():
    frames = _trace(2, 3, seed=9)
    jsvc = BandedFleetService(2, W, H, bands=1, rows=_jax_rows(2, 1), codecs=["vp8", "H264"])
    svc = TorchBandedFleetService(2, W, H, bands=1, rows=[[CPU]] * 2, codecs=["vp8", "H264"])
    try:
        assert svc.codecs == jsvc.codecs == ["h264", "h264"]
        for batch in frames:
            assert svc.encode_tick(batch) == jsvc.encode_tick(batch)
    finally:
        svc.close()
        jsvc.close()


@pytest.mark.parametrize("codec", ["av1", "vp9"])
def test_av1_vp9_sessions_raise(codec):
    with pytest.raises(NotImplementedError, match="TileColumn"):
        TorchBandedFleetService(2, W, H, bands=1, rows=[[CPU]] * 2, codecs=["h264", codec])


@pytest.mark.parametrize("codec", ["av1", "vp9"])
def test_codec_switch_to_av1_vp9_raises_and_keeps_serving(codec):
    """set_codec + recarve: the mark is a codec switch's, the build raises
    outside any degrade-to-h264 path, and the old encoder keeps serving."""
    frames = _trace(2, 3, seed=10)
    svc = TorchBandedFleetService(2, W, H, bands=1, rows=[[CPU]] * 2)
    oracle = TorchBandedFleetService(2, W, H, bands=1, rows=[[CPU]] * 2)
    try:
        assert svc.encode_tick(frames[0]) == oracle.encode_tick(frames[0])
        assert svc.set_codec(1, codec) and not svc.set_codec(1, codec)
        old = svc.encoders[1]
        with pytest.raises(NotImplementedError, match="TileColumn"):
            svc.recarve(1, [CPU])
        assert tjitprof.sentinel._mark[:2] == ("codec_switch", f"session-1:{codec}")
        assert svc.encoders[1] is old
        for batch in frames[1:]:
            assert svc.encode_tick(batch) == oracle.encode_tick(batch)
    finally:
        svc.close()
        oracle.close()


def test_set_bitrate_is_a_noop_on_h264_rows():
    svc = TorchBandedFleetService(1, W, H, bands=1, rows=[[CPU]])
    try:
        svc.set_bitrate(0, 1500)
        svc.recarve(0, [])
        svc.set_qp(0, 30)  # parked: every per-session knob is a no-op
        svc.force_keyframe(0)
        svc.set_bitrate(0, 900)
        assert svc.encode_tick(_trace(1, 1)[0]) == [b""]
    finally:
        svc.close()


def _failed_restore(pkg):
    """migrate:0@2:raise: the checkpoint (the site's first call) lands, the
    restore (its second) raises; the half-built encoder is closed and the
    old one keeps serving, byte for byte."""
    frames = _trace(1, 4, seed=12)
    if pkg == "jax":
        jax_configure("migrate:0@2:raise")
        svc = BandedFleetService(1, W, H, bands=2, rows=_jax_rows(1, 2))
        row, exc = jax.devices()[:2], JaxInjectedFault
    else:
        configure_faults("migrate:0@2:raise")
        svc = TorchBandedFleetService(1, W, H, bands=2, rows=[[CPU] * 2])
        row, exc = [CPU] * 2, InjectedFault
    closed = []
    build = svc._build_encoder

    def spy(k, devices):
        enc = build(k, devices)
        orig = enc.close
        enc.close = lambda: (closed.append(k), orig())[1]
        return enc

    svc._build_encoder = spy
    out = []
    try:
        out.append(_sha(svc.encode_tick(frames[0])[0]))
        old = svc.encoders[0]
        with pytest.raises(exc):
            svc.recarve(0, row)
        assert svc.encoders[0] is old and closed == [0]
        out += [_sha(svc.encode_tick(f)[0]) for f in frames[1:]]
        out.append(list(svc.last_idrs))
    finally:
        svc.close()
    return out


def test_failed_restore_closes_the_replacement_as_jax():
    got = _failed_restore("torch")
    want = _failed_restore("jax")
    assert got == want and got[-1] == [False]


# -- the carve through the device pool ------------------------------------------


def test_devices_none_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the pool enumerates it")
    reset_device_pool()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBandedFleetService(2, W, H, bands=2)


def test_pool_with_one_device_gives_the_shared_carve():
    """The card's case: a pool of one device, 2 sessions x 2 bands -> the
    shared carve, each session on the one device at 2 bands."""
    set_device_pool(DevicePool(devices=[CPU]))
    svc = TorchBandedFleetService(2, W, H, bands=2)
    try:
        assert svc.shared_carve and svc.bands == 2
        assert [e.device for e in svc.encoders] == [CPU, CPU]
        assert [e.bands for e in svc.encoders] == [2, 2]
        want = port_run("shared_bands2")[0]
        assert _drive(svc, _trace(2, TICKS)) == want
    finally:
        svc.close()
