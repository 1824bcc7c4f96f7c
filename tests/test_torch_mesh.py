"""The multi-device carve of the port against JAX's meshes on tier-1's 8
virtual CPU devices. The port's side lists CPU devices (``[cpu] * k``: a
carve may repeat a device), so its mesh paths run here as they run over
several cards: the band and tile meshes of TorchBandedH264Encoder against
JAX's ``BandedH264Encoder(..., devices=jax.devices()[:k])`` with
``mesh_enabled`` (AUs sha256-equal over every frame kind; the halo
exchanges and the mesh steps element for element), the column front-end
against JAX's ``col`` mesh, the session groups of TorchMultiSessionEncoder
and TorchMultiSessionH264Service against JAX's session mesh, the banded
fleet over listed rows, and the rule that fewer devices than chips keep
the stacked path."""

from __future__ import annotations

import functools
import gc
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from selkies_tpu.parallel import bands as JB
from selkies_tpu.parallel import codec_mesh as jmesh
from selkies_tpu.parallel.sessions import _CHECK_KW, _shard_map
from selkies_tpu.resilience import devhealth as jdh
from selkies_tpu_torch.device import device_list
from selkies_tpu_torch.models.h264 import me_mc
from selkies_tpu_torch.parallel import bands as TB
from selkies_tpu_torch.parallel import codec_mesh as tmesh
from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder
from selkies_tpu_torch.parallel.serving import TorchBandedFleetService, TorchMultiSessionH264Service
from selkies_tpu_torch.parallel.sessions import TorchMultiSessionEncoder
from selkies_tpu_torch.resilience import faultinject as tfi

from test_torch_bands import _pin_env, drive, trace  # noqa: F401 - _pin_env is autouse
from test_torch_codec_mesh import _drive as drive_frontend
from test_torch_codec_mesh import _need_av1, drive_row, mesh_trace, row_trace
from test_torch_fleet_service import TICKS as FLEET_TICKS
from test_torch_fleet_service import _drive as drive_fleet
from test_torch_fleet_service import _trace as fleet_trace
from test_torch_fleet_service import jax_run as jax_fleet_run
from test_torch_serving import _drive as drive_service
from test_torch_serving import jax_run as jax_service_run
from test_torch_sessions import _run as run_sessions
from test_torch_sessions import jax_run as jax_sessions_run

CPU = torch.device("cpu")
QP = 30
_KW = {_CHECK_KW: False} if _CHECK_KW else {}


@pytest.fixture
def jax_pool():
    """A test whose JAX side builds JAX's process-wide device pool
    (``devices=None``) drops it afterwards: the pool registers itself
    with JAX's telemetry, whose ``/healthz`` later tests in this worker
    read."""
    yield
    jdh.reset_device_pool()
    gc.collect()

# name -> (w, h, kwargs, devices); the device-entropy row codes flat blocks
CONFIGS = {
    "bands2": (96, 96, dict(bands=2), 2),
    "bands2_device_entropy": (96, 96, dict(bands=2, device_entropy=True, bits_min_mbs=4), 2),
    "bands4": (256, 256, dict(bands=4), 4),
    "grid1x2": (256, 256, dict(bands=1, cols=2), 2),
    "grid2x2": (192, 96, dict(bands=2, cols=2), 4),
    "grid2x2_cabac": (192, 96, dict(bands=2, cols=2, entropy_coder="cabac"), 4),
}


def _frames(name):
    w, h, _, _ = CONFIGS[name]
    return trace(w, h, blocks="device_entropy" in name)


@functools.lru_cache(maxsize=None)
def jax_encoder(name):
    """A row's JAX mesh encoder, one per process: its steps compile once."""
    w, h, kw, k = CONFIGS[name]
    enc = JB.BandedH264Encoder(w, h, qp=QP, devices=jax.devices()[:k], **kw)
    assert enc.mesh_enabled
    return enc


@functools.lru_cache(maxsize=None)
def jax_run(name):
    return drive(jax_encoder(name), _frames(name))


@functools.lru_cache(maxsize=None)
def port_run(name):
    w, h, kw, k = CONFIGS[name]
    enc = TorchBandedH264Encoder(w, h, qp=QP, devices=[CPU] * k, **kw)
    launches = []
    real = me_mc.me_mc

    def counted(*a):
        launches.append(1)
        return real(*a)

    try:
        assert enc.mesh_enabled and enc.devices == [CPU] * k
        assert enc.mesh == [[CPU] * enc.cols] * enc.bands
        me_mc.me_mc = counted
        out, links = drive(enc, _frames(name))
        return out, links, len(launches), enc.shard_bytes.snapshot()
    finally:
        me_mc.me_mc = real
        enc.close()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mesh_encoder_matches_jax_mesh(name):
    got, got_links, launches, moved = port_run(name)
    want, want_links = jax_run(name)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name} frame {i}: {g} != {w}"
    assert len(got) == len(want) and got_links == want_links
    # K1 once per band or tile and non-static P frame
    w, h, kw, k = CONFIGS[name]
    p_frames = sum(1 for _, idr, skipped, _ in got if not idr and skipped != (w // 16) * (h // 16))
    assert launches == k * p_frames
    # only the exchanges cross shards: halos, votes, the row gather
    assert moved and set(moved) <= {"halo_rows", "halo_cols", "coarse_cols", "votes", "coarse",
                                    "row_gather", "recon_crop"}
    if kw.get("cols", 1) == 1:
        assert set(moved) == {"halo_rows"}
    if "device_entropy" in name:
        assert {"bits", "coeff"} <= {m for *_, m in got}


def test_mesh_shard_bytes_are_what_jax_exchanges():
    """bands4 at 256x256: each P frame copies 40 luma and 2 x 20 chroma
    rows across each of 3 seams, both ways."""
    got, _, _, moved = port_run("bands4")
    p_frames = sum(1 for _, idr, skipped, _ in got if not idr and skipped != 256)
    per_p = 3 * 2 * (40 * 256 + 2 * 20 * 128)
    assert moved == {"halo_rows": p_frames * per_p}


# -- the exchanges against ppermute -------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_exchange(axis: str, n: int, halo: int):
    mesh = Mesh(np.array(jax.devices()[:n]), (axis,))
    fn = JB._ppermute_slab if axis == "band" else JB._ppermute_cols
    spec = P(axis) if axis == "band" else P(None, axis)

    def body(r):
        return fn(r, halo, n, axis)

    return jax.jit(_shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec, **_KW))


@pytest.mark.parametrize("axis,n,halo", [("band", 4, 40), ("band", 2, 20), ("band", 3, 4),
                                         ("col", 2, 40), ("col", 4, 16), ("col", 3, 8)])
def test_exchanges_match_ppermute(axis, n, halo):
    rng = np.random.default_rng(n * 100 + halo)
    shard = (48, 64)
    if axis == "band":
        full = rng.integers(0, 256, (n * shard[0], shard[1]), np.uint8)
        parts = [torch.from_numpy(full[i * shard[0]:(i + 1) * shard[0]].copy()) for i in range(n)]
        got = np.concatenate([t.numpy() for t in TB._exchange_rows(parts, halo)], axis=0)
    else:
        full = rng.integers(0, 256, (shard[0], n * shard[1]), np.uint8)
        parts = [torch.from_numpy(full[:, i * shard[1]:(i + 1) * shard[1]].copy())
                 for i in range(n)]
        got = np.concatenate([t.numpy() for t in TB._exchange_cols(parts, halo)], axis=1)
    want = np.asarray(_jax_exchange(axis, n, halo)(jnp.asarray(full)))
    np.testing.assert_array_equal(got, want)


def test_exchanges_with_one_shard_or_no_halo_are_identity():
    t = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    for fn in (TB._exchange_rows, TB._exchange_cols):
        assert fn([t], 40)[0] is t and fn([t, t], 0)[1] is t


# -- the mesh steps against JAX's mesh steps ----------------------------------

def _split(enc, planes):
    """One frame's (y, u, v) as JAX's mesh encoder takes them (stacked on
    the band, or band and col, axes and sharded) and as the port's mesh
    steps do (nested per band-row and tile; one tile a row at one column)."""
    b, c, bh, tw = enc.bands, enc.cols, enc._band_h, enc._tile_w
    tiles = [np.ascontiguousarray(p.reshape(b, bh >> s, c, tw >> s).transpose(0, 2, 1, 3))
             for p, s in zip(planes, (0, 1, 1))]
    lists = [[[torch.from_numpy(a[r, k].copy()) for k in range(c)] for r in range(b)]
             for a in tiles]
    arrs = tiles if c > 1 else [a[:, 0] for a in tiles]
    return [jax.device_put(a, enc._shard) for a in arrs], lists


def _moved_planes(w, h, seed):
    rng = np.random.default_rng(seed)
    ref = [np.kron(rng.integers(0, 256, ((h >> s) // 8, (w >> s) // 8)), np.ones((8, 8)))
           .astype(np.uint8) for s in (0, 1, 1)]
    cur = [np.roll(ref[0], (21, -19), (0, 1)), np.roll(ref[1], (10, -9), (0, 1)),
           np.roll(ref[2], (10, -9), (0, 1))]
    cur[0][h // 2 - 8:h // 2 + 8, w // 2 - 24:w // 2 + 24] = rng.integers(0, 256, (16, 48))
    return cur, ref


def _assert_outputs(got, want, cols, kind):
    """The port's per-row (nested per tile) outputs against JAX's stacked
    ones; a tile grid's fused and buf against column 0's copy, a band
    mesh's recon with the unit column axis squeezed."""
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if isinstance(g[0], list):
            g = np.stack([np.stack([t.numpy() for t in row]) for row in g])
            g = g if cols > 1 else g[:, 0]
        else:
            g = np.stack([t.numpy() for t in g])
            w = w[:, 0] if cols > 1 else w
        np.testing.assert_array_equal(g, w, err_msg=f"{kind} output {k}")


@pytest.mark.parametrize("name", ["bands4", "grid2x2"])
def test_mesh_steps_match_jax_mesh_steps(name):
    """The IDR step on a frame, then the P step against its recon, from a
    frame that moved by more than the halo: prefix / fused, buf and recon
    element for element."""
    w, h, _, k = CONFIGS[name]
    enc = jax_encoder(name)
    cur, ref = _moved_planes(w, h, 5)
    jref, _ = _split(enc, ref)
    want_i = enc._step_i(*jref, np.int32(QP))
    # the port uploads an IDR's band-rows whole to their column-0 device
    rows = [[torch.from_numpy(p.reshape(enc.bands, -1, p.shape[1])[r].copy())
             for r in range(enc.bands)] for p in ref]
    got_i = TB._mesh_tile_i_step(*rows, QP, grid=TB.tile_mesh(enc.bands, enc.cols, [CPU] * k),
                                 cap_rows=enc._cap_i, tile_w=enc._tile_w)
    _assert_outputs(got_i, want_i, enc.cols, "I")
    jcur, cur_lists = _split(enc, cur)
    want = enc._step_p(*jcur, np.int32(QP), *want_i[2:])
    got = TB._mesh_tile_p_step(*cur_lists, QP, *got_i[2:], halo=enc.halo,
                               halo_cols=enc.halo_cols, nscap=enc._nscap, cap_rows=enc._cap_p,
                               entropy=None)
    _assert_outputs(got, want, enc.cols, "P")
    assert (np.stack([t.numpy() for t in got[0]])[:, 0] != 0).any()


# -- the carve -----------------------------------------------------------------

@pytest.mark.parametrize("fn,args", [("band_mesh", (4,)), ("tile_mesh", (2, 3))])
def test_short_device_list_raises_as_jax(fn, args):
    with pytest.raises(ValueError) as got:
        getattr(TB, fn)(*args, [CPU] * 3)
    with pytest.raises(ValueError) as want:
        getattr(JB, fn)(*args, jax.devices()[:3])
    assert str(got.value) == str(want.value)


def test_mesh_helpers_index_and_keep_repeats():
    assert TB.band_mesh(2, ["cpu", CPU, CPU]) == [CPU, CPU]
    assert TB.tile_mesh(2, 2, [CPU] * 5) == [[CPU, CPU], [CPU, CPU]]
    assert device_list(["cpu", CPU]) == [CPU, CPU]


@pytest.mark.parametrize("w,h,kw,listed", [(96, 96, dict(bands=2), 1),
                                           (256, 256, dict(bands=4), 3),
                                           (192, 96, dict(bands=2, cols=2), 3),
                                           (256, 256, dict(bands=1), 4)])
def test_fewer_devices_than_chips_keep_the_stacked_path(w, h, kw, listed):
    enc = TorchBandedH264Encoder(w, h, devices=[CPU] * listed, **kw)
    jenc = JB.BandedH264Encoder(w, h, devices=jax.devices()[:listed], **kw)
    try:
        assert enc.mesh_enabled == jenc.mesh_enabled is False
        assert enc.mesh is None and enc.devices == [CPU] and len(jenc.devices) == 1
    finally:
        enc.close()
        jenc.close()


def test_device_and_devices_are_exclusive():
    with pytest.raises(ValueError, match="not both"):
        TorchBandedH264Encoder(96, 96, bands=2, device="cpu", devices=[CPU, CPU])
    with pytest.raises(ValueError, match="need a device"):
        TorchBandedH264Encoder(96, 96, bands=2, devices=[])


def test_fault_site_counts_a_repeated_card_once():
    """device:0@2:raise: the mesh on [cpu]*2 raises on its second frame, as
    the one-device encoder does: the site is consulted once per card and
    frame, however often a carve lists the card."""
    frames = [f for f, _ in trace(96, 96)[:3]]
    results = []
    for kw in (dict(device="cpu"), dict(devices=[CPU, CPU])):
        tfi.configure_faults("device:0@2:raise")
        enc = TorchBandedH264Encoder(96, 96, bands=2, **kw)
        got = []
        try:
            for f in frames:
                try:
                    got.append(hashlib.sha256(enc.encode_frame(f)).hexdigest())
                except tfi.InjectedFault:
                    got.append("raised")
                except RuntimeError as exc:
                    got.append(type(exc).__name__)
        finally:
            enc.close()
            tfi.reset_faults()
        results.append(got)
    assert results[0] == results[1] and results[0][1] == "DeviceFault"


# -- the column front-end -------------------------------------------------------

@pytest.mark.parametrize("cols", [2, 4])
def test_mesh_frontend_on_listed_devices_matches_jax(cols, jax_pool):
    w, h = 208, 96
    tr = mesh_trace(w, h)
    jfe = jmesh.MeshDeltaFrontend(w, h, cols=cols)
    tfe = tmesh.MeshDeltaFrontend(w, h, cols, devices=[CPU] * (cols + 1))
    assert tfe.mesh_enabled and tfe.devices == [CPU] * cols
    want, got = drive_frontend(jfe, tr), drive_frontend(tfe, tr)
    for i, ((jd, jh), (td, th)) in enumerate(zip(want, got)):
        if jd is None:
            assert td is None and th is None, i
            continue
        np.testing.assert_array_equal(td, jd, err_msg=f"dirty, frame {i}")
        np.testing.assert_array_equal(th, jh, err_msg=f"hints, frame {i}")
    assert tfe.votes == len(tr) - 2


def test_mesh_frontend_with_fewer_devices_runs_on_one():
    fe = tmesh.MeshDeltaFrontend(208, 96, 4, devices=[CPU] * 3)
    assert not fe.mesh_enabled and fe.devices == [CPU]


# -- the session groups ----------------------------------------------------------

@pytest.mark.parametrize("n,k", [(8, 2), (4, 2), (5, 3), (3, 5), (7, 7), (6, 4)])
def test_session_groups_split_contiguously(n, k):
    enc = TorchMultiSessionEncoder(n, 32, 32, devices=[CPU] * k)
    groups = [(g.lo, g.hi) for g in enc.groups]
    assert len(groups) == min(n, k) and groups[0][0] == 0 and groups[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    sizes = [hi - lo for lo, hi in groups]
    assert max(sizes) - min(sizes) <= 1
    kk = min(n, k)
    assert [next(j for j, (lo, hi) in enumerate(groups) if lo <= i < hi) for i in range(n)] == [
        i * kk // n for i in range(n)]


def test_session_encoder_over_two_devices_matches_jax():
    """tests/test_torch_sessions.py's trace (IDR, P and mixed ticks with
    per-session QPs) on 2 groups against JAX's 4-device session mesh, and
    the plain K1 once per group and tick with a P session."""
    calls = []
    real = me_mc.me_mc_batch_plain

    def counted(*a):
        calls.append(a[1].shape[0])
        return real(*a)

    enc = TorchMultiSessionEncoder(4, 48, 48, devices=[CPU, CPU])
    me_mc.me_mc_batch_plain = counted
    try:
        got = run_sessions(enc, True)
    finally:
        me_mc.me_mc_batch_plain = real
    want = jax_sessions_run(True)
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), t
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"tick {t} {key}")
    # P sessions per group and tick: p (2, 2), mixed IPPI (1, 1), PPPP (2, 2),
    # IIII none, PIPP (1, 2)
    assert calls == [2, 2, 1, 1, 2, 2, 1, 2]
    assert [g.ref[0].device for g in enc.groups] == [CPU, CPU]


def test_service_over_two_devices_matches_jax():
    svc = TorchMultiSessionH264Service(4, 64, 48, qp=26, devices=[CPU, CPU])
    try:
        assert svc.devices == [CPU, CPU] and [(g.lo, g.hi) for g in svc.enc.groups] == [
            (0, 2), (2, 4)]
        got = drive_service(svc)
        # the last tick holds an IDR, so its timing has idr_pack_ms as well
        assert any(svc.last_idrs) and len(svc.last_timing) == 8
        assert svc.last_timing["down_bytes"] > 0 and svc.last_timing["idr_pack_ms"] > 0
    finally:
        svc.close()
    assert got == jax_service_run()


def test_service_load_state_splits_over_groups():
    """A reference set in session order lands in each group's rows."""
    svc = TorchMultiSessionH264Service(3, 32, 32, devices=[CPU, CPU])
    try:
        ref = [np.arange(3 * 32 * 32, dtype=np.uint8).reshape(3, 32, 32),
               np.ones((3, 16, 16), np.uint8), np.zeros((3, 16, 16), np.uint8)]
        svc.load_jax_state({"ref": ref, "pic_init_qp": 28, "sessions": [
            {"frames_since_idr": 1, "idr_pic_id": 0, "force_idr": False, "qp": 28}] * 3})
        assert [(g.lo, g.hi) for g in svc.enc.groups] == [(0, 2), (2, 3)]
        np.testing.assert_array_equal(svc.enc.groups[1].ref[0].numpy(), ref[0][2:])
        np.testing.assert_array_equal(svc.enc._ref[0].numpy(), ref[0])
    finally:
        svc.close()


# -- the banded fleet over listed rows ------------------------------------------

def test_banded_fleet_on_listed_rows_runs_meshes_as_jax():
    """Four listed devices carve into two 2-device rows: each session's
    encoder is a band mesh, with the bytes of JAX's fleet on 2-chip rows
    (tests/test_torch_fleet_service.py's trace and run)."""
    svc = TorchBandedFleetService(2, 192, 128, qp=28, bands=2, devices=[CPU] * 4)
    try:
        assert all(e.mesh_enabled and e.devices == [CPU, CPU] for e in svc.encoders)
        got = drive_fleet(svc, fleet_trace(2, FLEET_TICKS))
    finally:
        svc.close()
    want, bands, shared = jax_fleet_run("bands2")
    assert got == want and (bands, shared) == (2, False)


def test_fleet_rebuild_keeps_the_row_mesh():
    """A re-carve onto a row of 2 devices rebuilds the session as a mesh."""
    svc = TorchBandedFleetService(1, 192, 128, qp=28, bands=2, rows=[[CPU]])
    try:
        assert not svc.encoders[0].mesh_enabled
        svc.recarve(0, [CPU, CPU])
        assert svc.encoders[0].mesh_enabled and svc.encoders[0].devices == [CPU, CPU]
    finally:
        svc.close()


def test_av1_row_front_end_spreads_over_the_row(jax_pool):
    """A fleet row handed to the AV1 tile-column row: the device front-end
    runs a column per listed device, with JAX's row's bytes."""
    _need_av1()
    w, h = 256, 128
    tr = row_trace(w, h)
    want = drive_row(jmesh.TileColumnAV1Encoder(w, h, cols=2, frontend="device"), tr)
    enc = tmesh.TileColumnAV1Encoder(w, h, cols=2, frontend="device", devices=[CPU, CPU])
    assert enc._device_fe.mesh_enabled and enc._device_fe.devices == [CPU, CPU]
    assert drive_row(enc, tr)[:2] == want[:2]
