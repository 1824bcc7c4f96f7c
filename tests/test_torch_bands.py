"""The band slice of the port: TorchBandedH264Encoder's 1D band carve against
JAX's BandedH264Encoder on one device (``devices=[cpu]``) and once against
its mesh run on the 8 virtual CPU devices. Helpers and env parsers equal
JAX's, the band device half and the stacked steps (the tile steps at one
column) equal JAX's band steps element for element, and the whole
encoder's access units are sha256-equal over a trace of every frame kind,
for both coders with device entropy off and on. Inside
the port: bands=1 equals the solo encoder, and the dispatch/complete seam
keeps its contract."""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from selkies_tpu.models.h264 import bitstream as jbs
from selkies_tpu.models.h264 import encoder_core as JC
from selkies_tpu.models.h264 import sparse_complete as JS
from selkies_tpu.models.h264.encoder import TPUH264Encoder
from selkies_tpu.parallel import bands as JB
from selkies_tpu_torch.models.h264 import bitstream as tbs
from selkies_tpu_torch.models.h264 import device_cavlc as tdc
from selkies_tpu_torch.models.h264 import encoder_core as TC
from selkies_tpu_torch.models.h264 import sparse_complete as TS
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
from selkies_tpu_torch.parallel import bands as TB
from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

W, H = 256, 256  # 16 MB rows -> 4 bands of 4
QP = 30
_ENV = ("SELKIES_BANDS", "SELKIES_TILE_GRID", "SELKIES_BAND_HALO", "SELKIES_TILE_HALO",
        "SELKIES_ENTROPY_CODER", "SELKIES_DEVICE_ENTROPY", "SELKIES_BITS_MIN_MBS",
        "SELKIES_PACK_WORKERS", "SELKIES_PACK_DENSITY", "SELKIES_TILE_CACHE",
        "SELKIES_SPARSE_NATIVE", "SELKIES_FRONTEND_WORKERS", "SELKIES_PARALLEL_FRONTEND",
        "SELKIES_DAMAGE_FULL_SCAN")


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    # one torch intra-op thread (many small CPU ops; xdist workers share cores)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- helpers and env parsers ---------------------------------------------

_ENV_CASES = [
    ("SELKIES_BANDS", v) for v in ("", "4", "1", "0", "-3", "abc", "2.5")
] + [
    ("SELKIES_BAND_HALO", v) for v in ("", "16", "3", "17", "40", "100", "x")
] + [
    ("SELKIES_TILE_HALO", v) for v in ("", "36", "5", "90", "y")
] + [
    ("SELKIES_TILE_GRID", v) for v in ("", "2x2", "4X2", "3×1", "0x2", "abc", "2", "2x2x2",
                                       "x", "axb")
]


@pytest.mark.parametrize("name,value", _ENV_CASES, ids=[f"{n}={v!r}" for n, v in _ENV_CASES])
def test_env_parsers_match_jax(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    for fn in ("bands_from_env", "halo_from_env", "tile_halo_from_env", "grid_from_env"):
        assert getattr(TB, fn)() == getattr(JB, fn)(), fn


@pytest.mark.parametrize("requested", [1, 2, 3, 4, 5, 8, 40, 200])
def test_carve_helpers_match_jax(requested):
    for mb in range(1, 136):
        assert TB.usable_bands(mb, requested) == JB.usable_bands(mb, requested), mb
        assert TB.usable_cols(mb, requested) == JB.usable_cols(mb, requested), mb
        bands = TB.usable_bands(mb, requested)
        assert TB.band_spans(mb, bands) == JB.band_spans(mb, bands)
    assert TB.usable_bands(68, 4) == 4 and TB.usable_bands(135, 4) == 3  # 1080p, 4K


def test_constants_and_span_errors_match_jax():
    assert (TB.BAND_HALO, TB.MIN_BAND_MB_ROWS, TB.MIN_TILE_MB_COLS) == (
        JB.BAND_HALO, JB.MIN_BAND_MB_ROWS, JB.MIN_TILE_MB_COLS)
    for mod in (TB, JB):
        with pytest.raises(ValueError):
            mod.band_spans(16, 5)


@pytest.mark.parametrize("bands,rows,halo", [(4, 64, 40), (2, 48, 4), (1, 16, 0), (3, 8, 20),
                                             (4, 32, 16)])
def test_tile_slab_at_one_column_matches_jax_band_slabs(bands, rows, halo):
    """The tile step's slab cut at one column, from the edge-padded
    reassembled reference: each band's slab equals JAX's clipped row
    gather of the stacked bands."""
    ref = torch.arange(bands * rows * 3, dtype=torch.int32).reshape(bands, rows, 3)
    want = JB._stacked_slabs(jnp.asarray(ref.numpy()), halo)
    padded = TC.edge_pad(ref.reshape(bands * rows, 3), halo, halo, 0, 0)
    got = torch.stack([TB._tile_slab(padded, b, 0, rows, 3, halo, 0) for b in range(bands)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the band device half ------------------------------------------------

def _band_planes(seed, bh=48, w=96, motion=(7, -5)):
    """A band's source planes and a reference frame whose content moved."""
    rng = np.random.default_rng(seed)
    full_h = 3 * bh
    ref = [rng.integers(0, 256, (full_h >> s, w >> s), np.uint8) for s in (0, 1, 1)]
    cur = [np.roll(ref[0], motion, (0, 1)), np.roll(ref[1], (motion[0] // 2, motion[1] // 2),
                                                    (0, 1)),
           np.roll(ref[2], (motion[0] // 2, motion[1] // 2), (0, 1))]
    return cur, ref


def _clip_slab(plane, r0, rows, halo):
    idx = np.clip(np.arange(r0 - halo, r0 + rows + halo), 0, plane.shape[0] - 1)
    return plane[idx]


def _eq_out(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_band_p(halo):
    return jax.jit(lambda *a: JC.encode_band_p_planes(*a, halo=halo))


@pytest.mark.parametrize("halo", [0, 16, 40])
def test_encode_band_p_planes_matches_jax(halo):
    """The middle band of three against its slab, the port's tile encode at
    one column (``halo_cols=0``) against JAX's band encode; halo 0 takes
    the whole reference as the slab (the one-band identity, unclamped
    window)."""
    (y, u, v), (ry, ru, rv) = _band_planes(3 + halo)
    bh = 48
    if halo == 0:
        srcs = (y, u, v)
        slabs = (ry, ru, rv)
    else:
        srcs = (y[bh:2 * bh], u[bh // 2:bh], v[bh // 2:bh])
        slabs = (_clip_slab(ry, bh, bh, halo), _clip_slab(ru, bh // 2, bh // 2, halo // 2),
                 _clip_slab(rv, bh // 2, bh // 2, halo // 2))
    want = _jax_band_p(halo)(*srcs, *slabs, jnp.int32(QP))
    got = TC.encode_tile_p_planes(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (*srcs, *slabs)), QP, halo=halo, halo_cols=0)
    _eq_out(got, want)
    assert (got["mvs"].numpy() != 0).any()


@pytest.mark.parametrize("kw", [dict(halo=2), dict(halo=7), dict(halo=42), dict(halo=-4),
                                dict(halo=40, halo_cols=3), dict(halo=40, halo_cols=2),
                                dict(halo=40, halo_cols=44)])
def test_halo_validation_matches_jax(kw):
    (y, u, v), (ry, ru, rv) = _band_planes(1)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (y, u, v, ry, ru, rv)]
    with pytest.raises(ValueError) as got:
        TC.encode_tile_p_planes(*args, QP, **kw)
    with pytest.raises(ValueError) as want:
        JC.encode_tile_p_planes(*(jnp.asarray(a.numpy()) for a in args), QP, **kw)
    assert str(got.value) == str(want.value)


# -- the stacked steps: the tile steps at one column -------------------

BW, BH = 96, 96  # 6 MB rows -> 2 bands of 3
_STEP_ENTROPY = ["none", "cavlc", "cabac"]


def _entropy(mod, m, name):
    """The entropy tuple of a row with device entropy and bits_min_mbs=4."""
    if name == "none":
        return None
    return mod.resolve_entropy(m, True, 4, entropy_coder=name)[3]


def _stacked_inputs(bands, seed=11):
    rng = np.random.default_rng(seed)
    # 8x8 blocks with light noise: the moved frame codes a few MBs per band
    planes = [np.clip(np.kron(rng.integers(0, 256, (BH >> s + 3, BW >> s + 3)), np.ones((8, 8)))
                      + rng.integers(-2, 3, (BH >> s, BW >> s)), 0, 255).astype(np.uint8)
              for s in (0, 1, 1)]
    moved = [np.roll(planes[0], (8, -6), (0, 1)), np.roll(planes[1], (4, -3), (0, 1)),
             np.roll(planes[2], (4, -3), (0, 1))]
    moved[0][40:56, 30:60] = rng.integers(0, 256, (16, 30), np.uint8)
    stack = lambda ps: [p.reshape(bands, p.shape[0] // bands, p.shape[1]) for p in ps]  # noqa
    return stack(planes), stack(moved)


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _col(arrs):
    """Stacked band planes on (bands, 1) tile axes: the grid at one column."""
    return [t[:, None] for t in _t(arrs)]


def _on_dev0(arrs):
    """Arrays placed as the JAX encoder places a step's inputs (committed to
    its one device), so a direct call of its jitted step reuses the program
    its own frames compile (an uncommitted argument compiles another)."""
    dev = jax.devices()[0]
    return [jax.device_put(np.ascontiguousarray(a), dev) for a in arrs]


# the stacked-step tests call the jitted steps of the whole-encoder rows
# at the same geometry (one compile each), entropy off / CAVLC / CABAC
_STEP_ROWS = {"none": "cabac_bands2", "cavlc": "device_cavlc_bands2",
              "cabac": "device_cabac_bands2"}


def test_stacked_i_step_matches_jax():
    """The tile IDR at one column against JAX's band IDR, the unit column
    axis squeezed."""
    cur, _ = _stacked_inputs(2)
    want = jax_encoder(_STEP_ROWS["none"])._step_i(*_on_dev0(cur), np.int32(QP))
    got = TB._stacked_tile_i_step(*_col(cur), QP, bands=2, cols=1, cap_rows=min(27 * 18, 4096))
    for name, g, w in zip(("prefix", "buf", "ry", "ru", "rv"), got, want):
        np.testing.assert_array_equal(g[:, 0].numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("entropy", _STEP_ENTROPY)
def test_stacked_p_step_matches_jax(entropy):
    """The tile P step at one column against JAX's band P step from an
    IDR's recon, the slabs cut across the band seam; every output (fused,
    buf, recon) equal, the unit column axis squeezed."""
    ref, cur = _stacked_inputs(2)
    m = 3 * 6
    rec = TB._stacked_tile_i_step(*_col(ref), QP, bands=2, cols=1,
                                  cap_rows=min(27 * m, 4096))[2:]
    want = jax_encoder(_STEP_ROWS[entropy])._step_p(*_on_dev0(cur), np.int32(QP),
                                                    *_on_dev0(r[:, 0].numpy() for r in rec))
    got = TB._stacked_tile_p_step(*_col(cur), QP, *rec, entropy=_entropy(tdc, m, entropy),
                                  bands=2, cols=1, halo=40, halo_cols=0, nscap=m,
                                  cap_rows=min(26 * m, 4096))
    for name, g, w in zip(("fused", "buf", "ry", "ru", "rv"), got, want):
        np.testing.assert_array_equal(g[:, 0].numpy(), np.asarray(w), err_msg=name)
    if entropy != "none":  # a busy band ships its coded slice
        assert 1 in {int(f[0, 0]) for f in got[0]}


# -- the whole encoder against JAX --------------------------------------


def trace(w, h, seed=7, blocks=False):
    """-> [(frame, op)]: an IDR, a vertical roll (crosses band seams), a
    horizontal roll with a block across the column seam, a diagonal at a new
    QP, a static repeat (all-skip), one dirty MB with a damage hint, a forced
    IDR, and two more P frames (a keyframe_interval of 3 puts an IDR here).
    Noise, or with ``blocks`` flat 16x16 blocks: their IDR leaves no
    quantisation tail, so the one dirty MB is a quiet frame."""
    rng = np.random.default_rng(seed)
    if blocks:
        f0 = np.kron(rng.integers(0, 256, (h // 16, w // 16, 4), np.uint8),
                     np.ones((16, 16, 1), np.uint8))
    else:
        f0 = rng.integers(0, 256, (h, w, 4), np.uint8)
    f1 = np.roll(f0, 9, 0).copy()
    f2 = np.roll(f1, -13, 1).copy()
    f2[h // 4:h // 4 + 48, w // 2 - 24:w // 2 + 24] = rng.integers(0, 256 >> 5 * blocks,
                                                                     (48, 48, 4), np.uint8)
    f3 = np.roll(np.roll(f2, 5, 0), 6, 1).copy()
    quiet = f3.copy()
    quiet[h - 40:h - 32, 8:24] ^= 0x40
    return [(f0, None), (f1, None), (f2, None), (f3, ("qp", 34)), (f3.copy(), None),
            (quiet, ("damage", [(8, h - 40, 16, 8)])), (f1, "idr"), (f2, None), (f0, None)]


def drive(enc, frames):
    """-> [(sha256, idr, skipped MBs, downlink mode)] and the link bytes."""
    out = []
    for f, op in frames:
        qp = damage = None
        if op == "idr":
            enc.force_keyframe()
        elif op is not None and op[0] == "qp":
            qp = op[1]
        elif op is not None:
            damage = op[1]
        au = enc.encode_frame(f, qp, damage=damage)
        st = enc.last_stats
        assert (st.bands, st.cols) == (enc.bands, enc.cols)
        assert len(st.band_step_ms) == (0 if st.upload_kind == "static" else enc.bands)
        out.append((hashlib.sha256(au).hexdigest(), st.idr, st.skipped_mbs, st.downlink_mode))
    return out, enc.link_bytes.snapshot()


# name -> (w, h, kwargs); the device-entropy rows code flat blocks. The
# rows at BW x BH with device entropy off share one step program (the coder
# is host-side), so the JAX side compiles it once.
CONFIGS = {
    "bands1": (W, H, dict(bands=1)),
    "bands2_kfi3": (BW, BH, dict(bands=2, keyframe_interval=3)),
    "bands4": (W, H, dict(bands=4)),
    "bands4_halo16": (W, H, dict(bands=4, halo=16)),
    "ragged_336x192_bands4": (336, 192, dict(bands=4)),
    "cabac_bands2": (BW, BH, dict(bands=2, entropy_coder="cabac")),
    "device_cavlc_bands2": (BW, BH, dict(bands=2, device_entropy=True, bits_min_mbs=4)),
    "device_cabac_bands2": (BW, BH, dict(bands=2, device_entropy=True, bits_min_mbs=4,
                                         entropy_coder="cabac")),
}


def _frames(name):
    w, h, _ = CONFIGS[name]
    return trace(w, h, blocks=name.startswith("device_"))


@functools.lru_cache(maxsize=None)
def jax_encoder(name):
    """A row's JAX encoder, one per process: its steps compile once."""
    w, h, kw = CONFIGS[name]
    enc = JB.BandedH264Encoder(w, h, qp=QP, devices=jax.devices()[:1], **kw)
    assert not enc.mesh_enabled
    return enc


@functools.lru_cache(maxsize=None)
def jax_run(name):
    return drive(jax_encoder(name), _frames(name))


@functools.lru_cache(maxsize=None)
def port_run(name):
    w, h, kw = CONFIGS[name]
    enc = TorchBandedH264Encoder(w, h, qp=QP, device="cpu", **kw)
    try:
        assert not enc.mesh_enabled and enc.devices == [torch.device("cpu")]
        return drive(enc, _frames(name))
    finally:
        enc.close()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_banded_encoder_matches_jax(name):
    got, got_links = port_run(name)
    want, want_links = jax_run(name)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name} frame {i}: {g} != {w}"
    assert len(got) == len(want)
    assert got_links == want_links
    modes = {m for *_, m in got}
    if name.startswith("device_"):  # busy bands ship coded slices, the quiet one rows
        assert {"bits" if "cavlc" in name else "cabac", "coeff"} <= modes


def test_matches_jax_mesh_run():
    """JAX's 4-band mesh (shard_map + ppermute on 4 virtual devices) gives
    the bytes of its one-device run, and so the port's."""
    frames = trace(W, H)[:5]
    mesh = JB.BandedH264Encoder(W, H, qp=QP, bands=4)
    try:
        assert mesh.mesh_enabled
        want, _ = drive(mesh, frames)
    finally:
        mesh.close()
    got, _ = port_run("bands4")
    assert [g[0] for g in got[:5]] == [w[0] for w in want]


# -- identities inside the port --------------------------------------------


@pytest.mark.parametrize("halo", [None, 0])
def test_bands1_matches_solo_encoder(halo):
    """One band equals the flat solo encoder; halo 0 leaves the window
    unclamped (a vertical-motion P frame would grow otherwise)."""
    frames = trace(BW, BH)
    banded = TorchBandedH264Encoder(BW, BH, qp=QP, bands=1, halo=halo, device="cpu")
    solo = TorchH264Encoder(BW, BH, qp=QP, frame_batch=1, pipeline_depth=0, ltr_scenes=False,
                            scene_qp_boost=0, device="cpu")
    try:
        assert banded.halo == (0 if halo == 0 else TB.BAND_HALO)
        for i, (f, _) in enumerate(frames[:5]):  # IDR, P frames, static all-skip
            (a, st, meta), = banded.submit(f, meta=i)
            (b, _, _), = solo.submit(f)
            assert (meta, st.bands, st.cols) == (i, 1, 1)
            assert a == b, f"frame {i}: bands=1 differs from the solo encoder"
        assert banded.flush() == []
    finally:
        banded.close()
        solo.close()


# -- the dispatch/complete seam and the API ------------------------------


def _small(**kw):
    return TorchBandedH264Encoder(BW, BH, qp=QP, bands=2, device="cpu", **kw)


def test_second_dispatch_raises():
    f0, f1 = (f for f, _ in trace(BW, BH)[:2])
    enc = _small()
    try:
        pending = enc.dispatch_frame(f0)
        with pytest.raises(RuntimeError, match="in flight"):
            enc.dispatch_frame(f1)
        enc.complete_frame(pending)
        enc.complete_frame(enc.dispatch_frame(f1))
        assert enc.frame_index == 2
    finally:
        enc.close()


def test_qp_is_taken_at_dispatch():
    """A set_qp between the halves does not reach a dispatched P frame
    (its slice header and coefficients), only the next one. A dispatched
    IDR completes with the QP held at completion, as JAX's does
    (test_set_qp_between_dispatch_and_complete_matches_jax)."""
    frames = [f for f, _ in trace(BW, BH)[:3]]
    ref = _small()
    want = [ref.encode_frame(frames[0], 24), ref.encode_frame(frames[1], 24),
            ref.encode_frame(frames[2], 40)]
    ref.close()
    enc = _small()
    try:
        got = [enc.encode_frame(frames[0], 24)]
        pending = enc.dispatch_frame(frames[1], qp=24)
        enc.set_qp(40)
        got.append(enc.complete_frame(pending))
        assert not enc.last_stats.idr and enc.last_stats.qp == 24
        got.append(enc.encode_frame(frames[2]))
    finally:
        enc.close()
    assert got == want


def test_set_qp_between_dispatch_and_complete_matches_jax():
    """set_qp between dispatch_frame and complete_frame, on an IDR, a P
    frame and a forced IDR: the AUs equal JAX's. An IDR's slice carries the
    QP held at completion over coefficients quantised at the dispatch QP
    (JAX's behaviour, kept byte for byte), so its AU differs from the same
    IDR without the set_qp."""
    frames = [f for f, _ in trace(BW, BH)[:3]]

    def run(enc, late_qp=True):
        out = []
        for i, f in enumerate(frames):
            if i == 2:
                enc.force_keyframe()
            pending = enc.dispatch_frame(f, qp=24)
            if late_qp:
                enc.set_qp(40)
            out.append(enc.complete_frame(pending))
        enc.close()
        return out

    want = run(JB.BandedH264Encoder(BW, BH, qp=QP, bands=2, devices=jax.devices()[:1]))
    got = run(_small())
    for i, (g, w) in enumerate(zip(got, want)):
        assert hashlib.sha256(g).hexdigest() == hashlib.sha256(w).hexdigest(), f"frame {i}"
    plain = run(_small(), late_qp=False)
    assert got[0] != plain[0] and got[2] != plain[2]
    assert got[1] == plain[1]


def test_failed_step_restarts_with_an_idr(monkeypatch):
    frames = [f for f, _ in trace(BW, BH)[:3]]
    enc = _small()
    try:
        enc.encode_frame(frames[0])

        def boom(*a, **k):
            raise RuntimeError("injected step failure")

        monkeypatch.setattr(enc, "_step_p", boom)
        with pytest.raises(RuntimeError, match="injected"):
            enc.encode_frame(frames[1])
        assert enc._ref is None and not enc._inflight
        monkeypatch.undo()
        au = enc.encode_frame(frames[2])
        assert enc.last_stats.idr and au.startswith(enc._headers)
    finally:
        enc.close()


def test_failed_pack_restarts_with_an_idr(monkeypatch):
    frames = [f for f, _ in trace(BW, BH)[:3]]
    enc = _small()
    try:
        enc.encode_frame(frames[0])
        monkeypatch.setattr(enc, "_complete_band_p",
                            lambda *a: (_ for _ in ()).throw(RuntimeError("injected pack")))
        with pytest.raises(RuntimeError, match="injected pack"):
            enc.encode_frame(frames[1])
        assert enc._ref is None
        monkeypatch.undo()
        enc.encode_frame(frames[2])
        assert enc.last_stats.idr
    finally:
        enc.close()


def test_prewarm_resets_the_gop():
    frames = [f for f, _ in trace(BW, BH)[:3]]
    fresh = _small()
    want = [fresh.encode_frame(f) for f in frames]
    fresh.close()
    enc = _small()
    try:
        enc.prewarm()
        assert (enc.frame_index, enc._ref, enc._force_idr) == (0, None, True)
        assert [enc.encode_frame(f) for f in frames] == want
    finally:
        enc.close()


def test_frame_stats_and_interface():
    enc = _small(entropy_coder="cabac")
    try:
        assert (enc.entropy_coder, enc.h264_profile, enc.codec) == ("cabac", "main", "h264")
        frames = [f for f, _ in trace(BW, BH)[:2]]
        for i, f in enumerate(frames):
            (au, st, meta), = enc.submit(f, meta=("m", i))
            assert meta == ("m", i) and st.bytes == len(au)
            assert (st.bands, st.cols, len(st.band_step_ms), st.idr) == (2, 1, 2, i == 0)
            assert st.step_ms >= max(st.band_step_ms) - 1e-3
        assert enc.flush() == []
    finally:
        enc.close()
    with pytest.raises(ValueError):
        TorchBandedH264Encoder(BW, BH, channels=3, device="cpu")
    with pytest.raises(ValueError):
        _small().set_qp(52)


def test_carve_from_env(monkeypatch):
    monkeypatch.setenv("SELKIES_BANDS", "4")
    monkeypatch.setenv("SELKIES_BAND_HALO", "17")
    enc = TorchBandedH264Encoder(W, H, device="cpu")
    jenc = JB.BandedH264Encoder(W, H, devices=jax.devices()[:1])
    try:
        assert (enc.bands, enc.cols, enc.halo, enc.halo_cols) == (
            jenc.bands, jenc.cols, jenc.halo, jenc.halo_cols) == (4, 1, 16, 0)
        assert enc._pack_pool._max_workers == jenc._pack_pool._max_workers
    finally:
        enc.close()
        jenc.close()


@pytest.mark.parametrize("bands,env", [(4, None), (None, "3"), (None, None)])
def test_solo_encoder_bands_sizes_the_pack_pool_as_jax(monkeypatch, bands, env):
    if env is not None:
        monkeypatch.setenv("SELKIES_BANDS", env)
    kw = dict(frame_batch=4, pipeline_depth=2, bands=bands)
    port = TorchH264Encoder(W, H, device="cpu", **kw)
    ref = TPUH264Encoder(W, H, **kw)
    try:
        assert port.bands == ref.bands == (bands or int(env or 1))
        assert port._pack_pool._max_workers == ref._pack_pool._max_workers
    finally:
        port.close()
        ref.close()


# -- complete_sparse_slice with a band's first_mb and cabac_init_idc -------


def _band_out():
    """The P outputs of the second band (3x6 MBs) of a moved block frame."""
    ref, cur = (tuple(p[0] for p in ps) for ps in _stacked_inputs(1))
    bh = 48
    srcs = (cur[0][bh:], cur[1][bh // 2:], cur[2][bh // 2:])
    slabs = (_clip_slab(ref[0], bh, bh, 40), _clip_slab(ref[1], bh // 2, bh // 2, 20),
             _clip_slab(ref[2], bh // 2, bh // 2, 20))
    return TC.encode_tile_p_planes(*_t((*srcs, *slabs)), 26, halo=40, halo_cols=0)


_ARMS = ["cavlc", "cabac", "device_bits", "device_tokens", "dense"]


@pytest.mark.parametrize("first_mb,idc", [(18, 0), (0, 2), (18, 1)])
@pytest.mark.parametrize("arm", _ARMS)
def test_complete_sparse_slice_band_matches_jax(arm, first_mb, idc):
    out = _band_out()
    mbh, mbw = out["skip"].shape
    m = mbh * mbw
    coder = "cabac" if arm in ("cabac", "device_tokens") else "cavlc"
    nscap, cap = (4 if arm == "dense" else m), 26 * m
    if arm.startswith("device"):
        fused, dense, buf = TC.pack_p_sparse_entropy(
            out, nscap, cap, None, *tdc.resolve_entropy(m, True, 1, coder)[3][:3],
            entropy_coder=coder)
    else:
        fused, dense, buf = TC.pack_p_sparse_var(out, nscap, cap)
    fused, dense, buf = fused.numpy(), dense.numpy(), buf.numpy()
    res = []
    for mod, bs in ((JS, jbs), (TS, tbs)):
        params = bs.StreamParams(width=BW, height=BH, qp=26, entropy_coder=coder)
        needs = []
        nal, skipped, _, mode = mod.complete_sparse_slice(
            fused, mbh=mbh, mbw=mbw, nscap=nscap, cap_rows=cap, qp=26, frame_num=3,
            params=params, device_bits=arm.startswith("device"), full_d=fused, buf_d=buf,
            dense_d=dense, prefix_bytes=fused.nbytes, note_need=needs.append,
            first_mb=first_mb, entropy_coder=coder, cabac_init_idc=idc)
        res.append((nal, skipped, mode, needs))
    assert res[1] == res[0]
    assert res[1][2] == {"device_bits": "bits", "device_tokens": "cabac",
                         "dense": "dense"}.get(arm, "coeff")
