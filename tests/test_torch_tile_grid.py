"""The tile-grid slice of the port: TorchBandedH264Encoder with cols > 1
(SELKIES_TILE_GRID=RxC) against JAX's BandedH264Encoder on one device. The
coarse vote of a tile (its downsampled column halo), the tile device half
(clamped windows, an injected coarse list, deferred P_Skip) and the stacked
tile steps equal JAX's element for element; the whole encoder's AUs are
sha256-equal on seam-crossing traces, for both coders with device entropy
off and on, and on a ragged 4x3 carve. Inside the port: an RxC grid equals
bands=R at the default halos, and its AU has R slices, not R*C."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from selkies_tpu.models.h264 import encoder_core as JC
from selkies_tpu.parallel import bands as JB
from selkies_tpu_torch.models.h264 import device_cavlc as tdc
from selkies_tpu_torch.models.h264 import encoder_core as TC
from selkies_tpu_torch.parallel import bands as TB
from selkies_tpu_torch.parallel.bands import TorchBandedH264Encoder

from test_torch_bands import _eq_out, _entropy, _on_dev0, _pin_env, _t, drive, trace  # noqa: F401

W, H = 256, 256  # 16x16 MBs: the 1x2 grid has 2 tile columns of 8
QP = 30


def _split_nals(au: bytes) -> list[bytes]:
    parts = au.split(b"\x00\x00\x00\x01")
    assert parts[0] == b""
    return [b"\x00\x00\x00\x01" + p for p in parts[1:]]


@pytest.mark.parametrize("mbw,req,want", [(16, 2, 2), (16, 1, 1), (16, 5, 4), (16, 3, 2),
                                          (240, 4, 4), (256, 8, 8), (7, 4, 1), (120, 40, 40),
                                          (21, 3, 3), (120, 2, 2)])
def test_usable_cols_matches_jax(mbw, req, want):
    assert TB.usable_cols(mbw, req) == JB.usable_cols(mbw, req) == want


# -- the coarse vote of a tile ------------------------------------------


def _vote_planes(seed=5, h=64, w=128):
    rng = np.random.default_rng(seed)
    ref = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8))).astype(np.int32)
    cur = np.roll(ref, (4, -8), (0, 1)) + rng.integers(-3, 4, ref.shape)
    return np.clip(cur, 0, 255).astype(np.uint8), ref.astype(np.uint8)


@pytest.mark.parametrize("halo_dcols", [0, 4, 8])
def test_coarse_votes_of_a_tile_match_jax(halo_dcols):
    """The right half of a plane votes over its downsampled columns plus
    ``halo_dcols`` real ones each side (edge-padded past the picture)."""
    cur, ref = _vote_planes()
    w = cur.shape[1]
    rd = np.asarray(JC._downsample4(jnp.asarray(ref)))
    wd, h2 = w // 4, w // 2
    rd_pad = np.pad(rd, ((0, 0), (halo_dcols, halo_dcols)), mode="edge")
    ext = rd_pad[:, wd // 2:wd + 2 * halo_dcols]  # the right tile's columns and halo
    tile = cur[:, h2:]
    want = JC.coarse_votes_jnp(jnp.asarray(tile), jnp.asarray(ext), halo_dcols)
    got = TC.coarse_votes(torch.from_numpy(np.ascontiguousarray(tile)),
                          torch.from_numpy(np.ascontiguousarray(ext)), halo_dcols)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == (cur.shape[0] // 16) * (h2 // 16)
    np.testing.assert_array_equal(TC.select_coarse(got).numpy(),
                                  np.asarray(JC.select_coarse_jnp(want)))


@pytest.mark.parametrize("halo_dcols", [9, -1])
def test_coarse_votes_halo_range_matches_jax(halo_dcols):
    cur, ref = _vote_planes()
    rd = np.asarray(JC._downsample4(jnp.asarray(ref)))
    with pytest.raises(ValueError) as got:
        TC.coarse_votes(torch.from_numpy(cur), torch.from_numpy(rd.copy()), halo_dcols)
    with pytest.raises(ValueError) as want:
        JC.coarse_votes_jnp(jnp.asarray(cur), jnp.asarray(rd), halo_dcols)
    assert str(got.value) == str(want.value)


# -- the tile device half -----------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_tile_p(halo, halo_cols):
    """Both defer_skip forms of one tile in one program (one compile)."""
    return jax.jit(lambda *a: tuple(
        JC.encode_tile_p_planes(*a[:7], halo=halo, halo_cols=halo_cols, coarse=a[7],
                                defer_skip=d) for d in (False, True)))


def _tile_inputs(halo, halo_cols, seed):
    """The (1, 1) tile of a 3x3 grid of 3x4-MB tiles (48x64 luma) and its
    2D slab; the frame moved diagonally by more than a 16-pixel halo."""
    rng = np.random.default_rng(seed)
    th, tw = 48, 64
    ref = [np.kron(rng.integers(0, 256, ((3 * th >> s) // 8, (3 * tw >> s) // 8)),
                   np.ones((8, 8))).astype(np.uint8) for s in (0, 1, 1)]
    cur = [np.roll(ref[0], (21, -19), (0, 1)), np.roll(ref[1], (10, -9), (0, 1)),
           np.roll(ref[2], (10, -9), (0, 1))]

    def crop(p, s, hv, hc):
        rows = np.clip(np.arange((th >> s) - hv, 2 * (th >> s) + hv), 0, p.shape[0] - 1)
        cols = np.clip(np.arange((tw >> s) - hc, 2 * (tw >> s) + hc), 0, p.shape[1] - 1)
        return p[rows][:, cols]

    srcs = [crop(c, s, 0, 0) for c, s in zip(cur, (0, 1, 1))]
    slabs = [crop(r, s, halo >> s, halo_cols >> s) for r, s in zip(ref, (0, 1, 1))]
    # the row-merged list a grid would inject: the full frame's coarse vote
    coarse = TC.coarse_vote_candidates(torch.from_numpy(cur[0]), torch.from_numpy(ref[0]))
    return srcs, slabs, coarse


@pytest.mark.parametrize("defer_skip", [False, True], ids=["skip", "defer_skip"])
@pytest.mark.parametrize("halo_cols", [0, 16, 40])
def test_encode_tile_p_planes_matches_jax(halo_cols, defer_skip):
    halo = 16 if halo_cols == 16 else 40
    srcs, slabs, coarse = _tile_inputs(halo, halo_cols, 3 + halo_cols)
    if halo_cols == 0:  # a full-width slab: the band case with an injected list
        srcs = [np.ascontiguousarray(np.tile(s, (1, 3))) for s in srcs]
        slabs = [np.ascontiguousarray(np.tile(s, (1, 3))) for s in slabs]
    want = _jax_tile_p(halo, halo_cols)(*srcs, *slabs, jnp.int32(QP),
                                        jnp.asarray(coarse.numpy()))[defer_skip]
    got = TC.encode_tile_p_planes(*_t((*srcs, *slabs)), QP, halo=halo, halo_cols=halo_cols,
                                  coarse=coarse, defer_skip=defer_skip)
    _eq_out(got, want)
    assert ("resid_zero" in got) == defer_skip and ("skip" in got) != defer_skip
    assert (got["mvs"].numpy() != 0).any()


# -- the stacked tile steps -----------------------------------------------

GW, GH = 192, 96  # 6x12 MBs -> a 2x2 grid of 3x6-MB tiles


def _grid_inputs(seed=13):
    """(bands, cols, th, tw) source and moved planes of a 2x2 grid."""
    rng = np.random.default_rng(seed)
    planes = [np.clip(np.kron(rng.integers(0, 256, ((GH >> s) // 8, (GW >> s) // 8)),
                              np.ones((8, 8))) + rng.integers(-2, 3, (GH >> s, GW >> s)),
                      0, 255).astype(np.uint8) for s in (0, 1, 1)]
    moved = [np.roll(planes[0], (8, -12), (0, 1)), np.roll(planes[1], (4, -6), (0, 1)),
             np.roll(planes[2], (4, -6), (0, 1))]
    # a new block pattern across both seams
    moved[0][32:64, 80:112] = np.kron(rng.integers(0, 256, (4, 4)), np.ones((8, 8)))

    def tiles(ps):
        return [np.ascontiguousarray(p.reshape(2, p.shape[0] // 2, 2, p.shape[1] // 2)
                                     .transpose(0, 2, 1, 3)) for p in ps]
    return tiles(planes), tiles(moved)


# the stacked-step tests call the jitted steps of the whole-encoder rows
# at the same geometry (one compile each), entropy off / CAVLC / CABAC
_STEP_ROWS = {"none": "cabac_grid2x2", "cavlc": "device_cavlc_grid2x2",
              "cabac": "device_cabac_grid2x2"}


def test_stacked_tile_i_step_matches_jax():
    cur, _ = _grid_inputs()
    want = jax_encoder(_STEP_ROWS["none"])._step_i(*_on_dev0(cur), np.int32(QP))
    got = TB._stacked_tile_i_step(*_t(cur), QP, bands=2, cols=2, cap_rows=min(27 * 36, 4096))
    for name, g, w in zip(("prefix", "buf", "ry", "ru", "rv"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("entropy", ["none", "cavlc", "cabac"])
def test_stacked_tile_p_step_matches_jax(entropy):
    """The tile P step against the tile IDR's recon crops: the merged
    votes, the 2D slabs with their corner blocks, the row merge and the
    row pack; every output equal."""
    ref, cur = _grid_inputs()
    m = 3 * 12
    rec = TB._stacked_tile_i_step(*_t(ref), QP, bands=2, cols=2, cap_rows=min(27 * m, 4096))[2:]
    want = jax_encoder(_STEP_ROWS[entropy])._step_p(*_on_dev0(cur), np.int32(QP),
                                                    *_on_dev0(r.numpy() for r in rec))
    got = TB._stacked_tile_p_step(*_t(cur), QP, *rec, entropy=_entropy(tdc, m, entropy),
                                  bands=2, cols=2, halo=40, halo_cols=40, nscap=m,
                                  cap_rows=min(26 * m, 4096))
    for name, g, w in zip(("fused", "buf", "ry", "ru", "rv"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if entropy != "none":
        assert 1 in {int(f[0, 0]) for f in got[0]}


# -- the whole encoder against JAX --------------------------------------

# name -> (w, h, kwargs); the device-entropy rows code flat blocks. The
# rows at GW x GH with device entropy off share one step program (the coder
# is host-side), so the JAX side compiles it once.
GRIDS = {
    "grid2x2": (GW, GH, dict(bands=2, cols=2)),
    "grid1x2": (W, H, dict(bands=1, cols=2)),
    "ragged_336x192_grid4x3": (336, 192, dict(bands=4, cols=3)),
    "cabac_grid2x2": (GW, GH, dict(bands=2, cols=2, entropy_coder="cabac")),
    "device_cavlc_grid2x2": (GW, GH, dict(bands=2, cols=2, device_entropy=True,
                                          bits_min_mbs=4)),
    "device_cabac_grid2x2": (GW, GH, dict(bands=2, cols=2, device_entropy=True,
                                          bits_min_mbs=4, entropy_coder="cabac")),
}


def _frames(w, h, name):
    return trace(w, h, blocks=name.startswith("device_"))


@functools.lru_cache(maxsize=None)
def grid_run(name, port: bool):
    """(frames, link bytes) of a GRIDS row, or with ``name`` "bands:..."
    the same row with cols=1 (its band oracle)."""
    oracle = name.startswith("bands:")
    w, h, kw = GRIDS[name.split(":")[-1]]
    kw = dict(kw, cols=1, halo_cols=None) if oracle else kw
    if not port:
        return drive(jax_encoder(name), _frames(w, h, name))
    enc = TorchBandedH264Encoder(w, h, qp=QP, device="cpu", **kw)
    try:
        assert enc.cols == (1 if oracle else kw["cols"])
        return drive(enc, _frames(w, h, name.split(":")[-1]))
    finally:
        enc.close()


@functools.lru_cache(maxsize=None)
def jax_encoder(name):
    """A GRIDS row's JAX encoder, one per process: its steps compile once."""
    w, h, kw = GRIDS[name]
    enc = JB.BandedH264Encoder(w, h, qp=QP, devices=jax.devices()[:1], **kw)
    assert not enc.mesh_enabled and enc.cols == kw["cols"]
    return enc


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_encoder_matches_jax(name):
    got, got_links = grid_run(name, True)
    want, want_links = grid_run(name, False)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name} frame {i}: {g} != {w}"
    assert len(got) == len(want) and got_links == want_links
    if name.startswith("device_"):
        assert {"bits" if "cavlc" in name else "cabac", "coeff"} <= {m for *_, m in got}


# -- identities inside the port --------------------------------------------


@pytest.mark.parametrize("name", ["grid2x2", "grid1x2", "ragged_336x192_grid4x3",
                                  "device_cavlc_grid2x2"])
def test_grid_equals_its_band_oracle(name):
    """At the default full-reach halos an RxC AU equals bands=R's."""
    got, _ = grid_run(name, True)
    want, _ = grid_run("bands:" + name, True)
    assert [g[0] for g in got] == [w[0] for w in want]


def test_grid_au_has_one_slice_per_band_row():
    frames = [f for f, _ in trace(GW, GH)[:3]]
    enc = TorchBandedH264Encoder(GW, GH, qp=QP, bands=2, cols=2, device="cpu")
    try:
        assert (enc.bands, enc.cols, enc.halo, enc.halo_cols) == (2, 2, 40, 40)
        for i, f in enumerate(frames):
            (au, st, _), = enc.submit(f)
            assert len(_split_nals(au)) == (2 + 2 if i == 0 else 2)
            assert (st.bands, st.cols, len(st.band_step_ms)) == (2, 2, 2)
        assert enc._ref[0].shape == (2, 2, 48, 96)
    finally:
        enc.close()


def test_grid_env_owns_the_carve(monkeypatch):
    monkeypatch.setenv("SELKIES_BANDS", "4")
    monkeypatch.setenv("SELKIES_TILE_GRID", "2x2")
    monkeypatch.setenv("SELKIES_TILE_HALO", "17")
    enc = TorchBandedH264Encoder(W, H, device="cpu")
    jenc = JB.BandedH264Encoder(W, H, devices=jax.devices()[:1])
    try:
        assert (enc.bands, enc.cols, enc.halo, enc.halo_cols) == (
            jenc.bands, jenc.cols, jenc.halo, jenc.halo_cols) == (2, 2, 40, 16)
    finally:
        enc.close()
        jenc.close()
    # one band-row spans the frame: its tiles' slabs have the whole height
    enc = TorchBandedH264Encoder(W, H, bands=1, cols=2, halo=24, device="cpu")
    assert (enc.halo, enc.halo_cols) == (0, 16)
    enc.close()
