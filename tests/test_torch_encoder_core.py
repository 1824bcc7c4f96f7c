"""Port parity: selkies_tpu_torch encoder_core against the JAX encode core.

Inputs are made from a seed with numpy, run through both versions in one
process and compared as numpy arrays. The pipeline is integer-exact, so
every comparison is exact equality (tolerance zero)."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from selkies_tpu.models.h264 import encoder_core as J
from selkies_tpu_torch.models.h264 import encoder_core as T
from selkies_tpu_torch.models.h264 import intra
from selkies_tpu_torch.models.h264 import numpy_ref as ref_np

QPS = (0, 26, 51)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    np.testing.assert_array_equal(got, want, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def test_quant_tables_match_jax():
    _eq(T._MF_BY_REM, J._MF_BY_REM, "_MF_BY_REM")
    _eq(T._V_BY_REM, J._V_BY_REM, "_V_BY_REM")
    _eq(T._CHROMA_QP, J._CHROMA_QP, "_CHROMA_QP")


@pytest.mark.parametrize("qp", QPS)
def test_transforms_and_quant_match_jax(qp):
    rng = np.random.default_rng(qp + 7)
    blocks = rng.integers(-255, 256, (6, 3, 4, 4)).astype(np.int32)
    coeffs = rng.integers(-4000, 4001, (6, 3, 4, 4)).astype(np.int32)
    levels = rng.integers(-60, 61, (6, 3, 4, 4)).astype(np.int32)
    dc4 = rng.integers(-4000, 4001, (5, 4, 4)).astype(np.int32)
    dc2 = rng.integers(-4000, 4001, (5, 2, 2)).astype(np.int32)
    lv2 = rng.integers(-60, 61, (5, 2, 2)).astype(np.int32)
    _eq(T.fdct4(_t(blocks)), J.fdct4(blocks), "fdct4")
    _eq(T.idct4(_t(coeffs)), J.idct4(coeffs), "idct4")
    _eq(T._had4(_t(dc4)), J._had4(dc4), "_had4")
    _eq(T._had2(_t(dc2)), J._had2(dc2), "_had2")
    for intra in (True, False):
        _eq(T.quant4(_t(coeffs), qp, intra), J.quant4(coeffs, qp, intra), f"quant4 {intra}")
        _eq(T.quant_chroma_dc(_t(dc2), qp, intra), J.quant_chroma_dc(dc2, qp, intra),
            f"quant_chroma_dc {intra}")
    _eq(T.dequant4(_t(levels), qp), J.dequant4(levels, qp), "dequant4")
    _eq(T.quant_luma_dc(_t(dc4), qp), J.quant_luma_dc(dc4, qp), "quant_luma_dc")
    _eq(T.dequant_luma_dc(_t(levels[:, 0]), qp), J.dequant_luma_dc(levels[:, 0], qp),
        "dequant_luma_dc")
    _eq(T.dequant_chroma_dc(_t(lv2), qp), J.dequant_chroma_dc(lv2, qp), "dequant_chroma_dc")


def _planes(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8))


@pytest.mark.parametrize("h,w,qp", [(48, 64, 0), (48, 64, 26), (96, 128, 51), (96, 128, 30)])
def test_encode_frame_planes_matches_jax(h, w, qp):
    y, u, v = _planes(h, w, h + w + qp)
    want = J.encode_frame_planes(y, u, v, qp)
    got = T.encode_frame_planes(_t(y), _t(u), _t(v), qp)
    assert set(got) == set(want)
    for key in want:
        _eq(got[key], want[key], key)


def _p_case(h, w, motion, noise, seed):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w), np.int64)
    ref = np.roll(cur, motion, (0, 1))
    if noise:
        ref = ref + rng.integers(-noise, noise + 1, ref.shape)
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    cu = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    cv = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    return cur.astype(np.uint8), ref, cu, cv


def test_coarse_votes_and_candidates_match_jax():
    cur, ref, _, _ = _p_case(96, 128, (9, -13), 4, seed=3)
    rd = J._downsample4(jnp.asarray(ref))
    _eq(T._downsample4(_t(ref)), rd, "_downsample4")
    _eq(T.coarse_votes(_t(cur), _t(np.asarray(rd))), J.coarse_votes_jnp(jnp.asarray(cur), rd),
        "coarse_votes")
    got = T.coarse_vote_candidates(_t(cur), _t(ref))
    _eq(got, J.coarse_vote_candidates_jnp(jnp.asarray(cur), jnp.asarray(ref)), "coarse")
    _eq(got, ref_np.coarse_vote_candidates(cur, ref), "coarse vs numpy_ref")


@pytest.mark.parametrize("dy_max,dx_max", [(None, None), (6, None), (None, 10), (4, 30), (2, 2)])
def test_refine_cands_match_jax(dy_max, dx_max):
    coarse = np.array([[8, -8], [-3, 5], [0, 1]], np.int32)
    got = T._refine_cands(_t(coarse), dy_max, dx_max)
    _eq(got, J._refine_cands_jnp(jnp.asarray(coarse), dy_max, dx_max), "refine")
    if dy_max is None and dx_max is None:
        _eq(got, ref_np.refine_candidate_list(coarse), "refine vs numpy_ref")


def test_select_coarse_tie_order_matches_jax():
    """Equal vote counts resolve to the lower rank, as lax.top_k does."""
    votes = np.zeros(289, np.int32)
    votes[[5, 40, 41, 200]] = [7, 7, 3, 7]
    _eq(T.select_coarse(_t(votes)), J.select_coarse_jnp(jnp.asarray(votes)), "select")


@pytest.mark.parametrize("h,w,motion,noise", [
    (64, 128, (0, 0), 0),
    (96, 192, (-30, 22), 3),
    (128, 128, (7, 7), 40),
])
def test_hier_me_mc_matches_jax_and_numpy_ref(h, w, motion, noise):
    cur, ref, cu, cv = _p_case(h, w, motion, noise, seed=h + w)
    pads = [np.pad(p, J.MV_PAD, mode="edge") for p in (ref, cu, cv)]
    want = J.hier_me_mc(jnp.asarray(cur.astype(np.int32)), jnp.asarray(ref),
                        *(jnp.asarray(p) for p in pads))
    got = T.hier_me_mc(_t(cur.astype(np.int32)), _t(ref), *(_t(p) for p in pads))
    for name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
        _eq(a, b, name)
    # golden model: per-MB MVs and per-MB MC blocks
    mvs = ref_np.hier_search_me(cur, ref)
    _eq(got[0], mvs, "mvs vs numpy_ref")
    pred_y, pred_u, pred_v = (g.numpy() for g in got[1:])
    for mby in range(h // 16):
        for mbx in range(w // 16):
            mv = mvs[mby, mbx]
            np.testing.assert_array_equal(
                pred_y[mby * 16:mby * 16 + 16, mbx * 16:mbx * 16 + 16],
                ref_np.mc_luma_16x16(pads[0], mbx, mby, mv))
            for pred, pad in ((pred_u, pads[1]), (pred_v, pads[2])):
                np.testing.assert_array_equal(
                    pred[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8],
                    ref_np.mc_chroma_8x8(pad, mbx, mby, mv))


def test_edge_pad_matches_numpy():
    a = np.arange(35, dtype=np.uint8).reshape(5, 7)
    _eq(T.edge_pad(_t(a), 3), np.pad(a, 3, mode="edge"), "edge_pad")
    _eq(T.edge_pad(_t(a), 0, 2, 0, 5), np.pad(a, ((0, 2), (0, 5)), mode="edge"), "edge_pad asym")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skip_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mvs = rng.integers(-2, 3, (5, 7, 2)).astype(np.int32)
    mvs[rng.random((5, 7)) < 0.4] = 0
    resid_zero = rng.random((5, 7)) < 0.7
    got = T._skip_mask(_t(mvs), _t(resid_zero))
    _eq(got, J._skip_mask(jnp.asarray(mvs), jnp.asarray(resid_zero)), "skip")
    for y in range(5):
        for x in range(7):
            want = resid_zero[y, x] and tuple(mvs[y, x]) == ref_np.skip_mv_16x16(mvs, x, y)
            assert bool(got[y, x]) == want, (y, x)


@pytest.mark.parametrize("qp", QPS)
def test_encode_frame_p_planes_and_downlink_match_jax(qp):
    cur, ref, cu, cv = _p_case(64, 96, (3, -5), 2, seed=qp)
    ru, rv = np.roll(cu, (1, -2), (0, 1)), np.roll(cv, (1, -2), (0, 1))
    args = (cur, cu, cv, ref, ru, rv)
    want = J.encode_frame_p_planes(*(jnp.asarray(a) for a in args), qp)
    got = T.encode_frame_p_planes(*(_t(a) for a in args), qp)
    assert set(got) == set(want)
    for key in want:
        _eq(got[key], want[key], key)
    hj, bj = J.pack_p_compact(want)
    ht, bt = T.pack_p_compact(got)
    _eq(ht, hj, "p header")
    _eq(bt, bj, "p rows")
    for cap in (4096, 5):
        _eq(T.fuse_downlink(ht, bt, cap), J.fuse_downlink(hj, bj, cap), f"fuse {cap}")


@pytest.mark.parametrize("qp", [10, 40])
def test_pack_i_compact_matches_jax(qp):
    y, u, v = _planes(48, 64, qp)
    want = J.encode_frame_planes(y, u, v, qp)
    got = T.encode_frame_planes(_t(y), _t(u), _t(v), qp)
    hj, bj = J.pack_i_compact(want)
    ht, bt = T.pack_i_compact(got)
    _eq(ht, hj, "i header")
    _eq(bt, bj, "i rows")
    _eq(T.fuse_downlink(ht, bt, 7), J.fuse_downlink(hj, bj, 7), "fuse")


def test_bitpack_words_high_bit():
    """Bit 31 set: the packed word is negative int32, as in JAX."""
    bits = np.zeros(70, bool)
    bits[[0, 31, 33, 63, 69]] = True
    _eq(T._bitpack32(_t(bits)), J._bitpack32(jnp.asarray(bits)), "bitpack32")


# -- the intra kernel's wrapper (models/h264/intra.py) without a card


def test_cpu_planes_take_the_plain_intra_version():
    y, u, v = _planes(32, 48, 3)
    before = intra.launches
    got = T.encode_frame_planes_batch(_t(y[None]), _t(u[None]), _t(v[None]),
                                      torch.tensor([30], dtype=torch.int32))
    want = J.encode_frame_planes(y, u, v, 30)
    assert intra.launches == before
    for key in want:
        _eq(got[key][0], want[key], key)


def _bad_intra_args(case):
    y, u, v = (_t(p) for p in _planes(32, 48, 5))
    rows = T._QPRows.of(28, torch.device("cpu")).rows
    if case == "h-not-16":
        y, u, v = y[:24], u[:12], v[:12]
    elif case == "w-not-16":
        y, u, v = y[:, :40], u[:, :20], v[:, :20]
    elif case == "under-one-mb":
        y, u, v = y[:8, :8], u[:4, :4], v[:4, :4]
    elif case == "chroma-shape":
        u = u[:, :-8]
    elif case == "chroma-lead":
        y = y[None].expand(2, -1, -1)
    elif case == "four-dims":
        y, u, v = y[None, None], u[None, None], v[None, None]
    elif case == "qp-rows-count":
        y, u, v = y[None].expand(3, -1, -1), u[None].expand(3, -1, -1), v[None].expand(3, -1, -1)
        rows = T._QPRows.gather(torch.tensor([1, 2], dtype=torch.int32)).rows
    elif case == "qp-rows-width":
        rows = rows[:, :44]
    return y, u, v, rows


@pytest.mark.parametrize("case", ["h-not-16", "w-not-16", "under-one-mb", "chroma-shape",
                                  "chroma-lead", "four-dims", "qp-rows-count", "qp-rows-width"])
def test_intra_wrapper_refuses_bad_shapes_before_loading(case, monkeypatch):
    """The shape contract raises on any device, before the library loads."""
    def no_load():
        raise AssertionError("the library loaded")

    monkeypatch.setattr(intra, "_load", no_load)
    with pytest.raises(ValueError):
        intra.encode_intra(*_bad_intra_args(case))


def test_intra_wrapper_refuses_cpu_planes(monkeypatch):
    monkeypatch.setattr(intra, "_load", lambda: pytest.fail("the library loaded"))
    y, u, v = (_t(p) for p in _planes(32, 48, 6))
    with pytest.raises(ValueError, match="CUDA"):
        intra.encode_intra(y, u, v, T._QPRows.of(20, torch.device("cpu")).rows)


def test_intra_kernel_reads_the_qp_table_layout():
    """csrc/intra.cu reads each QP's constants at the columns _QP_COLS gives."""
    src = intra.SOURCE.read_text()
    names = {"kMf": "mf", "kVs": "vs", "kQbits": "qbits", "kFi": "f_i", "kMf00": "mf00",
             "kF2i": "f2_i", "kQb1": "qb1", "kV00": "v00", "kDcA": "dc_a", "kDcR": "dc_r",
             "kDcB": "dc_b", "kQper": "qper"}
    for const, col in names.items():
        m = re.search(rf"\b{const} = (\d+)", src)
        assert m and int(m.group(1)) == T._QP_COLS[col], const
    assert re.search(rf"kQpHalf = {T._QP_HALF};", src)
    assert intra.QP_ROW == T._qp_table().shape[1] == 2 * T._QP_HALF
