"""Port parity for the sparse P downlinks: pack_p_sparse_var and
pack_p_sparse_packed (whole fused buffers, dense headers and row buffers,
both layouts, the dense-flag flip, ns > nscap and n > cap_rows), the host
unpackers, complete_sparse_slice, and the native sparse packer against the
Python path. Exact equality throughout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from selkies_tpu.models.h264 import bitstream as jbs
from selkies_tpu.models.h264 import compact as JK
from selkies_tpu.models.h264 import encoder_core as JC
from selkies_tpu.models.h264 import sparse_complete as JS
from selkies_tpu.models.stats import LinkByteCounter as JLinks
from selkies_tpu_torch.models.h264 import bitstream as tbs
from selkies_tpu_torch.models.h264 import compact as TK
from selkies_tpu_torch.models.h264 import encoder_core as TC
from selkies_tpu_torch.models.h264 import native
from selkies_tpu_torch.models.h264 import sparse_complete as TS
from selkies_tpu_torch.models.stats import LinkByteCounter

MBH, MBW = 6, 9  # 54 MBs: two skip words, the second partial


def _out(seed, p_skip, density, lanes):
    """A P step's outputs: skip MBs carry no coefficients; each coded MB's
    4x4 blocks are nonzero with probability ``density``, ``lanes`` nonzero
    coefficients out of 16 in a nonzero block."""
    rng = np.random.default_rng(seed)
    skip = rng.random((MBH, MBW)) < p_skip
    mvs = rng.integers(-40, 41, (MBH, MBW, 2)).astype(np.int32)

    def coeffs(shape):
        blocks = np.prod(shape[:-2])
        c = rng.integers(-30, 31, (blocks, 16))
        keep = rng.random((blocks, 16)) < lanes / 16
        c = np.where(keep, c, 0) * (rng.random((blocks, 1)) < density)
        c = c.reshape(shape).astype(np.int32)
        c[skip] = 0
        return c

    dc = rng.integers(-9, 10, (MBH, MBW, 2, 2, 2)) * (rng.random((MBH, MBW, 2, 1, 1)) < density)
    dc[skip] = 0
    return {
        "mvs": mvs, "skip": skip,
        "luma_ac": coeffs((MBH, MBW, 4, 4, 4, 4)),
        "chroma_dc": dc.astype(np.int32),
        "chroma_ac": coeffs((MBH, MBW, 2, 2, 2, 4, 4)),
    }


# name -> (seed, p_skip, block density, lanes, nscap, cap_rows)
_CASES = {
    "quiet": (1, 0.8, 0.3, 2, 4096, 4096),
    "busy_dense_flag": (2, 0.1, 0.9, 15, 4096, 4096),
    "ns_over_nscap": (3, 0.3, 0.4, 3, 10, 4096),
    "rows_over_cap": (4, 0.2, 0.7, 4, 4096, 40),
    "all_skip": (5, 1.0, 0.0, 0, 4096, 4096),
}


def _pair(case):
    seed, p_skip, dens, lanes, nscap, cap = _CASES[case]
    out = _out(seed, p_skip, dens, lanes)
    jout = {k: jnp.asarray(v) for k, v in out.items()}
    tout = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    return jout, tout, nscap, cap


def _eq(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("case", list(_CASES))
def test_pack_p_sparse_var_matches_jax(case):
    jout, tout, nscap, cap = _pair(case)
    want = JC.pack_p_sparse_var(jout, nscap, cap)
    got = TC.pack_p_sparse_var(tout, nscap, cap)
    for name, g, w in zip(("fused", "dense", "buf"), got, want):
        _eq(g, w, name)


@pytest.mark.parametrize("density", [75, 20])
@pytest.mark.parametrize("case", list(_CASES))
def test_pack_p_sparse_packed_matches_jax(case, density):
    jout, tout, nscap, cap = _pair(case)
    want = JC.pack_p_sparse_packed(jout, nscap, cap, density)
    got = TC.pack_p_sparse_packed(tout, nscap, cap, density)
    for name, g, w in zip(("fused", "dense", "buf"), got, want):
        _eq(g, w, name)


def test_dense_flag_takes_both_values():
    """The cases above cover both layouts of the packed buffer."""
    flags = set()
    for case in _CASES:
        _, tout, nscap, cap = _pair(case)
        fused = TC.pack_p_sparse_packed(tout, nscap, cap, 75)[0].numpy()
        flags.add(int(fused[:12].view(np.int32)[5]))
    assert flags == {0, 1}


def _pfc_eq(got, want):
    for k in ("mvs", "skip", "luma_ac", "chroma_dc", "chroma_ac", "qp"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


@pytest.mark.parametrize("packed", [False, True], ids=["var", "packed"])
@pytest.mark.parametrize("case", list(_CASES))
def test_unpackers_match_jax(case, packed):
    _, tout, nscap, cap = _pair(case)
    fused, dense, buf = (TC.pack_p_sparse_packed(tout, nscap, cap) if packed
                         else TC.pack_p_sparse_var(tout, nscap, cap))
    fused, buf = fused.numpy(), buf.numpy()
    n = int(fused[:2].view(np.int32)[0])
    extra = buf[cap:n] if n > cap else None
    unpack = ("unpack_p_sparse_packed" if packed else "unpack_p_sparse_var")
    want_pfc, want_rows = getattr(JK, unpack)(fused, 27, MBH, MBW, nscap, cap, extra)
    got_pfc, got_rows = getattr(TK, unpack)(fused, 27, MBH, MBW, nscap, cap, extra)
    np.testing.assert_array_equal(got_rows, want_rows)
    if want_pfc is None:
        assert got_pfc is None
    else:
        _pfc_eq(got_pfc, want_pfc)
    want_w = JK.p_sparse_wire_views(fused, MBH, MBW, nscap, cap, packed, extra)
    got_w = TK.p_sparse_wire_views(fused, MBH, MBW, nscap, cap, packed, extra)
    assert (got_w is None) == (want_w is None)
    if want_w is not None:
        for k in vars(want_w):
            np.testing.assert_array_equal(getattr(got_w, k), getattr(want_w, k), err_msg=k)


@pytest.mark.parametrize("hint", [24, None], ids=["short_hint", "full"])
@pytest.mark.parametrize("packed", [False, True], ids=["var", "packed"])
@pytest.mark.parametrize("case", ["quiet", "busy_dense_flag", "ns_over_nscap", "rows_over_cap"])
def test_complete_sparse_slice_matches_jax(case, packed, hint):
    """Same NAL, skip count, mode and link bytes; a 24-word hint forces the
    shortfall refetch."""
    jout, tout, nscap, cap = _pair(case)
    jf, jd, jb = (JC.pack_p_sparse_packed(jout, nscap, cap) if packed
                  else JC.pack_p_sparse_var(jout, nscap, cap))
    tf, td, tb = (TC.pack_p_sparse_packed(tout, nscap, cap) if packed
                  else TC.pack_p_sparse_var(tout, nscap, cap))
    w, h = MBW * 16, MBH * 16
    res = []
    for mod, params, f, d, b, links in (
            (JS, jbs.StreamParams(width=w, height=h, qp=26), jf, jd, jb, JLinks()),
            (TS, tbs.StreamParams(width=w, height=h, qp=26), tf, td, tb, LinkByteCounter())):
        pre = np.asarray(f)[:hint] if hint else np.asarray(f)
        needs = []
        nal, skipped, _, mode = mod.complete_sparse_slice(
            pre, mbh=MBH, mbw=MBW, nscap=nscap, cap_rows=cap, qp=30, frame_num=5,
            params=params, packed=packed, full_d=f, buf_d=b, dense_d=d, link_bytes=links,
            prefix_bytes=pre.nbytes, note_need=needs.append)
        res.append((nal, skipped, mode, links.snapshot(), needs))
    assert res[1] == res[0]
    assert res[1][2] == ("dense" if case == "ns_over_nscap" else "coeff")


@pytest.mark.parametrize("packed", [False, True], ids=["var", "packed"])
@pytest.mark.parametrize("case", ["quiet", "busy_dense_flag", "rows_over_cap", "all_skip"])
def test_native_sparse_packer_equals_python_path(case, packed):
    _, tout, nscap, cap = _pair(case)
    f, d, b = (TC.pack_p_sparse_packed(tout, nscap, cap) if packed
               else TC.pack_p_sparse_var(tout, nscap, cap))
    params = tbs.StreamParams(width=MBW * 16, height=MBH * 16)
    kw = dict(mbh=MBH, mbw=MBW, nscap=nscap, cap_rows=cap, qp=22, frame_num=9, params=params,
              packed=packed, full_d=f, buf_d=b, dense_d=d)
    before = native.sparse_calls
    got = TS.complete_sparse_slice(f.numpy(), **kw)
    assert native.sparse_calls == before + 1
    want = TS.complete_sparse_slice(f.numpy(), native_wire=False, **kw)
    assert native.sparse_calls == before + 1
    assert got[0] == want[0] and got[1] == want[1]


def test_fetch_rest_matches_jax():
    buf = np.arange(9000 * 16, dtype=np.int16).reshape(9000, 16)
    for n, base in ((4100, 4096), (8200, 4096), (500, 0), (9000, 40)):
        np.testing.assert_array_equal(TS.fetch_rest(torch.from_numpy(buf), n, base),
                                      JS.fetch_rest(jnp.asarray(buf), n, base))
