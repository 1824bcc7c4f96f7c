"""Device CAVLC (K2) of the port against the JAX coder and the host packer.

The same seeded coefficients go through ``selkies_tpu``'s device_cavlc
(JAX on the CPU) and ``selkies_tpu_torch``'s (``device="cpu"`` tensors):
every key of ``_frame_structure``, the full-grid words, and the active
coder at every bucket of an explicit ladder must be equal element for
element; the assembled NAL must equal ``cavlc.pack_slice_p``. The cases
mirror tests/test_device_cavlc.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from selkies_tpu.models.h264 import device_cavlc as jdc  # noqa: E402
from selkies_tpu.models.h264.bitstream import StreamParams as JStreamParams  # noqa: E402
from selkies_tpu.models.h264.cavlc import pack_slice_p as jax_pack_slice_p  # noqa: E402
from selkies_tpu.models.h264.encoder_core import pack_p_sparse_entropy as jax_entropy  # noqa: E402
from selkies_tpu_torch.models.h264 import device_cavlc as tdc  # noqa: E402
from selkies_tpu_torch.models.h264.bitstream import StreamParams  # noqa: E402
from selkies_tpu_torch.models.h264.cavlc import pack_slice_p  # noqa: E402
from selkies_tpu_torch.models.h264.compact import p_sparse_entropy_meta  # noqa: E402
from selkies_tpu_torch.models.h264.encoder_core import (  # noqa: E402
    encode_frame_p_planes,
    pack_p_sparse_entropy,
)
from selkies_tpu_torch.models.h264.native import derive_skip_mvs  # noqa: E402
from selkies_tpu_torch.models.h264.numpy_ref import PFrameCoeffs  # noqa: E402
from selkies_tpu_torch.models.h264.sparse_complete import complete_sparse_slice  # noqa: E402
from selkies_tpu_torch.models.stats import LinkByteCounter  # noqa: E402

WORD_CAP = 4096
KEYS = ("mvs", "skip", "luma_ac", "chroma_dc", "chroma_ac")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_fc(mbh, mbw, qp, seed, skip_p=0.6, mag=8, mv_range=8, derive=False):
    """Sparse random coefficients (skip MBs carry none). ``derive`` gives
    skip MBs their derived skip MV, as the sparse wire reconstructs them."""
    rng = np.random.default_rng(seed)
    skip = rng.random((mbh, mbw)) < skip_p
    mvs = rng.integers(-mv_range, mv_range + 1, (mbh, mbw, 2)).astype(np.int32)
    if derive:
        derive_skip_mvs(mvs, skip)

    def coeffs(shape):
        c = rng.integers(-mag, mag + 1, shape).astype(np.int32)
        c[rng.random(shape) < 0.8] = 0
        return c

    luma = coeffs((mbh, mbw, 4, 4, 4, 4))
    cac = coeffs((mbh, mbw, 2, 2, 2, 4, 4))
    cac[..., 0, 0] = 0  # AC blocks: DC position unused
    cdc = coeffs((mbh, mbw, 2, 2, 2))
    for a in (luma, cac, cdc):
        a[skip] = 0
    return PFrameCoeffs(mvs=mvs, skip=skip, luma_ac=luma, chroma_dc=cdc, chroma_ac=cac, qp=qp)


def _real_fc():
    """P-frame coefficients from the port's own encode core."""
    rng = np.random.default_rng(23)
    h, w = 64, 96
    y0 = rng.integers(0, 255, (h, w)).astype(np.uint8)
    u0 = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
    v0 = rng.integers(0, 255, (h // 2, w // 2)).astype(np.uint8)
    t = torch.from_numpy
    out = encode_frame_p_planes(t(np.roll(y0, 3, 1)), t(np.roll(u0, 1, 1)),
                                t(np.roll(v0, 1, 1)), t(y0), t(u0), t(v0), 26)
    return PFrameCoeffs(**{k: out[k].numpy() for k in KEYS}, qp=26)


MBH, MBW = 4, 6  # one geometry, so each JAX function compiles once


def _chroma_dc_only():
    """cbp_chroma == 1: chroma DC coded, no chroma AC."""
    fc = random_fc(MBH, MBW, 26, 19, skip_p=0.0, mag=4)
    fc.chroma_ac[:] = 0
    return fc


def _skip_runs():
    fc = random_fc(MBH, MBW, 24, 11, skip_p=0.5)
    fc.skip[0, :5] = True  # leading run
    fc.skip[-1, -4:] = True  # trailing run
    for a in (fc.luma_ac, fc.chroma_ac, fc.chroma_dc):
        a[fc.skip] = 0
    return fc


CASES = {
    "sparse0": lambda: random_fc(MBH, MBW, 26, 0),
    "sparse1": lambda: random_fc(MBH, MBW, 26, 1),
    "sparse2": lambda: random_fc(MBH, MBW, 26, 2),
    "dense": lambda: random_fc(MBH, MBW, 30, 7, skip_p=0.0, mag=3),
    "all_skip": lambda: random_fc(MBH, MBW, 28, 9, skip_p=1.1),
    "skip_runs": _skip_runs,
    # level escapes and extended prefixes (level_code past 4096)
    "escape900": lambda: random_fc(MBH, MBW, 4, 13, skip_p=0.2, mag=900),
    "escape5000": lambda: random_fc(MBH, MBW, 2, 29, skip_p=0.1, mag=5000),
    "mvs": lambda: random_fc(MBH, MBW, 26, 17, skip_p=0.3, mv_range=30),
    "chroma_dc_only": _chroma_dc_only,
    "real_encoder": _real_fc,
}
M = MBH * MBW
LADDER = (4, 16, M)
_jax_structure = jax.jit(jdc._frame_structure)
_jax_bits = jax.jit(lambda o: jdc.pack_p_slice_bits(o, WORD_CAP))
_jax_active = jax.jit(lambda o: jdc.pack_p_slice_bits_active(o, WORD_CAP, LADDER))


def _outs(fc):
    return ({k: jnp.asarray(getattr(fc, k)) for k in KEYS},
            {k: torch.from_numpy(np.ascontiguousarray(getattr(fc, k))) for k in KEYS})


def _u32(a):
    """JAX uint32 words or the port's int32 bit patterns -> uint32."""
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("case", list(CASES))
def test_frame_structure_every_key(case):
    jo, to = _outs(CASES[case]())
    want = _jax_structure(jo)
    got = tdc._frame_structure(to)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("case", list(CASES))
def test_pack_p_slice_bits_matches_jax_and_host(case):
    fc = CASES[case]()
    jo, to = _outs(fc)
    jw, jn, jt = _jax_bits(jo)
    tw, tn, tt = tdc.pack_p_slice_bits(to, WORD_CAP)
    assert tw.dtype == torch.int32 and tw.shape == (WORD_CAP,)
    assert np.array_equal(_u32(tw.numpy()), np.asarray(jw))
    assert (int(tn), int(tt)) == (int(jn), int(jt))
    mbh, mbw = fc.skip.shape
    p = StreamParams(width=16 * mbw, height=16 * mbh, qp=fc.qp)
    nal = tdc.assemble_p_nal(tw.numpy(), int(tn), int(tt), p, 1, fc.qp)
    assert nal == pack_slice_p(fc, p, frame_num=1)
    assert nal == jax_pack_slice_p(fc, JStreamParams(width=16 * mbw, height=16 * mbh, qp=fc.qp),
                                   frame_num=1)


@pytest.mark.parametrize("live", [0, 1, 3, 4, 5, 15, 16, 17, M])
def test_active_coder_at_every_bucket(live):
    """ns below, at and past each rung of (4, 16, 24): every bucket that
    holds the coded MBs gives the JAX coder's words (its lax.switch picks
    the smallest); a smaller one drops MBs."""
    fc = random_fc(MBH, MBW, 26, 100 + live, skip_p=0.0)
    fc.skip.reshape(-1)[live:] = True
    for a in (fc.luma_ac, fc.chroma_ac, fc.chroma_dc):
        a[fc.skip] = 0
    jo, to = _outs(fc)
    ladder = LADDER
    jw, jn, jt, jns = _jax_active(jo)
    assert int(jns) == live
    for bucket in ladder:
        tw, tn, tt, tns = tdc.pack_p_slice_bits_active(to, WORD_CAP, ladder, bucket=bucket)
        assert int(tns) == live and int(tt) == int(jt)
        same = np.array_equal(_u32(tw.numpy()), np.asarray(jw)) and int(tn) == int(jn)
        assert same == (bucket >= live or live == 0), bucket
    assert tdc.bits_buckets(24, ladder) == ladder and tdc.bits_buckets(3) == (3,)
    assert tdc.bits_buckets(8160) == (256, 1024, 4096, 8160)
    with pytest.raises(ValueError):
        tdc.pack_p_slice_bits_active(to, WORD_CAP, ladder, bucket=5)


# -- the fused downlink: meta prefix + sparse coefficients or bit words ---


_jax_fused = {}


def _fused(fc, bits_words=1 << 12, min_mbs=0, density=75):
    jo, to = _outs(fc)
    key = (bits_words, min_mbs, density)
    if key not in _jax_fused:
        _jax_fused[key] = jax.jit(
            lambda o: jax_entropy(o, M, M * 26, density, bits_words, min_mbs, LADDER))
    want = _jax_fused[key](jo)
    got = pack_p_sparse_entropy(to, M, M * 26, density, bits_words, min_mbs, LADDER)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("kw,mode", [
    pytest.param({"density": None}, 1, id="bits_var"),
    pytest.param({}, 1, id="bits_packed"),
    pytest.param({"bits_words": 8}, 0, id="word_cap_overflow"),
    pytest.param({"min_mbs": 20}, 0, id="under_min_mbs"),
])
def test_fused_entropy_downlink_matches_jax(kw, mode):
    fc = random_fc(MBH, MBW, 26, 61, skip_p=0.4, derive=True)
    fused_d, dense_d, buf_d = _fused(fc, **kw)
    assert p_sparse_entropy_meta(fused_d.numpy())[0] == mode
    p = StreamParams(width=96, height=64, qp=fc.qp)
    nal, skipped, _tu, got_mode = complete_sparse_slice(
        fused_d.numpy(), mbh=4, mbw=6, nscap=M, cap_rows=M * 26, qp=fc.qp, frame_num=1,
        params=p, packed=kw.get("density", 75) is not None, device_bits=True, full_d=fused_d,
        buf_d=buf_d, dense_d=dense_d)
    assert got_mode == ("bits" if mode else "coeff")
    assert skipped == int(fc.skip.sum())
    assert nal == pack_slice_p(fc, p, frame_num=1)


def test_short_hint_refetches_bits():
    """A prefix shorter than the bit payload refetches the whole buffer,
    counts it as down_bits_refetch, and the bytes stay exact."""
    fc = random_fc(MBH, MBW, 26, 51, skip_p=0.3, derive=True)
    fused_d, _dense_d, buf_d = _fused(fc)
    short = fused_d.numpy()[:24]
    lb = LinkByteCounter()
    p = StreamParams(width=96, height=64, qp=fc.qp)
    nal, _s, _tu, mode = complete_sparse_slice(
        short, mbh=4, mbw=6, nscap=M, cap_rows=M * 26, qp=fc.qp, frame_num=1, params=p,
        packed=True, device_bits=True, full_d=fused_d, buf_d=buf_d, link_bytes=lb, prefix_bytes=short.nbytes)
    assert mode == "bits" and nal == pack_slice_p(fc, p, frame_num=1)
    snap = lb.snapshot()
    assert snap["down_bits"] == short.nbytes and snap["down_bits_refetch"] > 0


@pytest.mark.parametrize("hdr", [{"ltr_ref": 1}, {"mark_ltr": 0},
                                 {"mark_ltr": 1, "mmco_evict": (0, 2)}, {"first_mb": 6}],
                         ids=["ltr_ref", "mark_ltr", "mmco_evict", "first_mb"])
def test_assemble_header_variants(hdr):
    """The slice header is the host's: LTR flags and a band's first_mb
    shift the device stream's phase and nothing else."""
    fc = random_fc(MBH, MBW, 26, 71)
    _jo, to = _outs(fc)
    words, nbits, trailing = tdc.pack_p_slice_bits(to, WORD_CAP)
    p = StreamParams(width=96, height=64, qp=fc.qp)
    nal = tdc.assemble_p_nal(words.numpy(), int(nbits), int(trailing), p, 1, fc.qp, **hdr)
    assert nal == pack_slice_p(fc, p, frame_num=1, **hdr)
