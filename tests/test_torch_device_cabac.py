"""The port's CABAC coder: the device tokenizer (K3) against the JAX
tokenizer and both packages' host coder, the context init, and the
native arithmetic engine against the Python one.

Token words, counts and fused downlinks must equal the JAX package's
element for element; assembled NALs must equal ``pack_slice_p_cabac``
of the port and of the JAX package. The cases mirror
tests/test_device_cabac_tokens.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_device_cavlc import KEYS, random_fc

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from selkies_tpu.models.h264 import cabac as jcabac  # noqa: E402
from selkies_tpu.models.h264 import device_cabac as jdcb  # noqa: E402
from selkies_tpu.models.h264.bitstream import StreamParams as JStreamParams  # noqa: E402
from selkies_tpu.models.h264.encoder_core import pack_p_sparse_entropy as jax_entropy  # noqa: E402
from selkies_tpu_torch.models.h264 import cabac, native  # noqa: E402
from selkies_tpu_torch.models.h264 import device_cabac as tdcb  # noqa: E402
from selkies_tpu_torch.models.h264.bitstream import SLICE_I, SLICE_P, StreamParams  # noqa: E402
from selkies_tpu_torch.models.h264.compact import p_sparse_entropy_meta  # noqa: E402
from selkies_tpu_torch.models.h264.encoder_core import pack_p_sparse_entropy  # noqa: E402
from selkies_tpu_torch.models.h264.sparse_complete import complete_sparse_slice  # noqa: E402

MBH, MBW = 6, 8
M = MBH * MBW
W, H = MBW * 16, MBH * 16
LADDER = (4, 16, M)
WORD_CAP = 1 << 14


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fc(seed, live, mag=8, mv=8, mbh=MBH, qp=26):
    """Random coefficients with exactly ``live`` coded MBs; skip MBs carry
    their derived skip MV (coded MBs' mvd prediction reads them)."""
    fc = random_fc(mbh, MBW, qp, seed, skip_p=0.0, mag=mag, mv_range=mv)
    rng = np.random.default_rng(seed + 1000)
    skip = np.ones(mbh * MBW, bool)
    skip[rng.choice(mbh * MBW, size=min(live, mbh * MBW), replace=False)] = False
    fc.skip[:] = skip.reshape(mbh, MBW)
    for a in (fc.luma_ac, fc.chroma_ac, fc.chroma_dc):
        a[fc.skip] = 0
    native.derive_skip_mvs(fc.mvs, fc.skip)
    return fc


def _outs(fc):
    return ({k: jnp.asarray(getattr(fc, k)) for k in KEYS},
            {k: torch.from_numpy(np.ascontiguousarray(getattr(fc, k))) for k in KEYS})


_jax_full = jax.jit(lambda o: jdcb.pack_p_slice_tokens(o, word_cap=WORD_CAP))
_jax_active = jax.jit(lambda o: jdcb.pack_p_slice_tokens_active(o, word_cap=WORD_CAP,
                                                                 buckets=LADDER))


def _params(fc, h=H):
    return (StreamParams(width=W, height=h, qp=fc.qp, entropy_coder="cabac"),
            JStreamParams(width=W, height=h, qp=fc.qp, entropy_coder="cabac"))


def _assert_matches(fc, active=False, idc=0, first_mb=0, h=H, **hdr):
    """Tokens equal to JAX's (every bucket of the ladder that holds the
    coded MBs when ``active``), and the NAL equal to both host coders."""
    jo, to = _outs(fc)
    jw, jn, jc, jns = (_jax_active if active else _jax_full)(jo)
    ns = int((~fc.skip).sum())
    assert int(jns) == ns
    runs = ([tdcb.pack_p_slice_tokens_active(to, WORD_CAP, LADDER, bucket=b)
             for b in LADDER if b >= ns] if active else [tdcb.pack_p_slice_tokens(to, WORD_CAP)])
    p, jp = _params(fc, h)
    want = cabac.pack_slice_p_cabac(fc, p, frame_num=1, cabac_init_idc=idc, first_mb=first_mb,
                                    **hdr)
    assert want == jcabac.pack_slice_p_cabac(fc, jp, frame_num=1, cabac_init_idc=idc,
                                             first_mb=first_mb, **hdr)
    for tw, tn, tc, tns in runs:
        assert np.array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert (int(tn), int(tns)) == (int(jn), ns)
        nal = tdcb.assemble_p_cabac_nal(tw.numpy(), int(tn), tc.numpy()[:ns], fc.skip, p, 1,
                                        fc.qp, first_mb=first_mb, cabac_init_idc=idc, **hdr)
        assert nal == want, f"device CABAC diverged at ns={ns}"


@pytest.mark.parametrize("live", [0, 1, M // 2, M])
def test_density_sweep(live):
    _assert_matches(_fc(live * 7 + 1, live))


@pytest.mark.parametrize("live", [3, 4, 5, 15, 16, 17])
def test_bucket_boundaries(live):
    """ns at and around each rung: every bucket that holds the coded MBs
    gives the JAX tokenizer's output; padded slots emit nothing."""
    _assert_matches(_fc(live + 100, live), active=True)


@pytest.mark.parametrize("idc", [0, 1, 2])
def test_cabac_init_idc_variants(idc):
    _assert_matches(_fc(40 + idc, M // 2), idc=idc)


def test_escape_levels_through_ueg0():
    """Magnitudes far past the TU prefix: the closed-form UEG0 suffix."""
    _assert_matches(_fc(13, 5, mag=5000, qp=2))


def test_large_mvd_ueg3():
    """|mvd| past uCoff 9: the UEG3 escape."""
    _assert_matches(_fc(17, 8, mv=30))


def test_banded_slice_nonzero_first_mb():
    """A band slice (first_mb_in_slice > 0): the header's extra field
    shifts the stream phase."""
    _assert_matches(_fc(41, 10, mbh=3), first_mb=3 * MBW, h=6 * 16)


@pytest.mark.parametrize("hdr", [{"ltr_ref": 1}, {"mark_ltr": 0},
                                 {"mark_ltr": 1, "mmco_evict": (0, 2)}],
                         ids=["ltr_ref", "mark_ltr", "mmco_evict"])
def test_ltr_header_variants(hdr):
    _assert_matches(_fc(31, M // 2), **hdr)


# -- the fused downlink: meta + skip bitmap + counts + tokens ---------------

_jax_fused = {}


def _fused(fc, tok_words=1 << 14, min_mbs=0):
    jo, to = _outs(fc)
    key = (tok_words, min_mbs)
    if key not in _jax_fused:
        _jax_fused[key] = jax.jit(lambda o: jax_entropy(o, M, M * 26, None, tok_words, min_mbs,
                                                        LADDER, entropy_coder="cabac"))
    want = _jax_fused[key](jo)
    got = pack_p_sparse_entropy(to, M, M * 26, None, tok_words, min_mbs, LADDER,
                                entropy_coder="cabac")
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("seed,live,kw,mode", [
    pytest.param(21, M // 2, {}, "cabac", id="tokens"),
    pytest.param(51, 0, {}, "cabac", id="all_skip"),
    pytest.param(52, M, {}, "cabac", id="dense"),
    pytest.param(22, M, {"tok_words": 8}, "coeff", id="word_cap_overflow"),
    pytest.param(23, 2, {"min_mbs": 10}, "coeff", id="under_min_mbs"),
])
def test_fused_token_downlink(seed, live, kw, mode):
    """mode 1 completes through the token interleave and the engine; the
    coefficient fallbacks still pack with the CABAC coder (the PPS sets
    entropy_coding_mode_flag for the whole stream)."""
    fc = _fc(seed, live)
    fused_d, _dense_d, buf_d = _fused(fc, **kw)
    meta = p_sparse_entropy_meta(fused_d.numpy())
    assert meta[0] == (mode == "cabac") and meta[4] == live
    p, _jp = _params(fc)
    nal, skipped, _tu, got = complete_sparse_slice(
        fused_d.numpy(), mbh=MBH, mbw=MBW, nscap=M, cap_rows=M * 26, qp=fc.qp, frame_num=1,
        params=p, device_bits=True, full_d=fused_d, buf_d=buf_d, entropy_coder="cabac")
    assert got == mode and skipped == int(fc.skip.sum())
    assert nal == cabac.pack_slice_p_cabac(fc, p, frame_num=1)


def test_short_hint_refetches_tokens():
    fc = _fc(24, M // 2)
    fused_d, _dense_d, buf_d = _fused(fc)
    short = fused_d.numpy()[:40]
    p, _jp = _params(fc)
    nal, _s, _tu, got = complete_sparse_slice(
        short, mbh=MBH, mbw=MBW, nscap=M, cap_rows=M * 26, qp=fc.qp, frame_num=1, params=p,
        device_bits=True, full_d=fused_d, buf_d=buf_d, entropy_coder="cabac")
    assert got == "cabac" and nal == cabac.pack_slice_p_cabac(fc, p, frame_num=1)


# -- the context init and the arithmetic engine ------------------------------


@pytest.mark.parametrize("slice_type,idc", [(SLICE_I, 0), (SLICE_P, 0), (SLICE_P, 1),
                                            (SLICE_P, 2)])
def test_init_states_match_jax(slice_type, idc):
    for qp in (0, 12, 26, 51):
        got = cabac.init_states(qp, slice_type, idc)
        assert np.array_equal(got, jcabac.init_states(qp, slice_type, idc))


def _token_stream(seed: int, n: int) -> np.ndarray:
    """A seeded stream of every token kind, ending in the TERM(1) flush."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, n)
    ctx = rng.integers(0, cabac.N_STATES, n)
    bit = rng.integers(0, 2, n)
    toks = np.where(kind == 0, cabac.TOK_REG | (bit << 2) | (ctx << 3), 0)
    toks = np.where(kind == 1, cabac.TOK_RUN | (bit << 2) | ((ctx % 1024) << 3)
                    | (rng.integers(1, 8, n) << 13), toks)
    nb = rng.integers(1, 11, n)
    toks = np.where(kind == 2, cabac.TOK_BYP | (nb << 2)
                    | ((rng.integers(0, 1 << 10, n) & ((1 << nb) - 1)) << 6), toks)
    toks = np.where(kind == 3, cabac.TOK_TERM, toks)  # TERM(0)
    return np.append(toks, cabac.TOK_TERM | (1 << 2)).astype(np.uint16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_engine_matches_python(seed):
    toks = _token_stream(seed, 4000)
    states = cabac.init_states(26 + seed, SLICE_P, seed)
    before = native.cabac_calls
    got = native.cabac_encode_tokens(states, toks)
    assert native.cabac_calls == before + 1
    assert got == cabac.encode_tokens_py(states, toks)
    assert got == jcabac.encode_tokens_py(states, toks)


def test_native_engine_refuses_an_unflushed_stream():
    toks = _token_stream(3, 50)[:-1]
    with pytest.raises(ValueError, match="TERM"):
        native.cabac_encode_tokens(cabac.init_states(26, SLICE_P, 0), toks)
