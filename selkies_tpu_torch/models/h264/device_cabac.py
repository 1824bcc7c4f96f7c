"""CABAC binarization and context derivation on the device (K3): a P
slice's token stream as tensor code.

Counterpart of ``selkies_tpu/models/h264/device_cabac.py``. The structure
pass is device_cavlc._frame_structure plus the CABAC context columns
(``_cabac_structure``); emission binarizes every syntax element of the
coded MBs into ``cabac.py``'s 16-bit token IR (REG/RUN/BYP/TERM) with each
regular bin's context index, over the activity-compacted coded-MB prefix.
The sequential half of CABAC -- the arithmetic interval updates and
context-state adaptation -- stays on the host (native/cabac_pack.cc), fed
one finished token stream per slice.

Emission reuses the CAVLC packing: every token is a (value, nbits) slot
with nbits in {0, 16}, so device_cavlc._pack_pairs and _merge_streams
concatenate per-segment token runs like VLC codewords, and the merged
stream is 16-bit aligned (the host reads the big-endian words as uint16
tokens).

Per P slice the device emits, per coded MB, the body tokens (mb_type,
mvd, cbp, mb_qp_delta, residual blocks) and a token count; the host adds
the mb_skip_flag of every MB and the end_of_slice bins, interleaved with
the bodies by prefix-sum arithmetic (numpy), runs the engine and splices
the header (``assemble_p_cabac_nal``). Output NALs are byte-identical to
cabac.pack_slice_p_cabac and the tokens to the JAX tokenizer's
(tests/test_torch_device_cabac.py). IDR slices use the host coder.
"""

from __future__ import annotations

import numpy as np
import torch

from selkies_tpu_torch.models.h264.cabac import (
    _LVL_OFF,
    _SIG_OFF,
    TOK_BYP,
    TOK_REG,
    TOK_RUN,
    TOK_TERM,
)
from selkies_tpu_torch.models.h264.device_cavlc import (
    _clz32,
    _compact_structure,
    _frame_structure,
    _merge_streams,
    _mv_pred_grid,
    _pack_pairs,
    _reverse_nonzeros,
    _tab,
    bits_buckets,
)
from selkies_tpu_torch.models.h264.encoder_core import _as_int32, _neighbour

__all__ = [
    "pack_p_slice_tokens",
    "pack_p_slice_tokens_active",
    "cabac_tok_words",
    "skip_flag_tokens",
    "interleave_p_tokens",
    "tokens_from_words",
    "assemble_p_cabac_nal",
]

_I32 = torch.int32


def cabac_tok_words(m: int) -> int:
    """Token-payload capacity in 32-bit words for an m-MB slice: 64 words
    (128 tokens) per MB, 4096..262144. An overflow falls back to the
    coefficient downlink, like the CAVLC bits cap."""
    return min(1 << 18, max(4096, 64 * int(m)))


# ---------------------------------------------------------------- token slots
#
# Every emitter below produces (value, nbits) slot arrays for _pack_pairs
# with nbits in {0, 16}: a slot holds one whole uint16 token or nothing.


def _ontok(on):
    return torch.where(on, 16, 0).to(_I32)


def _byp_pair(v, nb, on):
    """One bypass group of nb (<= 20) bits as two <= 10-bit BYP tokens,
    MSB-first (the engine output depends only on the bin sequence, not on
    its grouping)."""
    n_lo = (nb - 10).clamp(0, 10)
    n_hi = (nb - n_lo).clamp(0, 10)
    v_hi = (v >> n_lo) & 0x3FF
    v_lo = v & ((torch.ones_like(n_lo) << n_lo) - 1)
    hi_v = TOK_BYP | (n_hi << 2) | (v_hi << 6)
    lo_v = TOK_BYP | (n_lo << 2) | (v_lo << 6)
    return hi_v, _ontok(on & (n_hi > 0)), lo_v, _ontok(on & (n_lo > 0))


def _ueg_slots(v, k0: int, on):
    """UEGk escape suffix (9.3.2.3): a unary prefix of j ones and a stop
    zero, then a (k0 + j)-bit suffix -- four BYP slots. The prefix length
    has a closed form, j = floor(log2(v / 2^k0 + 1))."""
    j = 31 - _clz32((v >> k0) + 1)
    one = torch.ones_like(j)
    pv = (one << (j + 1)) - 2  # j ones then a zero
    sv = (v - ((one << (k0 + j)) - (1 << k0))).clamp(min=0)
    ph_v, ph_b, pl_v, pl_b = _byp_pair(pv, j + 1, on)
    sh_v, sh_b, sl_v, sl_b = _byp_pair(sv, k0 + j, on)
    return ph_v, ph_b, pl_v, pl_b, sh_v, sh_b, sl_v, sl_b


def _token_blocks(coeffs, cbf_ctx, cat: int):
    """Tokenize a batch of residual_block_cabac (7.3.5.3.3): (B, L)
    scan-order coefficients + (B,) coded_block_flag contexts -> (vals
    (B, S), bits (B, S)). The significance map is elementwise over scan
    positions; the level contexts' eq1/gt1 counters are exclusive prefix
    sums over the reverse-scan nonzeros; the UEG0 escape has closed forms.

    Slot layout: [cbf][per scan pos i < L-1: sig, last][per level k: gt0,
    ones-run a, ones-run b, stop zero, esc prefix hi/lo, esc suffix hi/lo,
    sign] = 1 + 2(L-1) + 9L slots."""
    B, L = coeffs.shape
    dev = coeffs.device
    coeffs = coeffs.to(_I32)
    nz = coeffs != 0
    total = nz.sum(-1, dtype=_I32)
    cbf = total > 0
    val_rev, pos_rev = _reverse_nonzeros(coeffs)
    last = pos_rev[:, 0]  # scan index of the last nonzero (valid iff cbf)

    cbf_v = (cbf.to(_I32) << 2) | (cbf_ctx.to(_I32) << 3)
    cbf_b = torch.full((B, 1), 16, dtype=_I32, device=dev)

    # significance map: bins at scan positions 0..min(last, L-2)
    i = torch.arange(L - 1, device=dev, dtype=_I32)[None, :]
    inc = i.clamp(max=2) if cat == 3 else i
    soff, loff = 105 + _SIG_OFF[cat], 166 + _SIG_OFF[cat]
    sig = nz[:, :L - 1]
    on = cbf[:, None] & (i <= last.clamp(max=L - 2)[:, None])
    sig_v = (sig.to(_I32) << 2) | ((soff + inc) << 3)
    last_v = ((i == last[:, None]).to(_I32) << 2) | ((loff + inc) << 3)
    sl_v = torch.stack([sig_v, last_v], -1)
    sl_b = torch.stack([_ontok(on), _ontok(on & sig)], -1)

    # levels, reverse scan order (k-th slot = k-th nonzero from the end)
    mag = val_rev.abs()
    kvalid = torch.arange(L, device=dev, dtype=_I32)[None, :] < total[:, None]
    m = (mag - 1).clamp(0, 14)
    gt1 = ((mag > 1) & kvalid).to(_I32)
    eq1 = ((mag == 1) & kvalid).to(_I32)
    gt1c = (torch.cumsum(gt1, -1) - gt1).to(_I32)  # exclusive: count before k
    eq1c = (torch.cumsum(eq1, -1) - eq1).to(_I32)
    base = 227 + _LVL_OFF[cat]
    c0 = base + torch.where(gt1c > 0, 0, (1 + eq1c).clamp(max=4))
    c1 = base + 5 + gt1c.clamp(max=4 - (1 if cat == 3 else 0))
    s0_v = ((m > 0).to(_I32) << 2) | (c0 << 3)
    n1 = (m - 1).clamp(0, 13)  # TU ones at c1
    na = n1.clamp(max=7)  # the RUN n field is 3 bits
    nb2 = n1 - na
    ra_v = TOK_RUN | (1 << 2) | (c1 << 3) | (na << 13)
    rb_v = TOK_RUN | (1 << 2) | (c1 << 3) | (nb2 << 13)
    z_v = c1 << 3  # TU stop zero
    esc_on = kvalid & (mag - 1 >= 14)
    ph_v, ph_b, pl_v, pl_b, sh_v, sh_b, su_v, su_b = _ueg_slots(
        (mag - 1 - 14).clamp(min=0), 0, esc_on)
    sgn_v = TOK_BYP | (1 << 2) | ((val_rev < 0).to(_I32) << 6)
    lev_v = torch.stack([s0_v, ra_v, rb_v, z_v, ph_v, pl_v, sh_v, su_v, sgn_v], -1)
    lev_b = torch.stack(
        [_ontok(kvalid), _ontok(kvalid & (na > 0)), _ontok(kvalid & (nb2 > 0)),
         _ontok(kvalid & (m > 0) & (m < 14)), ph_b, pl_b, sh_b, su_b, _ontok(kvalid)], -1)

    vals = torch.cat([cbf_v[:, None], sl_v.reshape(B, 2 * (L - 1)), lev_v.reshape(B, 9 * L)], 1)
    bits = torch.cat([cbf_b, sl_b.reshape(B, 2 * (L - 1)), lev_b.reshape(B, 9 * L)], 1)
    return vals, bits


def _header_slots(s: dict):
    """P macroblock header tokens (mb_type, mvd_l0 x/y, cbp, mb_qp_delta)
    of a (possibly compacted) structure -> (vals (A, 32), bits (A, 32)).
    The mvd UEG3 prefix bins j = 0..3 double as the TU terminator when
    |mvd| < 4 (bin = m > j, present iff m >= j); the j >= 4 ones collapse
    into one RUN slot."""
    live = s["coded"]
    A = live.shape[0]
    dev = live.device
    vs, bs = [], []

    def full(v):
        return torch.full((A,), v, dtype=_I32, device=dev)

    for ctx in (14, 15, 16):  # P_L0_16x16 mb_type: three 0 bins
        vs.append(full(ctx << 3))
        bs.append(_ontok(live))
    mvd = s["cb_mvd"]
    ctx0 = s["cb_mvd_ctx"]
    for comp in range(2):
        b = 40 if comp == 0 else 47
        d = mvd[:, comp]
        a = d.abs()
        m = a.clamp(max=9)
        for j in range(4):
            ctx = ctx0[:, comp] if j == 0 else full(b + 2 + j)
            vs.append(((m > j).to(_I32) << 2) | (ctx << 3))
            bs.append(_ontok(live & (m >= j)))
        n = (m - 4).clamp(0, 5)  # prefix ones at positions 4..8
        vs.append(TOK_RUN | (1 << 2) | ((b + 6) << 3) | (n << 13))
        bs.append(_ontok(live & (n > 0)))
        vs.append(full((b + 6) << 3))  # TU stop for m in 4..8
        bs.append(_ontok(live & (m >= 4) & (m < 9)))
        ph_v, ph_b, pl_v, pl_b, sh_v, sh_b, su_v, su_b = _ueg_slots(
            (a - 9).clamp(min=0), 3, live & (a >= 9))
        vs += [ph_v, pl_v, sh_v, su_v]
        bs += [ph_b, pl_b, sh_b, su_b]
        vs.append(TOK_BYP | (1 << 2) | ((d < 0).to(_I32) << 6))
        bs.append(_ontok(live & (a > 0)))
    ctx6, bins6 = s["cb_cbp_ctx"], s["cb_cbp_bins"]
    for k in range(6):
        vs.append((bins6[:, k] << 2) | (ctx6[:, k] << 3))
        bs.append(_ontok(live if k < 5 else (live & s["cb_cbp5"])))
    vs.append(full(60 << 3))  # mb_qp_delta = se(0)
    bs.append(_ontok(live & s["cb_qpd"]))
    return torch.stack(vs, -1), torch.stack(bs, -1)


# ------------------------------------------------------------ structure extras


def _shift_inc(grid):
    """condTermFlagA + 2 * condTermFlagB for every cell of a cbf grid: left
    and top reads with zero edges (9.3.3.1.1.9 inter rules)."""
    return _neighbour(grid, 0, -1) + 2 * _neighbour(grid, -1, 0)


def _cabac_structure(out: dict) -> dict:
    """_frame_structure + the CABAC context columns, all full-grid
    elementwise work. New per-MB keys (each compacted by the same row
    scatter as the CAVLC keys): cb_mvd (M, 2) quarter-pel mvd; cb_mvd_ctx
    (M, 2) first-bin ctx; cb_cbp_ctx / cb_cbp_bins (M, 6) and cb_cbp5 (M,);
    cb_qpd (M,) mb_qp_delta present; cb_cbf_luma (M, 16), cb_cbf_cdc (M, 2),
    cb_cbf_cac (M, 8) coded_block_flag ctx per block, coding order."""
    s = _frame_structure(out)
    skip = out["skip"].to(torch.bool)
    mvs = out["mvs"].to(_I32)
    mbh, mbw = skip.shape
    m = mbh * mbw
    dev = skip.device
    coded2 = ~skip
    cbp_l, cbp_c = s["cbp_luma"], s["cbp_chroma"]

    mvd = 4 * (mvs - _mv_pred_grid(mvs))
    amvd = torch.where(coded2[..., None], mvd.abs(), 0)
    ssum = _neighbour(amvd, 0, -1) + _neighbour(amvd, -1, 0)
    inc = torch.where(ssum < 3, 0, torch.where(ssum > 32, 2, 1)).to(_I32)
    s["cb_mvd"] = mvd.reshape(m, 2)
    comp = torch.arange(2, device=dev, dtype=_I32)
    s["cb_mvd_ctx"] = (40 + 7 * comp + inc).reshape(m, 2)  # 40 (x) / 47 (y)

    # cbp bin contexts: neighbour patterns read 15 (luma) / 0 (chroma) when
    # unavailable, 0 at skip MBs (cabac._cbp_tokens)
    clg = torch.where(coded2, cbp_l, 0)
    ccg = torch.where(coded2, cbp_c, 0)
    col = torch.arange(mbw, device=dev)[None, :]
    row = torch.arange(mbh, device=dev)[:, None]
    cl_left = torch.where(col > 0, _neighbour(clg, 0, -1), 15)
    cl_top = torch.where(row > 0, _neighbour(clg, -1, 0), 15)
    cc_left = torch.where(col > 0, _neighbour(ccg, 0, -1), 0)
    cc_top = torch.where(row > 0, _neighbour(ccg, -1, 0), 0)
    b0, b1 = cbp_l & 1, (cbp_l >> 1) & 1
    b2, b3 = (cbp_l >> 2) & 1, (cbp_l >> 3) & 1
    ctx6 = torch.stack([
        73 + (1 - ((cl_left >> 1) & 1)) + 2 * (1 - ((cl_top >> 2) & 1)),
        73 + (1 - b0) + 2 * (1 - ((cl_top >> 3) & 1)),
        73 + (1 - ((cl_left >> 3) & 1)) + 2 * (1 - b0),
        73 + (1 - b2) + 2 * (1 - b1),
        77 + (cc_left > 0).to(_I32) + 2 * (cc_top > 0).to(_I32),
        81 + (cc_left == 2).to(_I32) + 2 * (cc_top == 2).to(_I32),
    ], -1).to(_I32)
    bins6 = torch.stack([b0, b1, b2, b3, (cbp_c > 0).to(_I32), (cbp_c == 2).to(_I32)],
                        -1).to(_I32)
    s["cb_cbp_ctx"] = ctx6.reshape(m, 6)
    s["cb_cbp_bins"] = bins6.reshape(m, 6)
    s["cb_cbp5"] = (cbp_c > 0).reshape(m)
    s["cb_qpd"] = ((cbp_l | cbp_c) > 0).reshape(m)

    # coded_block_flag contexts from the gated TotalCoeff grids (the
    # transmitted cbf is TotalCoeff > 0; absent blocks hold 0)
    lcbf = (s["luma_tc_flat"] > 0).to(_I32)
    s["cb_cbf_luma"] = ((93 + _shift_inc(lcbf)).reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3)
                        .reshape(m, 16).index_select(1, _tab("luma_perm", dev)))
    ccbf = (s["ch_tc_flat"] > 0).to(_I32)
    s["cb_cbf_cac"] = (torch.stack([101 + _shift_inc(ccbf[c]) for c in range(2)])
                       .reshape(2, mbh, 2, mbw, 2).permute(1, 3, 0, 2, 4).reshape(m, 2, 4)
                       .index_select(2, _tab("chroma_perm", dev)).reshape(m, 8))
    cdc = out["chroma_dc"].reshape(mbh, mbw, 2, 4)
    dc_cbf = ((cdc != 0).any(-1) & (coded2 & (cbp_c >= 1))[..., None]).to(_I32)
    s["cb_cbf_cdc"] = torch.stack([97 + _shift_inc(dc_cbf[..., c]) for c in range(2)],
                                  -1).reshape(m, 2)
    return s


# per-MB arrays the CABAC emission needs compacted ("coded" rides along
# as the live mask: compaction makes it the dense ns-prefix)
CABAC_COMPACT_KEYS = (
    "coded", "luma_blocks", "luma_emit", "cdc_blocks", "cdc_emit",
    "ch_blocks", "ch_emit", "cb_mvd", "cb_mvd_ctx", "cb_cbp_ctx",
    "cb_cbp_bins", "cb_cbp5", "cb_qpd", "cb_cbf_luma", "cb_cbf_cdc",
    "cb_cbf_cac",
)


def _emit_slice_tokens(s: dict, word_cap: int):
    """K3, the expensive half over a compacted structure: tokenize every
    block and header, pack each MB's 27 segments (header, 16 luma, 2
    chroma DC, 8 chroma AC) and merge them into one token-aligned stream.
    -> (words (word_cap,) int32 bit patterns, ntok int32, counts (U,)
    int32 per-slot token counts, zero on padded slots)."""
    U = s["coded"].shape[0]
    lv, lb = _token_blocks(s["luma_blocks"].reshape(U * 16, 16), s["cb_cbf_luma"].reshape(-1), 2)
    lb = torch.where(s["luma_emit"].reshape(-1)[:, None], lb, 0)
    dv, db = _token_blocks(s["cdc_blocks"].reshape(U * 2, 4), s["cb_cbf_cdc"].reshape(-1), 3)
    db = torch.where(s["cdc_emit"].reshape(-1)[:, None], db, 0)
    cv, cb = _token_blocks(s["ch_blocks"].reshape(U * 8, 15), s["cb_cbf_cac"].reshape(-1), 4)
    cb = torch.where(s["ch_emit"].reshape(-1)[:, None], cb, 0)
    hv, hb = _header_slots(s)

    HW, DW, CW, BW = 16, 22, 82, 88  # ceil(16 * S / 32) per segment kind
    hdr_w, hdr_n = _pack_pairs(hv, hb, HW)
    luma_w, luma_n = _pack_pairs(lv, lb, BW)
    cdc_w, cdc_n = _pack_pairs(dv, db, DW)
    cac_w, cac_n = _pack_pairs(cv, cb, CW)

    def pad(w, k, width):
        return torch.cat([w.reshape(U, k, width), w.new_zeros((U, k, BW - width))], 2)

    seg_words = torch.cat([pad(hdr_w, 1, HW), luma_w.reshape(U, 16, BW), pad(cdc_w, 2, DW),
                           pad(cac_w, 8, CW)], 1).reshape(U * 27, BW)
    seg_bits = torch.cat([hdr_n.reshape(U, 1), luma_n.reshape(U, 16), cdc_n.reshape(U, 2),
                          cac_n.reshape(U, 8)], 1).reshape(U * 27)
    words, total = _merge_streams(seg_words, seg_bits, word_cap)
    counts = (hdr_n + luma_n.reshape(U, 16).sum(1) + cdc_n.reshape(U, 2).sum(1)
              + cac_n.reshape(U, 8).sum(1)) >> 4
    return _as_int32(words), (total >> 4).to(_I32), counts.to(_I32)


def pack_p_slice_tokens(out: dict, word_cap: int | None = None):
    """Full-grid device tokenizer (every MB pays), the tests' oracle.
    -> (words (word_cap,) int32 bit patterns, ntok, counts (M,), ns): the
    first ns counts are the coded MBs' body token counts in raster order."""
    s = _cabac_structure(out)
    m = s["coded"].shape[0]
    sc = _compact_structure(s, m, keys=CABAC_COMPACT_KEYS)
    words, ntok, counts = _emit_slice_tokens(sc, cabac_tok_words(m) if word_cap is None
                                             else word_cap)
    return words, ntok, counts, s["ns"]


def pack_p_slice_tokens_active(out: dict, word_cap: int | None = None,
                               buckets: tuple[int, ...] | None = None,
                               bucket: int | None = None):
    """Device CABAC whose emission runs over ``bucket`` compacted coded-MB
    slots (an entry of ``buckets``, the top one by default; see
    device_cavlc.pack_p_slice_bits_active). The counts are padded to
    buckets[-1] whatever the bucket. Tokens are the same for every bucket
    that holds the coded MBs. -> (words, ntok, counts, ns)."""
    s = _cabac_structure(out)
    m = s["coded"].shape[0]
    if word_cap is None:
        word_cap = cabac_tok_words(m)
    if buckets is None:
        buckets = bits_buckets(m)
    a = buckets[-1] if bucket is None else int(bucket)
    if a not in buckets:
        raise ValueError(f"bucket {a} is not one of {buckets}")
    words, ntok, counts = _emit_slice_tokens(
        _compact_structure(s, a, keys=CABAC_COMPACT_KEYS), word_cap)
    if a < buckets[-1]:
        counts = torch.cat([counts, counts.new_zeros(buckets[-1] - a)])
    return words, ntok, counts, s["ns"]


# ---------------------------------------------------------------------------
# Host half: skip/terminate interleave, engine, NAL assembly
# ---------------------------------------------------------------------------


def skip_flag_tokens(skip: np.ndarray) -> np.ndarray:
    """mb_skip_flag REG tokens for every MB of a slice, raster order --
    ctx 11 + (number of available, not skipped of {left, top})."""
    sk = np.asarray(skip, bool)
    inc = np.zeros(sk.shape, np.int32)
    inc[:, 1:] += ~sk[:, :-1]
    inc[1:, :] += ~sk[:-1, :]
    return (TOK_REG | (sk.astype(np.int32) << 2) | ((11 + inc) << 3)).reshape(-1).astype(np.uint16)


def interleave_p_tokens(body: np.ndarray, counts: np.ndarray, skip: np.ndarray) -> np.ndarray:
    """Splice per-MB streams into slice order without a Python loop: for
    each MB [skip_flag] [body tokens if coded] [end_of_slice], the last
    MB's end_of_slice being the TERM(1) flush. ``body`` is the device
    stream (coded-MB bodies in raster order), ``counts`` the per-coded-MB
    token counts (ns entries)."""
    sk = np.asarray(skip, bool).reshape(-1)
    m = sk.size
    cnt = np.zeros(m, np.int64)
    cnt[~sk] = np.asarray(counts, np.int64)
    stride = cnt + 2  # skip flag + body + terminate
    starts = np.zeros(m, np.int64)
    np.cumsum(stride[:-1], out=starts[1:])
    out = np.empty(int(stride.sum()), np.uint16)
    out[starts] = skip_flag_tokens(skip)
    out[starts + 1 + cnt] = TOK_TERM
    tot = int(cnt.sum())
    if tot:
        body_counts = cnt[~sk]
        excl = np.cumsum(body_counts) - body_counts
        pos = np.repeat(starts[~sk] + 1 - excl, body_counts) + np.arange(tot, dtype=np.int64)
        out[pos] = body[:tot]
    out[-1] = TOK_TERM | (1 << 2)  # end-of-slice flush
    return out


def tokens_from_words(words: np.ndarray, ntok: int) -> np.ndarray:
    """The uint16 token sequence of the device words (uint32 or their int32
    bit patterns): every slot is 16 bits, so the big-endian word stream is
    the token stream."""
    nw = (int(ntok) + 1) // 2
    return (np.ascontiguousarray(words[:nw]).view(np.uint32).astype(">u4")
            .view(">u2").astype(np.uint16)[:int(ntok)])


def assemble_p_cabac_nal(words: np.ndarray, ntok: int, counts: np.ndarray, skip: np.ndarray,
                         p, frame_num: int, qp: int, ltr_ref: int | None = None,
                         mark_ltr: int | None = None, mmco_evict: tuple = (),
                         first_mb: int = 0, cabac_init_idc: int = 0) -> bytes:
    """Finish a P slice from device tokens: interleave the skip/terminate
    bins, run the arithmetic engine, splice after the host-written header.
    Byte-identical to cabac.pack_slice_p_cabac for the same inputs;
    ``first_mb`` / ``cabac_init_idc`` position a band slice."""
    from selkies_tpu_torch.models.h264.bitstream import (
        NAL_SLICE_NON_IDR, SLICE_P, write_slice_header)
    from selkies_tpu_torch.models.h264.cabac import finish_cabac_nal
    from selkies_tpu_torch.utils.bits import BitWriter

    toks = interleave_p_tokens(tokens_from_words(words, ntok), counts, skip)
    w = BitWriter()
    write_slice_header(w, p, SLICE_P, frame_num, idr=False, slice_qp=qp, ltr_ref=ltr_ref,
                       mark_ltr=mark_ltr, mmco_evict=mmco_evict, first_mb=first_mb,
                       cabac_init_idc=cabac_init_idc)
    return finish_cabac_nal(w, toks, qp, SLICE_P, cabac_init_idc, NAL_SLICE_NON_IDR)
