"""CAVLC entropy coding on the device (K2): a P slice's slice-data bits
as tensor code, with cost proportional to the frame's coded MBs.

Counterpart of ``selkies_tpu/models/h264/device_cavlc.py``. Two entry
points share one implementation:

* ``pack_p_slice_bits`` -- the full-grid coder (every MB pays), the
  fixed-shape oracle of the tests;
* ``pack_p_slice_bits_active`` -- the encoder's coder: the coded MBs are
  compacted into a dense prefix of a bucket of slots before the
  expensive per-block work. The bucket is an argument, the top one
  (``bits_buckets`` always ends at the slice's MB count) by default:
  choosing a smaller one from the frame's coded count would need that
  count on the host, a stream sync on the submit thread. Every bucket
  that holds the coded MBs gives the same bits (compaction keeps raster
  order and padded slots emit nothing).

The structure pass (``_frame_structure``) is elementwise work and prefix
scans over the MB grid: skip runs, MV prediction, cbp, the TotalCoeff and
nC context grids, header codewords, the coding-order block relayout. The
emission pass (``_emit_slice_bits``) VLC-codes every block, packs each
segment's codewords into 32-bit words and merges the segments into one
stream. Where the reference uses TPU workarounds the port uses what the
card does well: VLC tables are gathers from table tensors (not one-hot
f32 matmuls, which TF32 would make inexact), codeword placement is an
``index_add_`` of each codeword's two word parts into an int64 buffer
(bits are disjoint by construction, so add equals or, and integer adds
are order-free), and every 32-bit word is carried in int64, masked to 32
bits, and turned into its int32 bit pattern only at the buffer boundary.

The host prepends the slice header, appends the trailing skip_run and the
rbsp stop bit, and emulation-prevents (``assemble_p_nal``). The output is
bit-identical to ``cavlc.pack_slice_p`` and to the JAX coder
(tests/test_torch_device_cavlc.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from selkies_tpu_torch.device import constant_tables
from selkies_tpu_torch.models.h264 import tables as T
from selkies_tpu_torch.models.h264.cavlc import INTER_CBP_TO_CODENUM
from selkies_tpu_torch.models.h264.encoder_core import _as_int32, _neighbour

__all__ = [
    "pack_p_slice_bits",
    "pack_p_slice_bits_active",
    "bits_buckets",
    "device_entropy_default",
    "entropy_coder_default",
    "resolve_entropy",
    "assemble_p_nal",
    "BITS_MIN_MBS_DEFAULT",
    "WORD_CAP_DEFAULT",
]

_I32 = torch.int32
_I64 = torch.int64

# A delta P slice with at least this many coded MBs ships its final slice
# bits; below it the sparse coefficient downlink is small and its host pack
# near-free. SELKIES_BITS_MIN_MBS overrides.
BITS_MIN_MBS_DEFAULT = 512


def device_entropy_default(explicit=None) -> bool:
    """The device-entropy knob: an explicit argument wins, then
    SELKIES_DEVICE_ENTROPY=0/1, then AUTO, which is off here, as on the JAX
    encoder's CPU backend: the device coder runs only when asked for."""
    if explicit is not None:
        return bool(explicit)
    env = os.environ.get("SELKIES_DEVICE_ENTROPY", "")
    return bool(env) and env != "0"


def entropy_coder_default(explicit=None) -> str:
    """The entropy-coder knob: an explicit argument wins, then
    SELKIES_ENTROPY_CODER=cavlc/cabac/auto, else cavlc (Baseline). ``auto``
    resolves to cavlc on this port, as on the JAX encoder's CPU backend."""
    coder = explicit
    if coder is None:
        coder = os.environ.get("SELKIES_ENTROPY_CODER", "") or "cavlc"
    coder = str(coder).lower()
    if coder == "auto":
        return "cavlc"
    if coder not in ("cavlc", "cabac"):
        raise ValueError(f"entropy_coder must be cavlc|cabac|auto, got {coder!r}")
    return coder


def resolve_entropy(m: int, device_entropy=None, bits_min_mbs=None, entropy_coder=None):
    """-> (enabled, min_mbs, bits_words, consts) for a slice of ``m`` MBs.

    ``consts`` is the (bits_words, min_mbs, buckets, coder) tuple that
    encoder_core.pack_p_sparse_entropy takes, None when the feature is off.
    For CAVLC ``bits_words`` is the bit-payload cap in 32-bit words (16 per
    MB, 1024..65536); for CABAC the token-word cap
    (device_cabac.cabac_tok_words)."""
    enabled = device_entropy_default(device_entropy)
    coder = entropy_coder_default(entropy_coder)
    if bits_min_mbs is None:
        try:
            bits_min_mbs = int(os.environ.get("SELKIES_BITS_MIN_MBS", "") or BITS_MIN_MBS_DEFAULT)
        except ValueError:
            bits_min_mbs = BITS_MIN_MBS_DEFAULT
    min_mbs = max(0, int(bits_min_mbs))
    if coder == "cabac":
        from selkies_tpu_torch.models.h264.device_cabac import cabac_tok_words

        bits_words = cabac_tok_words(m)
    else:
        bits_words = min(1 << 16, max(1024, 16 * int(m)))
    consts = (bits_words, min_mbs, bits_buckets(m), coder) if enabled else None
    return enabled, min_mbs, bits_words, consts


# ---------------------------------------------------------------------------
# VLC tables as dense arrays, generated from tables.py's functions
# ---------------------------------------------------------------------------

# coeff_token: class 0..2 -> nC buckets [0,2) [2,4) [4,8); class 3 = nC >= 8
# (the FLC); class 4 = chroma DC (nC == -1). Flat index cls*68 + total*4 + t1.
_CT_VAL = np.zeros((5, 17, 4), np.int32)
_CT_BITS = np.zeros((5, 17, 4), np.int32)
for _cls, _nc in enumerate((0, 2, 4, 8, -1)):
    for _total in range(17):
        for _t1 in range(min(_total, 3) + 1):
            if _nc == -1 and _total > 4:
                continue
            _CT_VAL[_cls, _total, _t1], _CT_BITS[_cls, _total, _t1] = T.coeff_token_code(
                _nc, _total, _t1)

_TZ_VAL = np.zeros((17, 16), np.int32)
_TZ_BITS = np.zeros((17, 16), np.int32)
for _total in range(1, 16):
    for _tz in range(0, 16 - _total + 1):
        _TZ_VAL[_total, _tz], _TZ_BITS[_total, _tz] = T.total_zeros_code(_total, _tz)
_TZC_VAL = np.zeros((4, 4), np.int32)
_TZC_BITS = np.zeros((4, 4), np.int32)
for _total in range(1, 4):
    for _tz in range(0, 4 - _total + 1):
        _TZC_VAL[_total, _tz], _TZC_BITS[_total, _tz] = T.total_zeros_code(
            _total, _tz, chroma_dc=True)

# run_before: zeros_left clamps at 7 in the spec table; run <= 14
_RB_VAL = np.zeros((15, 15), np.int32)
_RB_BITS = np.zeros((15, 15), np.int32)
for _zl in range(1, 15):
    for _run in range(0, _zl + 1):
        _RB_VAL[_zl, _run], _RB_BITS[_zl, _run] = T.run_before_code(_zl, _run)

# luma 4x4 blocks and chroma AC blocks in coding order -> (x, y) in the MB
_LUMA_ORDER = np.asarray([[x4, y4] for x4, y4 in T.LUMA_BLOCK_ORDER], np.int32)  # (16, 2)
_CHROMA_ORDER = np.asarray([[x, y] for x, y in T.CHROMA_BLOCK_ORDER], np.int32)  # (4, 2)

_TABLES = {
    "ct_val": _CT_VAL.reshape(-1), "ct_bits": _CT_BITS.reshape(-1),
    "tz_val": _TZ_VAL.reshape(-1), "tz_bits": _TZ_BITS.reshape(-1),
    "tzc_val": _TZC_VAL.reshape(-1), "tzc_bits": _TZC_BITS.reshape(-1),
    "rb_val": _RB_VAL.reshape(-1), "rb_bits": _RB_BITS.reshape(-1),
    "cbp_codenum": np.asarray(INTER_CBP_TO_CODENUM, np.int32),
    "zigzag": np.asarray(T.ZIGZAG_FLAT, np.int64),
    "luma_perm": (_LUMA_ORDER[:, 1] * 4 + _LUMA_ORDER[:, 0]).astype(np.int64),
    "luma_b8": ((_LUMA_ORDER[:, 1] // 2) * 2 + _LUMA_ORDER[:, 0] // 2).astype(np.int32),
    "chroma_perm": (_CHROMA_ORDER[:, 1] * 2 + _CHROMA_ORDER[:, 0]).astype(np.int64),
    "b8_of": ((np.arange(4)[:, None] // 2) * 2 + np.arange(4)[None, :] // 2).astype(np.int32),
}

WORD_CAP_DEFAULT = 1 << 17  # 512 KB frame bitstream capacity


_tab = constant_tables(_TABLES)  # (name, device) -> the table on the device, copied once


def _lut(name: str, idx):
    """(value, bits) of a VLC table at ``idx`` -- two gathers."""
    i = idx.long()
    return _tab(name + "_val", idx.device)[i], _tab(name + "_bits", idx.device)[i]


def _clz32(x):
    """Count leading zeros of a positive 32-bit value (vectorized), -> int32."""
    x = x.to(_I64) & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = torch.where(big, n + shift, n)
        x = torch.where(big, x >> shift, x)
    return (31 - n).to(_I32)


def _ue_bits(v):
    """Exp-Golomb codeword for v (vectorized): (value, nbits)."""
    v1 = v + 1
    nb = 32 - _clz32(v1).clamp(0, 31)  # significant bits of v1
    return v1, 2 * nb - 1


def _se_bits(v):
    """Signed Exp-Golomb: map se value -> ue codeword."""
    return _ue_bits(torch.where(v > 0, 2 * v - 1, -2 * v))


def _level_bits(level_code, suffix_len):
    """Two (value, nbits) pairs -- prefix codeword and suffix -- for one
    level (9.2.2.1), equal to cavlc._write_level. Each slot is at most 28
    bits. Extended prefixes (16+) are solved arithmetically: with
    x = lc_adj - (15 << sl) + 2^12, prefix p covers x in [2^(p-3), 2^(p-2)),
    so p = floor(log2 x) + 3."""
    lc0 = level_code
    one = torch.ones_like(lc0)
    lc_adj = torch.where((suffix_len == 0) & (lc0 >= 30), lc0 - 15, lc0)
    sl = suffix_len.clamp(min=0)
    prefix = lc_adj >> sl
    # regular: prefix zeros + 1, then sl suffix bits
    v1 = one
    b1 = prefix + 1
    v2 = lc_adj & ((one << sl) - 1)
    b2 = sl
    # escape: prefix 15 (16-bit '...1'), 12-bit suffix
    esc = lc_adj - (15 << sl)
    in_esc = (prefix >= 15) & (esc < (1 << 12))
    b1 = torch.where(in_esc, 16, b1)
    v2 = torch.where(in_esc, esc.clamp(0, (1 << 12) - 1), v2)
    b2 = torch.where(in_esc, 12, b2)
    # extended prefixes 16+
    x = (esc + (1 << 12)).clamp(min=1)
    nb = 31 - _clz32(x)  # floor(log2 x)
    ext = (prefix >= 15) & ~in_esc
    b1 = torch.where(ext, nb + 4, b1)  # pfx + 1 = (nb + 3) + 1
    v2 = torch.where(ext, x - (one << nb), v2)
    b2 = torch.where(ext, nb, b2)  # pfx - 3
    # suffix_len == 0 specials
    small = (suffix_len == 0) & (lc0 < 14)
    b1 = torch.where(small, lc0 + 1, b1)
    v2 = torch.where(small, 0, v2)
    b2 = torch.where(small, 0, b2)
    mid = (suffix_len == 0) & (lc0 >= 14) & (lc0 < 30)
    b1 = torch.where(mid, 15, b1)
    v2 = torch.where(mid, lc0 - 14, v2)
    b2 = torch.where(mid, 4, b2)
    return v1, b1, v2, b2


def _reverse_nonzeros(coeffs):
    """(B, L) scan-order blocks -> (val_rev, pos_rev) (B, L) int32: the k-th
    nonzero walking the block backwards and its scan position, 0 past the
    block's count. One scatter per array; zero entries target a sentinel
    column that is dropped (the only duplicate target)."""
    B, L = coeffs.shape
    rev = coeffs.flip(-1)
    nzr = rev != 0
    slot = torch.where(nzr, torch.cumsum(nzr, -1) - 1, L)
    pos = (L - 1 - torch.arange(L, device=coeffs.device, dtype=_I32)).expand(B, L)
    val_rev = coeffs.new_zeros((B, L + 1)).scatter_(1, slot, rev)[:, :L]
    pos_rev = pos.new_zeros((B, L + 1)).scatter_(1, slot, pos)[:, :L]
    return val_rev, pos_rev


def _encode_blocks(coeffs, nc, chroma_dc: bool):
    """CAVLC-encode a batch of residual blocks.

    coeffs: (B, L) int32 scan-order coefficients (L = 16, 15 or 4);
    nc: (B,) int32 neighbour context (-1 for chroma DC).
    Returns (vals (B, S), bits (B, S), total (B,)) -- S emission slots in
    order; bits == 0 slots contribute nothing."""
    B, L = coeffs.shape
    dev = coeffs.device
    coeffs = coeffs.to(_I32)
    total = (coeffs != 0).sum(-1, dtype=_I32)
    val_rev, pos_rev = _reverse_nonzeros(coeffs)
    idx = torch.arange(L, device=dev, dtype=_I32)[None, :]
    valid = idx < total[:, None]

    # trailing ones: leading run of |1| in val_rev, capped at 3
    is_one = ((val_rev.abs() == 1) & valid).to(_I32)
    t1 = torch.cumprod(is_one, -1).sum(-1).clamp(max=3).to(_I32)

    # coeff_token
    cls = torch.where(nc < 0, 4, torch.where(nc < 2, 0, torch.where(
        nc < 4, 1, torch.where(nc < 8, 2, 3))))
    ct_val, ct_bits = _lut("ct", cls * 68 + total * 4 + t1)

    # Slot layout (emission order): token, 3 t1 signs, 2L interleaved level
    # (prefix, suffix) pairs, total_zeros, L-1 run_befores.
    use_t1 = (idx[:, :3] < t1[:, None]) & (total[:, None] > 0)
    sign_v = torch.where(use_t1, (val_rev[:, :3] < 0).to(_I32), 0)
    sign_b = use_t1.to(_I32)

    # levels after the trailing ones: the suffix-length adaptation is the
    # only sequential dependency, an L-step walk over all blocks at once;
    # the codewords then depend only on (level, suffix_len, is_first)
    suffix_len = torch.where((total > 10) & (t1 < 3), 1, 0).to(_I32)
    val_t = val_rev.t()  # (L, B)
    sls, firsts, uses = [], [], []
    first_done = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(L):
        level = val_t[k]
        use = (k >= t1) & (k < total)
        is_first = use & ~first_done
        new_sl = torch.where(suffix_len == 0, 1, suffix_len)
        new_sl = torch.where((level.abs() > (3 << (new_sl - 1).clamp(min=0))) & (new_sl < 6),
                             new_sl + 1, new_sl)
        sls.append(suffix_len)
        firsts.append(is_first)
        uses.append(use)
        suffix_len = torch.where(use, new_sl, suffix_len)
        first_done = first_done | is_first
    sls, firsts, uses = torch.stack(sls), torch.stack(firsts), torch.stack(uses)
    level_code = torch.where(val_t > 0, 2 * val_t - 2, -2 * val_t - 1)
    level_code = torch.where(firsts & (t1[None, :] < 3), level_code - 2, level_code)
    lv1, lb1, lv2, lb2 = (torch.where(uses, a, 0) for a in _level_bits(level_code, sls))
    lev_v = torch.stack([lv1.t(), lv2.t()], -1).reshape(B, 2 * L)
    lev_b = torch.stack([lb1.t(), lb2.t()], -1).reshape(B, 2 * L)

    # total_zeros
    tz = torch.where(total > 0, pos_rev[:, 0] + 1 - total, 0)
    if chroma_dc:
        tz_val, tz_bits = _lut("tzc", total.clamp(0, 3) * 4 + tz.clamp(0, 3))
    else:
        tz_val, tz_bits = _lut("tz", total.clamp(0, 16) * 16 + tz.clamp(0, 15))
    use_tz = (total > 0) & (total < L)
    tz_v = torch.where(use_tz, tz_val, 0)
    tz_b = torch.where(use_tz, tz_bits, 0)

    # run_before chain: zeros_left before step k has the closed form
    # pos_k + k + 1 - total, so the chain needs no scan
    ks = torch.arange(L - 1, device=dev, dtype=_I32)[None, :]
    run = pos_rev[:, :-1] - pos_rev[:, 1:] - 1
    zl = pos_rev[:, :-1] + ks + 1 - total[:, None]
    use_r = (ks < total[:, None] - 1) & (zl > 0)
    rv, rb = _lut("rb", zl.clamp(0, 14) * 15 + run.clamp(0, 14))

    vals = torch.cat([ct_val[:, None], sign_v, lev_v, tz_v[:, None],
                      torch.where(use_r, rv, 0)], 1)
    bits = torch.cat([ct_bits[:, None], sign_b, lev_b, tz_b[:, None],
                      torch.where(use_r, rb, 0)], 1)
    return vals, bits, total


def _pack_pairs(vals, bits, nwords: int):
    """Pack (U, S) (value, nbits <= 28) emission slots into per-unit bit
    buffers -> (words (U, nwords) int64 holding 32-bit values, nbits_total
    (U,) int64). MSB-first; word 0 holds the first 32 bits.

    Each codeword lands in at most two words: its start word gets the high
    part, the next word the low part when it crosses a word boundary. Both
    parts are added into a flat int64 buffer with ``index_add_``; bits are
    disjoint, so the adds are ors, and their order does not matter. Parts
    that would fall past ``nwords`` go to a dropped sentinel word."""
    U, S = vals.shape
    b = bits.to(_I64)
    end = torch.cumsum(b, 1)
    start = end - b
    total = end[:, -1]
    v = vals.to(_I64) & ((1 << b.clamp(0, 32)) - 1)
    s = start & 31
    e = s + b  # end bit within the start word, 0..59
    fits = e <= 32
    over = (e - 32).clamp(1, 31)
    hi = torch.where(fits, v << (32 - e).clamp(0, 32), v >> over)
    lo = torch.where(fits, 0, (v & ((1 << over) - 1)) << (32 - over))
    use = b > 0
    w0 = start >> 5
    base = torch.arange(U, device=vals.device, dtype=_I64)[:, None] * nwords
    sentinel = U * nwords
    t_hi = torch.where(use & (w0 < nwords), base + w0, sentinel)
    t_lo = torch.where(use & ~fits & (w0 + 1 < nwords), base + w0 + 1, sentinel)
    out = torch.zeros(U * nwords + 1, dtype=_I64, device=vals.device)
    out.index_add_(0, t_hi.reshape(-1), torch.where(use, hi, 0).reshape(-1))
    out.index_add_(0, t_lo.reshape(-1), torch.where(use, lo, 0).reshape(-1))
    return out[:sentinel].reshape(U, nwords), total


def _merge_streams(words, nbits, out_words: int):
    """Concatenate U bit buffers: (U, W) int64 words + (U,) lengths ->
    ((out_words,) int64 words, total_bits int64).

    Every unit is shifted to its final bit phase (W + 1 words), then only
    the words that exist are added into the stream: the output slots
    laid out by a prefix sum of each unit's word count, slot -> unit by a
    marker add + prefix sum, T_CAP = 2U + out_words slots in all (slots past
    it only exist when the stream overflows ``out_words``, which the caller
    treats as the fall back to the coefficient downlink). Adjacent units
    share at most a boundary word with disjoint bits, so add == or."""
    U, W = words.shape
    dev = words.device
    nb = nbits.to(_I64)
    offs = torch.cumsum(nb, 0)
    starts = offs - nb
    total = offs[-1]
    sh = (starts & 31)[:, None]  # right shift 0..31
    hi = words >> sh
    lo = (words & ((1 << sh) - 1)) << (32 - sh)  # zero where sh == 0
    zcol = words.new_zeros((U, 1))
    shifted = torch.cat([hi, zcol], 1) + torch.cat([zcol, lo], 1)  # (U, W+1)
    nwp = torch.where(nb > 0, (nb + (starts & 31) + 31) >> 5, 0)  # words touched
    woffs = torch.cumsum(nwp, 0) - nwp
    t_cap = 2 * U + out_words
    mark = torch.zeros(t_cap + 1, dtype=_I64, device=dev)
    mark.index_add_(0, woffs.clamp(0, t_cap), torch.ones_like(woffs))
    unit = torch.cumsum(mark[:t_cap], 0) - 1  # slot -> unit
    unitc = unit.clamp(0, U - 1)
    win = torch.arange(t_cap, device=dev, dtype=_I64) - woffs[unitc]
    valid = (unit >= 0) & (win >= 0) & (win < nwp[unitc])
    vals = shifted[unitc, win.clamp(0, W)]
    tgt = torch.where(valid, (starts[unitc] >> 5) + win, out_words).clamp(0, out_words)
    out = torch.zeros(out_words + 1, dtype=_I64, device=dev)
    out.index_add_(0, tgt, torch.where(valid, vals, 0))
    return out[:out_words], total


def _mv_pred_grid(mvs, skip_unused=None):
    """Vectorized 8.4.1.3 prediction for every MB (numpy_ref.mv_pred_16x16,
    availability cases included)."""
    mbh, mbw = mvs.shape[:2]
    dev = mvs.device
    zeros = torch.zeros_like(mvs)
    left, top = _neighbour(mvs, 0, -1), _neighbour(mvs, -1, 0)
    tr, tl = _neighbour(mvs, -1, 1), _neighbour(mvs, -1, -1)
    col = torch.arange(mbw, device=dev)[None, :, None]
    row = torch.arange(mbh, device=dev)[:, None, None]
    a_avail = col > 0
    b_avail = row > 0
    c_avail = (row > 0) & (col + 1 < mbw)
    d_avail = (row > 0) & (col > 0)
    c_sub = torch.where(c_avail, tr, torch.where(d_avail, tl, zeros))
    c_eff = c_avail | d_avail
    a = torch.where(a_avail, left, zeros)
    b = torch.where(b_avail, top, zeros)
    med = (a + b + c_sub - torch.maximum(torch.maximum(a, b), c_sub)
           - torch.minimum(torch.minimum(a, b), c_sub))
    n_avail = a_avail.to(_I32) + b_avail.to(_I32) + c_eff.to(_I32)
    only = torch.where(a_avail, a, torch.where(b_avail, b, c_sub))
    pred = torch.where(n_avail == 1, only, med)
    # 8.4.1.3.1: only A available (B, C, D all unavailable) -> mvA
    return torch.where(a_avail & ~b_avail & ~c_eff, a, pred)


def _nc_grid(grid):
    """nC for every block position of a (BH, BW) TotalCoeff grid: shifted
    reads of the left and top neighbours (9.2.1 availability)."""
    bh, bw = grid.shape
    dev = grid.device
    left, top = _neighbour(grid, 0, -1), _neighbour(grid, -1, 0)
    has_l = torch.arange(bw, device=dev)[None, :] > 0
    has_t = torch.arange(bh, device=dev)[:, None] > 0
    both = (left + top + 1) >> 1
    return torch.where(has_l & has_t, both, torch.where(has_l, left, torch.where(has_t, top, 0)))


def _frame_structure(out: dict) -> dict:
    """Full-grid per-MB syntax structure -- the cheap half of the coder:
    elementwise work and O(M) prefix scans over the MB grid. Every per-MB
    array is keyed in ``_COMPACT_KEYS`` so ``_compact_structure`` can gather
    the coded MBs into a dense prefix."""
    mvs = out["mvs"].to(_I32)
    skip = out["skip"].to(torch.bool)
    mbh, mbw = skip.shape
    m = mbh * mbw
    dev = skip.device
    zig = _tab("zigzag", dev)
    luma_scan = out["luma_ac"].reshape(mbh, mbw, 4, 4, 16).to(_I32).index_select(-1, zig)
    chroma_scan = out["chroma_ac"].reshape(mbh, mbw, 2, 2, 2, 16).to(_I32).index_select(-1, zig)
    cdc = out["chroma_dc"].reshape(mbh, mbw, 2, 4).to(_I32)

    coded = ~skip
    # cbp: 8x8 group b8 = (y4 >> 1) * 2 + (x4 >> 1)
    grp_nz = (luma_scan.reshape(mbh, mbw, 2, 2, 2, 2, 16).permute(0, 1, 2, 4, 3, 5, 6)
              .reshape(mbh, mbw, 2, 2, -1) != 0).any(-1).to(_I32)  # [y8][x8]
    cbp_luma = (grp_nz[..., 0, 0] | (grp_nz[..., 0, 1] << 1) | (grp_nz[..., 1, 0] << 2)
                | (grp_nz[..., 1, 1] << 3))
    chroma_ac_nz = (chroma_scan[..., 1:] != 0).reshape(mbh, mbw, -1).any(-1)
    chroma_dc_nz = (cdc != 0).reshape(mbh, mbw, -1).any(-1)
    cbp_chroma = torch.where(chroma_ac_nz, 2, torch.where(chroma_dc_nz, 1, 0)).to(_I32)
    cbp = cbp_luma | (cbp_chroma << 4)

    # TotalCoeff context grids: a block is coded iff its MB is coded and
    # its 8x8 group is in cbp
    luma_total = (luma_scan != 0).sum(-1, dtype=_I32)  # (mbh, mbw, 4, 4) [y4][x4]
    luma_gate = coded[..., None, None] & (
        ((cbp_luma[..., None, None] >> _tab("b8_of", dev)) & 1) != 0)
    luma_tc_flat = torch.where(luma_gate, luma_total, 0).permute(0, 2, 1, 3).reshape(
        mbh * 4, mbw * 4)
    ch_total = (chroma_scan[..., 1:] != 0).sum(-1, dtype=_I32)  # (mbh, mbw, 2, 2, 2) [c][y][x]
    ch_gate = coded[..., None, None, None] & (cbp_chroma[..., None, None, None] == 2)
    ch_tc_flat = torch.where(ch_gate, ch_total, 0).permute(2, 0, 3, 1, 4).reshape(
        2, mbh * 2, mbw * 2)

    # per-block inputs in coding order (a fixed index_select over the
    # 16-block axis)
    luma_perm = _tab("luma_perm", dev)
    nc_luma = (_nc_grid(luma_tc_flat).reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3)
               .reshape(m, 16).index_select(1, luma_perm))
    luma_blocks = luma_scan.reshape(mbh, mbw, 16, 16).index_select(2, luma_perm).reshape(m, 16, 16)
    luma_emit = (coded[..., None] & (
        ((cbp_luma[..., None] >> _tab("luma_b8", dev)) & 1) != 0)).reshape(m, 16)
    cdc_blocks = cdc.reshape(m, 2, 4)
    cdc_emit = (coded & (cbp_chroma >= 1))[..., None].expand(mbh, mbw, 2).reshape(m, 2)
    # chroma AC: nC per component from its own grid
    ch_perm = _tab("chroma_perm", dev)
    nc_ch = (torch.stack([_nc_grid(ch_tc_flat[c]) for c in range(2)])
             .reshape(2, mbh, 2, mbw, 2).permute(1, 3, 0, 2, 4).reshape(m, 2, 4)
             .index_select(2, ch_perm).reshape(m, 8))
    ch_blocks = (chroma_scan.reshape(mbh, mbw, 2, 4, 16).index_select(3, ch_perm)
                 .reshape(m, 8, 16)[..., 1:])
    ch_emit = (coded & (cbp_chroma == 2))[..., None, None].expand(mbh, mbw, 2, 4).reshape(m, 8)

    # MB headers: the skip run before each coded MB is the skips since the
    # previous coded MB, found by a running max over coded positions
    skip_flat = skip.reshape(-1).to(_I32)
    csum_skip = torch.cumsum(skip_flat, 0).to(_I32)
    coded_flat = 1 - skip_flat
    coded_pos = torch.where(coded_flat.bool(), torch.arange(m, device=dev, dtype=_I32), -1)
    prev_coded = torch.cummax(coded_pos, 0).values  # running max incl. self
    prev_excl = torch.cat([coded_pos.new_full((1,), -1), prev_coded[:-1]])
    csum_at = torch.cat([csum_skip.new_zeros(1), csum_skip])  # csum_at[p+1] = csum incl. p
    skip_run = csum_skip - torch.where(prev_excl >= 0, csum_at[(prev_excl + 1).long()], 0)

    mvd = 4 * (mvs.reshape(-1, 2) - _mv_pred_grid(mvs).reshape(-1, 2))
    sr_v, sr_b = _ue_bits(skip_run)
    mt = torch.ones_like(skip_run)  # ue(0) = '1'
    mx_v, mx_b = _se_bits(mvd[:, 0])
    my_v, my_b = _se_bits(mvd[:, 1])
    cbp_flat = cbp.reshape(-1)
    cb_v, cb_b = _ue_bits(_tab("cbp_codenum", dev)[cbp_flat.long()])
    qd_b = torch.where(cbp_flat > 0, 1, 0).to(_I32)  # se(0) = '1'
    hdr_vals = torch.stack([sr_v, mt, mx_v, my_v, cb_v, mt], -1)
    emit_mb = coded_flat.bool()
    hdr_bits = torch.where(emit_mb[:, None],
                           torch.stack([sr_b, mt, mx_b, my_b, cb_b, qd_b], -1), 0)

    # trailing skip run (after the last coded MB)
    # (indexing with a 0-dim tensor would read it back to the host: gather)
    last = prev_coded[-1:]
    at_last = csum_at.gather(0, (last + 1).clamp(min=0).long())
    trailing = torch.where(last >= 0, csum_skip[-1:] - at_last, csum_skip[-1:]).reshape(())
    return {
        "hdr_vals": hdr_vals, "hdr_bits": hdr_bits,
        "luma_blocks": luma_blocks, "nc_luma": nc_luma, "luma_emit": luma_emit,
        "cdc_blocks": cdc_blocks, "cdc_emit": cdc_emit,
        "ch_blocks": ch_blocks, "nc_ch": nc_ch, "ch_emit": ch_emit,
        "coded": emit_mb, "trailing": trailing,
        "ns": coded_flat.sum(dtype=_I32),
        # full-grid context grids, read by the CABAC emitter
        "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
        "luma_tc_flat": luma_tc_flat, "ch_tc_flat": ch_tc_flat,
    }


# per-MB arrays the activity compaction gathers into a dense prefix
_COMPACT_KEYS = (
    "hdr_vals", "hdr_bits", "luma_blocks", "nc_luma", "luma_emit",
    "cdc_blocks", "cdc_emit", "ch_blocks", "nc_ch", "ch_emit",
)


def _compact_structure(s: dict, A: int, keys=_COMPACT_KEYS) -> dict:
    """Gather the coded MBs of a frame structure into a dense prefix of
    ``A`` slots (raster order kept; slots past the coded count stay zero,
    so they emit nothing). One row scatter per array; every non-coded MB
    (and any coded MB past slot A) targets one sentinel row that is
    dropped, the only duplicate target. The caller selects A >= ns."""
    coded = s["coded"]
    pos = torch.cumsum(coded, 0) - 1
    dest = torch.where(coded & (pos < A), pos, A)

    def cp(a):
        return a.new_zeros((A + 1,) + tuple(a.shape[1:])).index_put_((dest,), a)[:A]

    return {k: cp(s[k]) for k in keys}


def _emit_slice_bits(s: dict, word_cap: int):
    """K2, the expensive half: VLC-code every block of a (possibly
    compacted) per-MB structure, pack each segment's codewords and merge
    them into one stream. Cost scales with the structure's leading axis.
    -> (words (word_cap,) int32 bit patterns, nbits int32)."""
    U = s["hdr_bits"].shape[0]
    dev = s["hdr_bits"].device
    lv, lb, _ = _encode_blocks(s["luma_blocks"].reshape(U * 16, 16), s["nc_luma"].reshape(-1),
                               chroma_dc=False)
    lb = torch.where(s["luma_emit"].reshape(-1)[:, None], lb, 0)
    dv, db, _ = _encode_blocks(s["cdc_blocks"].reshape(U * 2, 4),
                               torch.full((U * 2,), -1, dtype=_I32, device=dev), chroma_dc=True)
    db = torch.where(s["cdc_emit"].reshape(-1)[:, None], db, 0)
    cv, cb, _ = _encode_blocks(s["ch_blocks"].reshape(U * 8, 15), s["nc_ch"].reshape(-1),
                               chroma_dc=False)
    cb = torch.where(s["ch_emit"].reshape(-1)[:, None], cb, 0)

    # an MB is 27 segments in syntax order: header, 16 luma, 2 chroma DC,
    # 8 chroma AC
    HW = 4  # header words (6 codewords <= 78 bits)
    BW = 32  # per-block words (hard bound: 16+3+16*52+9+14*11 = 1014 bits)
    hdr_w, hdr_n = _pack_pairs(s["hdr_vals"], s["hdr_bits"], HW)
    luma_w, luma_n = _pack_pairs(lv, lb, BW)
    cdc_w, cdc_n = _pack_pairs(dv, db, BW)
    cac_w, cac_n = _pack_pairs(cv, cb, BW)
    seg_words = torch.cat([
        torch.cat([hdr_w, hdr_w.new_zeros((U, BW - HW))], 1).reshape(U, 1, BW),
        luma_w.reshape(U, 16, BW), cdc_w.reshape(U, 2, BW), cac_w.reshape(U, 8, BW),
    ], 1).reshape(U * 27, BW)
    seg_bits = torch.cat([hdr_n.reshape(U, 1), luma_n.reshape(U, 16), cdc_n.reshape(U, 2),
                          cac_n.reshape(U, 8)], 1).reshape(U * 27)
    words, total = _merge_streams(seg_words, seg_bits, word_cap)
    return _as_int32(words), total.to(_I32)


def pack_p_slice_bits(out: dict, word_cap: int = WORD_CAP_DEFAULT):
    """P-frame encode outputs -> slice-data bits on the device, full grid.

    Returns (words (word_cap,) int32 bit patterns of the big-endian-order
    uint32 words, nbits int32, trailing_skip int32): everything between
    the slice header and the final skip_run."""
    s = _frame_structure(out)
    words, nbits = _emit_slice_bits(s, word_cap)
    return words, nbits, s["trailing"]


def bits_buckets(m: int, ladder=(256, 1024, 4096)) -> tuple[int, ...]:
    """Activity buckets for a slice of ``m`` MBs: the ladder clipped to the
    grid, always ending at m."""
    m = int(m)
    return tuple(sorted({min(int(b), m) for b in ladder} | {m}))


def pack_p_slice_bits_active(out: dict, word_cap: int = WORD_CAP_DEFAULT,
                             buckets: tuple[int, ...] | None = None, bucket: int | None = None):
    """Device CAVLC whose emission runs over ``bucket`` compacted slots
    (an entry of ``buckets``, the top one by default). Bit-identical to
    pack_p_slice_bits whenever the bucket holds the frame's coded MBs; a
    smaller bucket drops the coded MBs past it. -> (words, nbits,
    trailing_skip, ns), ns the coded-MB count for the caller's
    ship-bits-or-coefficients decision, all on the device."""
    s = _frame_structure(out)
    m = s["coded"].shape[0]
    if buckets is None:
        buckets = bits_buckets(m)
    a = buckets[-1] if bucket is None else int(bucket)
    if a not in buckets:
        raise ValueError(f"bucket {a} is not one of {buckets}")
    words, nbits = _emit_slice_bits(s if a >= m else _compact_structure(s, a), word_cap)
    return words, nbits, s["trailing"], s["ns"]


# ---------------------------------------------------------------------------
# Host half: splice header + device bits + trailing, NAL-wrap
# ---------------------------------------------------------------------------


def _or_bits(out: np.ndarray, src: np.ndarray, bit_off: int, nbits: int) -> None:
    """OR ``nbits`` MSB-first bits of src into out at bit offset bit_off."""
    if nbits <= 0:
        return
    src = src[:(nbits + 7) // 8]
    sh = bit_off & 7
    b0 = bit_off >> 3
    # src may be zero-padded past nbits (whole device words): clamp every
    # write to the output (the spilled-over bytes are zeros)
    n1 = min(len(src), len(out) - b0)
    if sh == 0:
        out[b0:b0 + n1] |= src[:n1]
        return
    out[b0:b0 + n1] |= (src >> sh)[:n1]
    spill = ((src.astype(np.uint16) << (8 - sh)) & 0xFF).astype(np.uint8)
    n2 = min(len(spill), len(out) - b0 - 1)
    out[b0 + 1:b0 + 1 + n2] |= spill[:n2]


def assemble_p_nal(words: np.ndarray, nbits: int, trailing_skip: int, p, frame_num: int,
                   qp: int, ltr_ref: int | None = None, mark_ltr: int | None = None,
                   mmco_evict: tuple = (), first_mb: int = 0) -> bytes:
    """Finish a P slice from device bits: header + stream + trailing
    skip_run + rbsp stop, emulation-prevented and Annex-B wrapped.
    ``words`` are the uint32 words (or their int32 bit patterns).
    Byte-identical to cavlc.pack_slice_p for the same inputs; ``first_mb``
    positions a band slice and lives in the host-written header only."""
    from selkies_tpu_torch.models.h264 import native
    from selkies_tpu_torch.models.h264.bitstream import (
        NAL_SLICE_NON_IDR, SLICE_P, write_slice_header)
    from selkies_tpu_torch.utils.bits import BitWriter

    w = BitWriter()
    write_slice_header(w, p, SLICE_P, frame_num, idr=False, slice_qp=qp, ltr_ref=ltr_ref,
                       mark_ltr=mark_ltr, mmco_evict=mmco_evict, first_mb=first_mb)
    hdr_bytes, hdr_bits = w.get_partial()
    nbits = int(nbits)
    dev_bytes = (np.ascontiguousarray(words[:(nbits + 31) // 32]).view(np.uint32)
                 .astype(">u4").view(np.uint8))
    tail = BitWriter()
    if trailing_skip:
        tail.write_ue(int(trailing_skip))
    tail.write_bit(1)  # rbsp_stop_one_bit; the byte-align zeros come from sizing
    tail_bytes, tail_bits = tail.get_partial()
    out = np.zeros((hdr_bits + nbits + tail_bits + 7) // 8, np.uint8)
    _or_bits(out, np.frombuffer(hdr_bytes, np.uint8), 0, hdr_bits)
    _or_bits(out, dev_bytes, hdr_bits, nbits)
    _or_bits(out, np.frombuffer(tail_bytes, np.uint8), hdr_bits + nbits, tail_bits)
    return (b"\x00\x00\x00\x01" + bytes([(3 << 5) | NAL_SLICE_NON_IDR])
            + native.emulation_prevent(out.tobytes()))
