"""Host-side unpack of the compact and sparse downlinks.

Counterpart of ``selkies_tpu/models/h264/compact.py``: the dense compact
layout (``encoder_core.pack_*_compact``), the two sparse P layouts of the
delta path (``pack_p_sparse_var``, ``pack_p_sparse_packed``) and the
device-entropy wrapper around them (``pack_p_sparse_entropy``). Scatters
the fetched nonzero rows back into dense coefficient arrays and wraps them
as FrameCoeffs / PFrameCoeffs, so the CAVLC packers get exactly the arrays
the device computed; ``p_sparse_wire_views`` instead hands the sparse
buffer's regions straight to the native sparse packer.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from selkies_tpu_torch.models.h264.encoder_core import (
    I_ENTRIES,
    I_ROW_CHROMA,
    I_ROW_DC_C,
    I_ROW_LUMA,
    P_ENTRIES,
    P_ROW_CHROMA,
    P_ROW_DC,
)
from selkies_tpu_torch.models.h264.native import derive_skip_mvs
from selkies_tpu_torch.models.h264.numpy_ref import FrameCoeffs, PFrameCoeffs

# The int32 views over the device's int16 stream assume the host's lane
# order matches the device's (little-endian). Fail loudly otherwise.
if sys.byteorder != "little":
    raise RuntimeError("compact downlink decode requires a little-endian host")


def p_header_words(mbh: int, mbw: int) -> int:
    m = mbh * mbw
    return 4 + 2 * m + (m + 31) // 32


def i_header_words(mbh: int, mbw: int) -> int:
    return 4 + 2 * mbh * mbw


def split_prefix(prefix: np.ndarray, header_words: int):
    """Undo encoder_core.fuse_downlink: (header int32, data rows (cap, 16)
    int16, n). Viewing the int16 pairs back as int32 is exact."""
    header = np.ascontiguousarray(prefix[: 2 * header_words]).view(np.int32)
    data = prefix[2 * header_words:].reshape(-1, 16)
    return header, data, int(header[0])


def _flags_from_bitmap(words: np.ndarray, entries: int) -> np.ndarray:
    return ((words[:, None] >> np.arange(entries, dtype=np.int32)) & 1).astype(bool)


def _scatter_rows(flags: np.ndarray, data: np.ndarray) -> np.ndarray:
    """flags (M, E); data (>=n, 16) -> dense rows (M, E, 16) int16."""
    m, e = flags.shape
    flat_idx = np.flatnonzero(flags.reshape(-1))
    rows = np.zeros((m * e, 16), np.int16)
    if len(flat_idx):
        rows[flat_idx] = data[: len(flat_idx)]
    return rows.reshape(m, e, 16)


def _check_rows(data: np.ndarray, n: int) -> None:
    if data.shape[0] < n:
        raise ValueError(f"data has {data.shape[0]} rows, header says {n}")


def unpack_p_compact(header: np.ndarray, data: np.ndarray, qp: int) -> PFrameCoeffs:
    """header int32, data int16 (>=n, 16) -> dense PFrameCoeffs."""
    n, mbh, mbw = int(header[0]), int(header[1]), int(header[2])
    m = mbh * mbw
    _check_rows(data, n)
    mv_words = header[4: 4 + m].astype(np.int32)
    mvx = (mv_words << 16) >> 16  # sign-extend low half
    mvy = mv_words >> 16
    mvs = np.stack([mvx, mvy], -1).reshape(mbh, mbw, 2)
    mbinfo = header[4 + m: 4 + 2 * m].astype(np.int32)
    skip_words = header[4 + 2 * m:].astype(np.int64) & 0xFFFFFFFF
    skip_bits = ((skip_words[:, None] >> np.arange(32)) & 1).astype(bool).reshape(-1)[:m]
    return _p_coeffs(mvs, skip_bits.reshape(mbh, mbw), mbinfo, data, qp)


def _p_coeffs(mvs, skip, mbinfo, data, qp: int) -> PFrameCoeffs:
    """Per-MB nonzero-row bitmaps + the rows -> dense PFrameCoeffs."""
    mbh, mbw = skip.shape
    rows = _scatter_rows(_flags_from_bitmap(mbinfo, P_ENTRIES), data)
    return PFrameCoeffs(
        mvs=mvs,
        skip=skip,
        luma_ac=rows[:, :P_ROW_CHROMA].reshape(mbh, mbw, 4, 4, 4, 4).astype(np.int32),
        chroma_dc=rows[:, P_ROW_DC:P_ENTRIES, :4].reshape(mbh, mbw, 2, 2, 2).astype(np.int32),
        chroma_ac=rows[:, P_ROW_CHROMA:P_ROW_DC].reshape(mbh, mbw, 2, 2, 2, 4, 4).astype(np.int32),
        qp=qp,
    )


def unpack_i_compact(header: np.ndarray, data: np.ndarray, qp: int) -> FrameCoeffs:
    """header int32, data int16 (>=n, 16) -> dense FrameCoeffs."""
    n, mbh, mbw = int(header[0]), int(header[1]), int(header[2])
    m = mbh * mbw
    _check_rows(data, n)
    mbinfo = header[4: 4 + m].astype(np.int32)
    modes = header[4 + m: 4 + 2 * m].astype(np.int32)
    rows = _scatter_rows(_flags_from_bitmap(mbinfo, I_ENTRIES), data)
    return FrameCoeffs(
        luma_mode=(modes & 0xFF).reshape(mbh, mbw),
        chroma_mode=(modes >> 8).reshape(mbh, mbw),
        luma_dc=rows[:, 0].reshape(mbh, mbw, 4, 4).astype(np.int32),
        luma_ac=rows[:, I_ROW_LUMA:I_ROW_CHROMA].reshape(mbh, mbw, 4, 4, 4, 4).astype(np.int32),
        chroma_dc=rows[:, I_ROW_DC_C:I_ENTRIES, :4].reshape(mbh, mbw, 2, 2, 2).astype(np.int32),
        chroma_ac=rows[:, I_ROW_CHROMA:I_ROW_DC_C].reshape(mbh, mbw, 2, 2, 2, 4, 4).astype(np.int32),
        qp=qp,
    )


# ---------------------------------------------------------------------------
# Sparse P layouts (the delta path)
# ---------------------------------------------------------------------------

def p_sparse_var_words(mbh: int, mbw: int, nscap: int, cap_rows: int) -> int:
    """Total int16 length of the variable-packed sparse buffer."""
    sw = (mbh * mbw + 31) // 32
    return 8 + 2 * sw + 4 * nscap + 16 * cap_rows


def p_sparse_var_need(fused16: np.ndarray, mbh: int, mbw: int, nscap: int,
                      cap_rows: int):
    """(needed int16 length, n, ns) from a slice that covers the meta.
    ``needed`` counts only what the fused buffer holds (rows cap at
    cap_rows); ns > nscap means the dense-header fallback."""
    meta = np.ascontiguousarray(fused16[:8]).view(np.int32)
    n, ns = int(meta[0]), int(meta[3])
    sw = (mbh * mbw + 31) // 32
    return 8 + 2 * sw + 4 * min(ns, nscap) + 16 * min(n, cap_rows), n, ns


def unpack_p_sparse_var(fused16: np.ndarray, qp: int, mbh: int, mbw: int, nscap: int,
                        cap_rows: int, extra_rows: np.ndarray | None = None):
    """Variable-packed sparse buffer -> (PFrameCoeffs | None, rows (n, 16)):
    None means ns > nscap (the caller falls back to the dense header, reusing
    ``rows``). ``extra_rows`` supplies rows [cap_rows, n) of a spill."""
    m = mbh * mbw
    sw = (m + 31) // 32
    need, n, ns = p_sparse_var_need(fused16, mbh, mbw, nscap, cap_rows)
    if len(fused16) < need:
        raise ValueError(f"slice has {len(fused16)} int16, need {need}")
    base = 8 + 2 * sw
    rows_off = base + 4 * min(ns, nscap)
    held = min(n, cap_rows)
    rows = fused16[rows_off: rows_off + 16 * held].reshape(held, 16)
    if n > held:
        rows = np.concatenate([rows, extra_rows[: n - held]])
    if ns > nscap:
        return None, rows
    skip_words = (np.ascontiguousarray(fused16[8: 8 + 2 * sw]).view(np.int32)
                  .astype(np.int64) & 0xFFFFFFFF)
    skip_bits = ((skip_words[:, None] >> np.arange(32)) & 1).astype(bool).reshape(-1)[:m]
    pairs = np.ascontiguousarray(fused16[base: base + 4 * ns]).view(np.int32)
    return _finish_sparse_p(pairs, skip_bits, rows, ns, qp, mbh, mbw)


def p_sparse_packed_words(mbh: int, mbw: int, nscap: int, cap_rows: int) -> int:
    """Total int16 length of the bit-packed sparse buffer."""
    sw = (mbh * mbw + 31) // 32
    return 12 + 2 * sw + 4 * nscap + cap_rows + 16 * cap_rows


def p_sparse_packed_need(fused16: np.ndarray, mbh: int, mbw: int, nscap: int,
                         cap_rows: int):
    """(needed int16 length, n, ns) for a bit-packed sparse buffer, from a
    slice that covers the 12-word meta (as p_sparse_var_need)."""
    meta = np.ascontiguousarray(fused16[:12]).view(np.int32)
    n, ns, nw, dense = int(meta[0]), int(meta[3]), int(meta[4]), int(meta[5])
    sw = (mbh * mbw + 31) // 32
    held = min(n, cap_rows)
    rows_words = 16 * held if dense else held + nw
    return 12 + 2 * sw + 4 * min(ns, nscap) + rows_words, n, ns


ENTROPY_META16 = 16  # int16 words of the pack_p_sparse_entropy meta prefix


def p_sparse_entropy_words(mbh: int, mbw: int, nscap: int, cap_rows: int, packed: bool,
                           bits_words: int, entropy_coder: str = "cavlc") -> int:
    """Total int16 length of the entropy-wrapped fused buffer
    (encoder_core.pack_p_sparse_entropy): the 8-int32 meta prefix plus a
    payload region sized for the larger of its two modes. For CABAC the
    token payload also holds the skip bitmap and the per-coded-MB token
    counts ahead of the token words."""
    coeff = (p_sparse_packed_words(mbh, mbw, nscap, cap_rows) if packed
             else p_sparse_var_words(mbh, mbw, nscap, cap_rows))
    m = mbh * mbw
    sw = (m + 31) // 32
    bits = 2 * sw + m + 2 * bits_words if entropy_coder == "cabac" else 2 * bits_words
    return ENTROPY_META16 + max(coeff, bits)


def p_sparse_entropy_meta(fused16: np.ndarray):
    """(mode, nbits, trailing_skip, nskip, ns) of an entropy-wrapped fused
    buffer. Mode 1: the payload is the slice-data bit words (CAVLC; for
    CABAC nbits is the token count); mode 0: the unchanged sparse
    coefficient layout starting at ENTROPY_META16."""
    meta = np.ascontiguousarray(fused16[:ENTROPY_META16]).view(np.int32)
    return int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3]), int(meta[4])


def _expand_packed_rows(bitmaps: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """bitmaps (held,) int16 + quad-padded values -> dense rows (held, 16)."""
    bm = bitmaps.astype(np.int32) & 0xFFFF
    bits = ((bm[:, None] >> np.arange(16)) & 1).astype(bool)
    counts = bits.sum(-1)
    width = 4 * ((counts + 3) // 4)
    off = np.cumsum(width) - width
    rows = np.zeros((len(bm), 16), np.int16)
    rr, cc = np.nonzero(bits)
    if len(rr):
        rank = (np.cumsum(bits, axis=1) - 1)[rr, cc]
        rows[rr, cc] = vals[off[rr] + rank]
    return rows


def unpack_p_sparse_packed(fused16: np.ndarray, qp: int, mbh: int, mbw: int, nscap: int,
                           cap_rows: int, extra_rows: np.ndarray | None = None):
    """Bit-packed sparse buffer -> (PFrameCoeffs | None, rows), with the
    contract of unpack_p_sparse_var."""
    m = mbh * mbw
    sw = (m + 31) // 32
    need, n, ns = p_sparse_packed_need(fused16, mbh, mbw, nscap, cap_rows)
    if len(fused16) < need:
        raise ValueError(f"slice has {len(fused16)} int16, need {need}")
    meta = np.ascontiguousarray(fused16[:12]).view(np.int32)
    nw, dense_flag = int(meta[4]), int(meta[5])
    base = 12 + 2 * sw
    rows_off = base + 4 * min(ns, nscap)
    held = min(n, cap_rows)
    if dense_flag:
        rows = fused16[rows_off: rows_off + 16 * held].reshape(held, 16)
    else:
        rows = _expand_packed_rows(fused16[rows_off: rows_off + held],
                                   fused16[rows_off + held: rows_off + held + nw])
    if n > held:
        rows = np.concatenate([rows, extra_rows[: n - held]])
    if ns > nscap:
        return None, rows
    skip_words = (np.ascontiguousarray(fused16[12: 12 + 2 * sw]).view(np.int32)
                  .astype(np.int64) & 0xFFFFFFFF)
    skip_bits = ((skip_words[:, None] >> np.arange(32)) & 1).astype(bool).reshape(-1)[:m]
    pairs = np.ascontiguousarray(fused16[base: base + 4 * ns]).view(np.int32)
    return _finish_sparse_p(pairs, skip_bits, rows, ns, qp, mbh, mbw)


@dataclass
class SparsePWire:
    """Views into one frame's sparse-P downlink buffer, in the regions
    ``native/cavlc_pack.cc`` pack_slice_p_sparse_rbsp consumes. Arrays are
    contiguous int16 views of the fetched buffer; ``extra_rows`` is the
    cap_rows spill (16-lane rows), empty when the frame fit."""

    mbh: int
    mbw: int
    n: int              # total nonzero rows
    ns: int             # non-skip MBs (== len(pairs16) // 4)
    held: int           # rows present in the primary layout
    packed: bool
    skip16: np.ndarray       # (2*ceil(M/32),) skip bitmap words
    pairs16: np.ndarray      # (4*ns,) (mv, mbinfo) int32 pairs
    rows16: np.ndarray       # (16*held,) 16-lane rows (empty when packed)
    bitmaps: np.ndarray      # (held,) significance bitmaps (packed only)
    vals: np.ndarray         # (nw,) quad-padded nonzero values (packed only)
    extra_rows: np.ndarray   # ((n-held)*16,) spill rows, 16-lane


_EMPTY_I16 = np.empty(0, np.int16)


def p_sparse_wire_views(fused16: np.ndarray, mbh: int, mbw: int, nscap: int, cap_rows: int,
                        packed: bool, extra_rows: np.ndarray | None = None
                        ) -> SparsePWire | None:
    """Sparse buffer -> SparsePWire views for the native sparse packer, or
    None when ns > nscap (dense-header fallback). Checks the skip bitmap
    against ns, so a corrupt buffer fails instead of packing garbage."""
    m = mbh * mbw
    sw = (m + 31) // 32
    if packed:
        meta = np.ascontiguousarray(fused16[:12]).view(np.int32)
        n, ns, nw, dense = int(meta[0]), int(meta[3]), int(meta[4]), int(meta[5])
        base = 12 + 2 * sw
    else:
        meta = np.ascontiguousarray(fused16[:8]).view(np.int32)
        n, ns = int(meta[0]), int(meta[3])
        nw, dense = 0, 1
        base = 8 + 2 * sw
    if ns > nscap:
        return None
    skip16 = fused16[base - 2 * sw: base]
    nskip = int(np.unpackbits(np.ascontiguousarray(skip16).view(np.uint8)).sum())
    if m - nskip != ns:
        raise ValueError(f"skip bitmap has {m - nskip} non-skip MBs, header says {ns}")
    held = min(n, cap_rows)
    rows_off = base + 4 * ns
    if packed and not dense:
        rows16 = _EMPTY_I16
        bitmaps = fused16[rows_off: rows_off + held]
        vals = fused16[rows_off + held: rows_off + held + nw]
    else:
        rows16 = fused16[rows_off: rows_off + 16 * held]
        bitmaps = vals = _EMPTY_I16
    if n > held:
        extra = np.ascontiguousarray(extra_rows[: n - held], np.int16).reshape(-1)
    else:
        extra = _EMPTY_I16
    return SparsePWire(
        mbh=mbh, mbw=mbw, n=n, ns=ns, held=held, packed=bool(packed and not dense),
        skip16=skip16, pairs16=fused16[base:rows_off], rows16=rows16,
        bitmaps=bitmaps, vals=vals, extra_rows=extra,
    )


def _finish_sparse_p(pairs, skip_bits, rows, ns, qp, mbh, mbw):
    """Shared tail of the sparse unpackers: (mv, info) pairs + skip bitmap
    + rows -> (PFrameCoeffs, rows), skip MBs' MVs derived (8.4.1.1)."""
    m = mbh * mbw
    mv_c, info_c = pairs[0::2], pairs[1::2]
    pos = np.flatnonzero(~skip_bits)
    if len(pos) != ns:
        raise ValueError(f"skip bitmap has {len(pos)} non-skip MBs, header says {ns}")
    mv_words = np.zeros(m, np.int32)
    mv_words[pos] = mv_c
    mbinfo = np.zeros(m, np.int32)
    mbinfo[pos] = info_c
    mvx = (mv_words << 16) >> 16
    mvy = mv_words >> 16
    skip = skip_bits.reshape(mbh, mbw)
    mvs = np.ascontiguousarray(np.stack([mvx, mvy], -1).reshape(mbh, mbw, 2))
    derive_skip_mvs(mvs, skip)
    return _p_coeffs(mvs, skip, mbinfo, rows, qp), rows
