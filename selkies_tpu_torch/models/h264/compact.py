"""Host-side unpack of the compact downlink (encoder_core.pack_*_compact).

Counterpart of ``selkies_tpu/models/h264/compact.py`` for the dense
compact layout. Scatters the fetched nonzero rows back into dense
coefficient arrays and wraps them as FrameCoeffs / PFrameCoeffs, so the
CAVLC packers get exactly the arrays the device computed.
"""

from __future__ import annotations

import sys

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
    rows = _scatter_rows(_flags_from_bitmap(mbinfo, P_ENTRIES), data)
    return PFrameCoeffs(
        mvs=mvs,
        skip=skip_bits.reshape(mbh, mbw),
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
