"""Copy of ``selkies_tpu/models/h264/tables.py``, kept so the port imports nothing of the JAX package.

H.264 static tables: quantization matrices, scan orders, CAVLC VLCs.

Sources: ISO/IEC 14496-10 tables 9-5 (coeff_token), 9-7/9-8 (total_zeros),
9-9 (total_zeros chroma DC), 9-10 (run_before), and the standard
quantization multiplier/rescale factors (8.5.9).

All VLC tables are expressed as human-auditable bit strings and converted
to (value, nbits) pairs at import. Conformance is enforced empirically by
tests/test_h264_conformance.py, which decodes generated streams with
FFmpeg (via cv2) and compares reconstructions bit-exactly.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Scan orders
# ---------------------------------------------------------------------------

# 4x4 zigzag scan: index -> (row, col)
ZIGZAG_4x4 = [
    (0, 0), (0, 1), (1, 0), (2, 0),
    (1, 1), (0, 2), (0, 3), (1, 2),
    (2, 1), (3, 0), (3, 1), (2, 2),
    (1, 3), (2, 3), (3, 2), (3, 3),
]
ZIGZAG_FLAT = np.array([r * 4 + c for r, c in ZIGZAG_4x4], dtype=np.int32)

# Luma 4x4 block coding order within a macroblock (8x8 quadrant Z-order,
# 4x4 Z-order within): blk index -> (x4, y4) in units of 4 samples.
LUMA_BLOCK_ORDER = [
    (0, 0), (1, 0), (0, 1), (1, 1),
    (2, 0), (3, 0), (2, 1), (3, 1),
    (0, 2), (1, 2), (0, 3), (1, 3),
    (2, 2), (3, 2), (2, 3), (3, 3),
]

# Chroma 4x4 block order within the 8x8 plane (raster): blk -> (x4, y4)
CHROMA_BLOCK_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1)]

# ---------------------------------------------------------------------------
# Quantization (8.5.9): MF (encoder multiplier) and V (decoder rescale)
# ---------------------------------------------------------------------------

# Rows: QP % 6. Columns: position class 0 (both even), 1 (both odd), 2 (mixed).
QUANT_MF = np.array(
    [
        [13107, 5243, 8066],
        [11916, 4660, 7490],
        [10082, 4194, 6554],
        [9362, 3647, 5825],
        [8192, 3355, 5243],
        [7282, 2893, 4559],
    ],
    dtype=np.int64,
)

DEQUANT_V = np.array(
    [
        [10, 16, 13],
        [11, 18, 14],
        [13, 20, 16],
        [14, 23, 18],
        [16, 25, 20],
        [18, 29, 23],
    ],
    dtype=np.int64,
)

# Position class for each coefficient of a 4x4 block.
_POS_CLASS = np.array(
    [[0 if (i % 2 == 0 and j % 2 == 0) else 1 if (i % 2 and j % 2) else 2 for j in range(4)] for i in range(4)],
    dtype=np.int64,
)


def mf_matrix(qp: int) -> np.ndarray:
    """4x4 encoder quant multipliers for QP."""
    return QUANT_MF[qp % 6][_POS_CLASS]


def v_matrix(qp: int) -> np.ndarray:
    """4x4 decoder rescale factors for QP."""
    return DEQUANT_V[qp % 6][_POS_CLASS]


# Chroma QP mapping (table 8-15) for qPi 30..51; below 30 identity.
_CHROMA_QP_TAIL = [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39]


def chroma_qp(qp: int, offset: int = 0) -> int:
    qpi = max(0, min(51, qp + offset))
    return qpi if qpi < 30 else _CHROMA_QP_TAIL[qpi - 30]


# ---------------------------------------------------------------------------
# CAVLC VLC tables
# ---------------------------------------------------------------------------


def _vlc(s: str) -> tuple[int, int]:
    """'0101' -> (value, nbits)."""
    return (int(s, 2), len(s))


def _tbl(rows: list[list[str | None]]) -> list[list[tuple[int, int] | None]]:
    return [[None if c is None else _vlc(c) for c in row] for row in rows]


# coeff_token, Table 9-5. Indexed [TotalCoeff][TrailingOnes].
# Three VLC tables by nC range plus the chroma-DC table; nC>=8 is 6-bit FLC.
# Row i = TotalCoeff i (0..16); column j = TrailingOnes j (0..3).

COEFF_TOKEN_NC_0_2: list[list[str | None]] = [
    ["1", None, None, None],
    ["000101", "01", None, None],
    ["00000111", "000100", "001", None],
    ["000000111", "00000110", "0000101", "00011"],
    ["0000000111", "000000110", "00000101", "000011"],
    ["00000000111", "0000000110", "000000101", "0000100"],
    ["0000000001111", "00000000110", "0000000101", "00000100"],
    ["0000000001011", "0000000001110", "00000000101", "000000100"],
    ["0000000001000", "0000000001010", "0000000001101", "0000000100"],
    ["00000000001111", "00000000001110", "0000000001001", "00000000100"],
    ["00000000001011", "00000000001010", "00000000001101", "0000000001100"],
    ["000000000001111", "000000000001110", "00000000001001", "00000000001100"],
    ["000000000001011", "000000000001010", "000000000001101", "00000000001000"],
    ["0000000000001111", "000000000000001", "000000000001001", "000000000001100"],
    ["0000000000001011", "0000000000001110", "0000000000001101", "000000000001000"],
    ["0000000000000111", "0000000000001010", "0000000000001001", "0000000000001100"],
    ["0000000000000100", "0000000000000110", "0000000000000101", "0000000000001000"],
]

COEFF_TOKEN_NC_2_4: list[list[str | None]] = [
    ["11", None, None, None],
    ["001011", "10", None, None],
    ["000111", "00111", "011", None],
    ["0000111", "001010", "001001", "0101"],
    ["00000111", "000110", "000101", "0100"],
    ["00000100", "0000110", "0000101", "00110"],
    ["000000111", "00000110", "00000101", "001000"],
    ["00000001111", "000000110", "000000101", "000100"],
    ["00000001011", "00000001110", "00000001101", "0000100"],
    ["000000001111", "00000001010", "00000001001", "000000100"],
    ["000000001011", "000000001110", "000000001101", "00000001100"],
    ["000000001000", "000000001010", "000000001001", "00000001000"],
    ["0000000001111", "0000000001110", "0000000001101", "000000001100"],
    ["0000000001011", "0000000001010", "0000000001001", "0000000001100"],
    ["0000000000111", "00000000001011", "0000000000110", "0000000001000"],
    ["00000000001001", "00000000001000", "00000000001010", "0000000000001"],
    ["00000000000111", "00000000000110", "00000000000101", "00000000000100"],
]

COEFF_TOKEN_NC_4_8: list[list[str | None]] = [
    ["1111", None, None, None],
    ["001111", "1110", None, None],
    ["001011", "01111", "1101", None],
    ["001000", "01100", "01110", "1100"],
    ["0001111", "01010", "01011", "1011"],
    ["0001011", "01000", "01001", "1010"],
    ["0001001", "001110", "001101", "1001"],
    ["0001000", "001010", "001001", "1000"],
    ["00001111", "0001110", "0001101", "01101"],
    ["00001011", "00001110", "0001010", "001100"],
    ["000001111", "00001010", "00001101", "0001100"],
    ["000001011", "000001110", "00001001", "00001100"],
    ["000001000", "000001010", "000001101", "00001000"],
    ["0000001101", "000000111", "000001001", "000001100"],
    ["0000001001", "0000001100", "0000001011", "0000001010"],
    ["0000000101", "0000001000", "0000000111", "0000000110"],
    ["0000000001", "0000000100", "0000000011", "0000000010"],
]

COEFF_TOKEN_CHROMA_DC: list[list[str | None]] = [
    ["01", None, None, None],
    ["000111", "1", None, None],
    ["000100", "000110", "001", None],
    ["000011", "0000011", "0000010", "000101"],
    ["000010", "00000011", "00000010", "0000000"],
]

_COEFF_TOKEN_TABLES = {
    0: _tbl(COEFF_TOKEN_NC_0_2),
    2: _tbl(COEFF_TOKEN_NC_2_4),
    4: _tbl(COEFF_TOKEN_NC_4_8),
    -1: _tbl(COEFF_TOKEN_CHROMA_DC),
}


def coeff_token_code(nc: int, total_coeff: int, trailing_ones: int) -> tuple[int, int]:
    """Return (value, nbits) for coeff_token."""
    if nc >= 8:
        if total_coeff == 0:
            return (0b000011, 6)
        return (((total_coeff - 1) << 2) | trailing_ones, 6)
    if nc == -1:
        table = _COEFF_TOKEN_TABLES[-1]
    elif nc < 2:
        table = _COEFF_TOKEN_TABLES[0]
    elif nc < 4:
        table = _COEFF_TOKEN_TABLES[2]
    else:
        table = _COEFF_TOKEN_TABLES[4]
    code = table[total_coeff][trailing_ones]
    if code is None:
        raise ValueError(f"invalid coeff_token TC={total_coeff} T1={trailing_ones}")
    return code


# total_zeros for 4x4 blocks (Tables 9-7, 9-8). TOTAL_ZEROS_4x4[tc-1][tz].
TOTAL_ZEROS_4x4: list[list[str]] = [
    # tzVlcIndex 1
    ["1", "011", "010", "0011", "0010", "00011", "00010", "000011", "000010",
     "0000011", "0000010", "00000011", "00000010", "000000011", "000000010", "000000001"],
    # 2
    ["111", "110", "101", "100", "011", "0101", "0100", "0011", "0010",
     "00011", "00010", "000011", "000010", "000001", "000000"],
    # 3
    ["0101", "111", "110", "101", "0100", "0011", "100", "011", "0010",
     "00011", "00010", "000001", "00001", "000000"],
    # 4
    ["00011", "111", "0101", "0100", "110", "101", "100", "0011", "011",
     "0010", "00010", "00001", "00000"],
    # 5
    ["0101", "0100", "0011", "111", "110", "101", "100", "011", "0010",
     "00001", "0001", "00000"],
    # 6
    ["000001", "00001", "111", "110", "101", "100", "011", "010", "0001",
     "001", "000000"],
    # 7
    ["000001", "00001", "101", "100", "011", "11", "010", "0001", "001", "000000"],
    # 8
    ["000001", "0001", "00001", "011", "11", "10", "010", "001", "000000"],
    # 9
    ["000001", "000000", "0001", "11", "10", "001", "01", "00001"],
    # 10
    ["00001", "00000", "001", "11", "10", "01", "0001"],
    # 11
    ["0000", "0001", "001", "010", "1", "011"],
    # 12
    ["0000", "0001", "01", "1", "001"],
    # 13
    ["000", "001", "1", "01"],
    # 14
    ["00", "01", "1"],
    # 15
    ["0", "1"],
]

# total_zeros for chroma DC 2x2 blocks (Table 9-9).
TOTAL_ZEROS_CHROMA_DC: list[list[str]] = [
    ["1", "01", "001", "000"],
    ["1", "01", "00"],
    ["1", "0"],
]

_TZ_4x4 = [[_vlc(c) for c in row] for row in TOTAL_ZEROS_4x4]
_TZ_CDC = [[_vlc(c) for c in row] for row in TOTAL_ZEROS_CHROMA_DC]


def total_zeros_code(total_coeff: int, total_zeros: int, chroma_dc: bool = False) -> tuple[int, int]:
    table = _TZ_CDC if chroma_dc else _TZ_4x4
    return table[total_coeff - 1][total_zeros]


# run_before (Table 9-10). RUN_BEFORE[min(zerosLeft,7)-1][run]; zerosLeft>6
# extends with unary codes for run >= 7.
RUN_BEFORE: list[list[str]] = [
    ["1", "0"],
    ["1", "01", "00"],
    ["11", "10", "01", "00"],
    ["11", "10", "01", "001", "000"],
    ["11", "10", "011", "010", "001", "000"],
    ["11", "000", "001", "011", "010", "101", "100"],
    ["111", "110", "101", "100", "011", "010", "001"],
]

_RUN_BEFORE = [[_vlc(c) for c in row] for row in RUN_BEFORE]


def run_before_code(zeros_left: int, run: int) -> tuple[int, int]:
    if zeros_left <= 6:
        return _RUN_BEFORE[zeros_left - 1][run]
    if run <= 6:
        return _RUN_BEFORE[6][run]
    # run 7..14: '0001', '00001', ... (run-4 zeros then a 1)
    return (1, run - 3)
