"""Copy of ``selkies_tpu/models/h264/cavlc.py``, kept so the port imports nothing of the JAX package.

CAVLC entropy coding (ISO 14496-10 §9.2): FrameCoeffs → slice NAL bytes.

Pure-Python reference packer. The production path is the C++ packer in
native/cavlc_pack.cc (byte-identical output, validated by tests); this
module is the readable specification of the bit layout and the fallback
when the native library isn't built.

Design note: the bit-serial part of H.264 is the worst fit for TPU
hardware, so the split mirrors the reference's CPU/GPU division of labour
(NVENC keeps entropy coding in dedicated silicon): the TPU produces
quantized coefficient tensors (FrameCoeffs), the host packs bits.
"""

from __future__ import annotations

import numpy as np

from selkies_tpu_torch.models.h264.bitstream import (
    NAL_SLICE_IDR,
    NAL_SLICE_NON_IDR,
    SLICE_I,
    SLICE_P,
    StreamParams,
    write_slice_header,
)
from selkies_tpu_torch.models.h264.numpy_ref import FrameCoeffs, PFrameCoeffs, mv_pred_16x16
from selkies_tpu_torch.models.h264.tables import (
    CHROMA_BLOCK_ORDER,
    LUMA_BLOCK_ORDER,
    ZIGZAG_FLAT,
    coeff_token_code,
    run_before_code,
    total_zeros_code,
)
from selkies_tpu_torch.utils.bits import BitWriter, annexb_nal

__all__ = ["pack_slice", "pack_slice_p", "encode_stream", "residual_block", "nc_context"]

# Table 9-4 column for Inter MB prediction: coded_block_pattern -> codeNum
# for the me(v) mapping (index = cbp value 0..47).
INTER_CBP_TO_CODENUM = [
    0, 2, 3, 7, 4, 8, 17, 13, 5, 18, 9, 14, 10, 15, 16, 11,
    1, 32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6, 24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12,
]


def residual_block(w: BitWriter, coeffs: np.ndarray, max_coeff: int, nc: int) -> int:
    """Write one CAVLC residual block; coeffs already in scan order.

    Returns TotalCoeff (for neighbour nC context upkeep).
    """
    coeffs = [int(c) for c in coeffs]
    nz = [i for i, c in enumerate(coeffs) if c != 0]
    total = len(nz)
    # trailing ones: consecutive |1| at the end of the nonzero list, max 3
    t1 = 0
    for i in reversed(nz):
        if abs(coeffs[i]) == 1 and t1 < 3:
            t1 += 1
        else:
            break
    val, nbits = coeff_token_code(nc, total, t1)
    w.write_bits(val, nbits)
    if total == 0:
        return 0

    # trailing one signs, reverse scan order
    for k in range(t1):
        w.write_bit(1 if coeffs[nz[-1 - k]] < 0 else 0)

    # remaining levels, reverse scan order
    suffix_len = 1 if (total > 10 and t1 < 3) else 0
    for idx, k in enumerate(range(t1, total)):
        level = coeffs[nz[-1 - k]]
        level_code = 2 * level - 2 if level > 0 else -2 * level - 1
        if idx == 0 and t1 < 3:
            level_code -= 2
        _write_level(w, level_code, suffix_len)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # total_zeros
    total_zeros = nz[-1] + 1 - total
    if total < max_coeff:
        val, nbits = total_zeros_code(total, total_zeros, chroma_dc=(max_coeff == 4))
        w.write_bits(val, nbits)

    # run_before, reverse scan order, last coeff's run implied
    zeros_left = total_zeros
    for k in range(total - 1):
        if zeros_left <= 0:
            break
        run = nz[-1 - k] - nz[-2 - k] - 1
        val, nbits = run_before_code(zeros_left, run)
        w.write_bits(val, nbits)
        zeros_left -= run
    return total


def _write_level(w: BitWriter, level_code: int, suffix_len: int) -> None:
    """Write level_prefix + level_suffix for one level (9.2.2.1)."""
    if suffix_len == 0:
        if level_code < 14:
            w.write_bits(1, level_code + 1)  # unary: level_code zeros then 1
            return
        if level_code < 30:
            w.write_bits(1, 15)  # prefix 14
            w.write_bits(level_code - 14, 4)
            return
        level_code -= 15  # decoder adds 15 back for prefix>=15, suffix_len==0
    if level_code < (15 << suffix_len):
        prefix = level_code >> suffix_len
        w.write_bits(1, prefix + 1)
        if suffix_len:
            w.write_bits(level_code & ((1 << suffix_len) - 1), suffix_len)
        return
    # escape: prefix 15, 12-bit suffix
    esc = level_code - (15 << suffix_len)
    if esc < (1 << 12):
        w.write_bits(1, 16)
        w.write_bits(esc, 12)
        return
    # extended prefixes (16+): suffix size = prefix - 3
    prefix = 16
    while True:
        base = (15 << suffix_len) + (1 << (prefix - 3)) - (1 << 12)
        if level_code - base < (1 << (prefix - 3)):
            w.write_bits(1, prefix + 1)
            w.write_bits(level_code - base, prefix - 3)
            return
        prefix += 1


def nc_context(counts: np.ndarray, bx: int, by: int) -> int:
    """Neighbour context for block at absolute block coords (bx, by)."""
    left = counts[by, bx - 1] if bx > 0 else None
    top = counts[by - 1, bx] if by > 0 else None
    if left is not None and top is not None:
        return (int(left) + int(top) + 1) >> 1
    if left is not None:
        return int(left)
    if top is not None:
        return int(top)
    return 0


def pack_slice(
    fc: FrameCoeffs,
    p: StreamParams,
    frame_num: int = 0,
    idr: bool = True,
    idr_pic_id: int = 0,
    first_mb: int = 0,
) -> bytes:
    """Entropy-code Intra16x16 MBs into one slice NAL.

    fc may cover the whole picture (first_mb=0, the single-slice default)
    or one horizontal BAND of it (parallel/bands.py): first_mb is the
    slice header's first_mb_in_slice, and fc's grid is the band's own
    (band_mbh, mbw) — neighbour/nC context starts fresh at the band's
    first row, which is exactly the slice-boundary availability rule
    (neighbours in another slice are unavailable)."""
    mbh, mbw = fc.luma_mode.shape
    w = BitWriter()
    # fc.qp is the QP the coefficients were quantized with; slice_qp_delta
    # carries any difference from pic_init_qp (live rate-control retunes).
    write_slice_header(w, p, SLICE_I, frame_num, idr=idr, idr_pic_id=idr_pic_id,
                       slice_qp=fc.qp, first_mb=first_mb)

    # nC context grids (TotalCoeff per 4x4 block, frame-wide)
    luma_tc = np.zeros((mbh * 4, mbw * 4), np.int32)
    chroma_tc = np.zeros((2, mbh * 2, mbw * 2), np.int32)

    # Precompute zigzag views once: AC scans positions 1..15.
    luma_ac = fc.luma_ac.reshape(mbh, mbw, 4, 4, 16)[..., ZIGZAG_FLAT]
    chroma_ac = fc.chroma_ac.reshape(mbh, mbw, 2, 2, 2, 16)[..., ZIGZAG_FLAT]
    luma_dc_scan = fc.luma_dc.reshape(mbh, mbw, 16)[..., ZIGZAG_FLAT]

    for mby in range(mbh):
        for mbx in range(mbw):
            cbp_luma = 15 if np.any(luma_ac[mby, mbx, :, :, 1:]) else 0
            if np.any(chroma_ac[mby, mbx, :, :, :, 1:]):
                cbp_chroma = 2
            elif np.any(fc.chroma_dc[mby, mbx]):
                cbp_chroma = 1
            else:
                cbp_chroma = 0
            mb_type = 1 + int(fc.luma_mode[mby, mbx]) + 4 * cbp_chroma + 12 * (1 if cbp_luma else 0)
            w.write_ue(mb_type)
            w.write_ue(int(fc.chroma_mode[mby, mbx]))
            w.write_se(0)  # mb_qp_delta (constant QP per slice)

            # Intra16x16 DC block: nC from luma block 0's neighbours
            nc = nc_context(luma_tc, mbx * 4, mby * 4)
            residual_block(w, luma_dc_scan[mby, mbx], 16, nc)

            if cbp_luma:
                for blk, (x4, y4) in enumerate(LUMA_BLOCK_ORDER):
                    bx, by = mbx * 4 + x4, mby * 4 + y4
                    nc = nc_context(luma_tc, bx, by)
                    tc = residual_block(w, luma_ac[mby, mbx, y4, x4, 1:], 15, nc)
                    luma_tc[by, bx] = tc
            # (cbp_luma == 0 leaves TotalCoeff 0 in the context grid)

            if cbp_chroma:
                for comp in range(2):
                    # chroma DC scan order: raster over the 2x2
                    residual_block(w, fc.chroma_dc[mby, mbx, comp].reshape(4), 4, -1)
            if cbp_chroma == 2:
                for comp in range(2):
                    for x4, y4 in CHROMA_BLOCK_ORDER:
                        bx, by = mbx * 2 + x4, mby * 2 + y4
                        nc = nc_context(chroma_tc[comp], bx, by)
                        tc = residual_block(w, chroma_ac[mby, mbx, comp, y4, x4, 1:], 15, nc)
                        chroma_tc[comp, by, bx] = tc

    w.rbsp_trailing_bits()
    nal_type = NAL_SLICE_IDR if idr else NAL_SLICE_NON_IDR
    return annexb_nal(3, nal_type, w.get_bytes())


def pack_slice_p(
    fc: PFrameCoeffs,
    p: StreamParams,
    frame_num: int,
    ltr_ref: int | None = None,
    mark_ltr: int | None = None,
    mmco_evict: tuple = (),
    first_mb: int = 0,
) -> bytes:
    """Entropy-code one P frame (P_Skip / P_L0_16x16 MBs) into a slice NAL.

    Syntax per 7.3.4 (slice data) + 7.3.5 (macroblock layer): mb_skip_run
    before every coded MB, mb_type 0 (P_L0_16x16), no ref_idx (single
    reference), mvd relative to the 8.4.1.3 predictor in quarter-pel units,
    me(v)-mapped CBP, and 16-coefficient luma residual blocks (inter MBs
    have no luma DC Hadamard).

    As with pack_slice, fc may be one band of a multi-slice picture:
    first_mb positions the slice and fc's (band_mbh, mbw) grid resets
    the MV-predictor / nC neighbourhood at the band's first row (slice
    boundaries make those neighbours unavailable, 8.4.1.3 / 9.2.1).
    """
    mbh, mbw = fc.skip.shape
    w = BitWriter()
    write_slice_header(w, p, SLICE_P, frame_num, idr=False, slice_qp=fc.qp,
                       ltr_ref=ltr_ref, mark_ltr=mark_ltr,
                       mmco_evict=mmco_evict, first_mb=first_mb)

    luma_tc = np.zeros((mbh * 4, mbw * 4), np.int32)
    chroma_tc = np.zeros((2, mbh * 2, mbw * 2), np.int32)
    luma_scan = fc.luma_ac.reshape(mbh, mbw, 4, 4, 16)[..., ZIGZAG_FLAT]
    chroma_scan = fc.chroma_ac.reshape(mbh, mbw, 2, 2, 2, 16)[..., ZIGZAG_FLAT]

    skip_run = 0
    for mby in range(mbh):
        for mbx in range(mbw):
            if fc.skip[mby, mbx]:
                skip_run += 1
                continue  # TotalCoeff grids stay 0 for nC context
            w.write_ue(skip_run)
            skip_run = 0
            w.write_ue(0)  # mb_type P_L0_16x16
            px, py = mv_pred_16x16(fc.mvs, mbx, mby)
            w.write_se(4 * (int(fc.mvs[mby, mbx, 0]) - px))  # mvd quarter-pel
            w.write_se(4 * (int(fc.mvs[mby, mbx, 1]) - py))

            cbp_luma = 0
            for b8 in range(4):
                y8, x8 = b8 >> 1, b8 & 1
                if np.any(luma_scan[mby, mbx, y8 * 2 : y8 * 2 + 2, x8 * 2 : x8 * 2 + 2]):
                    cbp_luma |= 1 << b8
            if np.any(chroma_scan[mby, mbx, :, :, :, 1:]):
                cbp_chroma = 2
            elif np.any(fc.chroma_dc[mby, mbx]):
                cbp_chroma = 1
            else:
                cbp_chroma = 0
            cbp = cbp_luma | (cbp_chroma << 4)
            w.write_ue(INTER_CBP_TO_CODENUM[cbp])
            if cbp:
                w.write_se(0)  # mb_qp_delta (constant QP per slice)

            for x4, y4 in LUMA_BLOCK_ORDER:
                b8 = (y4 >> 1) * 2 + (x4 >> 1)
                if not cbp_luma & (1 << b8):
                    continue
                bx, by = mbx * 4 + x4, mby * 4 + y4
                nc = nc_context(luma_tc, bx, by)
                tc = residual_block(w, luma_scan[mby, mbx, y4, x4], 16, nc)
                luma_tc[by, bx] = tc

            if cbp_chroma:
                for comp in range(2):
                    residual_block(w, fc.chroma_dc[mby, mbx, comp].reshape(4), 4, -1)
            if cbp_chroma == 2:
                for comp in range(2):
                    for x4, y4 in CHROMA_BLOCK_ORDER:
                        bx, by = mbx * 2 + x4, mby * 2 + y4
                        nc = nc_context(chroma_tc[comp], bx, by)
                        tc = residual_block(w, chroma_scan[mby, mbx, comp, y4, x4, 1:], 15, nc)
                        chroma_tc[comp, by, bx] = tc

    if skip_run:
        w.write_ue(skip_run)
    w.rbsp_trailing_bits()
    return annexb_nal(3, NAL_SLICE_NON_IDR, w.get_bytes())


def encode_stream(y, u, v, qp: int, width: int | None = None, height: int | None = None):
    """Convenience: (annexb_bytes, FrameEncoding) for one IDR via the numpy model."""
    from selkies_tpu_torch.models.h264.bitstream import write_pps, write_sps
    from selkies_tpu_torch.models.h264.numpy_ref import encode_frame_i16

    h, w_ = y.shape
    p = StreamParams(width=width or w_, height=height or h, qp=qp)
    enc = encode_frame_i16(y, u, v, qp)
    return write_sps(p) + write_pps(p) + pack_slice(enc.coeffs, p), enc
