"""Copy of ``selkies_tpu/models/h264/numpy_ref.py``, kept so the port imports nothing of the JAX package.

Numpy golden-model H.264 intra encoder: transform, quant, predict, recon.

This is the bit-exact reference the TPU path (encoder.py, JAX/Pallas) and
the C++ CAVLC packer are validated against, and the authority for
conformance tests (FFmpeg must reconstruct exactly these pixels).

Scope (first milestone): Intra16x16 luma + Intra8x8 chroma, CAVLC, single
slice per frame, deblocking disabled. Prediction-mode policy is chosen for
TPU-friendliness (see encoder.py): vertical prediction everywhere the top
neighbour exists (dependencies run down rows only, so a row of MBs is a
single data-parallel batch), DC prediction on the first row (left-to-right
chain, one scan per frame).

The quantization/rescale math follows ISO/IEC 14496-10 §8.5; integer
shifts are arithmetic (numpy's >> on signed ints), matching the spec.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from selkies_tpu_torch.models.h264.tables import chroma_qp, mf_matrix, v_matrix

# Forward core transform matrix Cf (8.5.12 inverse's encoder-side dual).
CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]], dtype=np.int64)
# 4x4 Hadamard for Intra16x16 luma DC.
H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], dtype=np.int64)
# 2x2 Hadamard for chroma DC.
H2 = np.array([[1, 1], [1, -1]], dtype=np.int64)

# Intra16x16 luma prediction modes (coded in mb_type).
I16_VERTICAL = 0
I16_HORIZONTAL = 1
I16_DC = 2
I16_PLANE = 3

# Chroma prediction modes (intra_chroma_pred_mode syntax element).
CHROMA_DC = 0
CHROMA_HORIZONTAL = 1
CHROMA_VERTICAL = 2
CHROMA_PLANE = 3


def fdct4(blocks: np.ndarray) -> np.ndarray:
    """Forward 4x4 core transform over (..., 4, 4) int blocks."""
    return CF @ blocks.astype(np.int64) @ CF.T


def idct4(coeffs: np.ndarray) -> np.ndarray:
    """Inverse 4x4 core transform (8.5.12.2), bit-exact with >> semantics.

    Input: dequantized coefficients (..., 4, 4). Output: residual (..., 4, 4)
    after the final (x + 32) >> 6 rounding.
    """
    d = coeffs.astype(np.int64)
    # horizontal first (8.5.12.2): mix columns within each row
    e0 = d[..., 0] + d[..., 2]
    e1 = d[..., 0] - d[..., 2]
    e2 = (d[..., 1] >> 1) - d[..., 3]
    e3 = d[..., 1] + (d[..., 3] >> 1)
    g = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    # then vertical: mix rows
    e0 = g[..., 0, :] + g[..., 2, :]
    e1 = g[..., 0, :] - g[..., 2, :]
    e2 = (g[..., 1, :] >> 1) - g[..., 3, :]
    e3 = g[..., 1, :] + (g[..., 3, :] >> 1)
    out = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-2)
    return (out + 32) >> 6


def quant4(coeffs: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    """Quantize (..., 4, 4) transform coefficients (AC path incl. DC pos)."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3 if intra else (1 << qbits) // 6
    mf = mf_matrix(qp)
    c = coeffs.astype(np.int64)
    level = (np.abs(c) * mf + f) >> qbits
    return np.where(c < 0, -level, level)


def dequant4(levels: np.ndarray, qp: int) -> np.ndarray:
    """Rescale (..., 4, 4) levels (AC path); feeds idct4."""
    return levels.astype(np.int64) * v_matrix(qp) * (1 << (qp // 6))


def quant_luma_dc(dc: np.ndarray, qp: int) -> np.ndarray:
    """Forward Hadamard + quant for the (..., 4, 4) luma DC block."""
    t = (H4 @ dc.astype(np.int64) @ H4) >> 1
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf00 = mf_matrix(qp)[0, 0]
    level = (np.abs(t) * mf00 + 2 * f) >> (qbits + 1)
    return np.where(t < 0, -level, level)


def dequant_luma_dc(levels: np.ndarray, qp: int) -> np.ndarray:
    """Inverse Hadamard + rescale; returns DC values to substitute into
    each 4x4 block before idct4 (8.5.10)."""
    f = H4 @ levels.astype(np.int64) @ H4
    v00 = v_matrix(qp)[0, 0]
    qp_per = qp // 6
    if qp_per >= 2:
        return (f * v00) << (qp_per - 2)
    return (f * v00 + (1 << (1 - qp_per))) >> (2 - qp_per)


def quant_chroma_dc(dc: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    """Forward 2x2 Hadamard + quant for (..., 2, 2) chroma DC (qp = chroma QP)."""
    t = H2 @ dc.astype(np.int64) @ H2
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3 if intra else (1 << qbits) // 6
    mf00 = mf_matrix(qp)[0, 0]
    level = (np.abs(t) * mf00 + 2 * f) >> (qbits + 1)
    return np.where(t < 0, -level, level)


def dequant_chroma_dc(levels: np.ndarray, qp: int) -> np.ndarray:
    """8.5.11 with the default flat scaling list (LevelScale = 16·V):
    dcC = ((f · 16·V00) << (qP/6)) >> 5  ==  ((f · V00) << (qP/6)) >> 1,
    validated empirically against FFmpeg (tools/cavlc_probe.py)."""
    f = H2 @ levels.astype(np.int64) @ H2
    v00 = v_matrix(qp)[0, 0]
    return ((f * v00) << (qp // 6)) >> 1


def split_blocks(mb: np.ndarray, n: int) -> np.ndarray:
    """(N*n, M*n) -> (N, M, n, n) grid of nxn blocks."""
    h, w = mb.shape
    return mb.reshape(h // n, n, w // n, n).swapaxes(1, 2)


def merge_blocks(blocks: np.ndarray) -> np.ndarray:
    """(N, M, n, n) -> (N*n, M*n)."""
    nby, nbx, n, _ = blocks.shape
    return blocks.swapaxes(1, 2).reshape(nby * n, nbx * n)


@dataclass
class FrameCoeffs:
    """Stacked per-MB quantized coefficients for one frame.

    This is the contract between the encode core (numpy golden model /
    JAX TPU path) and the entropy packers (cavlc.py, native/cavlc_pack.cc):
      luma_mode / chroma_mode: (mbh, mbw) int32 prediction modes
      luma_dc:   (mbh, mbw, 4, 4)        quantized Hadamard DC levels
      luma_ac:   (mbh, mbw, 4, 4, 4, 4)  [by][bx][i][j]; DC position ignored
      chroma_dc: (mbh, mbw, 2, 2, 2)     [comp][i][j] (comp 0=Cb, 1=Cr)
      chroma_ac: (mbh, mbw, 2, 2, 2, 4, 4) [comp][by][bx][i][j]
    """

    luma_mode: np.ndarray
    chroma_mode: np.ndarray
    luma_dc: np.ndarray
    luma_ac: np.ndarray
    chroma_dc: np.ndarray
    chroma_ac: np.ndarray
    qp: int


def encode_mb_luma(orig: np.ndarray, pred: np.ndarray, qp: int):
    """Intra16x16 luma: transform+quant+recon for one (16, 16) MB.

    Returns (dc_levels (4,4), ac_levels (4,4,4,4), recon (16,16) uint8).
    """
    resid = orig.astype(np.int64) - pred.astype(np.int64)
    blocks = split_blocks(resid, 4)  # (4,4,4,4)
    w = fdct4(blocks)
    dc = w[..., 0, 0]  # (4,4) raster of block DCs
    dc_levels = quant_luma_dc(dc, qp)
    ac_levels = quant4(w, qp, intra=True)
    # Reconstruction: dequant AC, substitute dequantized DC, inverse transform.
    deq = dequant4(ac_levels, qp)
    deq[..., 0, 0] = dequant_luma_dc(dc_levels, qp)
    r = idct4(deq)
    recon = np.clip(merge_blocks(r) + pred.astype(np.int64), 0, 255).astype(np.uint8)
    return dc_levels, ac_levels, recon


def encode_mb_chroma(orig: np.ndarray, pred: np.ndarray, qp_c: int):
    """One chroma component (8, 8): returns (dc (2,2), ac (2,2,4,4), recon)."""
    resid = orig.astype(np.int64) - pred.astype(np.int64)
    blocks = split_blocks(resid, 4)  # (2,2,4,4)
    w = fdct4(blocks)
    dc = w[..., 0, 0]  # (2,2)
    dc_levels = quant_chroma_dc(dc, qp_c)
    ac_levels = quant4(w, qp_c, intra=True)
    deq = dequant4(ac_levels, qp_c)
    deq[..., 0, 0] = dequant_chroma_dc(dc_levels, qp_c)
    r = idct4(deq)
    recon = np.clip(merge_blocks(r) + pred.astype(np.int64), 0, 255).astype(np.uint8)
    return dc_levels, ac_levels, recon


def _dc_pred_luma(top: np.ndarray | None, left: np.ndarray | None) -> np.ndarray:
    if top is not None and left is not None:
        dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
    elif left is not None:
        dc = (int(left.sum()) + 8) >> 4
    elif top is not None:
        dc = (int(top.sum()) + 8) >> 4
    else:
        dc = 128
    return np.full((16, 16), dc, dtype=np.int64)


def _dc_pred_chroma(top: np.ndarray | None, left: np.ndarray | None) -> np.ndarray:
    """8.3.4.1 chroma DC prediction: per-4x4 rules."""
    pred = np.empty((8, 8), dtype=np.int64)
    for by in (0, 1):
        for bx in (0, 1):
            t = top[bx * 4 : bx * 4 + 4] if top is not None else None
            l = left[by * 4 : by * 4 + 4] if left is not None else None
            if bx == by:  # corner blocks (0,0) and (1,1): use both if avail
                if t is not None and l is not None:
                    dc = (int(t.sum()) + int(l.sum()) + 4) >> 3
                elif l is not None:
                    dc = (int(l.sum()) + 2) >> 2
                elif t is not None:
                    dc = (int(t.sum()) + 2) >> 2
                else:
                    dc = 128
            elif by == 0:  # block (1,0): prefer top
                if t is not None:
                    dc = (int(t.sum()) + 2) >> 2
                elif l is not None:
                    dc = (int(l.sum()) + 2) >> 2
                else:
                    dc = 128
            else:  # block (0,1): prefer left
                if l is not None:
                    dc = (int(l.sum()) + 2) >> 2
                elif t is not None:
                    dc = (int(t.sum()) + 2) >> 2
                else:
                    dc = 128
            pred[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = dc
    return pred


@dataclass
class FrameEncoding:
    """Output of the frame encoder: coefficients + reconstruction."""

    coeffs: FrameCoeffs
    recon_y: np.ndarray
    recon_u: np.ndarray
    recon_v: np.ndarray


def pad_planes(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    """Edge-pad planes to macroblock multiples (the SPS crops them back)."""
    h, w = y.shape
    hp, wp = (h + 15) // 16 * 16, (w + 15) // 16 * 16
    if (hp, wp) == (h, w):
        return y, u, v
    y = np.pad(y, ((0, hp - h), (0, wp - w)), mode="edge")
    u = np.pad(u, ((0, hp // 2 - u.shape[0]), (0, wp // 2 - u.shape[1])), mode="edge")
    v = np.pad(v, ((0, hp // 2 - v.shape[0]), (0, wp // 2 - v.shape[1])), mode="edge")
    return y, u, v


# ---------------------------------------------------------------------------
# Inter (P-frame) golden model
# ---------------------------------------------------------------------------
#
# Partitioning policy: P_Skip / P_L0_16x16 only, one reference frame,
# full-pel luma motion vectors (chroma lands on half-pel, bilinear per
# 8.4.2.2.2). There is no intra prediction in P frames, so — unlike the
# I-frame row scan — every macroblock is independent given the reference
# frame: the TPU path (encoder_core.py) batches the whole frame as one
# tensor op. The reference's encoders get this from NVENC silicon
# (gstwebrtc_app.py:260-367); for remote-desktop content the dominant case
# is a P_Skip carpet over unchanged screen regions.

# Max motion-vector magnitude (full-pel); reference planes are edge-padded
# by this much so unrestricted MVs never index out of bounds. Sized for the
# hierarchical search reach: COARSE_DS*COARSE_R + REFINE_R = 34 <= MV_PAD.
MV_PAD = 40

# Hierarchical ME geometry (hier_search_me / encoder_core.hier_motion_search)
COARSE_DS = 4   # coarse level downsample factor
COARSE_R = 8    # coarse search radius in downsampled pels (→ ±32 full-pel)
REFINE_R = 2    # full-res refine radius around each upscaled global candidate
                # (±2 exactly covers the COARSE_DS=4 grid; ±3 only added
                # overlap and cost ~2x the refine-scan device time)
TOPK = 3        # dominant global motion candidates carried to full-res refine


@dataclass
class PFrameCoeffs:
    """Per-MB data for one P frame (contract with the entropy packers).

    mvs:       (mbh, mbw, 2) int32 full-pel motion vectors, [..., 0]=x, [..., 1]=y
    skip:      (mbh, mbw) bool — MB coded as P_Skip (requires mv == skip MV
               and all residual levels zero; enforced by encode_frame_p)
    luma_ac:   (mbh, mbw, 4, 4, 4, 4) [by][bx][i][j] — all 16 coeffs coded
               (inter MBs have no luma DC Hadamard)
    chroma_dc: (mbh, mbw, 2, 2, 2) [comp][i][j]
    chroma_ac: (mbh, mbw, 2, 2, 2, 4, 4)
    """

    mvs: np.ndarray
    skip: np.ndarray
    luma_ac: np.ndarray
    chroma_dc: np.ndarray
    chroma_ac: np.ndarray
    qp: int


@dataclass
class PFrameEncoding:
    coeffs: PFrameCoeffs
    recon_y: np.ndarray
    recon_u: np.ndarray
    recon_v: np.ndarray


def _median3(a: int, b: int, c: int) -> int:
    return int(np.median([a, b, c]))


def mv_pred_16x16(mvs: np.ndarray, mbx: int, mby: int) -> tuple[int, int]:
    """8.4.1.3 motion-vector prediction for a 16x16 partition.

    All coded MBs share refIdx 0 (single reference), so the "exactly one
    neighbour matches refIdx" rule reduces to availability counting.
    mvs holds the ACTUAL per-MB motion vectors (skip MBs included).
    """
    mbh, mbw = mvs.shape[:2]
    a_avail = mbx > 0
    b_avail = mby > 0
    c_avail = mby > 0 and mbx + 1 < mbw
    d_avail = mby > 0 and mbx > 0
    # top-right substitution: C unavailable -> D takes its place
    if not c_avail and d_avail:
        c_mv, c_avail = mvs[mby - 1, mbx - 1], True
    elif c_avail:
        c_mv = mvs[mby - 1, mbx + 1]
    else:
        c_mv = np.zeros(2, np.int32)
    a_mv = mvs[mby, mbx - 1] if a_avail else np.zeros(2, np.int32)
    b_mv = mvs[mby - 1, mbx] if b_avail else np.zeros(2, np.int32)
    # 8.4.1.3.1: B, C, D all unavailable and A available -> mvA
    if a_avail and not b_avail and not c_avail:
        return int(a_mv[0]), int(a_mv[1])
    # exactly one available neighbour (refIdx match) -> its mv
    n_avail = int(a_avail) + int(b_avail) + int(c_avail)
    if n_avail == 1:
        only = a_mv if a_avail else (b_mv if b_avail else c_mv)
        return int(only[0]), int(only[1])
    return (
        _median3(int(a_mv[0]), int(b_mv[0]), int(c_mv[0])),
        _median3(int(a_mv[1]), int(b_mv[1]), int(c_mv[1])),
    )


def skip_mv_16x16(mvs: np.ndarray, mbx: int, mby: int) -> tuple[int, int]:
    """8.4.1.1 P_Skip motion-vector derivation."""
    if mbx == 0 or mby == 0:
        return 0, 0
    a = mvs[mby, mbx - 1]
    b = mvs[mby - 1, mbx]
    if (a[0] == 0 and a[1] == 0) or (b[0] == 0 and b[1] == 0):
        return 0, 0
    return mv_pred_16x16(mvs, mbx, mby)


def pad_ref(plane: np.ndarray, pad: int = MV_PAD) -> np.ndarray:
    return np.pad(plane, pad, mode="edge")


def mc_luma_16x16(ref_pad: np.ndarray, mbx: int, mby: int, mv) -> np.ndarray:
    """Full-pel 16x16 luma motion compensation from an MV_PAD-padded ref."""
    y0 = mby * 16 + int(mv[1]) + MV_PAD
    x0 = mbx * 16 + int(mv[0]) + MV_PAD
    return ref_pad[y0 : y0 + 16, x0 : x0 + 16].astype(np.int64)


def mc_chroma_8x8(ref_pad: np.ndarray, mbx: int, mby: int, mv) -> np.ndarray:
    """8x8 chroma MC (8.4.2.2.2). Full-pel luma MVs land chroma on
    half-pel: frac ∈ {0, 4} eighths per axis -> bilinear with weights 4/4."""
    mvx, mvy = int(mv[0]), int(mv[1])
    x0 = mbx * 8 + (mvx >> 1) + MV_PAD
    y0 = mby * 8 + (mvy >> 1) + MV_PAD
    xf = 4 * (mvx & 1)
    yf = 4 * (mvy & 1)
    p = ref_pad.astype(np.int64)
    a = p[y0 : y0 + 8, x0 : x0 + 8]
    b = p[y0 : y0 + 8, x0 + 1 : x0 + 9]
    c = p[y0 + 1 : y0 + 9, x0 : x0 + 8]
    d = p[y0 + 1 : y0 + 9, x0 + 1 : x0 + 9]
    return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b + (8 - xf) * yf * c + xf * yf * d + 32) >> 6


def encode_mb_inter_luma(orig: np.ndarray, pred: np.ndarray, qp: int):
    """Inter 16x16 luma: plain 4x4 transform+quant (no DC Hadamard).

    Returns (ac_levels (4,4,4,4) with all 16 coeffs live, recon (16,16))."""
    resid = orig.astype(np.int64) - pred
    w = fdct4(split_blocks(resid, 4))
    ac_levels = quant4(w, qp, intra=False)
    r = idct4(dequant4(ac_levels, qp))
    recon = np.clip(merge_blocks(r) + pred, 0, 255).astype(np.uint8)
    return ac_levels, recon


def encode_mb_inter_chroma(orig: np.ndarray, pred: np.ndarray, qp_c: int):
    """Inter 8x8 chroma: 2x2 DC Hadamard + AC, inter rounding."""
    resid = orig.astype(np.int64) - pred
    w = fdct4(split_blocks(resid, 4))
    dc_levels = quant_chroma_dc(w[..., 0, 0], qp_c, intra=False)
    ac_levels = quant4(w, qp_c, intra=False)
    deq = dequant4(ac_levels, qp_c)
    deq[..., 0, 0] = dequant_chroma_dc(dc_levels, qp_c)
    r = idct4(deq)
    recon = np.clip(merge_blocks(r) + pred, 0, 255).astype(np.uint8)
    return dc_levels, ac_levels, recon


def full_search_me(
    y: np.ndarray, ref_y: np.ndarray, search: int = 8
) -> np.ndarray:
    """Exhaustive full-pel SAD search over ±search per MB (golden model).

    Zero MV wins ties (preferred: cheaper to code, skip-eligible)."""
    h, w = y.shape
    mbh, mbw = h // 16, w // 16
    ref_pad = pad_ref(ref_y)
    cur = y.astype(np.int64)
    best_sad = np.full((mbh, mbw), np.iinfo(np.int64).max)
    best_mv = np.zeros((mbh, mbw, 2), np.int32)
    cand = sorted(
        ((dx, dy) for dy in range(-search, search + 1) for dx in range(-search, search + 1)),
        key=lambda c: (c != (0, 0)),
    )
    for dx, dy in cand:
        shifted = ref_pad[
            MV_PAD + dy : MV_PAD + dy + h, MV_PAD + dx : MV_PAD + dx + w
        ].astype(np.int64)
        sad = (
            np.abs(cur - shifted).reshape(mbh, 16, mbw, 16).sum(axis=(1, 3))
        )
        better = sad < best_sad
        best_sad = np.where(better, sad, best_sad)
        best_mv[better] = (dx, dy)
    return best_mv


def downsample4(plane: np.ndarray) -> np.ndarray:
    """4x4 box downsample with round-half-up: ds[i,j] = (Σ 4x4 block + 8)>>4.

    Exact integer arithmetic (the device mirror must match bit-for-bit —
    the coarse ME level runs on these planes)."""
    h, w = plane.shape
    return (
        plane.astype(np.int64).reshape(h // 4, 4, w // 4, 4).sum(axis=(1, 3)) + 8
    ) >> 4


def coarse_vote_candidates(y: np.ndarray, ref_y: np.ndarray) -> np.ndarray:
    """Level-1 ME: exhaustive ±COARSE_R search on 4x-downsampled planes,
    then the TOPK most-voted coarse displacements across the frame.

    Returns (TOPK, 2) int32 coarse MVs (downsampled units). Ties in the
    vote count resolve to the lower candidate rank (zero-first raster),
    mirrored exactly by the device path. Desktop motion is dominated by a
    few global displacements (scroll/pan/drag), which is what makes a
    frame-level candidate set competitive with per-MB search at a fraction
    of the cost — and it keeps the device path free of gathers, which are
    pathologically slow on TPU (tools/profile_slope2.py: 30 ms per
    full-plane gather vs 0.26 ms per global-shift SAD map).
    """
    h, w = y.shape
    mbh, mbw = h // 16, w // 16
    yd = downsample4(y)
    rd = downsample4(ref_y)
    pad = COARSE_R
    rp = np.pad(rd, pad, mode="edge")
    hd, wd = yd.shape
    cand = sorted(
        ((dx, dy) for dy in range(-COARSE_R, COARSE_R + 1) for dx in range(-COARSE_R, COARSE_R + 1)),
        key=lambda c: (c != (0, 0)),
    )
    best_sad = np.full((mbh, mbw), np.iinfo(np.int64).max)
    best_rank = np.zeros((mbh, mbw), np.int32)
    for rank, (dx, dy) in enumerate(cand):
        shifted = rp[pad + dy : pad + dy + hd, pad + dx : pad + dx + wd]
        sad = np.abs(yd - shifted).reshape(mbh, 4, mbw, 4).sum(axis=(1, 3))
        better = sad < best_sad
        best_sad = np.where(better, sad, best_sad)
        best_rank = np.where(better, rank, best_rank)
    votes = np.bincount(best_rank.reshape(-1), minlength=len(cand))
    # deterministic top-K: score = votes desc, then rank asc
    order = np.lexsort((np.arange(len(cand)), -votes))
    return np.array([cand[i] for i in order[:TOPK]], np.int32)


def refine_candidate_list(coarse: np.ndarray) -> np.ndarray:
    """Full-res candidate shift list: zero MV (rank 0), then for each
    global candidate g the raster grid g*COARSE_DS + (dx, dy),
    |dx|,|dy| <= REFINE_R. Duplicates are harmless (earlier rank wins)."""
    out = [(0, 0)]
    for g in coarse:
        for dy in range(-REFINE_R, REFINE_R + 1):
            for dx in range(-REFINE_R, REFINE_R + 1):
                out.append((int(g[0]) * COARSE_DS + dx, int(g[1]) * COARSE_DS + dy))
    return np.array(out, np.int32)


def hier_search_me(y: np.ndarray, ref_y: np.ndarray) -> np.ndarray:
    """Global-candidate hierarchical full-pel ME (golden model).

    Level 1 picks TOPK dominant coarse displacements by per-MB vote;
    level 0 evaluates global-shift SAD maps for every refine candidate
    (zero MV first) and each MB takes the earliest-ranked minimum. All
    full-res work is global shifts — the device mirror runs entirely on
    dynamic slices + dense selects (no gathers).
    """
    h, w = y.shape
    mbh, mbw = h // 16, w // 16
    cands = refine_candidate_list(coarse_vote_candidates(y, ref_y))
    ref_pad = pad_ref(ref_y)
    cur = y.astype(np.int64)
    best_sad = np.full((mbh, mbw), np.iinfo(np.int64).max)
    best_mv = np.zeros((mbh, mbw, 2), np.int32)
    for dx, dy in cands:
        shifted = ref_pad[
            MV_PAD + dy : MV_PAD + dy + h, MV_PAD + dx : MV_PAD + dx + w
        ].astype(np.int64)
        sad = np.abs(cur - shifted).reshape(mbh, 16, mbw, 16).sum(axis=(1, 3))
        better = sad < best_sad
        best_sad = np.where(better, sad, best_sad)
        best_mv[better] = (dx, dy)
    return best_mv


def encode_frame_p(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    ref_y: np.ndarray,
    ref_u: np.ndarray,
    ref_v: np.ndarray,
    mvs: np.ndarray,
    qp: int,
) -> PFrameEncoding:
    """Encode a P frame given per-MB full-pel motion vectors.

    Planes must be pre-padded to MB multiples; ref_* are the previous
    frame's reconstruction (decoder state), same shapes.
    """
    h, w = y.shape
    mbh, mbw = h // 16, w // 16
    if mvs.shape != (mbh, mbw, 2):
        raise ValueError(f"mvs shape {mvs.shape} != {(mbh, mbw, 2)}")
    if np.abs(mvs).max(initial=0) > MV_PAD:
        raise ValueError(f"|mv| exceeds MV_PAD={MV_PAD}")
    qp_c = chroma_qp(qp)
    ry, ru, rv = pad_ref(ref_y), pad_ref(ref_u), pad_ref(ref_v)
    recon_y = np.zeros_like(y)
    recon_u = np.zeros_like(u)
    recon_v = np.zeros_like(v)
    fc = PFrameCoeffs(
        mvs=mvs.astype(np.int32),
        skip=np.zeros((mbh, mbw), bool),
        luma_ac=np.zeros((mbh, mbw, 4, 4, 4, 4), np.int32),
        chroma_dc=np.zeros((mbh, mbw, 2, 2, 2), np.int32),
        chroma_ac=np.zeros((mbh, mbw, 2, 2, 2, 4, 4), np.int32),
        qp=qp,
    )
    for mby in range(mbh):
        for mbx in range(mbw):
            mv = mvs[mby, mbx]
            pred_y = mc_luma_16x16(ry, mbx, mby, mv)
            pred_u = mc_chroma_8x8(ru, mbx, mby, mv)
            pred_v = mc_chroma_8x8(rv, mbx, mby, mv)
            ac_y, rec_y = encode_mb_inter_luma(
                y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16], pred_y, qp
            )
            dc_u, ac_u, rec_u = encode_mb_inter_chroma(
                u[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8], pred_u, qp_c
            )
            dc_v, ac_v, rec_v = encode_mb_inter_chroma(
                v[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8], pred_v, qp_c
            )
            recon_y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16] = rec_y
            recon_u[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8] = rec_u
            recon_v[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8] = rec_v
            fc.luma_ac[mby, mbx] = ac_y
            fc.chroma_dc[mby, mbx] = np.stack([dc_u, dc_v])
            fc.chroma_ac[mby, mbx] = np.stack([ac_u, ac_v])
    # Skip pass: residual-free MBs whose mv equals the 8.4.1.1 skip MV.
    # (Depends only on the final mv field, so order doesn't matter.)
    for mby in range(mbh):
        for mbx in range(mbw):
            if (
                not fc.luma_ac[mby, mbx].any()
                and not fc.chroma_dc[mby, mbx].any()
                and not fc.chroma_ac[mby, mbx].any()
                and tuple(mvs[mby, mbx]) == skip_mv_16x16(mvs, mbx, mby)
            ):
                fc.skip[mby, mbx] = True
    return PFrameEncoding(coeffs=fc, recon_y=recon_y, recon_u=recon_u, recon_v=recon_v)


def encode_frame_i16(y: np.ndarray, u: np.ndarray, v: np.ndarray, qp: int) -> FrameEncoding:
    """Encode planes (padded to MB multiples) as an all-Intra16x16 frame.

    Prediction policy (mirrors the TPU row-scan in encoder.py):
      row 0:  luma DC (left/none), chroma DC  — serial left-to-right
      row>0:  luma vertical, chroma vertical  — rows depend only on the row above
    """
    h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError(f"luma plane {w}x{h} must be padded to multiples of 16 (see pad_planes)")
    if u.shape != (h // 2, w // 2) or v.shape != (h // 2, w // 2):
        raise ValueError("chroma planes must be (h/2, w/2) for 4:2:0")
    if not 0 <= qp <= 51:
        raise ValueError(f"qp {qp} out of range [0, 51]")
    mbh, mbw = h // 16, w // 16
    qp_c = chroma_qp(qp)
    recon_y = np.zeros_like(y)
    recon_u = np.zeros_like(u)
    recon_v = np.zeros_like(v)
    fc = FrameCoeffs(
        luma_mode=np.zeros((mbh, mbw), np.int32),
        chroma_mode=np.zeros((mbh, mbw), np.int32),
        luma_dc=np.zeros((mbh, mbw, 4, 4), np.int32),
        luma_ac=np.zeros((mbh, mbw, 4, 4, 4, 4), np.int32),
        chroma_dc=np.zeros((mbh, mbw, 2, 2, 2), np.int32),
        chroma_ac=np.zeros((mbh, mbw, 2, 2, 2, 4, 4), np.int32),
        qp=qp,
    )
    for mby in range(mbh):
        for mbx in range(mbw):
            ys, xs = mby * 16, mbx * 16
            cys, cxs = mby * 8, mbx * 8
            if mby == 0:
                left_y = recon_y[ys : ys + 16, xs - 1] if mbx > 0 else None
                pred_y = _dc_pred_luma(None, left_y)
                luma_mode = I16_DC
                left_u = recon_u[cys : cys + 8, cxs - 1] if mbx > 0 else None
                left_v = recon_v[cys : cys + 8, cxs - 1] if mbx > 0 else None
                pred_u = _dc_pred_chroma(None, left_u)
                pred_v = _dc_pred_chroma(None, left_v)
                chroma_mode = CHROMA_DC
            else:
                pred_y = np.broadcast_to(recon_y[ys - 1, xs : xs + 16].astype(np.int64), (16, 16))
                luma_mode = I16_VERTICAL
                pred_u = np.broadcast_to(recon_u[cys - 1, cxs : cxs + 8].astype(np.int64), (8, 8))
                pred_v = np.broadcast_to(recon_v[cys - 1, cxs : cxs + 8].astype(np.int64), (8, 8))
                chroma_mode = CHROMA_VERTICAL
            dc_y, ac_y, rec_y = encode_mb_luma(y[ys : ys + 16, xs : xs + 16], pred_y, qp)
            dc_u, ac_u, rec_u = encode_mb_chroma(u[cys : cys + 8, cxs : cxs + 8], pred_u, qp_c)
            dc_v, ac_v, rec_v = encode_mb_chroma(v[cys : cys + 8, cxs : cxs + 8], pred_v, qp_c)
            recon_y[ys : ys + 16, xs : xs + 16] = rec_y
            recon_u[cys : cys + 8, cxs : cxs + 8] = rec_u
            recon_v[cys : cys + 8, cxs : cxs + 8] = rec_v
            fc.luma_mode[mby, mbx] = luma_mode
            fc.chroma_mode[mby, mbx] = chroma_mode
            fc.luma_dc[mby, mbx] = dc_y
            fc.luma_ac[mby, mbx] = ac_y
            fc.chroma_dc[mby, mbx] = np.stack([dc_u, dc_v])
            fc.chroma_ac[mby, mbx] = np.stack([ac_u, ac_v])
    return FrameEncoding(coeffs=fc, recon_y=recon_y, recon_u=recon_u, recon_v=recon_v)
