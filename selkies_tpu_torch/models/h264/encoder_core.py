"""PyTorch encode core for the H.264 device step (IDR + P), int32-exact.

Counterpart of ``selkies_tpu/models/h264/encoder_core.py``: intra
prediction, the forward/inverse 4x4 transforms, the Hadamard DC paths,
quantization, hierarchical motion estimation + compensation, the P-frame
transform tail, the compact coefficient downlink and the device-entropy
wrapper of the sparse downlink (``pack_p_sparse_entropy``, whose coders
are ``device_cavlc.py`` and ``device_cabac.py``). Otherwise entropy coding
stays on the host (``native.py``, ``cabac.py``).

Every function works on tensors of one device (CPU or CUDA) and returns
tensors on it. Arithmetic is int32 throughout: uint8 inputs are widened
before any arithmetic, because torch's uint8 arithmetic wraps. Outputs
equal the JAX version element for element (tests/test_torch_encoder_core.py).

The batched entry points (``encode_frame_planes_batch``,
``encode_frame_p_planes_batch``, the multi-session tick of
``parallel/sessions.py``) run N sessions' steps as one set of device ops:
every plane gains a leading session axis and QP is an (N,) int32 tensor on
the device, whose quantiser constants are gathered from a 52-row table on
the card (``_QPRows``), so the host reads nothing back. Session i equals
the solo step at ``int(qps[i])``, as ``jax.vmap`` guarantees for the JAX
version (tests/test_torch_sessions.py). A solo step's Python-int QP is a
one-row view of the same table, so every quantiser helper has one path,
on planes with or without the session axis.

Intra: row 0 uses DC prediction, a left-to-right chain over MB columns;
rows 1.. use vertical prediction from the reconstructed row above. Both
are sequential. On a CUDA tensor the whole IDR step is one call of the
hand-written kernel ``intra.encode_intra`` (one warp walks each session's
row 0, then one warp each MB column down the rows). On a CPU tensor it is
the plain version: a Python loop of batched tensor ops over MB columns for
row 0, then over MB rows.

Inter: P frames have no spatial dependencies (P_Skip / P_L0_16x16 only),
so everything is one batched program over the MB grid. The refine
search + motion compensation goes through ``me_mc.me_mc``, which runs the
hand-written CUDA kernel on a CUDA tensor and the plain version on a CPU
tensor. The carve's step (``encode_tile_p_planes``, driven by
``parallel/bands.py``) runs the same P step on one tile against a
halo-extended reference slab; a band is a tile row at one column
(``halo_cols=0``, a full-width slab).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from selkies_tpu_torch.device import constant_tables
from selkies_tpu_torch.models.h264 import intra, me_mc, tables
from selkies_tpu_torch.models.h264.numpy_ref import (
    COARSE_DS,
    COARSE_R,
    MV_PAD,
    REFINE_R,
    TOPK,
)

# out-of-range slices would read the wrong reference pixels silently
if COARSE_DS * COARSE_R + REFINE_R > MV_PAD:
    raise RuntimeError("ME reach exceeds MV_PAD")

_I32 = torch.int32

_POS_CLASS = np.array(
    [[0 if (i % 2 == 0 and j % 2 == 0) else 1 if (i % 2 and j % 2) else 2 for j in range(4)] for i in range(4)],
    np.int32,
)
_MF_BY_REM = torch.from_numpy(np.asarray(tables.QUANT_MF, np.int32)[:, _POS_CLASS])  # (6, 4, 4)
_V_BY_REM = torch.from_numpy(np.asarray(tables.DEQUANT_V, np.int32)[:, _POS_CLASS])  # (6, 4, 4)
_CHROMA_QP = torch.tensor([tables.chroma_qp(q) for q in range(52)], dtype=_I32)


# one half-row of the per-QP table: the quantiser constants of one QP
_QP_COLS = {"mf": 0, "vs": 16, "qbits": 32, "f_i": 33, "f_p": 34, "mf00": 35, "f2_i": 36,
            "f2_p": 37, "qb1": 38, "v00": 39, "dc_a": 40, "dc_r": 41, "dc_b": 42, "qper": 43}
_QP_HALF = 44


def _qp_half(q: int) -> list[int]:
    per, rem = q // 6, q % 6
    qbits = 15 + per
    f_i, f_p = (1 << qbits) // 3, (1 << qbits) // 6
    mf = _MF_BY_REM[rem].reshape(-1).tolist()
    vs = (_V_BY_REM[rem] * (1 << per)).reshape(-1).tolist()
    # dequant_luma_dc as ((f << dc_a) + dc_r) >> dc_b for either branch
    dc = (per - 2, 0, 0) if per >= 2 else (0, 1 << (1 - per), 2 - per)
    return [*mf, *vs, qbits, f_i, f_p, mf[0], 2 * f_i, 2 * f_p, qbits + 1,
            int(_V_BY_REM[rem, 0, 0]), *dc, per]


def _qp_table() -> np.ndarray:
    """(52, 2 * _QP_HALF) int32: per luma QP its constants, then its chroma
    QP's (``_CHROMA_QP``)."""
    return np.array([_qp_half(q) + _qp_half(int(_CHROMA_QP[q])) for q in range(52)], np.int32)


class _QPRows:
    """Per-session quantiser constants: each session's row of the 52-row
    per-QP table, gathered on the device by its QP (one op, no host read).
    ``col`` / ``block`` give a constant shaped to broadcast against a
    tensor of ``ndim`` dims whose leading dim is the session axis; the one
    row of a Python-int QP (``of``) broadcasts against any tensor."""

    def __init__(self, rows: torch.Tensor, off: int = 0):
        self.rows, self.off = rows, off

    @classmethod
    def gather(cls, qps: torch.Tensor) -> "_QPRows":
        if qps.dim() != 1:
            raise ValueError(f"qps must be (N,), got {tuple(qps.shape)}")
        return cls(_const("qp_rows", qps.device).index_select(0, qps.to(_I32)))

    @classmethod
    def of(cls, qp, device: torch.device) -> "_QPRows":
        """``qp`` as is, or the one-row view (no device op) of a Python-int
        QP's row: the constants of QP ``qp`` itself, luma or chroma."""
        if isinstance(qp, _QPRows):
            return qp
        q = int(qp)
        return cls(_const("qp_rows", device)[q:q + 1])

    def chroma(self) -> "_QPRows":
        return _QPRows(self.rows, _QP_HALF)

    def col(self, name: str, ndim: int) -> torch.Tensor:
        return self.rows[:, self.off + _QP_COLS[name]].reshape((-1,) + (1,) * (ndim - 1))

    def block(self, name: str, ndim: int) -> torch.Tensor:
        c = self.off + _QP_COLS[name]
        return self.rows[:, c:c + 16].reshape((-1,) + (1,) * (ndim - 3) + (4, 4))


# ---------------------------------------------------------------------------
# Transforms and quantization
# ---------------------------------------------------------------------------

def _fdct1d(x):
    """1-D forward core transform along the last axis of (..., 4)."""
    x0, x1, x2, x3 = x.unbind(-1)
    s0, s1 = x0 + x3, x1 + x2
    d0, d1 = x0 - x3, x1 - x2
    return torch.stack([s0 + s1, 2 * d0 + d1, s0 - s1, d0 - 2 * d1], dim=-1)


def fdct4(blocks):
    """Forward 4x4 core transform over (..., 4, 4) int32 blocks (exact)."""
    b = _fdct1d(blocks.to(_I32))
    return _fdct1d(b.transpose(-1, -2)).transpose(-1, -2)


def _idct1d(x):
    """1-D inverse butterfly along the last axis (8.5.12.2 step)."""
    x0, x1, x2, x3 = x.unbind(-1)
    e0, e1 = x0 + x2, x0 - x2
    e2 = (x1 >> 1) - x3
    e3 = x1 + (x3 >> 1)
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)


def idct4(coeffs):
    """Bit-exact inverse 4x4 transform: horizontal first, then vertical."""
    d = _idct1d(coeffs.to(_I32))
    d = _idct1d(d.transpose(-1, -2)).transpose(-1, -2)
    return (d + 32) >> 6


def _had1d(x):
    x0, x1, x2, x3 = x.unbind(-1)
    s0, s1 = x0 + x1, x2 + x3
    d0, d1 = x0 - x1, x2 - x3
    return torch.stack([s0 + s1, s0 - s1, d0 - d1, d0 + d1], dim=-1)


def _had4(x):
    """H4 . X . H4 for (..., 4, 4) (H4 symmetric)."""
    x = _had1d(x.to(_I32))
    return _had1d(x.transpose(-1, -2)).transpose(-1, -2)


def _had2(x):
    """H2 . X . H2 for (..., 2, 2)."""
    x = x.to(_I32)
    a = x[..., 0, 0] + x[..., 0, 1]
    b = x[..., 0, 0] - x[..., 0, 1]
    c = x[..., 1, 0] + x[..., 1, 1]
    d = x[..., 1, 0] - x[..., 1, 1]
    return torch.stack(
        [torch.stack([a + c, b + d], dim=-1), torch.stack([a - c, b - d], dim=-1)], dim=-2
    )


def _signed(level, like):
    return torch.where(like < 0, -level, level)


# Each helper takes a Python-int QP (for the chroma ones, the chroma QP) or
# a _QPRows.

def quant4(coeffs, qp, intra: bool = True):
    c = coeffs.to(_I32)
    qp, nd = _QPRows.of(qp, c.device), c.dim()
    f = qp.col("f_i" if intra else "f_p", nd)
    return _signed((c.abs() * qp.block("mf", nd) + f) >> qp.col("qbits", nd), c)


def dequant4(levels, qp):
    qp = _QPRows.of(qp, levels.device)
    return levels.to(_I32) * qp.block("vs", levels.dim())  # V << qp // 6


def quant_luma_dc(dc, qp):
    t = _had4(dc) >> 1
    qp, nd = _QPRows.of(qp, t.device), t.dim()
    return _signed((t.abs() * qp.col("mf00", nd) + qp.col("f2_i", nd)) >> qp.col("qb1", nd), t)


def dequant_luma_dc(levels, qp):
    f = _had4(levels)
    qp, nd = _QPRows.of(qp, f.device), f.dim()
    f = f * qp.col("v00", nd)
    return ((f << qp.col("dc_a", nd)) + qp.col("dc_r", nd)) >> qp.col("dc_b", nd)


def quant_chroma_dc(dc, qp_c, intra: bool = True):
    t = _had2(dc)
    qp_c, nd = _QPRows.of(qp_c, t.device), t.dim()
    f2 = qp_c.col("f2_i" if intra else "f2_p", nd)
    return _signed((t.abs() * qp_c.col("mf00", nd) + f2) >> qp_c.col("qb1", nd), t)


def dequant_chroma_dc(levels, qp_c):
    f = _had2(levels)
    qp_c, nd = _QPRows.of(qp_c, f.device), f.dim()
    return ((f * qp_c.col("v00", nd)) << qp_c.col("qper", nd)) >> 1


# ---------------------------------------------------------------------------
# Intra (IDR) frame
# ---------------------------------------------------------------------------

def _lead_perm(lead: int, perm: tuple[int, ...]) -> tuple[int, ...]:
    """``perm`` of the trailing axes, behind ``lead`` leading axes kept in place."""
    return (*range(lead), *(lead + p for p in perm))


def _row_to_blocks(row, n: int):
    """(..., n*4, W) plane row -> (..., mbw, n, n, 4, 4) indexed [mb][by][bx][i][j]."""
    *lead, h, w = row.shape
    mbw = w // (n * 4)
    return row.reshape(*lead, n, 4, mbw, n, 4).permute(_lead_perm(len(lead), (2, 0, 3, 1, 4)))


def _blocks_to_row(blocks):
    """Inverse of _row_to_blocks: (..., mbw, n, n, 4, 4) -> (..., n*4, mbw*n*4)."""
    lead = blocks.shape[:-5]
    mbw, n = blocks.shape[-5], blocks.shape[-4]
    return blocks.permute(_lead_perm(len(lead), (1, 3, 0, 2, 4))).reshape(
        *lead, n * 4, mbw * n * 4)


def _encode_plane_row(row, pred, qp, n: int, luma: bool):
    """Batched encode of one MB row of a plane.

    row, pred: (..., n*4, W) int32. Returns (dc (..., mbw,n,n), ac
    (..., mbw,n,n,4,4), recon (..., n*4, W))."""
    w = fdct4(_row_to_blocks(row - pred, n))
    dc = w[..., 0, 0]
    if luma:
        dc_levels = quant_luma_dc(dc, qp)
        dc_deq = dequant_luma_dc(dc_levels, qp)
    else:
        dc_levels = quant_chroma_dc(dc, qp)
        dc_deq = dequant_chroma_dc(dc_levels, qp)
    ac_levels = quant4(w, qp, intra=True)
    deq = dequant4(ac_levels, qp)
    deq[..., 0, 0] = dc_deq
    recon = (_blocks_to_row(idct4(deq)) + pred).clamp(0, 255)
    return dc_levels, ac_levels, recon


def _dc_pred_luma(left_col, lead: tuple, device):
    """DC prediction of a row-0 MB from its left neighbour's recon column
    (..., 16) (None at the left edge -> 128)."""
    if left_col is None:
        return torch.full((*lead, 16, 16), 128, dtype=_I32, device=device)
    dc = (left_col.sum(-1, dtype=_I32) + 8) >> 4
    return dc.reshape(*lead, 1, 1).expand(*lead, 16, 16)


def _dc_pred_chroma(left_col, lead: tuple, device):
    """Chroma DC prediction with top unavailable (8.3.4.1): the two block
    rows use the matching 4-sample left segments; no left -> 128."""
    if left_col is None:
        return torch.full((*lead, 8, 8), 128, dtype=_I32, device=device)
    top = (left_col[..., :4].sum(-1, dtype=_I32) + 2) >> 2
    bot = (left_col[..., 4:].sum(-1, dtype=_I32) + 2) >> 2
    return torch.stack([top, bot], -1).repeat_interleave(4, dim=-1).reshape(
        *lead, 8, 1).expand(*lead, 8, 8)


def _encode_row0(y_row, u_row, v_row, qp, qp_c):
    """Row 0: DC prediction, a serial loop over MB columns (each MB's
    prediction is the reconstructed right column of its left neighbour)."""
    lead = tuple(y_row.shape[:-2])
    mbw = y_row.shape[-1] // 16
    dev = y_row.device
    yl = ul = vl = None
    outs = []
    for i in range(mbw):
        y_mb = y_row[..., 16 * i:16 * i + 16]
        u_mb = u_row[..., 8 * i:8 * i + 8]
        v_mb = v_row[..., 8 * i:8 * i + 8]
        ry = _encode_plane_row(y_mb, _dc_pred_luma(yl, lead, dev), qp, 4, True)
        ru = _encode_plane_row(u_mb, _dc_pred_chroma(ul, lead, dev), qp_c, 2, False)
        rv = _encode_plane_row(v_mb, _dc_pred_chroma(vl, lead, dev), qp_c, 2, False)
        yl, ul, vl = ry[2][..., -1], ru[2][..., -1], rv[2][..., -1]
        outs.append((*ry, *ru, *rv))
    dc_y, ac_y, rec_y, dc_u, ac_u, rec_u, dc_v, ac_v, rec_v = zip(*outs)
    cat0 = functools.partial(torch.cat, dim=len(lead))
    cat1 = functools.partial(torch.cat, dim=len(lead) + 1)
    return (cat0(dc_y), cat0(ac_y), cat0(dc_u), cat0(ac_u), cat0(dc_v), cat0(ac_v),
            cat1(rec_y), cat1(rec_u), cat1(rec_v))


def _encode_intra(y, u, v, qp: _QPRows) -> dict:
    """encode_frame_planes over planes with optional leading axes; ``qp``
    one row, or one row per session. CUDA planes go to the kernel
    (``intra.encode_intra``, which raises on what it does not take), any
    other to the plain version."""
    if y.device.type == "cuda":
        return intra.encode_intra(y, u, v, qp.rows)
    return _encode_intra_plain(y, u, v, qp)


def _encode_intra_plain(y, u, v, qp: _QPRows) -> dict:
    """The plain version of the intra kernel, on any device: the row-0
    chain, then a loop over the MB rows, in batched tensor ops."""
    y, u, v = y.to(_I32), u.to(_I32), v.to(_I32)
    qp_c = qp.chroma()
    *lead, h, w_ = y.shape
    nl = len(lead)
    mbh = h // 16

    dc_y, ac_y, dc_u, ac_u, dc_v, ac_v, rec_y, rec_u, rec_v = _encode_row0(
        y[..., :16, :], u[..., :8, :], v[..., :8, :], qp, qp_c)
    rows = [(dc_y, ac_y, dc_u, ac_u, dc_v, ac_v, rec_y, rec_u, rec_v)]
    for r in range(1, mbh):
        yb, ub, vb = (rows[-1][k][..., -1:, :] for k in (6, 7, 8))
        ry = _encode_plane_row(y[..., 16 * r:16 * r + 16, :], yb.expand(*lead, 16, w_), qp, 4,
                               True)
        ru = _encode_plane_row(u[..., 8 * r:8 * r + 8, :], ub.expand(*lead, 8, w_ // 2), qp_c,
                               2, False)
        rv = _encode_plane_row(v[..., 8 * r:8 * r + 8, :], vb.expand(*lead, 8, w_ // 2), qp_c,
                               2, False)
        rows.append((ry[0], ry[1], ru[0], ru[1], rv[0], rv[1], ry[2], ru[2], rv[2]))
    luma_dc, luma_ac, cb_dc, cb_ac, cr_dc, cr_ac = (
        torch.stack([r[k] for r in rows], dim=nl) for k in range(6))
    recon_y, recon_u, recon_v = (torch.cat([r[k] for r in rows], dim=nl) for k in range(6, 9))

    mbw = luma_dc.shape[nl + 1]
    row0 = (torch.arange(mbh, device=y.device) == 0)[:, None].expand(*lead, mbh, mbw)
    return {
        "luma_mode": torch.where(row0, 2, 0).to(_I32),  # DC / vertical
        "chroma_mode": torch.where(row0, 0, 2).to(_I32),  # DC / vertical
        "luma_dc": luma_dc,
        "luma_ac": luma_ac,
        "chroma_dc": torch.stack([cb_dc, cr_dc], dim=nl + 2),
        "chroma_ac": torch.stack([cb_ac, cr_ac], dim=nl + 2),
        "recon_y": recon_y.to(torch.uint8),
        "recon_u": recon_u.to(torch.uint8),
        "recon_v": recon_v.to(torch.uint8),
    }


def encode_frame_planes(y, u, v, qp: int) -> dict:
    """All-Intra16x16 frame encode on padded planes.

    y: (H, W) uint8/int32, u/v: (H/2, W/2). Returns a dict of
    FrameCoeffs-layout int32 tensors plus uint8 recon planes (the recon is
    the reference of the next P frame)."""
    return _encode_intra(y, u, v, _QPRows.of(qp, y.device))


def encode_frame_planes_batch(y, u, v, qps) -> dict:
    """N sessions' IDR frames in one set of device ops.

    y: (N, H, W), u/v: (N, H/2, W/2); qps: (N,) int32 on the planes'
    device. Every output gains a leading N; session i equals
    ``encode_frame_planes(y[i], u[i], v[i], int(qps[i]))``."""
    return _encode_intra(y, u, v, _QPRows.gather(qps))


# ---------------------------------------------------------------------------
# Inter (P-frame) path
# ---------------------------------------------------------------------------

_ME_CHUNK = 17


def edge_pad(plane, top: int, bottom: int | None = None, left: int | None = None,
             right: int | None = None):
    """Edge-replicating pad of the last two axes of a plane or a batch of
    planes (``jnp.pad(mode="edge")``), by index selection so it works for
    every dtype on every device."""
    bottom = top if bottom is None else bottom
    left = top if left is None else left
    right = left if right is None else right
    h, w = plane.shape[-2:]
    dev = plane.device
    rows = torch.arange(-top, h + bottom, device=dev).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=dev).clamp(0, w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


def _me_candidates(search: int) -> np.ndarray:
    """Candidate (dx, dy) list in golden-model order: zero MV first, then
    raster (dy outer). A candidate's index is its rank, which breaks SAD
    ties identically to numpy_ref."""
    cands = [(dx, dy) for dy in range(-search, search + 1) for dx in range(-search, search + 1)]
    cands.sort(key=lambda c: c != (0, 0))
    return np.array(cands, np.int32)


# the search's host-made tables, on the card once (``device.constant_tables``)
_const = constant_tables({
    "coarse_cands": _me_candidates(COARSE_R),
    "refine_grid": np.array([(dx, dy) for dy in range(-REFINE_R, REFINE_R + 1)
                             for dx in range(-REFINE_R, REFINE_R + 1)], np.int32),
    "qp_rows": _qp_table(),
})


def _downsample4(plane):
    """4x4 box downsample of the last two axes, round-half-up (mirrors
    numpy_ref.downsample4)."""
    *lead, h, w = plane.shape
    s = plane.to(_I32).reshape(*lead, h // 4, 4, w // 4, 4).sum(dim=(-3, -1), dtype=_I32)
    return (s + 8) >> 4


def coarse_votes(cur, rd_ext, halo_dcols: int = 0):
    """Per-MB coarse-rank vote histogram ((2*COARSE_R+1)^2,) int32; with a
    leading session axis on ``cur`` and ``rd_ext``, one histogram per
    session (N, (2*COARSE_R+1)^2).

    ``rd_ext`` is the downsampled reference, optionally extended by
    ``halo_dcols`` real neighbour columns each side (a tile of the 2D grid,
    parallel/bands.py: the extension is made in downsampled space, so a
    tile's votes equal the full row's, whose edge pad also comes after the
    downsample). ``halo_dcols=0`` with a full-width plane is the frame and
    band case. Each MB's best coarse candidate (min SAD*scale + rank over
    the +-COARSE_R window) casts one vote; the votes of one slice row's
    tiles sum to the row's histogram."""
    *lead, h, w = cur.shape
    mbh, mbw = h // 16, w // 16
    if not 0 <= halo_dcols <= COARSE_R:
        raise ValueError(f"halo_dcols {halo_dcols} not in [0, {COARSE_R}]")
    yd = _downsample4(cur)
    hd, wd = yd.shape[-2:]
    px = COARSE_R - halo_dcols  # edge-pad the rest of the horizontal reach
    rp = edge_pad(rd_ext.to(_I32), COARSE_R, COARSE_R, px, px)
    cands = _me_candidates(COARSE_R)
    n = len(cands)
    scale = 1 << (n - 1).bit_length()
    ranks = torch.arange(n, device=cur.device, dtype=_I32)
    best = None
    for c0 in range(0, n, _ME_CHUNK):
        chunk = cands[c0:c0 + _ME_CHUNK]
        sh = torch.stack([rp[..., COARSE_R + dy:COARSE_R + dy + hd,
                             COARSE_R + dx:COARSE_R + dx + wd] for dx, dy in chunk.tolist()])
        sads = (yd - sh).abs().reshape(len(chunk), *lead, mbh, 4, mbw, 4).sum(
            dim=(-3, -1), dtype=_I32)
        rank = ranks[c0:c0 + len(chunk)].reshape(len(chunk), *(1,) * (len(lead) + 2))
        cost = (sads * scale + rank).amin(dim=0)
        best = cost if best is None else torch.minimum(best, cost)
    best_rank = best & (scale - 1)  # cost = sad*scale + rank
    # an add, not torch.bincount: on the card bincount reads the largest
    # rank back to the host to size its output, a stream sync per frame.
    # Batched, session s votes into bins s*n + rank of one flat histogram
    nb = int(np.prod(lead, dtype=np.int64))
    if lead:
        best_rank = best_rank + (torch.arange(nb, device=cur.device, dtype=_I32) * n).reshape(
            *lead, 1, 1)
    votes = torch.zeros(nb * n, dtype=_I32, device=cur.device)
    votes.index_add_(0, best_rank.reshape(-1).long(), torch.ones_like(best_rank.reshape(-1)))
    return votes.reshape(*lead, n)


def select_coarse(votes):
    """Vote histogram -> (TOPK, 2) int32 coarse candidates, in the golden
    model's order (votes desc, then rank asc); (N, n) histograms -> (N,
    TOPK, 2), one row per session. The scores are unique, so topk's order
    is the same as JAX's."""
    cands = _const("coarse_cands", votes.device)
    idx = torch.arange(len(cands), device=votes.device, dtype=_I32)
    score = votes.to(_I32) * 512 + (511 - idx)  # vote count <= mbh*mbw < 2^22
    top_idx = torch.topk(score, TOPK).indices
    return cands[top_idx]


def coarse_vote_candidates(cur, ref):
    """(TOPK, 2) int32 coarse MVs in downsampled units, element-exact with
    numpy_ref.coarse_vote_candidates."""
    return select_coarse(coarse_votes(cur, _downsample4(ref.to(_I32))))


def _refine_cands(coarse, dy_max: int | None = None, dx_max: int | None = None):
    """(TOPK, 2) coarse -> (1 + TOPK*(2R+1)^2, 2) int32 full-res shift
    list, zero MV first (mirrors numpy_ref.refine_candidate_list); (N,
    TOPK, 2) -> one list per session.

    dy_max / dx_max clamp the vertical / horizontal component of every
    coarse displacement so that no refined candidate reaches past
    ``d_max`` (the window a band or tile slab holds); the refine grid stays
    the +-R raster, so candidate order and tie-breaks are preserved."""
    coarse = coarse.to(_I32).clone()
    lead = coarse.shape[:-2]
    if dy_max is not None:
        cmax = max(0, (int(dy_max) - REFINE_R) // COARSE_DS)
        coarse[..., 1] = coarse[..., 1].clamp(-cmax, cmax)
    if dx_max is not None:
        cmax = max(0, (int(dx_max) - REFINE_R) // COARSE_DS)
        coarse[..., 0] = coarse[..., 0].clamp(-cmax, cmax)
    grid = _const("refine_grid", coarse.device)  # raster, dy outer
    cands = (coarse[..., :, None, :] * COARSE_DS + grid).reshape(*lead, -1, 2)
    zero = torch.zeros((*lead, 1, 2), dtype=_I32, device=coarse.device)
    return torch.cat([zero, cands], dim=-2)


def hier_candidates(cur, ref_y):
    """The refine candidate list of the hierarchical search: the coarse
    vote's TOPK global displacements, each refined over a +-REFINE_R
    raster, zero MV first -- (1 + TOPK*(2R+1)^2, 2) int32 on cur's device."""
    return _refine_cands(coarse_vote_candidates(cur, ref_y))


def hier_me_mc(cur, ref_y, ry_pad, ru_pad, rv_pad, dy_max: int | None = None,
               dx_max: int | None = None, coarse=None):
    """Hierarchical ME fused with MC -- the plain PyTorch version.

    Coarse vote -> 76 refine candidates -> per-MB min SAD*scale + rank ->
    the winner's full-pel luma and half-pel chroma predictions. Returns
    (mvs (mbh,mbw,2) int32, pred_y, pred_u, pred_v int32), element-exact
    with numpy_ref.hier_search_me + mc_luma_16x16/mc_chroma_8x8.
    ``dy_max``/``dx_max`` clamp the candidate window (_refine_cands);
    ``coarse`` replaces the coarse vote with a given (TOPK, 2) list (the
    row-merged list of a tile grid, parallel/bands.py)."""
    if coarse is None:
        coarse = coarse_vote_candidates(cur, ref_y)
    return me_mc.me_mc_plain(_refine_cands(coarse, dy_max, dx_max), cur, ry_pad, ru_pad,
                             rv_pad)


def _me_mc_dispatch(y, ref_y, ry, ru, rv, dy_max: int | None = None,
                    dx_max: int | None = None, coarse=None):
    """ME + MC over MV_PAD-padded reference planes (the frame, band and
    tile steps): the refine search + MC runs through ``me_mc.me_mc`` (the
    CUDA kernel for CUDA tensors, the plain version for CPU ones)."""
    if coarse is None:
        coarse = coarse_vote_candidates(y, ref_y)
    return me_mc.me_mc(_refine_cands(coarse, dy_max, dx_max), y, ry, ru, rv)


# -- the golden path's entries (tests and tools; no encoder calls them) ------

mc_luma = me_mc.mc_luma
mc_chroma = me_mc.mc_chroma


def _zero_chroma(cur):
    h, w = cur.shape[-2:]
    return torch.zeros((h // 2 + 2 * MV_PAD, w // 2 + 2 * MV_PAD), dtype=torch.uint8,
                       device=cur.device)


def motion_search(cur, ref_pad, search: int = 8):
    """Exhaustive full-pel SAD search: (H, W) planes -> (mbh, mbw, 2) int32
    MVs over the +-``search`` raster, zero MV first; ties resolve to the
    first candidate in that order (the plain ME/MC over zero chroma)."""
    if search > MV_PAD:
        raise ValueError(f"search {search} exceeds MV_PAD={MV_PAD}")
    cands = torch.from_numpy(_me_candidates(search)).to(cur.device)
    zc = _zero_chroma(cur)
    return me_mc.me_mc_plain(cands, cur, ref_pad, zc, zc)[0]


def hier_motion_search(cur, ref, ref_pad):
    """MV-only ``hier_me_mc``: ``ref_pad`` is the MV_PAD-padded luma; the
    chroma planes are zeros."""
    zc = _zero_chroma(cur)
    return hier_me_mc(cur, ref, ref_pad, zc, zc)[0]


def _plane_to_mb_blocks(plane, n: int):
    """(..., mbh*n*4, mbw*n*4) -> (..., mbh, mbw, n, n, 4, 4) [by][bx][i][j]."""
    *lead, h, w = plane.shape
    mbh, mbw = h // (n * 4), w // (n * 4)
    return plane.reshape(*lead, mbh, n, 4, mbw, n, 4).permute(
        _lead_perm(len(lead), (0, 3, 1, 4, 2, 5)))


def _mb_blocks_to_plane(blocks):
    lead = blocks.shape[:-6]
    mbh, mbw, n = blocks.shape[-6], blocks.shape[-5], blocks.shape[-4]
    return blocks.permute(_lead_perm(len(lead), (0, 2, 4, 1, 3, 5))).reshape(
        *lead, mbh * n * 4, mbw * n * 4)


def _neighbour(mvs, di: int, dj: int, lead: int = 0):
    """out[i, j] = mvs[i + di, j + dj], zero where that lies off the grid;
    the grid axes follow ``lead`` leading (session) axes."""
    mbh, mbw = mvs.shape[lead:lead + 2]
    out = torch.zeros_like(mvs)
    i0, i1 = max(0, -di), min(mbh, mbh - di)
    j0, j1 = max(0, -dj), min(mbw, mbw - dj)
    if i1 > i0 and j1 > j0:
        keep = (slice(None),) * lead
        out[(*keep, slice(i0, i1), slice(j0, j1))] = mvs[
            (*keep, slice(i0 + di, i1 + di), slice(j0 + dj, j1 + dj))]
    return out


def _skip_mask(mvs, resid_zero):
    """Vectorized 8.4.1.1 P_Skip eligibility: residual-free MBs whose MV
    equals the skip-derived MV. mvs (..., mbh, mbw, 2)."""
    lead = mvs.dim() - 3
    mbh, mbw = mvs.shape[lead:lead + 2]
    dev = mvs.device
    left = _neighbour(mvs, 0, -1, lead)
    top = _neighbour(mvs, -1, 0, lead)
    # C = top-right, replaced by D = top-left on the last column (both exist
    # whenever the median branch is taken: mbx>0 and mby>0).
    tr = _neighbour(mvs, -1, 1, lead)
    tl = _neighbour(mvs, -1, -1, lead)
    last_col = torch.arange(mbw, device=dev) == mbw - 1
    cmv = torch.where(last_col[None, :, None], tl, tr)
    med = (left + top + cmv - torch.maximum(torch.maximum(left, top), cmv)
           - torch.minimum(torch.minimum(left, top), cmv))
    edge = (torch.arange(mbw, device=dev)[None, :] == 0) | (torch.arange(mbh, device=dev)[:, None] == 0)
    zero_cond = edge | (left == 0).all(-1) | (top == 0).all(-1)
    skipmv = torch.where(zero_cond[..., None], torch.zeros_like(med), med)
    return resid_zero & (mvs == skipmv).all(-1)


def _all_zero(x, ndims: int):
    """True where the trailing ``ndims`` axes of ``x`` are all zero."""
    return ~(x != 0).flatten(-ndims).any(-1)


def _p_transform_tail(y, u, v, qp: _QPRows, mvs, pred_y, pred_u, pred_v,
                      defer_skip: bool = False) -> dict:
    """Transform + quant + recon + skip derivation -- everything after ME/MC.
    ``defer_skip`` returns ``resid_zero`` (the residual-free mask) instead
    of ``skip``, for a tile grid that derives P_Skip on the row-merged MV
    grid (the left neighbour of a tile's first column is in the next tile)."""
    qp_c = qp.chroma()
    # Luma: plain 4x4 transform, all 16 coeffs (no DC Hadamard in inter MBs)
    wy = fdct4(_plane_to_mb_blocks(y - pred_y, 4))
    luma_ac = quant4(wy, qp, intra=False)
    rec_y = (_mb_blocks_to_plane(idct4(dequant4(luma_ac, qp))) + pred_y).clamp(0, 255)

    def chroma(plane, pred):
        wc = fdct4(_plane_to_mb_blocks(plane - pred, 2))
        dc = quant_chroma_dc(wc[..., 0, 0], qp_c, intra=False)
        ac = quant4(wc, qp_c, intra=False)
        deq = dequant4(ac, qp_c)
        deq[..., 0, 0] = dequant_chroma_dc(dc, qp_c)
        rec = (_mb_blocks_to_plane(idct4(deq)) + pred).clamp(0, 255)
        return dc, ac, rec

    cb_dc, cb_ac, rec_u = chroma(u, pred_u)
    cr_dc, cr_ac, rec_v = chroma(v, pred_v)
    resid_zero = (_all_zero(luma_ac, 4) & _all_zero(cb_dc, 2) & _all_zero(cr_dc, 2)
                  & _all_zero(cb_ac, 4) & _all_zero(cr_ac, 4))
    skip_kv = ({"resid_zero": resid_zero} if defer_skip
               else {"skip": _skip_mask(mvs, resid_zero)})
    return {
        "mvs": mvs,
        **skip_kv,
        "luma_ac": luma_ac,
        "chroma_dc": torch.stack([cb_dc, cr_dc], dim=mvs.dim() - 1),
        "chroma_ac": torch.stack([cb_ac, cr_ac], dim=mvs.dim() - 1),
        "recon_y": rec_y.to(torch.uint8),
        "recon_u": rec_u.to(torch.uint8),
        "recon_v": rec_v.to(torch.uint8),
    }


def encode_frame_p_planes(y, u, v, ref_y, ref_u, ref_v, qp: int) -> dict:
    """P-frame encode on padded planes against the previous recon.

    Two-level hierarchical search covering +-32 (the JAX default
    ``me="hier"``). Returns mvs/skip/coefficients (PFrameCoeffs layout) +
    uint8 recon planes. Luma and chroma references are both edge-padded by
    MV_PAD."""
    y, u, v = y.to(_I32), u.to(_I32), v.to(_I32)
    ry = edge_pad(ref_y, MV_PAD)
    ru = edge_pad(ref_u, MV_PAD)
    rv = edge_pad(ref_v, MV_PAD)
    mvs, pred_y, pred_u, pred_v = _me_mc_dispatch(y, ref_y, ry, ru, rv)
    return _p_transform_tail(y, u, v, _QPRows.of(qp, y.device), mvs, pred_y, pred_u, pred_v)


def encode_frame_p_planes_batch(y, u, v, ref_y, ref_u, ref_v, qps) -> dict:
    """N sessions' P frames in one set of device ops, K1 launched once.

    Planes (N, H, W) / (N, H/2, W/2), each session against its own
    reference; qps (N,) int32 on the planes' device. Every output gains a
    leading N; session i equals ``encode_frame_p_planes(y[i], ..., ref_v[i],
    int(qps[i]))``: each session votes its own coarse candidates (76 per
    session) and ``me_mc.me_mc_batch`` searches every session in one launch."""
    y, u, v = y.to(_I32), u.to(_I32), v.to(_I32)
    ry = edge_pad(ref_y, MV_PAD)
    ru = edge_pad(ref_u, MV_PAD)
    rv = edge_pad(ref_v, MV_PAD)
    cands = _refine_cands(coarse_vote_candidates(y, ref_y))
    mvs, pred_y, pred_u, pred_v = me_mc.me_mc_batch(cands, y, ry, ru, rv)
    return _p_transform_tail(y, u, v, _QPRows.gather(qps), mvs, pred_y, pred_u, pred_v)


def encode_tile_p_planes(y, u, v, slab_y, slab_u, slab_v, qp: int, halo: int,
                         halo_cols: int = 0, coarse=None, defer_skip: bool = False) -> dict:
    """Tile-sliced P encode: one tile against a 2D reference slab, ``halo``
    real rows above and below and ``halo_cols`` real columns left and right
    (chroma: half of each), edge-replicated at the picture edges as the
    decoder clamps. ``halo_cols=0`` with a full-width slab is a band;
    ``halo=0`` with the whole reference as the slab is
    encode_frame_p_planes. The validity rule for either halo: even,
    and 0 (the slab spans the whole reference on that axis) or in
    [REFINE_R + 2, MV_PAD]; below the full reach (COARSE_DS*COARSE_R +
    REFINE_R + 2 = 36) the window on that axis is clamped to ``halo - 2``,
    so that no chosen prediction reads a replicated slab row.

    ``coarse`` injects a (TOPK, 2) coarse list: a tile grid sums the vote
    histograms of one slice row's tiles and selects once, so every tile
    refines the candidates of the full-row encoder. ``defer_skip`` returns
    ``resid_zero`` instead of ``skip`` (_p_transform_tail)."""
    if halo % 2 or not 0 <= halo <= MV_PAD or 0 < halo < REFINE_R + 2:
        raise ValueError(
            f"halo {halo} must be even and 0 (full-reference slab) or in "
            f"[{REFINE_R + 2}, {MV_PAD}]")
    if halo_cols % 2 or not 0 <= halo_cols <= MV_PAD or 0 < halo_cols < REFINE_R + 2:
        raise ValueError(
            f"halo_cols {halo_cols} must be even and 0 (full-width slab) or "
            f"in [{REFINE_R + 2}, {MV_PAD}]")
    y, u, v = y.to(_I32), u.to(_I32), v.to(_I32)
    vt, vtc = MV_PAD - halo, MV_PAD - halo // 2
    ht, htc = MV_PAD - halo_cols, MV_PAD - halo_cols // 2
    ry = edge_pad(slab_y, vt, vt, ht, ht)
    ru = edge_pad(slab_u, vtc, vtc, htc, htc)
    rv = edge_pad(slab_v, vtc, vtc, htc, htc)
    # the tile's own reference, for the coarse vote when no list is given
    ref_y = slab_y[halo:slab_y.shape[0] - halo] if halo else slab_y
    if halo_cols:
        ref_y = ref_y[:, halo_cols:ref_y.shape[1] - halo_cols]
    # a halo of the full reach plus the chroma bilinear's one extra row or
    # column covers every candidate; halo 0 is the whole reference
    full_reach = COARSE_DS * COARSE_R + REFINE_R + 2
    dy_max = None if halo == 0 or halo >= full_reach else halo - 2
    dx_max = None if halo_cols == 0 or halo_cols >= full_reach else halo_cols - 2
    mvs, pred_y, pred_u, pred_v = _me_mc_dispatch(y, ref_y, ry, ru, rv, dy_max=dy_max,
                                                  dx_max=dx_max, coarse=coarse)
    return _p_transform_tail(y, u, v, _QPRows.of(qp, y.device), mvs, pred_y, pred_u, pred_v,
                             defer_skip=defer_skip)


# ---------------------------------------------------------------------------
# Compact downlink
# ---------------------------------------------------------------------------
#
# The device emits one int32 header (counts + packed MVs + per-MB
# nonzero-block bitmap + skip bitmask, or intra modes for IDR) and one
# int16 buffer whose first n rows are the nonzero 4x4 blocks in global
# scan order. fuse_downlink joins the header and the first cap_rows rows
# into one int16 buffer, so a typical frame is one device->host copy. The
# host scatters rows back into dense arrays (compact.py) and feeds the
# unchanged CAVLC packer.

# Row-layout constants -- the only definition; compact.py imports these.
# P frame, per-MB rows: [0:16) luma AC, [16:24) chroma AC, [24:26) chroma DC.
P_ROW_CHROMA = 16
P_ROW_DC = 24
P_ENTRIES = 26
# IDR, per-MB rows: [0] luma DC, [1:17) luma AC, [17:25) chroma AC,
# [25:27) chroma DC.
I_ROW_LUMA = 1
I_ROW_CHROMA = 17
I_ROW_DC_C = 25
I_ENTRIES = 27


def _compact_rows(rows):
    """rows: (M, E, 16) int16 -> (flags (M,E) bool, buf (M*E, 16) int16,
    n int32). buf's first n rows are the nonzero rows in scan order, the
    rest are zero: a stable sort of the all-zero flags puts the nonzero
    rows first, in order, and needs no host sync."""
    m, e, _ = rows.shape
    flat = rows.reshape(m * e, 16)
    fl = (flat != 0).any(-1)
    order = torch.sort((~fl).to(torch.uint8), stable=True).indices
    buf = flat.index_select(0, order)
    return fl.reshape(m, e), buf, fl.sum(dtype=_I32)


def _bitmap_words(flags):
    """(M, E<=32) bool -> (M,) int32 per-MB bitmap."""
    e = flags.shape[1]
    sh = torch.arange(e, device=flags.device, dtype=torch.int64)
    return _as_int32((flags.to(torch.int64) << sh).sum(-1))


def _as_int32(words):
    """int64 holding unsigned 32-bit words -> int32 of the same bits."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(_I32)


def _bitpack32(bits):
    """(M,) bool -> (ceil(M/32),) int32."""
    m = bits.shape[0]
    pad = (-m) % 32
    b = torch.cat([bits.to(torch.int64), bits.new_zeros(pad, dtype=torch.int64)]).reshape(-1, 32)
    sh = torch.arange(32, device=bits.device, dtype=torch.int64)
    return _as_int32((b << sh).sum(-1))


def _meta(n, mbh: int, mbw: int, *rest):
    """[n, mbh, mbw, 0] (or [n, mbh, mbw, *rest] for int32 scalar tensors
    ``rest``) as one int32 vector, built on n's device without a host copy."""
    tail = [r.reshape(1).to(_I32) for r in rest] or [n.new_zeros(1, dtype=_I32)]
    return torch.cat([n.reshape(1).to(_I32), n.new_full((1,), mbh, dtype=_I32),
                      n.new_full((1,), mbw, dtype=_I32), *tail])


def _p_components(out: dict):
    """P outputs -> (n, mbh, mbw, mv_words (M,), mbinfo (M,), rows buf)."""
    mv = out["mvs"]
    mbh, mbw = mv.shape[:2]
    m = mbh * mbw
    luma = out["luma_ac"].reshape(m, 16, 16).to(torch.int16)
    chroma = out["chroma_ac"].reshape(m, 8, 16).to(torch.int16)
    dc = out["chroma_dc"].reshape(m, 2, 4).to(torch.int16)
    dc_rows = torch.cat([dc, dc.new_zeros((m, 2, 12))], dim=2)
    rows = torch.cat([luma, chroma, dc_rows], dim=1)  # (M, 26, 16)
    flags, buf, n = _compact_rows(rows)
    mv_words = ((mv[..., 0] & 0xFFFF) | (mv[..., 1] << 16)).reshape(-1).to(_I32)
    return n, mbh, mbw, mv_words, _bitmap_words(flags), buf


def pack_p_compact(out: dict):
    """P-frame outputs -> (header int32, data int16 (M*26, 16)).

    Header layout: [n, mbh, mbw, 0] ++ mv_words(M) ++ mbinfo(M) ++
    skip_words(ceil(M/32)); mv_words = (mvx & 0xFFFF) | (mvy << 16)."""
    n, mbh, mbw, mv_words, mbinfo, buf = _p_components(out)
    header = torch.cat([_meta(n, mbh, mbw), mv_words, mbinfo,
                        _bitpack32(out["skip"].reshape(-1))])
    return header, buf


# ---------------------------------------------------------------------------
# Sparse P downlinks (the delta path)
# ---------------------------------------------------------------------------
#
# One fused int16 buffer whose live content tracks the frame's activity:
# meta ++ skip bitmap ++ (mv, mbinfo) pairs of the first nscap non-skip MBs
# ++ the coefficient rows at a data-dependent offset. Every write at a
# data-dependent offset is an index_copy_ at a device-side start (the
# clamped start of ``lax.dynamic_update_slice``), and the dense/packed
# choice is a torch.where: the host reads no count before the fetch.


def _dus(buf, upd, start):
    """In-place ``lax.dynamic_update_slice`` of a 1-D buffer: the start is
    clamped so ``upd`` fits. ``start`` is an int or a device scalar."""
    size = upd.shape[0]
    hi = buf.shape[0] - size
    if isinstance(start, int):
        s = min(max(start, 0), hi)
        buf[s:s + size] = upd
        return buf
    s = start.to(torch.int64).clamp(0, hi)
    return buf.index_copy_(0, s + torch.arange(size, device=buf.device), upd)


def _sparse_pairs(skip, mv_words, mbinfo, nscap: int):
    """(ns int32, (mv, info) int32 pairs of the first nscap non-skip MBs as
    int16 words (4*nscap,)). Skipped MBs and those past nscap land in a
    sentinel slot that is dropped."""
    mask = ~skip
    ns = mask.sum(dtype=_I32)
    pos = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (pos < nscap), pos, nscap)
    mv_c = mv_words.new_zeros(nscap + 1).index_put_((dest,), mv_words)[:nscap]
    info_c = mbinfo.new_zeros(nscap + 1).index_put_((dest,), mbinfo)[:nscap]
    return ns, torch.stack([mv_c, info_c], -1).reshape(-1).view(torch.int16)


def pack_p_sparse_var(out: dict, nscap: int, cap_rows: int):
    """Skip-aware variable-density P downlink -> (fused int16, dense
    header int32, rows buf).

    fused = [n, mbh, mbw, ns] ++ skip_words ++ pairs (4*nscap int16) ++
    rows (16*cap_rows int16) written at base + 4*min(ns, nscap), over the
    pair region's dead tail. ``dense`` is pack_p_compact's header (the
    ns > nscap fallback), ``buf`` the rows past cap_rows (spill)."""
    n, mbh, mbw, mv_words, mbinfo, buf = _p_components(out)
    skip = out["skip"].reshape(-1)
    ns, pairs16 = _sparse_pairs(skip, mv_words, mbinfo, nscap)
    skip_words = _bitpack32(skip)
    head16 = torch.cat([_meta(n, mbh, mbw, ns), skip_words]).view(torch.int16)
    base = head16.shape[0]  # 8 + 2*sw
    fused = buf.new_zeros(base + 4 * nscap + 16 * cap_rows)
    _dus(fused, head16, 0)
    _dus(fused, pairs16, base)
    _dus(fused, buf[:cap_rows].reshape(-1), base + 4 * ns.clamp(0, nscap))
    dense = torch.cat([_meta(n, mbh, mbw), mv_words, mbinfo, skip_words])
    return fused, dense, buf


def pack_p_sparse_packed(out: dict, nscap: int, cap_rows: int, density_pct: int = 75):
    """Bit-packed variant of pack_p_sparse_var -> (fused, dense, buf).

    Meta is [n, mbh, mbw, ns, nw, dense_flag]. At the rows offset either
    the 16-lane rows (dense_flag=1) or per-row int16 significance bitmaps
    followed by the nonzero values, each row's padded to quads (nw words
    in all; the values overwrite the bitmap array's dead tail). The dense
    layout is chosen when bitmaps + values exceed density_pct% of the
    rows. Both layouts are built and one is selected with torch.where."""
    n, mbh, mbw, mv_words, mbinfo, buf = _p_components(out)
    skip = out["skip"].reshape(-1)
    ns, pairs16 = _sparse_pairs(skip, mv_words, mbinfo, nscap)
    skip_words = _bitpack32(skip)
    dev = buf.device

    rows = buf[:cap_rows]  # zero past row n
    sig = rows != 0
    bitmap16 = (sig.to(_I32) << torch.arange(16, dtype=_I32, device=dev)).sum(
        -1, dtype=_I32).to(torch.int16)
    counts = sig.sum(-1, dtype=_I32)
    width = 4 * ((counts + 3) // 4)  # int16 slots incl. quad padding
    off = torch.cumsum(width, 0) - width  # exclusive prefix
    nw = width.sum(dtype=_I32)
    lane = torch.cumsum(sig, -1) - 1  # rank of each nonzero in its row
    vdest = torch.where(sig, off[:, None] + lane, 16 * cap_rows)  # sentinel dropped
    vals16 = rows.new_zeros(16 * cap_rows + 1).index_put_(
        (vdest.reshape(-1),), rows.reshape(-1))[:16 * cap_rows]

    held = n.clamp(max=cap_rows)
    dense_flag = (held + nw) * 100 > (16 * held) * density_pct
    head16 = torch.cat([_meta(n, mbh, mbw, ns, nw, dense_flag),
                        skip_words]).view(torch.int16)
    base = head16.shape[0]  # 12 + 2*sw
    fused = buf.new_zeros(base + 4 * nscap + cap_rows + 16 * cap_rows)
    _dus(fused, head16, 0)
    _dus(fused, pairs16, base)
    rows_off = base + 4 * ns.clamp(0, nscap)
    with_rows = _dus(fused.clone(), rows.reshape(-1), rows_off)
    _dus(fused, bitmap16, rows_off)
    _dus(fused, vals16, rows_off + held)
    fused = torch.where(dense_flag, with_rows, fused)
    dense = torch.cat([_meta(n, mbh, mbw), mv_words, mbinfo, skip_words])
    return fused, dense, buf


def pack_p_sparse_entropy(out: dict, nscap: int, cap_rows: int, density_pct: int | None,
                          bits_words: int, min_mbs: int, buckets: tuple[int, ...],
                          entropy_coder: str = "cavlc"):
    """Device-entropy delta downlink -> (fused, dense, buf): busy frames
    ship their final slice bits (CAVLC) or their token stream (CABAC),
    quiet frames the sparse coefficients, decided per frame on the device.

    Wraps the sparse layouts (pack_p_sparse_var / pack_p_sparse_packed,
    unchanged) and the device coder (device_cavlc.pack_p_slice_bits_active
    over the top bucket). The fused buffer gains an 8-int32 meta prefix

      [mode, nbits, trailing_skip, nskip, ns, 0, 0, 0]   (16 int16)
      ++ mode 0: the sparse layout; mode 1: the bit words

    Mode 1 is chosen when the frame is busy enough (ns >= min_mbs), fits
    the top bucket and its bits fit ``bits_words`` (else the coefficient
    downlink: the word-cap overflow fallback). Both payloads are built and
    one is selected with torch.where, so the host reads nothing before its
    fetch. ``dense`` and ``buf`` are the coefficient mode's fallbacks, as
    in the wrapped packers. Host half:
    sparse_complete.complete_sparse_slice(device_bits=True).

    With entropy_coder="cabac" mode 1 carries the 16-bit token IR
    (device_cabac.pack_p_slice_tokens_active); the host still runs the
    arithmetic engine. Its payload (meta [1, ntok, 0, nskip, ns, 0, 0, 0]):
    the skip bitmap (2*sw int16), the per-coded-MB token counts (an
    A_max block, int16), then the token words at offset 2*sw + ns, over
    the counts' dead tail."""
    if entropy_coder == "cabac":
        return _pack_p_sparse_cabac(out, nscap, cap_rows, density_pct, bits_words, min_mbs,
                                    buckets)
    from selkies_tpu_torch.models.h264.device_cavlc import pack_p_slice_bits_active

    fused, dense, buf = (pack_p_sparse_var(out, nscap, cap_rows) if density_pct is None
                         else pack_p_sparse_packed(out, nscap, cap_rows, density_pct))
    words, nbits, trailing, ns = pack_p_slice_bits_active(out, word_cap=bits_words,
                                                          buckets=buckets)
    nskip = out["skip"].sum(dtype=_I32)
    use_bits = (ns >= min_mbs) & (ns <= buckets[-1]) & (nbits <= 32 * bits_words)
    zero = ns.new_zeros(())
    head16 = torch.stack([use_bits.to(_I32), nbits, trailing, nskip, ns, zero, zero,
                          zero]).to(_I32).view(torch.int16)
    total16 = 16 + max(int(fused.shape[0]), 2 * bits_words)
    with_coeff = fused.new_zeros(total16)
    _dus(with_coeff, fused, 16)
    with_bits = fused.new_zeros(total16)
    _dus(with_bits, words.view(torch.int16), 16)
    fused2 = torch.where(use_bits, with_bits, with_coeff)
    _dus(fused2, head16, 0)
    return fused2, dense, buf


def _pack_p_sparse_cabac(out: dict, nscap: int, cap_rows: int, density_pct: int | None,
                         bits_words: int, min_mbs: int, buckets: tuple[int, ...]):
    """The CABAC arm of pack_p_sparse_entropy (layout documented there)."""
    from selkies_tpu_torch.models.h264.device_cabac import pack_p_slice_tokens_active

    fused, dense, buf = (pack_p_sparse_var(out, nscap, cap_rows) if density_pct is None
                         else pack_p_sparse_packed(out, nscap, cap_rows, density_pct))
    words, ntok, counts, ns = pack_p_slice_tokens_active(out, word_cap=bits_words,
                                                         buckets=buckets)
    skip = out["skip"].reshape(-1)
    skip_words = _bitpack32(skip)
    sw = skip_words.shape[0]
    nskip = skip.sum(dtype=_I32)
    a_max = buckets[-1]
    use_toks = (ns >= min_mbs) & (ns <= a_max) & (ntok <= 2 * bits_words)
    zero = ns.new_zeros(())
    head16 = torch.stack([use_toks.to(_I32), ntok, zero, nskip, ns, zero, zero,
                          zero]).to(_I32).view(torch.int16)
    base = 16 + 2 * sw
    total16 = 16 + max(int(fused.shape[0]), 2 * sw + a_max + 2 * bits_words)
    with_coeff = fused.new_zeros(total16)
    _dus(with_coeff, fused, 16)
    with_toks = fused.new_zeros(total16)
    _dus(with_toks, skip_words.view(torch.int16), 16)
    _dus(with_toks, counts.to(torch.int16), base)
    _dus(with_toks, words.view(torch.int16), base + ns.clamp(0, a_max))
    fused2 = torch.where(use_toks, with_toks, with_coeff)
    _dus(fused2, head16, 0)
    return fused2, dense, buf


def pack_i_compact(out: dict):
    """IDR outputs -> (header int32, data int16 (M*27, 16)).

    Header: [n, mbh, mbw, 0] ++ mbinfo(M) ++ mode_words(M)
    (mode_words = luma_mode | chroma_mode << 8). Per-MB rows: 1 luma DC +
    16 luma AC + 8 chroma AC + 2 chroma DC."""
    mbh, mbw = out["luma_mode"].shape[:2]
    m = mbh * mbw
    luma_dc = out["luma_dc"].reshape(m, 1, 16).to(torch.int16)
    luma = out["luma_ac"].reshape(m, 16, 16).to(torch.int16)
    chroma = out["chroma_ac"].reshape(m, 8, 16).to(torch.int16)
    dc = out["chroma_dc"].reshape(m, 2, 4).to(torch.int16)
    dc_rows = torch.cat([dc, dc.new_zeros((m, 2, 12))], dim=2)
    rows = torch.cat([luma_dc, luma, chroma, dc_rows], dim=1)  # (M, 27, 16)
    flags, buf, n = _compact_rows(rows)
    modes = out["luma_mode"].reshape(-1) | (out["chroma_mode"].reshape(-1) << 8)
    header = torch.cat([_meta(n, mbh, mbw), _bitmap_words(flags), modes.to(_I32)])
    return header, buf


def fuse_downlink(header, buf, cap_rows: int):
    """Header + the first cap_rows data rows as ONE int16 buffer: the
    int32 header reinterpreted as int16 pairs (little-endian, as the JAX
    bitcast), then the rows. Frames with more than cap_rows nonzero rows
    fetch the rest from ``buf``."""
    hdr16 = header.contiguous().view(torch.int16)
    return torch.cat([hdr16, buf[:cap_rows].reshape(-1)])


# ---------------------------------------------------------------------------
# Delta upload: tile writes into device-resident planes
# ---------------------------------------------------------------------------
#
# The JAX steps apply tile lists with sequential loops of
# dynamic_update_slice, so where two entries hit one tile the later wins.
# Here a list is one scatter: every entry writes the data of the LAST
# entry that targets its tile, so duplicates carry identical bytes and the
# undefined order of duplicate writes (index_put_ on CUDA) cannot matter.


def last_writer(keys, valid=None):
    """(k,) keys -> (k,) int64: for each entry the index of the last entry
    (in list order) with the same key, among ``valid`` entries when given;
    -1 where no valid entry has the key. A k x k comparison on the device."""
    k = keys.shape[0]
    same = keys[:, None] == keys[None, :]
    if valid is not None:
        same = same & valid[None, :]
    order = torch.arange(k, device=keys.device)
    return torch.where(same, order[None, :], -1).amax(1)


def tile_view(plane, th: int, tw: int):
    """(H, W) plane -> (H/th, W/tw, th, tw) view of its tiles (writes to
    the view land in the plane)."""
    h, w = plane.shape
    return plane.view(h // th, th, w // tw, tw).transpose(1, 2)


def scatter_tiles(y, u, v, yb, ub, vb, idx, tile_w: int):
    """Write uploaded I420 tiles into the resident planes, in place.

    yb: (k, 16, tile_w) luma, ub/vb: (k, 8, tile_w/2) chroma, idx: (k,)
    band*1024 + tile. Duplicate positions are allowed (the host pads the
    list by repeating its last tile); the last entry at a position wins.
    Returns the planes."""
    idx = idx.to(torch.int64)
    band, tile = idx // 1024, idx % 1024
    win = last_writer(idx)
    tile_view(y, 16, tile_w)[band, tile] = yb[win]
    tile_view(u, 8, tile_w // 2)[band, tile] = ub[win]
    tile_view(v, 8, tile_w // 2)[band, tile] = vb[win]
    return y, u, v
