"""Plain PyTorch reference of the numbers a tpuh264enc frame carries.

One session, one frame at a time, on any device, with integer arithmetic
only: BGRx -> I420 conversion (BT.601, 2x2 chroma average, edge-replicated
padding to whole macroblocks), the IDR step (Intra16x16: DC prediction
along the first macroblock row, vertical below it; Intra8x8 chroma the
same way), the P step (the two-level global-candidate motion search, full
pel luma and half-pel bilinear chroma compensation, P_L0_16x16 residuals)
and the reconstruction that the next P frame predicts from. Transform,
quantisation and rescaling follow ISO/IEC 14496-10 8.5 with deblocking
off, as the stream's slice headers state.

It is written from the H.264 specification and the encoder's stated mode
policy, and imports nothing of the program. The integer transform is
exact in float32 at these magnitudes; ``precision="bf16"`` computes the
forward transform in bfloat16, the next precision down, as a tensor-core
matmul in bf16 would: the control that a correct comparison must reject.
"""

from __future__ import annotations

import torch

from reference.tables import chroma_qp, mf_matrix, v_matrix

MV_PAD = 40      # reference planes are edge-padded by this much
COARSE_DS = 4    # coarse level: 4x4 box downsample
COARSE_R = 8     # coarse search radius, downsampled pels
REFINE_R = 2     # full-resolution refine radius around each coarse winner
TOPK = 3         # coarse displacements carried to the refine

I16_DC, I16_VERTICAL = 2, 0
CHROMA_DC, CHROMA_VERTICAL = 0, 2

_I32 = torch.int32


def _raster_zero_first(r: int) -> list[tuple[int, int]]:
    """(dx, dy) over the +-r raster, dy outer, the zero vector moved first:
    a candidate's index is its rank, and the lowest rank wins a tie."""
    c = [(dx, dy) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    return [(0, 0)] + [d for d in c if d != (0, 0)]


def bgrx_to_i420(frame: torch.Tensor, pad_h: int, pad_w: int):
    """(H, W, 4) uint8 BGRx, H and W even -> (y, u, v) uint8 planes padded
    to (pad_h, pad_w) by replicating the last row and column."""
    f = frame.to(_I32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = (((66 * r + 129 * g + 25 * b + 128) >> 8) + 16).clamp(16, 235)
    u = (((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128).clamp(16, 240)
    v = (((112 * r - 94 * g - 18 * b + 128) >> 8) + 128).clamp(16, 240)
    h, w = y.shape

    def quads(c):
        return (c.reshape(h // 2, 2, w // 2, 2).sum(dim=(1, 3), dtype=_I32) + 2) >> 2

    planes = (y, quads(u), quads(v))
    out = []
    for p, (ph, pw) in zip(planes, ((pad_h, pad_w), (pad_h // 2, pad_w // 2),
                                    (pad_h // 2, pad_w // 2))):
        rows = torch.arange(ph, device=p.device).clamp(max=p.shape[0] - 1)
        cols = torch.arange(pw, device=p.device).clamp(max=p.shape[1] - 1)
        out.append(p.index_select(0, rows).index_select(1, cols).to(torch.uint8))
    return tuple(out)


def _edge_pad(plane: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicating pad of the last two axes."""
    h, w = plane.shape[-2:]
    rows = torch.arange(-pad, h + pad, device=plane.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=plane.device).clamp(0, w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


# -- 4x4 integer transforms (8.5.12) and their duals --------------------------

def _cf(a0, a1, a2, a3):
    s03, d03, s12, d12 = a0 + a3, a0 - a3, a1 + a2, a1 - a2
    return s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12


def fdct4(x: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """Forward core transform Cf X Cf^T over the last two axes."""
    if precision == "bf16":
        x = x.to(torch.bfloat16)
    r = torch.stack(_cf(*x.unbind(-2)), -2)
    r = torch.stack(_cf(*r.unbind(-1)), -1)
    return r.round().to(_I32) if precision == "bf16" else r


def idct4(d: torch.Tensor) -> torch.Tensor:
    """Inverse core transform (8.5.12.2): rows first, then columns, then
    (x + 32) >> 6, with arithmetic shifts."""
    e0, e1 = d[..., 0] + d[..., 2], d[..., 0] - d[..., 2]
    e2, e3 = (d[..., 1] >> 1) - d[..., 3], d[..., 1] + (d[..., 3] >> 1)
    g = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)
    e0, e1 = g[..., 0, :] + g[..., 2, :], g[..., 0, :] - g[..., 2, :]
    e2, e3 = (g[..., 1, :] >> 1) - g[..., 3, :], g[..., 1, :] + (g[..., 3, :] >> 1)
    out = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -2)
    return (out + 32) >> 6


def _had4(x):
    def h(a, b, c, d):
        return a + b + c + d, a + b - c - d, a - b - c + d, a - b + c - d
    r = torch.stack(h(*x.unbind(-2)), -2)
    return torch.stack(h(*r.unbind(-1)), -1)


def _had2(x):
    r = torch.stack([x[..., 0, :] + x[..., 1, :], x[..., 0, :] - x[..., 1, :]], -2)
    return torch.stack([r[..., 0] + r[..., 1], r[..., 0] - r[..., 1]], -1)


def _signed(mag, like):
    return torch.where(like < 0, -mag, mag)


class Quant:
    """The quantiser and rescaler of one QP on one device."""

    def __init__(self, qp: int, device):
        self.qp, self.per = qp, qp // 6
        self.qbits = 15 + self.per
        self.mf = torch.tensor(mf_matrix(qp), dtype=_I32, device=device)
        self.v = torch.tensor(v_matrix(qp), dtype=_I32, device=device)
        self.mf00, self.v00 = int(mf_matrix(qp)[0, 0]), int(v_matrix(qp)[0, 0])

    def f(self, intra: bool) -> int:
        return (1 << self.qbits) // (3 if intra else 6)

    def quant4(self, c, intra: bool):
        return _signed((c.abs() * self.mf + self.f(intra)) >> self.qbits, c)

    def dequant4(self, lv):
        return lv * self.v * (1 << self.per)

    def quant_luma_dc(self, dc):
        t = _had4(dc) >> 1
        return _signed((t.abs() * self.mf00 + 2 * self.f(True)) >> (self.qbits + 1), t)

    def dequant_luma_dc(self, lv):
        f = _had4(lv) * self.v00
        if self.per >= 2:
            return f << (self.per - 2)
        return (f + (1 << (1 - self.per))) >> (2 - self.per)

    def quant_chroma_dc(self, dc, intra: bool):
        t = _had2(dc)
        return _signed((t.abs() * self.mf00 + 2 * self.f(intra)) >> (self.qbits + 1), t)

    def dequant_chroma_dc(self, lv):
        return ((_had2(lv) * self.v00) << self.per) >> 1


def _blocks(plane, n: int):
    """(..., R*4n, C*4n) -> (..., R, C, n, n, 4, 4): per MB, [by][bx][i][j]."""
    *lead, h, w = plane.shape
    r, c = h // (4 * n), w // (4 * n)
    x = plane.reshape(*lead, r, n, 4, c, n, 4)
    k = len(lead)
    return x.permute(*range(k), k, k + 3, k + 1, k + 4, k + 2, k + 5)


def _unblocks(b):
    *lead, r, c, n, _, _, _ = b.shape
    k = len(lead)
    return b.permute(*range(k), k, k + 2, k + 4, k + 1, k + 3, k + 5).reshape(
        *lead, r * n * 4, c * n * 4)


class Encoder:
    """The reference's frame steps for one geometry on one device."""

    def __init__(self, pad_h: int, pad_w: int, device, precision: str = "exact"):
        if pad_h % 16 or pad_w % 16:
            raise ValueError(f"{pad_w}x{pad_h} is not whole macroblocks")
        self.h, self.w, self.device, self.precision = pad_h, pad_w, device, precision
        self.mbh, self.mbw = pad_h // 16, pad_w // 16
        self._quant: dict = {}
        self._coarse_list = _raster_zero_first(COARSE_R)
        self.coarse = torch.tensor(self._coarse_list, dtype=_I32, device=device)
        self.grid = torch.tensor([(dx, dy) for dy in range(-REFINE_R, REFINE_R + 1)
                                  for dx in range(-REFINE_R, REFINE_R + 1)],
                                 dtype=_I32, device=device)

    def q(self, qp: int, device=None) -> Quant:
        key = (qp, str(device or self.device))
        if key not in self._quant:
            self._quant[key] = Quant(qp, device or self.device)
        return self._quant[key]

    # -- IDR ------------------------------------------------------------------

    def _intra(self, oy, ou, ov, py, pu, pv, qp: int):
        """k intra MBs side by side: oy/py (16, 16k), ou/pu/ov/pv (8, 8k)."""
        q, qc = self.q(qp, oy.device), self.q(chroma_qp(qp), oy.device)
        wy = fdct4(_blocks(oy.to(_I32) - py, 4), self.precision)[0]   # (k, 4, 4, 4, 4)
        dc = q.quant_luma_dc(wy[..., 0, 0])
        ac = q.quant4(wy, True)
        deq = q.dequant4(ac)
        deq[..., 0, 0] = q.dequant_luma_dc(dc)
        ry = (_unblocks(idct4(deq)[None]) + py).clamp(0, 255)

        def chroma(o, p):
            wc = fdct4(_blocks(o.to(_I32) - p, 2), self.precision)[0]
            cdc = qc.quant_chroma_dc(wc[..., 0, 0], True)
            cac = qc.quant4(wc, True)
            d = qc.dequant4(cac)
            d[..., 0, 0] = qc.dequant_chroma_dc(cdc)
            return cdc, cac, (_unblocks(idct4(d)[None]) + p).clamp(0, 255)

        udc, uac, ru = chroma(ou, pu)
        vdc, vac, rv = chroma(ov, pv)
        return (dc, ac, torch.stack([udc, vdc], 1), torch.stack([uac, vac], 1),
                ry.to(torch.uint8), ru.to(torch.uint8), rv.to(torch.uint8))

    def _row0(self, y, u, v, qp: int):
        """The first MB row, DC-predicted from the left, one MB after the
        other: y (16, W), u and v (8, W/2) -> the row's levels and recon."""
        dev = y.device
        ry, ru, rv = torch.empty_like(y), torch.empty_like(u), torch.empty_like(v)
        rows = []
        for c in range(self.mbw):
            xs, cxs = 16 * c, 8 * c
            if c == 0:
                py = torch.full((16, 16), 128, dtype=_I32, device=dev)
                pu = pv = torch.full((8, 8), 128, dtype=_I32, device=dev)
            else:
                left = ry[:, xs - 1].to(_I32)
                py = ((left.sum(dtype=_I32) + 8) >> 4).expand(16, 16)

                def half(col):
                    s = col.to(_I32).reshape(2, 4).sum(1, dtype=_I32)
                    return ((s + 2) >> 2).repeat_interleave(4)[:, None].expand(8, 8)

                pu, pv = half(ru[:, cxs - 1]), half(rv[:, cxs - 1])
            res = self._intra(y[:, xs:xs + 16], u[:, cxs:cxs + 8], v[:, cxs:cxs + 8],
                              py, pu, pv, qp)
            ry[:, xs:xs + 16], ru[:, cxs:cxs + 8], rv[:, cxs:cxs + 8] = res[4:]
            rows.append(res[:4])
        return (*(torch.cat(t) for t in zip(*rows)), ry, ru, rv)

    def encode_idr(self, y, u, v, qp: int) -> dict:
        """All-Intra16x16 frame: row 0 DC from the left (left to right), every
        later row vertical from the row above. Row 0 is a chain of one-MB
        steps, so it runs on the host, where a small operation costs less
        than a launch; the other rows are one step each on the device."""
        mbh, mbw = self.mbh, self.mbw
        dev = self.device
        ry = torch.empty((self.h, self.w), dtype=torch.uint8, device=dev)
        ru = torch.empty((self.h // 2, self.w // 2), dtype=torch.uint8, device=dev)
        rv = torch.empty_like(ru)
        luma_dc = torch.empty((mbh, mbw, 4, 4), dtype=_I32, device=dev)
        luma_ac = torch.empty((mbh, mbw, 4, 4, 4, 4), dtype=_I32, device=dev)
        chroma_dc = torch.empty((mbh, mbw, 2, 2, 2), dtype=_I32, device=dev)
        chroma_ac = torch.empty((mbh, mbw, 2, 2, 2, 4, 4), dtype=_I32, device=dev)

        def put(r, res):
            luma_dc[r], luma_ac[r], chroma_dc[r], chroma_ac[r] = (t.to(dev) for t in res[:4])
            ry[16 * r:16 * r + 16] = res[4].to(dev)
            ru[8 * r:8 * r + 8] = res[5].to(dev)
            rv[8 * r:8 * r + 8] = res[6].to(dev)

        put(0, self._row0(y[0:16].cpu(), u[0:8].cpu(), v[0:8].cpu(), qp))
        for r in range(1, mbh):
            py = ry[16 * r - 1].to(_I32).expand(16, self.w)
            pu = ru[8 * r - 1].to(_I32).expand(8, self.w // 2)
            pv = rv[8 * r - 1].to(_I32).expand(8, self.w // 2)
            put(r, self._intra(y[16 * r:16 * r + 16], u[8 * r:8 * r + 8],
                               v[8 * r:8 * r + 8], py, pu, pv, qp))
        luma_mode = torch.full((mbh, mbw), I16_VERTICAL, dtype=_I32, device=dev)
        luma_mode[0] = I16_DC
        chroma_mode = torch.full((mbh, mbw), CHROMA_VERTICAL, dtype=_I32, device=dev)
        chroma_mode[0] = CHROMA_DC
        return {"luma_mode": luma_mode, "chroma_mode": chroma_mode, "luma_dc": luma_dc,
                "luma_ac": luma_ac, "chroma_dc": chroma_dc, "chroma_ac": chroma_ac,
                "qp": qp, "recon": (ry, ru, rv)}

    # -- P (N sessions at once: every plane has a leading session axis) -------

    def _coarse_top(self, y, ref_y):
        """(N, TOPK, 2) most-voted coarse displacements (downsampled units;
        ties: lower rank): each MB votes for its least-SAD rank over the
        +-COARSE_R raster of the 4x4-downsampled planes."""
        n = y.shape[0]

        def down(p):
            return (p.to(_I32).reshape(n, self.h // 4, 4, self.w // 4, 4).sum(
                dim=(2, 4), dtype=_I32) + 8) >> 4

        yd, rd = down(y), down(ref_y)
        hd, wd = yd.shape[1:]
        rp = _edge_pad(rd, COARSE_R)
        best = None
        for k0 in range(0, len(self._coarse_list), 64):
            chunk = self._coarse_list[k0:k0 + 64]
            sh = torch.stack([rp[:, COARSE_R + dy:COARSE_R + dy + hd,
                                 COARSE_R + dx:COARSE_R + dx + wd] for dx, dy in chunk], 1)
            sad = (yd[:, None] - sh).abs().reshape(n, len(chunk), self.mbh, 4, self.mbw, 4).sum(
                dim=(3, 5), dtype=_I32)
            rank = torch.arange(k0, k0 + len(chunk), dtype=_I32, device=self.device)
            cost = (sad * 512 + rank[:, None, None]).amin(1)
            best = cost if best is None else torch.minimum(best, cost)
        k = len(self._coarse_list)
        best = (best & 511).reshape(n, -1).long()
        votes = torch.zeros((n, k), dtype=_I32, device=self.device)
        votes.scatter_add_(1, best, torch.ones_like(best, dtype=_I32))
        rank = torch.arange(k, dtype=_I32, device=self.device)
        return self.coarse[torch.topk(votes * 512 + (511 - rank), TOPK, dim=1).indices]

    def motion(self, y, ref_y, mb_row0: int = 0):
        """(N, mbh, mbw, 2) full-pel MVs over the refine list: rank 0 the zero
        vector, then for each coarse winner g (in vote order) the raster
        g*COARSE_DS + (dx, dy), |dx|, |dy| <= REFINE_R, dy outer; the
        lowest-ranked candidate of least SAD wins.

        Where this encoder's picture is a band of a taller one, ``ref_y`` is
        the taller picture's reference and the band starts at its MB row
        ``mb_row0``: the vote reads the band's own rows of it (a slice votes
        alone), the refine reads all of it, edge-padded at its own edges."""
        n = y.shape[0]
        r0 = 16 * mb_row0
        top = self._coarse_top(y, ref_y[:, r0:r0 + self.h])
        cands = torch.cat([torch.zeros((n, 1, 2), dtype=_I32, device=self.device),
                           (top[:, :, None, :] * COARSE_DS + self.grid).reshape(n, -1, 2)], 1)
        ry = _edge_pad(ref_y, MV_PAD)
        cur = y[:, None]
        h, w, r = self.h, self.w, REFINE_R

        def cost(shifted, rank0: int):
            k = shifted.shape[1]
            diff = torch.maximum(cur, shifted) - torch.minimum(cur, shifted)  # |a - b| in uint8
            sad = diff.reshape(n, k, self.mbh, 16, self.mbw, 16).sum(dim=(3, 5), dtype=_I32)
            rank = torch.arange(rank0, rank0 + k, dtype=_I32, device=self.device)
            return (sad * 128 + rank[:, None, None]).amin(1)

        best = cost(ref_y[:, None, r0:r0 + h], 0)
        sess = torch.arange(n, device=self.device)[:, None, None]
        ar_h = torch.arange(r0, r0 + h + 2 * r, device=self.device)
        ar_w = torch.arange(w + 2 * r, device=self.device)
        for g in range(TOPK):
            off = top[:, g] * COARSE_DS + (MV_PAD - r)                  # (N, 2)
            win = ry[sess, (off[:, 1, None] + ar_h)[:, :, None], (off[:, 0, None] + ar_w)[:, None, :]]
            sh = torch.stack([win[:, dy + r:dy + r + h, dx + r:dx + r + w]
                              for dy in range(-r, r + 1) for dx in range(-r, r + 1)], 1)
            best = torch.minimum(best, cost(sh, 1 + g * (2 * r + 1) ** 2))
        return cands[sess, (best & 127).long()]

    def compensate(self, mvs, ref_y, ref_u, ref_v, mb_row0: int = 0):
        """Full-pel luma and half-pel bilinear chroma predictions (8.4.2.2);
        a band's from the taller reference at its MB row ``mb_row0``."""
        dev = self.device
        n = mvs.shape[0]
        sess = torch.arange(n, device=dev)[:, None, None, None, None]
        mvx, mvy = mvs[..., 0], mvs[..., 1]
        mby = torch.arange(mb_row0, mb_row0 + self.mbh, device=dev)[:, None]
        mbx = torch.arange(self.mbw, device=dev)[None, :]
        i16 = torch.arange(16, device=dev)
        rows = (16 * mby + mvy + MV_PAD)[..., None] + i16
        cols = (16 * mbx + mvx + MV_PAD)[..., None] + i16
        p = _edge_pad(ref_y, MV_PAD)
        py = p[sess, rows[..., :, None], cols[..., None, :]].to(_I32)  # (N, mbh, mbw, 16, 16)
        pred_y = py.permute(0, 1, 3, 2, 4).reshape(n, self.h, self.w)
        i8 = torch.arange(8, device=dev)
        y0 = (8 * mby + (mvy >> 1) + MV_PAD)[..., None] + i8
        x0 = (8 * mbx + (mvx >> 1) + MV_PAD)[..., None] + i8
        xf = (4 * (mvx & 1))[..., None, None]
        yf = (4 * (mvy & 1))[..., None, None]

        def chroma(plane):
            pc = _edge_pad(plane, MV_PAD).to(_I32)
            yy, xx = y0[..., :, None], x0[..., None, :]
            a, b = pc[sess, yy, xx], pc[sess, yy, xx + 1]
            c, d = pc[sess, yy + 1, xx], pc[sess, yy + 1, xx + 1]
            out = ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b + (8 - xf) * yf * c
                   + xf * yf * d + 32) >> 6
            return out.permute(0, 1, 3, 2, 4).reshape(n, self.h // 2, self.w // 2)

        return pred_y, chroma(ref_u), chroma(ref_v)

    def encode_p(self, y, u, v, ref, qp: int, mb_row0: int = 0) -> dict:
        """P_L0_16x16 residuals of every MB of N sessions, each against its
        ``ref`` (recon planes); every input and output has the session axis.
        A band's planes start at MB row ``mb_row0`` of the taller ``ref``
        (``motion``)."""
        q, qc = self.q(qp), self.q(chroma_qp(qp))
        mvs = self.motion(y, ref[0], mb_row0)
        pred_y, pred_u, pred_v = self.compensate(mvs, *ref, mb_row0=mb_row0)
        wy = fdct4(_blocks(y.to(_I32) - pred_y, 4), self.precision)
        luma_ac = q.quant4(wy, False)
        rec_y = (_unblocks(idct4(q.dequant4(luma_ac))) + pred_y).clamp(0, 255)

        def chroma(plane, pred):
            wc = fdct4(_blocks(plane.to(_I32) - pred, 2), self.precision)
            dc = qc.quant_chroma_dc(wc[..., 0, 0], False)
            ac = qc.quant4(wc, False)
            d = qc.dequant4(ac)
            d[..., 0, 0] = qc.dequant_chroma_dc(dc)
            return dc, ac, (_unblocks(idct4(d)) + pred).clamp(0, 255)

        udc, uac, ru = chroma(u, pred_u)
        vdc, vac, rv = chroma(v, pred_v)
        return {"mvs": mvs, "luma_ac": luma_ac, "chroma_dc": torch.stack([udc, vdc], -3),
                "chroma_ac": torch.stack([uac, vac], -5), "qp": qp,
                "recon": (rec_y.to(torch.uint8), ru.to(torch.uint8), rv.to(torch.uint8))}
