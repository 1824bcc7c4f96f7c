"""CAVLC slice data of the reference (ISO/IEC 14496-10 9.2 and 7.3.5), in NumPy.

Every residual block of a picture is coded at once: each block becomes a
row of (code, length) elements (coeff_token, trailing-one signs, levels,
total_zeros, run_before), each macroblock a row of header elements and
its blocks, and the picture the concatenation of those rows in raster
order, with unused elements at length 0. ``pack_i`` and ``pack_p`` return
the slice NAL of an IDR and of a P frame.

Mode policy of the encoder that is coded here: Intra16x16 with every AC
block coded when any AC level is nonzero; P_L0_16x16 or P_Skip, one
reference index, full-pel vectors; one QP per slice (mb_qp_delta 0).
"""

from __future__ import annotations

import numpy as np

from reference import bitstream as bs
from reference.tables import (
    CHROMA_BLOCK_ORDER,
    LUMA_BLOCK_ORDER,
    ZIGZAG_FLAT,
    coeff_token_code,
    run_before_code,
    total_zeros_code,
)

# coded_block_pattern -> codeNum for inter MBs (table 9-4)
INTER_CBP = np.array([
    0, 2, 3, 7, 4, 8, 17, 13, 5, 18, 9, 14, 10, 15, 16, 11,
    1, 32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6, 24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12,
])


def _lut():
    """coeff_token by (table, TotalCoeff, T1s); tables 0: 0<=nC<2, 1: 2<=nC<4,
    2: 4<=nC<8, 3: chroma DC (nC -1); total_zeros by (TotalCoeff, zeros) for
    4x4 and chroma DC blocks; run_before by (min(zerosLeft, 7), run)."""
    ct = np.zeros((2, 4, 17, 4), np.int64)
    for t, nc in enumerate((0, 2, 4, -1)):
        for tc in range(17 if nc != -1 else 5):
            for t1 in range(min(3, tc) + 1):
                code = coeff_token_code(nc, tc, t1)
                ct[:, t, tc, t1] = code
    tz = np.zeros((2, 2, 17, 16), np.int64)
    for tc in range(1, 16):
        for z in range(17 - tc):
            tz[:, 0, tc, z] = total_zeros_code(tc, z)
    for tc in range(1, 4):
        for z in range(5 - tc):
            tz[:, 1, tc, z] = total_zeros_code(tc, z, chroma_dc=True)
    rb = np.zeros((2, 8, 15), np.int64)
    for zl in range(1, 8):
        for run in range(min(zl, 14) + 1 if zl < 7 else 15):
            rb[:, zl, run] = run_before_code(zl if zl < 7 else 7, run)
    return ct, tz, rb


_CT, _TZ, _RB = _lut()


def ue(v):
    """(code, length) of ue(v) for an int array."""
    code = np.asarray(v, np.int64) + 1
    n = np.zeros_like(code)
    x = code.copy()
    while (x > 0).any():
        n += x > 0
        x >>= 1
    return code, 2 * n - 1


def se(v):
    v = np.asarray(v, np.int64)
    return ue(np.where(v > 0, 2 * v - 1, -2 * v))


def _level(lc, sl):
    """(code, length) of level_prefix + level_suffix (9.2.2.1)."""
    code = np.zeros_like(lc)
    ln = np.zeros_like(lc)
    small = (sl == 0) & (lc < 14)
    code[small], ln[small] = 1, lc[small] + 1
    p14 = (sl == 0) & (lc >= 14) & (lc < 30)
    code[p14], ln[p14] = (1 << 4) | (lc[p14] - 14), 19
    rest = ~(small | p14)
    lc2 = np.where((sl == 0) & rest, lc - 15, lc)
    reg = rest & (lc2 < (15 << sl))
    code[reg] = (1 << sl[reg]) | (lc2[reg] & ((1 << sl[reg]) - 1))
    ln[reg] = (lc2[reg] >> sl[reg]) + 1 + sl[reg]
    esc = rest & ~reg
    e = lc2 - (15 << sl)
    e12 = esc & (e < 4096)
    code[e12], ln[e12] = (1 << 12) | e[e12], 28
    todo = esc & ~e12
    prefix = 16
    while todo.any():
        base = (15 << sl) + (1 << (prefix - 3)) - 4096
        hit = todo & (lc2 - base < (1 << (prefix - 3)))
        code[hit] = (1 << (prefix - 3)) | (lc2[hit] - base[hit])
        ln[hit] = prefix + 1 + prefix - 3
        todo &= ~hit
        prefix += 1
    return code, ln


def blocks(levels: np.ndarray, nc: np.ndarray, chroma_dc: bool = False):
    """CAVLC residual blocks: levels (B, n) in scan order, nC (B,) ->
    (codes, lengths) (B, 2n + 4) and TotalCoeff (B,). An empty block is
    its coeff_token alone; only the others go through the level loops."""
    lv = levels.astype(np.int64)
    nb, n = lv.shape
    total = (lv != 0).sum(1)
    codes = np.zeros((nb, 2 * n + 4), np.int64)
    lens = np.zeros_like(codes)
    tab = np.where(chroma_dc, 3, np.where(nc < 2, 0, np.where(nc < 4, 1, 2)))
    codes[:, 0], lens[:, 0] = _CT[0, tab, 0, 0], _CT[1, tab, 0, 0]
    big = (nc >= 8) & (not chroma_dc)
    codes[big, 0], lens[big, 0] = 3, 6
    live = np.flatnonzero(total)
    if len(live):
        codes[live], lens[live] = _coded(lv[live], nc[live], total[live], chroma_dc)
    return codes, lens, total


def _coded(lv, nc, total, chroma_dc: bool):
    """``blocks`` for blocks with at least one nonzero level."""
    nb, n = lv.shape
    nz = lv != 0
    pos = np.arange(n)
    # nonzero positions and values, last in scan order first
    order = np.argsort(-np.where(nz, pos, -1), axis=1, kind="stable")
    val = np.take_along_axis(lv, order, 1)
    at = np.take_along_axis(np.broadcast_to(pos, lv.shape), order, 1)
    is1 = (np.abs(val) == 1) & (pos[None, :] < total[:, None])
    t1 = np.cumprod(is1[:, :3], axis=1).sum(1)

    codes = np.zeros((nb, 2 * n + 4), np.int64)
    lens = np.zeros_like(codes)
    tab = np.where(chroma_dc, 3, np.where(nc < 2, 0, np.where(nc < 4, 1, 2)))
    codes[:, 0], lens[:, 0] = _CT[0, tab, total, t1], _CT[1, tab, total, t1]
    big = (nc >= 8) & (not chroma_dc)
    codes[big, 0], lens[big, 0] = ((total[big] - 1) << 2) | t1[big], 6
    for k in range(3):
        on = k < t1
        codes[on, 1 + k], lens[on, 1 + k] = (val[on, k] < 0), 1
    sl = np.where((total > 10) & (t1 < 3), 1, 0)
    for k in range(n):
        on = (k >= t1) & (k < total)
        if not on.any():
            continue
        v = val[on, k]
        lc = np.where(v > 0, 2 * v - 2, -2 * v - 1) - 2 * ((k == t1[on]) & (t1[on] < 3))
        s = sl[on]
        codes[on, 4 + k], lens[on, 4 + k] = _level(lc, s)
        s = np.where(s == 0, 1, s)
        sl[on] = np.where((np.abs(v) > (3 << (s - 1))) & (s < 6), s + 1, s)
    zeros = at[:, 0] + 1 - total
    on = total < n
    kind = 1 if chroma_dc else 0
    codes[on, 4 + n] = _TZ[0, kind, total[on], zeros[on]]
    lens[on, 4 + n] = _TZ[1, kind, total[on], zeros[on]]
    left = zeros.copy()
    for k in range(n - 1):
        on = (k < total - 1) & (left > 0)
        if not on.any():
            continue
        run = at[on, k] - at[on, k + 1] - 1
        zl = np.minimum(left[on], 7)
        codes[on, 5 + n + k], lens[on, 5 + n + k] = _RB[0, zl, run], _RB[1, zl, run]
        left[on] -= run
    return codes, lens


def _nc(counts: np.ndarray) -> np.ndarray:
    """nC of every 4x4 block from its left and upper neighbours' TotalCoeff."""
    h, w = counts.shape
    left = np.zeros_like(counts)
    top = np.zeros_like(counts)
    left[:, 1:], top[1:, :] = counts[:, :-1], counts[:-1, :]
    has_l = np.arange(w)[None, :] > 0
    has_t = np.arange(h)[:, None] > 0
    both = has_l & has_t
    return np.where(both, (left + top + 1) >> 1, np.where(has_l, left, np.where(has_t, top, 0)))


def _zigzag(x: np.ndarray) -> np.ndarray:
    return x.reshape(*x.shape[:-2], 16)[..., ZIGZAG_FLAT]


def _luma_grid(x):
    """(mbh, mbw, 4, 4) per-MB raster [y4][x4] -> the (4mbh, 4mbw) block grid."""
    mbh, mbw = x.shape[:2]
    return x.transpose(0, 2, 1, 3).reshape(mbh * 4, mbw * 4)


def _grid_of(mbh: int, mbw: int, n: int, order):
    """Block-grid (row, col) of each MB's blocks in coding order: (mbh, mbw, k)."""
    ys = np.array([y for x, y in order])
    xs = np.array([x for x, y in order])
    r = np.arange(mbh)[:, None, None] * n + ys
    c = np.arange(mbw)[None, :, None] * n + xs
    return np.broadcast_to(r, (mbh, mbw, len(order))), np.broadcast_to(c, (mbh, mbw, len(order)))


def _residual(levels, counts_grid, order, n, mbh, mbw, coded):
    """Code one kind of 4x4 block: levels (mbh, mbw, k, n) in coding order;
    nC from ``counts_grid`` (n x n blocks a MB); ``coded`` (mbh, mbw, k)."""
    r, c = _grid_of(mbh, mbw, n, order)
    nc = _nc(counts_grid)[r, c]
    k = levels.shape[2]
    codes, lens, _ = blocks(levels.reshape(-1, levels.shape[-1]), nc.reshape(-1))
    lens[~coded.reshape(-1)] = 0
    return codes.reshape(mbh, mbw, -1), lens.reshape(mbh, mbw, -1), k


def _totals(levels):
    return (levels != 0).sum(-1)


def _chroma_parts(chroma_dc, chroma_ac_scan, cbp_c, mbh, mbw):
    """Chroma DC (both components) and AC (Cb's 4 blocks then Cr's)."""
    dc = chroma_dc.reshape(mbh, mbw, 2, 4)
    dcc, dcl, _ = blocks(dc.reshape(-1, 4), np.full(mbh * mbw * 2, -1), chroma_dc=True)
    dcl[~np.repeat((cbp_c > 0).reshape(-1), 2)] = 0
    parts = [(dcc.reshape(mbh, mbw, -1), dcl.reshape(mbh, mbw, -1))]
    for comp in range(2):
        ac = np.stack([chroma_ac_scan[:, :, comp, y, x, 1:] for x, y in CHROMA_BLOCK_ORDER], 2)
        grid = _chroma_grid(_totals(chroma_ac_scan[:, :, comp, :, :, 1:]))
        coded = np.broadcast_to((cbp_c == 2)[..., None], (mbh, mbw, 4))
        c, ln, _ = _residual(ac, grid, CHROMA_BLOCK_ORDER, 2, mbh, mbw, coded)
        parts.append((c, ln))
    return parts


def _chroma_grid(x):
    """(mbh, mbw, 2, 2) per-MB raster -> the (2mbh, 2mbw) block grid."""
    mbh, mbw = x.shape[:2]
    return x.transpose(0, 2, 1, 3).reshape(mbh * 2, mbw * 2)


def _cbp_chroma(chroma_dc, chroma_ac_scan):
    ac = (chroma_ac_scan[..., 1:] != 0).reshape(*chroma_ac_scan.shape[:2], -1).any(-1)
    dc = (chroma_dc != 0).reshape(*chroma_dc.shape[:2], -1).any(-1)
    return np.where(ac, 2, np.where(dc, 1, 0))


def _slice(header: bs.Bits, parts, tail=None) -> np.ndarray:
    codes = np.concatenate([p[0] for p in parts], axis=2).reshape(-1)
    lens = np.concatenate([p[1] for p in parts], axis=2).reshape(-1)
    if tail is not None:
        codes, lens = np.append(codes, tail[0]), np.append(lens, tail[1])
    return np.concatenate([header.array(), bs.expand(codes, lens)])


def pack_i(fc: dict, s: bs.Stream, *, frame_num: int = 0, idr_pic_id: int = 0,
           first_mb: int = 0) -> bytes:
    """IDR slice NAL from the reference's Intra16x16 levels (numpy arrays);
    ``first_mb`` places a band's slice in its picture."""
    mbh, mbw = fc["luma_mode"].shape
    ac_scan = _zigzag(fc["luma_ac"])                        # (mbh, mbw, 4, 4, 16)
    c_scan = _zigzag(fc["chroma_ac"])                       # (mbh, mbw, 2, 2, 2, 16)
    cbp_l = (ac_scan[..., 1:] != 0).reshape(mbh, mbw, -1).any(-1)
    cbp_c = _cbp_chroma(fc["chroma_dc"], c_scan)
    hdr = np.zeros((mbh, mbw, 3, 2), np.int64)
    mb_type = 1 + fc["luma_mode"] + 4 * cbp_c + 12 * cbp_l
    hdr[:, :, 0] = np.stack(ue(mb_type), -1)
    hdr[:, :, 1] = np.stack(ue(fc["chroma_mode"]), -1)
    hdr[:, :, 2] = np.stack(se(np.zeros_like(mb_type)), -1)
    grid = _luma_grid(_totals(ac_scan[..., 1:]) * cbp_l[..., None, None])
    # Intra16x16 DC: nC of luma block 0 from the neighbours' AC totals
    nc0 = _nc(grid)[::4, ::4]
    dcc, dcl, _ = blocks(_zigzag(fc["luma_dc"]).reshape(-1, 16), nc0.reshape(-1))
    ac = np.stack([ac_scan[:, :, y, x, 1:] for x, y in LUMA_BLOCK_ORDER], 2)
    coded = np.broadcast_to(cbp_l[..., None], (mbh, mbw, 16))
    lc, ll, _ = _residual(ac, grid, LUMA_BLOCK_ORDER, 4, mbh, mbw, coded)
    parts = [(hdr[..., 0], hdr[..., 1]), (dcc.reshape(mbh, mbw, -1), dcl.reshape(mbh, mbw, -1)),
             (lc, ll), *_chroma_parts(fc["chroma_dc"], c_scan, cbp_c, mbh, mbw)]
    h = bs.slice_header(s, idr=True, frame_num=frame_num, qp=int(fc["qp"]),
                        idr_pic_id=idr_pic_id, first_mb=first_mb)
    return bs.nal(3, bs.NAL_IDR, _slice(h, parts))


def _neighbours(mvs):
    """A (left), B (top), C (top-right, else top-left D) vectors and their
    availability over one slice's MB grid (8.4.1.3): a slice's top row has
    no neighbours above, whether it is the picture's or a band's."""
    mbh, mbw = mvs.shape[:2]
    z = np.zeros_like(mvs)
    a, b, c, d = z.copy(), z.copy(), z.copy(), z.copy()
    a[:, 1:], b[1:, :] = mvs[:, :-1], mvs[:-1, :]
    c[1:, :-1], d[1:, 1:] = mvs[:-1, 1:], mvs[:-1, :-1]
    col, row = np.arange(mbw)[None, :], np.arange(mbh)[:, None]
    ha = np.broadcast_to(col > 0, (mbh, mbw))
    hb = np.broadcast_to(row > 0, (mbh, mbw))
    hc = (row > 0) & (col + 1 < mbw)
    hd = (row > 0) & (col > 0)
    use_d = ~hc & hd
    c = np.where(use_d[..., None], d, c)
    hc = hc | use_d
    return a, b, c, ha, hb, hc


def mv_pred(mvs):
    a, b, c, ha, hb, hc = _neighbours(mvs)
    med = np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))
    n = ha.astype(int) + hb + hc
    only = np.where(ha[..., None], a, np.where(hb[..., None], b, c))
    pred = np.where((n == 1)[..., None], only, med)
    return np.where((ha & ~hb & ~hc)[..., None], a, pred)


def skip_mv(mvs):
    mbh, mbw = mvs.shape[:2]
    a, b, _, _, _, _ = _neighbours(mvs)
    col, row = np.arange(mbw)[None, :], np.arange(mbh)[:, None]
    zero = (col == 0) | (row == 0) | (a == 0).all(-1) | (b == 0).all(-1)
    return np.where(zero[..., None], 0, mv_pred(mvs))


def pack_p(fc: dict, s: bs.Stream, *, frame_num: int, ltr_ref=None,
           marking: bs.Marking = bs.Marking(), all_skip: bool = False,
           first_mb: int = 0) -> bytes:
    """P slice NAL: P_Skip where the residual is zero and the vector is the
    skip vector (8.4.1.1), else P_L0_16x16 with its mvd and residual.
    ``all_skip`` skips the ``s.mbw * s.mbh`` MBs of ``s``; ``first_mb``
    places a band's slice in its picture."""
    h = bs.slice_header(s, idr=False, frame_num=frame_num, qp=int(fc["qp"]),
                        ltr_ref=ltr_ref, marking=marking, first_mb=first_mb)
    if all_skip:
        c, ln = ue(s.mbw * s.mbh)
        return bs.nal(3, bs.NAL_SLICE, np.concatenate([h.array(), bs.expand(c, ln)]))
    mvs = fc["mvs"].astype(np.int64)
    mbh, mbw = mvs.shape[:2]
    l_scan = _zigzag(fc["luma_ac"])                          # (mbh, mbw, 4, 4, 16)
    c_scan = _zigzag(fc["chroma_ac"])
    cbp_c = _cbp_chroma(fc["chroma_dc"], c_scan)
    q8 = (l_scan != 0).reshape(mbh, mbw, 2, 2, 2, 2, 16).any(axis=(3, 5, 6))  # [y8][x8]
    cbp_l = (q8.reshape(mbh, mbw, 4) * (1 << np.arange(4))).sum(-1)
    # P_Skip needs every level zero, the AC quantiser's DC position included
    resid_zero = ~((l_scan != 0).reshape(mbh, mbw, -1).any(-1)
                   | (fc["chroma_dc"] != 0).reshape(mbh, mbw, -1).any(-1)
                   | (fc["chroma_ac"] != 0).reshape(mbh, mbw, -1).any(-1))
    skip = resid_zero & (mvs == skip_mv(mvs)).all(-1)
    coded = ~skip
    flat = coded.reshape(-1)
    idx = np.flatnonzero(flat)
    run = np.zeros(mbh * mbw, np.int64)
    run[idx] = idx - np.concatenate([[-1], idx[:-1]]) - 1
    cbp = cbp_l | (cbp_c << 4)
    mvd = 4 * (mvs - mv_pred(mvs))
    hdr = np.zeros((mbh, mbw, 6, 2), np.int64)
    for k, (c, ln) in enumerate((ue(run.reshape(mbh, mbw)), ue(np.zeros((mbh, mbw), int)),
                                 se(mvd[..., 0]), se(mvd[..., 1]), ue(INTER_CBP[cbp]),
                                 se(np.zeros((mbh, mbw), int)))):
        hdr[:, :, k, 0], hdr[:, :, k, 1] = c, ln
    hdr[:, :, 5, 1] *= cbp > 0
    hdr[..., 1] *= coded[..., None]
    grid = _luma_grid(_totals(l_scan))
    lv = np.stack([l_scan[:, :, y, x] for x, y in LUMA_BLOCK_ORDER], 2)
    b8 = np.array([(y >> 1) * 2 + (x >> 1) for x, y in LUMA_BLOCK_ORDER])
    lcoded = ((cbp_l[..., None] >> b8) & 1).astype(bool) & coded[..., None]
    lc, ll, _ = _residual(lv, grid, LUMA_BLOCK_ORDER, 4, mbh, mbw, lcoded)
    parts = [(hdr[..., 0], hdr[..., 1]), (lc, ll),
             *_chroma_parts(fc["chroma_dc"], c_scan, cbp_c * coded, mbh, mbw)]
    tail_run = mbh * mbw - 1 - (idx[-1] if len(idx) else -1)
    tail = ue(tail_run) if tail_run else None
    return bs.nal(3, bs.NAL_SLICE, _slice(h, parts, tail))
