"""Copy of ``selkies_tpu/models/h264/cabac.py``, kept so the port imports nothing of the JAX package.

CABAC entropy coding (ISO 14496-10 §9.3): coefficients → Main-profile NAL.

Second entropy backend behind the two-pass device split. The
coder is layered around a 16-bit *token* IR so every producer feeds one
sequential arithmetic engine:

  binarization (+ context-index derivation)  →  tokens  →  engine  →  bytes

Producers of tokens:
  * this module's Python binarizers (`pack_slice_cabac`,
    `pack_slice_p_cabac`) — the readable spec and the host coder when
    device entropy is off;
  * device_cabac.py — the same binarization data-parallel on device over
    the shared structure pass (only emission differs from CAVLC).

Consumers of tokens:
  * `encode_tokens_py` — the reference arithmetic engine (9.3.4.2
    flowcharts, verbatim), the tests' oracle only;
  * native/cabac_pack.cc via native.cabac_encode_tokens — the engine
    every slice goes through, byte-identical by test.

Token format (uint16, see also native/cabac_pack.cc):
  bits [1:0] type — 0 REG   regular bin:   bin=bit2,   ctx=bits[12:3]
                    1 RUN   n regular bins, same ctx/value: n=bits[16:13]
                    2 BYP   bypass bins:   n=bits[5:2] (1..10),
                                           values MSB-first in bits[15:6]
                    3 TERM  end-of-slice/terminate bin: bin=bit2
  RUN exists for the device emitter (TU prefixes as one slot); n REG
  tokens and one RUN(n) produce identical engine state by construction.

Context subset: this encoder emits only I_16x16 and P_Skip/P_L0_16x16
macroblocks (see cavlc.py), so of the 1024 spec contexts only
0..275 + the terminate bin are reachable: mb_type (3..10), skip (11..13),
P mb_type (14..16), mvd (40..53), qp_delta (60), chroma pred (64..67),
cbp (73..84), coded_block_flag (85..104), significant/last (105..226),
levels (227..265).
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
from selkies_tpu_torch.models.h264.cabac_tables import (
    INIT_I,
    INIT_PB,
    RANGE_LPS,
    TRANS_LPS,
)
from selkies_tpu_torch.models.h264.numpy_ref import FrameCoeffs, PFrameCoeffs, mv_pred_16x16
from selkies_tpu_torch.models.h264.tables import (
    CHROMA_BLOCK_ORDER,
    LUMA_BLOCK_ORDER,
    ZIGZAG_FLAT,
)
from selkies_tpu_torch.utils.bits import BitWriter

__all__ = [
    "N_STATES", "TOK_REG", "TOK_RUN", "TOK_BYP", "TOK_TERM",
    "tok_reg", "tok_run", "tok_term", "init_states", "encode_tokens_py",
    "TokenWriter", "pack_slice_cabac", "pack_slice_p_cabac",
    "mb_tokens_i16", "mb_tokens_p", "skip_ctx_inc", "finish_cabac_nal",
]

N_STATES = 276  # regular contexts we ever touch (terminate needs no state)

TOK_REG, TOK_RUN, TOK_BYP, TOK_TERM = 0, 1, 2, 3


def tok_reg(ctx: int, b: int) -> int:
    return TOK_REG | ((b & 1) << 2) | (ctx << 3)


def tok_run(ctx: int, b: int, n: int) -> int:
    return TOK_RUN | ((b & 1) << 2) | (ctx << 3) | (n << 13)


def tok_term(b: int) -> int:
    return TOK_TERM | ((b & 1) << 2)


def _clip3(lo: int, hi: int, v: int) -> int:
    return lo if v < lo else hi if v > hi else v


def init_states(qp: int, slice_type: int, cabac_init_idc: int = 0) -> np.ndarray:
    """(N_STATES, 2) uint8 [pStateIdx, valMPS] per 9.3.1.1."""
    table = INIT_I if slice_type == SLICE_I else INIT_PB[cabac_init_idc]
    out = np.empty((N_STATES, 2), np.uint8)
    q = _clip3(0, 51, qp)
    for ctx in range(N_STATES):
        m, n = table[ctx]
        pre = _clip3(1, 126, ((m * q) >> 4) + n)
        if pre <= 63:
            out[ctx] = (63 - pre, 0)
        else:
            out[ctx] = (pre - 64, 1)
    return out


def encode_tokens_py(states: np.ndarray, tokens) -> bytes:
    """Reference binary arithmetic engine (9.3.4.2). `states` is consumed
    as a working copy; the stream must end with a TERM(1) token (the
    end-of-slice flush, whose final written bit doubles as the
    rbsp_stop_one_bit) and the returned bytes are zero-padded to a byte
    boundary, ready to append to an aligned slice header."""
    st = [(int(s), int(m)) for s, m in states]
    low, rng, outstanding = 0, 510, 0
    first = True
    out = bytearray()
    acc, nacc = 0, 0

    def emit(b):
        nonlocal acc, nacc
        acc = (acc << 1) | b
        nacc += 1
        if nacc == 8:
            out.append(acc)
            acc, nacc = 0, 0

    def put_bit(b):
        nonlocal first, outstanding
        if first:
            first = False
        else:
            emit(b)
        while outstanding:
            emit(1 - b)
            outstanding -= 1

    def renorm():
        nonlocal low, rng, outstanding
        while rng < 256:
            if low < 256:
                put_bit(0)
            elif low >= 512:
                low -= 512
                put_bit(1)
            else:
                low -= 256
                outstanding += 1
            low <<= 1
            rng <<= 1

    def decision(ctx, b):
        nonlocal low, rng
        s, mps = st[ctx]
        lps = RANGE_LPS[s][(rng >> 6) & 3]
        rng -= lps
        if b != mps:
            low += rng
            rng = lps
            if s == 0:
                mps ^= 1
            st[ctx] = (TRANS_LPS[s], mps)
        else:
            st[ctx] = (s + 1 if s < 62 else 62, mps)
        renorm()

    def bypass(b):
        nonlocal low, outstanding
        low <<= 1
        if b:
            low += rng
        if low >= 1024:
            put_bit(1)
            low -= 1024
        elif low < 512:
            put_bit(0)
        else:
            low -= 512
            outstanding += 1

    flushed = False
    for t in tokens:
        t = int(t)
        kind = t & 3
        if kind == TOK_REG:
            decision((t >> 3) & 0x3FF, (t >> 2) & 1)
        elif kind == TOK_RUN:
            ctx, b = (t >> 3) & 0x3FF, (t >> 2) & 1
            for _ in range(t >> 13):
                decision(ctx, b)
        elif kind == TOK_BYP:
            n = (t >> 2) & 0xF
            v = t >> 6
            for i in range(n - 1, -1, -1):
                bypass((v >> i) & 1)
        else:  # TERM
            rng -= 2
            if (t >> 2) & 1:
                low += rng
                rng = 2
                renorm()
                put_bit((low >> 9) & 1)
                emit((low >> 8) & 1)
                emit(1)  # rbsp_stop_one_bit
                flushed = True
            else:
                renorm()
    if not flushed:
        raise ValueError("token stream did not end in a TERM(1) flush")
    while nacc:
        emit(0)  # alignment zero bits after the stop bit
    return bytes(out)


class TokenWriter:
    """Accumulates tokens; splits oversized runs/bypass groups."""

    __slots__ = ("toks",)

    def __init__(self) -> None:
        self.toks: list[int] = []

    def reg(self, ctx: int, b: int) -> None:
        self.toks.append(TOK_REG | ((b & 1) << 2) | (ctx << 3))

    def bypass_bits(self, value: int, nbits: int) -> None:
        while nbits > 0:
            n = min(nbits, 10)
            chunk = (value >> (nbits - n)) & ((1 << n) - 1)
            self.toks.append(TOK_BYP | (n << 2) | (chunk << 6))
            nbits -= n

    def term(self, b: int) -> None:
        self.toks.append(TOK_TERM | ((b & 1) << 2))

    def array(self) -> np.ndarray:
        return np.asarray(self.toks, np.uint16)


# ---------------------------------------------------------------- binarization

_SIG_OFF = (0, 15, 29, 44, 47)   # ctxBlockCat offsets for sig/last maps
_LVL_OFF = (0, 10, 20, 30, 39)   # ... for coeff_abs_level_minus1


def _residual_tokens(tw: TokenWriter, coeffs, cat: int, cbf_inc: int) -> int:
    """One residual_block_cabac (7.3.5.3.3): coded_block_flag,
    significance map, levels in reverse scan order. Returns the
    coded_block_flag (for the neighbour cbf grids)."""
    nz = [i for i, c in enumerate(coeffs) if c]
    cbf = 1 if nz else 0
    tw.reg(85 + 4 * cat + cbf_inc, cbf)
    if not cbf:
        return 0
    n = len(coeffs)
    last = nz[-1]
    soff, loff = 105 + _SIG_OFF[cat], 166 + _SIG_OFF[cat]
    nzset = set(nz)
    for i in range(min(last + 1, n - 1)):
        inc = min(i, 2) if cat == 3 else i
        sig = 1 if i in nzset else 0
        tw.reg(soff + inc, sig)
        if sig:
            tw.reg(loff + inc, 1 if i == last else 0)
    base = 227 + _LVL_OFF[cat]
    eq1 = gt1 = 0
    for i in reversed(nz):
        level = int(coeffs[i])
        mag = abs(level)
        m = min(mag - 1, 14)
        c0 = base + (0 if gt1 else min(4, 1 + eq1))
        c1 = base + 5 + min(4 - (1 if cat == 3 else 0), gt1)
        tw.reg(c0, 1 if m > 0 else 0)
        for _ in range(m - 1):
            tw.reg(c1, 1)
        if 0 < m < 14:
            tw.reg(c1, 0)
        if mag - 1 >= 14:  # UEG0 escape suffix, bypass
            v = mag - 1 - 14
            k = 0
            while v >= (1 << k):
                tw.bypass_bits(1, 1)
                v -= 1 << k
                k += 1
            tw.bypass_bits(0, 1)
            if k:
                tw.bypass_bits(v, k)
        tw.bypass_bits(1 if level < 0 else 0, 1)
        if mag > 1:
            gt1 += 1
        else:
            eq1 += 1
    return 1


def _mvd_tokens(tw: TokenWriter, mvd: int, comp: int, abs_a: int, abs_b: int) -> None:
    """UEG3 (uCoff 9) mvd binarization; ctx 40/47 + neighbour-sum inc."""
    base = 40 if comp == 0 else 47
    s = abs_a + abs_b
    inc = 0 if s < 3 else (2 if s > 32 else 1)
    a = abs(mvd)
    m = min(a, 9)
    ctx_of = lambda j: base + (inc if j == 0 else 3 + min(j - 1, 3))  # noqa: E731
    for j in range(m):
        tw.reg(ctx_of(j), 1)
    if m < 9:
        tw.reg(ctx_of(m), 0)
    if a >= 9:  # EG3 suffix, bypass
        v = a - 9
        k = 3
        while v >= (1 << k):
            tw.bypass_bits(1, 1)
            v -= 1 << k
            k += 1
        tw.bypass_bits(0, 1)
        tw.bypass_bits(v, k)
    if a:
        tw.bypass_bits(1 if mvd < 0 else 0, 1)


def skip_ctx_inc(skip, mbx: int, mby: int) -> int:
    """mb_skip_flag ctxIdxInc: available-and-not-skipped neighbours."""
    inc = 0
    if mbx > 0 and not skip[mby, mbx - 1]:
        inc += 1
    if mby > 0 and not skip[mby - 1, mbx]:
        inc += 1
    return inc


class _CbfGrids:
    """Neighbour coded_block_flag state for one slice.

    Grid cells hold the *transmitted* cbf where the block was coded and
    0 where it was absent (skip MB / cbp bit clear) — which is exactly
    condTermFlagN for an available neighbour (9.3.3.1.1.9: a missing
    transform block reads as 0 unless the edge rules below apply).
    Out-of-slice neighbours read 1 for intra macroblocks, 0 for inter.
    """

    def __init__(self, mbh: int, mbw: int) -> None:
        self.luma_dc = np.zeros((mbh, mbw), np.int8)
        self.luma = np.zeros((mbh * 4, mbw * 4), np.int8)
        self.chroma_dc = np.zeros((2, mbh, mbw), np.int8)
        self.chroma = np.zeros((2, mbh * 2, mbw * 2), np.int8)

    @staticmethod
    def inc(grid, bx: int, by: int, intra: bool) -> int:
        edge = 1 if intra else 0
        a = grid[by, bx - 1] if bx > 0 else edge
        b = grid[by - 1, bx] if by > 0 else edge
        return int(a) + 2 * int(b)


def _cbp_tokens(tw: TokenWriter, cbp_luma: int, cbp_chroma: int,
                cl_left: int, cl_top: int, cc_left: int, cc_top: int) -> None:
    """coded_block_pattern: FL4 luma prefix + TU2 chroma suffix.

    cl_left/cl_top are the neighbouring MBs' CodedBlockPatternLuma with
    unavailable neighbours passed as 15 (an absent neighbour reads as
    coded, condTermFlag 0); cc_* are neighbouring CodedBlockPatternChroma
    with unavailable as 0.
    """
    # luma bit 0: A = left MB bit 1, B = top MB bit 2
    c = (0 if (cl_left >> 1) & 1 else 1) + 2 * (0 if (cl_top >> 2) & 1 else 1)
    tw.reg(73 + c, cbp_luma & 1)
    c = (0 if cbp_luma & 1 else 1) + 2 * (0 if (cl_top >> 3) & 1 else 1)
    tw.reg(73 + c, (cbp_luma >> 1) & 1)
    c = (0 if (cl_left >> 3) & 1 else 1) + 2 * (0 if cbp_luma & 1 else 1)
    tw.reg(73 + c, (cbp_luma >> 2) & 1)
    c = (0 if (cbp_luma >> 2) & 1 else 1) + 2 * (0 if (cbp_luma >> 1) & 1 else 1)
    tw.reg(73 + c, (cbp_luma >> 3) & 1)
    c = (1 if cc_left else 0) + 2 * (1 if cc_top else 0)
    tw.reg(77 + c, 1 if cbp_chroma else 0)
    if cbp_chroma:
        c = (1 if cc_left == 2 else 0) + 2 * (1 if cc_top == 2 else 0)
        tw.reg(81 + c, 1 if cbp_chroma == 2 else 0)


def _mb_residual_tokens(tw, grids, mbx, mby, intra, cbp_luma, cbp_chroma,
                        luma_dc_scan, luma_scan, chroma_dc, chroma_scan,
                        luma_from: int) -> None:
    """Shared residual walk for I16 (luma_from=1, cat 0/1 + always-on DC)
    and inter (luma_from=0, cat 2) macroblocks."""
    if intra:
        inc = _CbfGrids.inc(grids.luma_dc, mbx, mby, intra)
        grids.luma_dc[mby, mbx] = _residual_tokens(tw, luma_dc_scan, 0, inc)
    cat_l = 1 if intra else 2
    for x4, y4 in LUMA_BLOCK_ORDER:
        b8 = (y4 >> 1) * 2 + (x4 >> 1)
        if not cbp_luma & (1 << b8):
            continue
        bx, by = mbx * 4 + x4, mby * 4 + y4
        inc = _CbfGrids.inc(grids.luma, bx, by, intra)
        grids.luma[by, bx] = _residual_tokens(
            tw, luma_scan[y4, x4, luma_from:], cat_l, inc)
    if cbp_chroma:
        for comp in range(2):
            inc = _CbfGrids.inc(grids.chroma_dc[comp], mbx, mby, intra)
            grids.chroma_dc[comp, mby, mbx] = _residual_tokens(
                tw, chroma_dc[comp].reshape(4), 3, inc)
    if cbp_chroma == 2:
        for comp in range(2):
            for x4, y4 in CHROMA_BLOCK_ORDER:
                bx, by = mbx * 2 + x4, mby * 2 + y4
                inc = _CbfGrids.inc(grids.chroma[comp], bx, by, intra)
                grids.chroma[comp, by, bx] = _residual_tokens(
                    tw, chroma_scan[comp, y4, x4, 1:], 4, inc)


def mb_tokens_i16(tw, grids, chroma_modes, mbx, mby, luma_mode, chroma_mode,
                  cbp_luma, cbp_chroma, luma_dc_scan, luma_scan, chroma_dc,
                  chroma_scan) -> None:
    """One I_16x16 macroblock_layer's tokens (9.3.2.5 Table 9-36 mb_type
    binarization: prefix 1, I_PCM terminate 0, cbp/predMode suffix)."""
    inc = (1 if mbx > 0 else 0) + (1 if mby > 0 else 0)
    tw.reg(3 + inc, 1)
    tw.term(0)  # the I_PCM escape is a terminate bin
    tw.reg(6, 1 if cbp_luma else 0)
    tw.reg(7, 1 if cbp_chroma else 0)
    if cbp_chroma:
        tw.reg(8, 1 if cbp_chroma == 2 else 0)
    tw.reg(9, (luma_mode >> 1) & 1)
    tw.reg(10, luma_mode & 1)  # predMode bins: ctx 9 then 10 (9.3.3.1.2
    # conditions both incs on the chroma-CBP bin, already consumed above)
    # intra_chroma_pred_mode: TU cMax 3, ctx 64 + neighbour inc, then 67
    inc = 0
    if mbx > 0 and chroma_modes[mby, mbx - 1]:
        inc += 1
    if mby > 0 and chroma_modes[mby - 1, mbx]:
        inc += 1
    for j in range(chroma_mode):
        tw.reg(64 + inc if j == 0 else 67, 1)
    if chroma_mode < 3:
        tw.reg(64 + inc if chroma_mode == 0 else 67, 0)
    chroma_modes[mby, mbx] = chroma_mode
    tw.reg(60, 0)  # mb_qp_delta (constant QP per slice)
    _mb_residual_tokens(tw, grids, mbx, mby, True, cbp_luma, cbp_chroma,
                        luma_dc_scan, luma_scan, chroma_dc, chroma_scan, 1)


def mb_tokens_p(tw, grids, mbx, mby, mvdx, mvdy, abs_mvd, cbp_luma,
                cbp_chroma, cbp_l_grid, cbp_c_grid, luma_scan, chroma_dc,
                chroma_scan) -> None:
    """One coded P_L0_16x16 macroblock_layer's tokens. `abs_mvd` is the
    per-MB |mvd| grid (skip MBs hold 0); cbp_*_grid the per-MB coded
    block patterns (skip MBs hold 0) — both updated here."""
    tw.reg(14, 0)  # P mb_type prefix: P_L0_16x16 = b(14:0, 15:0, 16:0)
    tw.reg(15, 0)
    tw.reg(16, 0)
    for comp, mvd in ((0, mvdx), (1, mvdy)):
        a = abs_mvd[mby, mbx - 1, comp] if mbx > 0 else 0
        b = abs_mvd[mby - 1, mbx, comp] if mby > 0 else 0
        _mvd_tokens(tw, mvd, comp, int(a), int(b))
    abs_mvd[mby, mbx, 0] = abs(mvdx)
    abs_mvd[mby, mbx, 1] = abs(mvdy)
    cl_left = int(cbp_l_grid[mby, mbx - 1]) if mbx > 0 else 15
    cl_top = int(cbp_l_grid[mby - 1, mbx]) if mby > 0 else 15
    cc_left = int(cbp_c_grid[mby, mbx - 1]) if mbx > 0 else 0
    cc_top = int(cbp_c_grid[mby - 1, mbx]) if mby > 0 else 0
    _cbp_tokens(tw, cbp_luma, cbp_chroma, cl_left, cl_top, cc_left, cc_top)
    cbp_l_grid[mby, mbx] = cbp_luma
    cbp_c_grid[mby, mbx] = cbp_chroma
    if cbp_luma or cbp_chroma:
        tw.reg(60, 0)  # mb_qp_delta
    _mb_residual_tokens(tw, grids, mbx, mby, False, cbp_luma, cbp_chroma,
                        None, luma_scan, chroma_dc, chroma_scan, 0)


# ------------------------------------------------------------------- packers

def _encode_engine(tokens: np.ndarray, qp: int, slice_type: int,
                   cabac_init_idc: int) -> bytes:
    """The arithmetic engine over a slice's token stream: always the
    native coder (``native.cabac_encode_tokens``, which raises when the
    library lacks it). ``encode_tokens_py`` is the tests' oracle only."""
    from selkies_tpu_torch.models.h264 import native

    return native.cabac_encode_tokens(init_states(qp, slice_type, cabac_init_idc), tokens)


def finish_cabac_nal(w: BitWriter, tokens: np.ndarray, qp: int,
                     slice_type: int, cabac_init_idc: int, nal_type: int) -> bytes:
    """Slice header writer state + token stream → Annex-B NAL: alignment
    ones, arithmetic payload, emulation prevention (the native one, equal
    to ``utils.bits.annexb_nal``'s)."""
    from selkies_tpu_torch.models.h264 import native

    w.byte_align(1)  # cabac_alignment_one_bit
    payload = _encode_engine(tokens, qp, slice_type, cabac_init_idc)
    return (b"\x00\x00\x00\x01" + bytes([(3 << 5) | nal_type])
            + native.emulation_prevent(w.get_bytes() + payload))


def pack_slice_cabac(
    fc: FrameCoeffs,
    p: StreamParams,
    frame_num: int = 0,
    idr: bool = True,
    idr_pic_id: int = 0,
    first_mb: int = 0,
) -> bytes:
    """Entropy-code Intra16x16 MBs into one CABAC slice NAL. Mirrors
    cavlc.pack_slice (same grid/band contract: fc may be one band, with
    neighbour availability resetting at the slice's first row)."""
    mbh, mbw = fc.luma_mode.shape
    w = BitWriter()
    write_slice_header(w, p, SLICE_I, frame_num, idr=idr,
                       idr_pic_id=idr_pic_id, slice_qp=fc.qp,
                       first_mb=first_mb)
    luma_ac = fc.luma_ac.reshape(mbh, mbw, 4, 4, 16)[..., ZIGZAG_FLAT]
    chroma_ac = fc.chroma_ac.reshape(mbh, mbw, 2, 2, 2, 16)[..., ZIGZAG_FLAT]
    luma_dc_scan = fc.luma_dc.reshape(mbh, mbw, 16)[..., ZIGZAG_FLAT]

    tw = TokenWriter()
    grids = _CbfGrids(mbh, mbw)
    chroma_modes = np.zeros((mbh, mbw), np.int8)
    last = mbh * mbw - 1
    for mby in range(mbh):
        for mbx in range(mbw):
            cbp_luma = 15 if np.any(luma_ac[mby, mbx, :, :, 1:]) else 0
            if np.any(chroma_ac[mby, mbx, :, :, :, 1:]):
                cbp_chroma = 2
            elif np.any(fc.chroma_dc[mby, mbx]):
                cbp_chroma = 1
            else:
                cbp_chroma = 0
            mb_tokens_i16(tw, grids, chroma_modes, mbx, mby,
                          int(fc.luma_mode[mby, mbx]),
                          int(fc.chroma_mode[mby, mbx]),
                          cbp_luma, cbp_chroma,
                          luma_dc_scan[mby, mbx], luma_ac[mby, mbx],
                          fc.chroma_dc[mby, mbx], chroma_ac[mby, mbx])
            tw.term(1 if mby * mbw + mbx == last else 0)  # end_of_slice_flag
    return finish_cabac_nal(w, tw.array(), fc.qp, SLICE_I, 0,
                            NAL_SLICE_IDR if idr else NAL_SLICE_NON_IDR)


def pack_slice_p_cabac(
    fc: PFrameCoeffs,
    p: StreamParams,
    frame_num: int,
    ltr_ref: int | None = None,
    mark_ltr: int | None = None,
    mmco_evict: tuple = (),
    first_mb: int = 0,
    cabac_init_idc: int = 0,
) -> bytes:
    """Entropy-code one P frame (P_Skip / P_L0_16x16) into a CABAC slice
    NAL. CABAC P slices carry a per-MB mb_skip_flag (no skip runs) and a
    per-MB end_of_slice terminate bin; everything else mirrors
    cavlc.pack_slice_p's syntax subset."""
    mbh, mbw = fc.skip.shape
    w = BitWriter()
    write_slice_header(w, p, SLICE_P, frame_num, idr=False, slice_qp=fc.qp,
                       ltr_ref=ltr_ref, mark_ltr=mark_ltr,
                       mmco_evict=mmco_evict, first_mb=first_mb,
                       cabac_init_idc=cabac_init_idc)
    luma_scan = fc.luma_ac.reshape(mbh, mbw, 4, 4, 16)[..., ZIGZAG_FLAT]
    chroma_scan = fc.chroma_ac.reshape(mbh, mbw, 2, 2, 2, 16)[..., ZIGZAG_FLAT]

    tw = TokenWriter()
    grids = _CbfGrids(mbh, mbw)
    abs_mvd = np.zeros((mbh, mbw, 2), np.int32)
    cbp_l_grid = np.zeros((mbh, mbw), np.int8)
    cbp_c_grid = np.zeros((mbh, mbw), np.int8)
    last = mbh * mbw - 1
    for mby in range(mbh):
        for mbx in range(mbw):
            skip = bool(fc.skip[mby, mbx])
            tw.reg(11 + skip_ctx_inc(fc.skip, mbx, mby), 1 if skip else 0)
            if not skip:
                px, py = mv_pred_16x16(fc.mvs, mbx, mby)
                mvdx = 4 * (int(fc.mvs[mby, mbx, 0]) - px)
                mvdy = 4 * (int(fc.mvs[mby, mbx, 1]) - py)
                cbp_luma = 0
                for b8 in range(4):
                    y8, x8 = b8 >> 1, b8 & 1
                    if np.any(luma_scan[mby, mbx, y8 * 2:y8 * 2 + 2,
                                        x8 * 2:x8 * 2 + 2]):
                        cbp_luma |= 1 << b8
                if np.any(chroma_scan[mby, mbx, :, :, :, 1:]):
                    cbp_chroma = 2
                elif np.any(fc.chroma_dc[mby, mbx]):
                    cbp_chroma = 1
                else:
                    cbp_chroma = 0
                mb_tokens_p(tw, grids, mbx, mby, mvdx, mvdy, abs_mvd,
                            cbp_luma, cbp_chroma, cbp_l_grid, cbp_c_grid,
                            luma_scan[mby, mbx], fc.chroma_dc[mby, mbx],
                            chroma_scan[mby, mbx])
            tw.term(1 if mby * mbw + mbx == last else 0)  # end_of_slice_flag
    return finish_cabac_nal(w, tw.array(), fc.qp, SLICE_P, cabac_init_idc,
                            NAL_SLICE_NON_IDR)
