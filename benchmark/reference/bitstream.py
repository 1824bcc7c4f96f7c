"""H.264 high-level syntax of the reference: SPS, PPS, slice headers, NAL units.

Written from ISO/IEC 14496-10 7.3 for the stream the encoder states:
Constrained Baseline, CAVLC, frame macroblocks only, POC type 2, three
reference frames, one slice per picture (or one per band, each starting at
its ``first_mb``), deblocking off, QP coded as
pic_init_qp plus a slice delta. Bits are gathered MSB first; slice data
arrives from ``cavlc.py`` as (code, length) arrays and is packed here.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8
SLICE_P, SLICE_I = 5, 7
LOG2_MAX_FRAME_NUM = 8

# (level_idc, MaxMBPS, MaxFS), table A-1
_LEVELS = ((10, 1485, 99), (11, 3000, 396), (12, 6000, 396), (13, 11880, 396),
           (20, 11880, 396), (21, 19800, 792), (22, 20250, 1620), (30, 40500, 1620),
           (31, 108000, 3600), (32, 216000, 5120), (40, 245760, 8192),
           (41, 245760, 8192), (42, 522240, 8704), (50, 589824, 22080),
           (51, 983040, 36864), (52, 2073600, 36864))


class Bits:
    """MSB-first bit list with Exp-Golomb writers (headers only)."""

    def __init__(self) -> None:
        self.bits: list[int] = []

    def u(self, value: int, n: int) -> None:
        if value < 0 or value >> n:
            raise ValueError(f"{value} does not fit in {n} bits")
        self.bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def ue(self, value: int) -> None:
        code = value + 1
        n = code.bit_length()
        self.u(0, n - 1)
        self.u(code, n)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def array(self) -> np.ndarray:
        return np.array(self.bits, np.uint8)


@dataclass(frozen=True)
class Stream:
    width: int
    height: int
    qp: int = 28        # pic_init_qp
    fps: int = 60

    @property
    def mbw(self) -> int:
        return (self.width + 15) // 16

    @property
    def mbh(self) -> int:
        return (self.height + 15) // 16

    def level_idc(self) -> int:
        fs = self.mbw * self.mbh
        for level, max_mbps, max_fs in _LEVELS:
            if fs <= max_fs and fs * self.fps <= max_mbps:
                return level
        return 62


def _epb(rbsp: bytes) -> bytes:
    """Emulation prevention (7.4.1.1): 0x03 after 0x0000 before 0x00-0x03."""
    return _ZZ.sub(b"\x00\x00\x03", rbsp)


_ZZ = re.compile(b"\x00\x00(?=[\x00-\x03])")


def nal(ref_idc: int, kind: int, bits: np.ndarray) -> bytes:
    """Annex B NAL unit around RBSP bits (trailing bits appended here)."""
    pad = (-(len(bits) + 1)) % 8
    rbsp = np.packbits(np.concatenate([bits, np.ones(1, np.uint8),
                                       np.zeros(pad, np.uint8)])).tobytes()
    return b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | kind]) + _epb(rbsp)


def sps(s: Stream) -> bytes:
    b = Bits()
    b.u(66, 8)               # profile_idc: Baseline
    b.u(0b11000000, 8)       # constraint_set0 and 1: Constrained Baseline
    b.u(s.level_idc(), 8)
    b.ue(0)                  # seq_parameter_set_id
    b.ue(LOG2_MAX_FRAME_NUM - 4)
    b.ue(2)                  # pic_order_cnt_type
    b.ue(3)                  # max_num_ref_frames
    b.u(0, 1)                # gaps_in_frame_num_value_allowed_flag
    b.ue(s.mbw - 1)
    b.ue(s.mbh - 1)
    b.u(1, 1)                # frame_mbs_only_flag
    b.u(1, 1)                # direct_8x8_inference_flag
    crop_r, crop_b = s.mbw * 16 - s.width, s.mbh * 16 - s.height
    if crop_r or crop_b:
        b.u(1, 1)
        b.ue(0)
        b.ue(crop_r // 2)
        b.ue(0)
        b.ue(crop_b // 2)
    else:
        b.u(0, 1)
    b.u(0, 1)                # vui_parameters_present_flag
    return nal(3, NAL_SPS, b.array())


def pps(s: Stream) -> bytes:
    b = Bits()
    b.ue(0)                  # pic_parameter_set_id
    b.ue(0)                  # seq_parameter_set_id
    b.u(0, 1)                # entropy_coding_mode_flag: CAVLC
    b.u(0, 1)                # bottom_field_pic_order_in_frame_present_flag
    b.ue(0)                  # num_slice_groups_minus1
    b.ue(0)                  # num_ref_idx_l0_default_active_minus1
    b.ue(0)                  # num_ref_idx_l1_default_active_minus1
    b.u(0, 1)                # weighted_pred_flag
    b.u(0, 2)                # weighted_bipred_idc
    b.se(s.qp - 26)          # pic_init_qp_minus26
    b.se(0)                  # pic_init_qs_minus26
    b.se(0)                  # chroma_qp_index_offset
    b.u(1, 1)                # deblocking_filter_control_present_flag
    b.u(0, 1)                # constrained_intra_pred_flag
    b.u(0, 1)                # redundant_pic_cnt_present_flag
    return nal(3, NAL_PPS, b.array())


@dataclass(frozen=True)
class Marking:
    """dec_ref_pic_marking of a non-IDR slice: with ``long_term_idx`` set,
    MMCO 1 for each of ``evict`` (difference_of_pic_nums_minus1), MMCO 4
    (two long-term indices), MMCO 3 marking the previous frame long-term
    ``long_term_idx``; otherwise the sliding window."""

    long_term_idx: int | None = None
    evict: tuple = ()


def slice_header(s: Stream, *, idr: bool, frame_num: int, qp: int, idr_pic_id: int = 0,
                 ltr_ref: int | None = None, marking: Marking = Marking(),
                 first_mb: int = 0) -> Bits:
    b = Bits()
    b.ue(first_mb)                           # first_mb_in_slice
    b.ue(SLICE_I if idr else SLICE_P)
    b.ue(0)                                  # pic_parameter_set_id
    b.u(frame_num % (1 << LOG2_MAX_FRAME_NUM), LOG2_MAX_FRAME_NUM)
    if idr:
        b.ue(idr_pic_id)
    else:
        b.u(0, 1)                            # num_ref_idx_active_override_flag
        if ltr_ref is None:
            b.u(0, 1)                        # ref_pic_list_modification_flag_l0
        else:
            b.u(1, 1)
            b.ue(2)                          # long_term_pic_num follows
            b.ue(ltr_ref)
            b.ue(3)
    if idr:
        b.u(0, 1)                            # no_output_of_prior_pics_flag
        b.u(0, 1)                            # long_term_reference_flag
    elif marking.long_term_idx is not None:
        b.u(1, 1)                            # adaptive_ref_pic_marking_mode_flag
        for d in marking.evict:
            b.ue(1)
            b.ue(d)
        b.ue(4)
        b.ue(2)                              # max_long_term_frame_idx_plus1
        b.ue(3)
        b.ue(0)                              # the previous frame
        b.ue(marking.long_term_idx)
        b.ue(0)
    else:
        b.u(0, 1)
    b.se(qp - s.qp)                          # slice_qp_delta
    b.ue(1)                                  # disable_deblocking_filter_idc
    return b


def expand(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """(code, length) elements, in order, -> their bits MSB first."""
    keep = lens > 0
    codes, lens = codes[keep].astype(np.int64), lens[keep].astype(np.int64)
    total = int(lens.sum())
    elem = np.repeat(np.arange(len(lens)), lens)
    start = np.cumsum(lens) - lens
    off = np.arange(total, dtype=np.int64) - start[elem]
    return ((codes[elem] >> (lens[elem] - 1 - off)) & 1).astype(np.uint8)
