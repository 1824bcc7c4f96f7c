"""Copy of ``selkies_tpu/models/h264/bitstream.py``, kept so the port imports nothing of the JAX package.

H.264 (ISO 14496-10) high-level bitstream syntax: SPS, PPS, slice headers.

Host-side, tiny, and cold — headers are written once per stream / per frame.
The hot per-macroblock entropy coding lives in cavlc.py (Python reference)
and native/cavlc_pack.cc (production C++).

Profile choices (mirroring the reference's browser-compatible settings,
gstwebrtc_app.py:788-804 — constrained-baseline, byte-stream):
  * profile_idc 66 (Baseline), constraint_set0+1 → Constrained Baseline,
    which every browser hardware decoder accepts.
  * CAVLC entropy coding, frame MBs only, POC type 2, 1 reference frame.
  * Deblocking disabled via slice header for bit-exact encoder/decoder
    reconstruction (re-enabled once the Pallas deblock kernel lands).
"""

from __future__ import annotations

from dataclasses import dataclass

from selkies_tpu_torch.utils.bits import BitWriter, annexb_nal

__all__ = ["StreamParams", "write_sps", "write_pps", "write_slice_header", "ipcm_frame"]

NAL_SLICE_NON_IDR = 1
NAL_SLICE_IDR = 5
NAL_SPS = 7
NAL_PPS = 8

LOG2_MAX_FRAME_NUM = 8  # MaxFrameNum = 256

# Slice types (all-slices-in-pic variants)
SLICE_P = 5
SLICE_I = 7


# (level_idc, MaxMBPS, MaxFS) from table A-1, ascending.
_LEVELS = (
    (10, 1485, 99), (11, 3000, 396), (12, 6000, 396), (13, 11880, 396),
    (20, 11880, 396), (21, 19800, 792), (22, 20250, 1620), (30, 40500, 1620),
    (31, 108000, 3600), (32, 216000, 5120), (40, 245760, 8192), (41, 245760, 8192),
    (42, 522240, 8704), (50, 589824, 22080), (51, 983040, 36864), (52, 2073600, 36864),
)


@dataclass(frozen=True)
class StreamParams:
    width: int
    height: int
    qp: int = 28
    fps: int = 60
    disable_deblocking: bool = True
    # "cavlc" (Baseline, profile_idc 66, the default — byte-identical to
    # the pre-CABAC streams) or "cabac" (Main, profile_idc 77,
    # entropy_coding_mode_flag=1). Selecting the coder here rather than
    # per-call keeps SPS/PPS/slice-header emission and the entropy
    # packers agreeing by construction.
    entropy_coder: str = "cavlc"

    def __post_init__(self) -> None:
        if self.width % 2 or self.height % 2:
            raise ValueError(f"{self.width}x{self.height}: 4:2:0 requires even dimensions")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("dimensions must be positive")
        if self.entropy_coder not in ("cavlc", "cabac"):
            raise ValueError(f"unknown entropy coder {self.entropy_coder!r}")

    @property
    def cabac(self) -> bool:
        return self.entropy_coder == "cabac"

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    @property
    def level_idc(self) -> int:
        """Smallest level whose MaxFS and MaxMBPS cover this stream (A-1)."""
        fs = self.mb_width * self.mb_height
        mbps = fs * self.fps
        for level, max_mbps, max_fs in _LEVELS:
            if fs <= max_fs and mbps <= max_mbps:
                return level
        return 62


def write_sps(p: StreamParams) -> bytes:
    w = BitWriter()
    if p.cabac:
        w.write_bits(77, 8)  # profile_idc: Main (CABAC requires >= Main)
        w.write_bits(0b01000000, 8)  # constraint_set1 (Main-conformant)
    else:
        w.write_bits(66, 8)  # profile_idc: Baseline
        w.write_bits(0b11000000, 8)  # constraint_set0+1 (constrained baseline)
    w.write_bits(p.level_idc, 8)
    w.write_ue(0)  # seq_parameter_set_id
    w.write_ue(LOG2_MAX_FRAME_NUM - 4)
    w.write_ue(2)  # pic_order_cnt_type: POC from frame_num (no B frames)
    # 3 reference frames: 1 short-term (the previous frame — the only
    # default prediction source) + 2 long-term scene slots for the
    # alt-tab LTR cache (encoder.py: window switches back to a
    # remembered scene encode as a tiny delta against its LTR instead
    # of a full-frame round trip). At 1080p a 3-frame DPB needs
    # MaxDpbMbs >= 24480, within level 4.0's 32768.
    w.write_ue(3)  # max_num_ref_frames
    w.write_bit(0)  # gaps_in_frame_num_value_allowed_flag
    w.write_ue(p.mb_width - 1)
    w.write_ue(p.mb_height - 1)
    w.write_bit(1)  # frame_mbs_only_flag
    w.write_bit(1)  # direct_8x8_inference_flag
    crop_r = p.mb_width * 16 - p.width
    crop_b = p.mb_height * 16 - p.height
    if crop_r or crop_b:
        w.write_bit(1)
        w.write_ue(0)  # left
        w.write_ue(crop_r // 2)
        w.write_ue(0)  # top
        w.write_ue(crop_b // 2)
    else:
        w.write_bit(0)
    w.write_bit(0)  # vui_parameters_present_flag
    w.rbsp_trailing_bits()
    return annexb_nal(3, NAL_SPS, w.get_bytes())


def write_pps(p: StreamParams) -> bytes:
    w = BitWriter()
    w.write_ue(0)  # pic_parameter_set_id
    w.write_ue(0)  # seq_parameter_set_id
    w.write_bit(1 if p.cabac else 0)  # entropy_coding_mode_flag
    w.write_bit(0)  # bottom_field_pic_order_in_frame_present_flag
    w.write_ue(0)  # num_slice_groups_minus1
    w.write_ue(0)  # num_ref_idx_l0_default_active_minus1
    w.write_ue(0)  # num_ref_idx_l1_default_active_minus1
    w.write_bit(0)  # weighted_pred_flag
    w.write_bits(0, 2)  # weighted_bipred_idc
    w.write_se(p.qp - 26)  # pic_init_qp_minus26
    w.write_se(0)  # pic_init_qs_minus26
    w.write_se(0)  # chroma_qp_index_offset
    w.write_bit(1)  # deblocking_filter_control_present_flag
    w.write_bit(0)  # constrained_intra_pred_flag
    w.write_bit(0)  # redundant_pic_cnt_present_flag
    w.rbsp_trailing_bits()
    return annexb_nal(3, NAL_PPS, w.get_bytes())


def write_slice_header(
    w: BitWriter,
    p: StreamParams,
    slice_type: int,
    frame_num: int,
    idr: bool,
    idr_pic_id: int = 0,
    first_mb: int = 0,
    slice_qp: int | None = None,
    ltr_ref: int | None = None,
    mark_ltr: int | None = None,
    mmco_evict: tuple = (),
    cabac_init_idc: int = 0,
) -> None:
    """Write the slice header into an open BitWriter (slice data follows).

    When ``p.cabac``, P slice headers carry ``cabac_init_idc`` (7.3.3 —
    I slices have none) and the caller must byte-align with
    ``cabac_alignment_one_bit`` (ones) before the arithmetic payload.
    Each slice initializes its own contexts, so the per-band slice
    layout needs no cross-band state.

    LTR scene-cache syntax (encoder.py's alt-tab optimization):
      * ltr_ref=j — predict this P slice from long-term reference j
        instead of the previous frame (ref_pic_list_modification with
        long_term_pic_num, 7.3.3.1). Used ONLY by scene-restore frames;
        the frame after one predicts the restore's recon through the
        default ref list (the restore is still short-term when that
        frame's ref list is built — MMCO marking applies post-decode).
      * mark_ltr=k — mark the PREVIOUS frame as long-term index k
        (adaptive dec_ref_pic_marking: MMCO 4 sizes the LT set to 2,
        MMCO 3 with difference_of_pic_nums_minus1=0 targets
        CurrPicNum-1, 7.4.3.3 / 8.2.5.4). Emitted one frame after a
        scene cut so the cut frame's recon is remembered while it is
        still resident short-term.
      * mmco_evict=(d, ...) — MMCO 1 operations (short-term → unused,
        difference_of_pic_nums_minus1 values) emitted alongside
        mark_ltr. Adaptive marking REPLACES the sliding window (8.2.5),
        so any extra short-term refs that accumulated while the DPB had
        slack must be evicted explicitly or the marked frame would push
        the DPB past max_num_ref_frames. The encoder mirrors the DPB
        and passes the stale picNum diffs here.
    """
    # first_mb positions a slice of a MULTI-SLICE picture (the band-
    # parallel encode, parallel/bands.py: band b starts at mb-row-offset
    # × mb_width). An out-of-picture value would produce a stream every
    # decoder rejects — fail at write time, where the band math is.
    if not 0 <= first_mb < p.mb_width * p.mb_height:
        raise ValueError(
            f"first_mb_in_slice {first_mb} outside picture "
            f"({p.mb_width}x{p.mb_height} MBs)")
    w.write_ue(first_mb)
    w.write_ue(slice_type)
    w.write_ue(0)  # pic_parameter_set_id
    w.write_bits(frame_num % (1 << LOG2_MAX_FRAME_NUM), LOG2_MAX_FRAME_NUM)
    if idr:
        w.write_ue(idr_pic_id)
    # pic_order_cnt_type == 2: nothing to write
    if slice_type in (SLICE_P, 0):
        w.write_bit(0)  # num_ref_idx_active_override_flag
        if ltr_ref is not None:
            w.write_bit(1)  # ref_pic_list_modification_flag_l0
            w.write_ue(2)   # modification_of_pic_nums_idc: long_term_pic_num
            w.write_ue(ltr_ref)
            w.write_ue(3)   # end of modification list
        else:
            w.write_bit(0)  # ref_pic_list_modification_flag_l0
    if idr:
        w.write_bit(0)  # no_output_of_prior_pics_flag
        w.write_bit(0)  # long_term_reference_flag
    elif mark_ltr is not None:
        w.write_bit(1)  # adaptive_ref_pic_marking_mode_flag
        for diff in mmco_evict:
            w.write_ue(1)   # MMCO 1: stale short-term -> unused
            w.write_ue(diff)
        w.write_ue(4)   # MMCO 4: size the long-term set
        w.write_ue(2)   # max_long_term_frame_idx_plus1: LT indices {0,1}
        w.write_ue(3)   # MMCO 3: short-term -> long-term
        w.write_ue(0)   # difference_of_pic_nums_minus1: previous frame
        w.write_ue(mark_ltr)  # long_term_frame_idx
        w.write_ue(0)   # MMCO 0: end
    else:
        # dec_ref_pic_marking is present whenever nal_ref_idc != 0 (7.3.3);
        # every slice we emit is a reference (annexb_nal ref_idc=3).
        w.write_bit(0)  # adaptive_ref_pic_marking_mode_flag
    if p.cabac and slice_type in (SLICE_P, 0):
        w.write_ue(cabac_init_idc)
    qp = p.qp if slice_qp is None else slice_qp
    w.write_se(qp - p.qp)  # slice_qp_delta relative to pic_init_qp
    if p.disable_deblocking:
        w.write_ue(1)  # disable_deblocking_filter_idc = 1 (off)
    else:
        w.write_ue(0)
        w.write_se(0)  # slice_alpha_c0_offset_div2
        w.write_se(0)  # slice_beta_offset_div2


def ipcm_frame(p: StreamParams, y, u, v, frame_num: int = 0, idr: bool = True) -> bytes:
    """Encode one frame entirely as I_PCM macroblocks (lossless, huge).

    Exists to (a) prove NAL/SPS/PPS/slice framing against a reference
    decoder independently of transform/entropy code, and (b) serve as an
    escape hatch for pathological content. y/u/v are numpy uint8 planes
    padded to macroblock multiples.
    """
    w = BitWriter()
    write_slice_header(w, p, SLICE_I, frame_num, idr=idr)
    mbw, mbh = p.mb_width, p.mb_height
    for mby in range(mbh):
        for mbx in range(mbw):
            w.write_ue(25)  # mb_type I_PCM
            w.byte_align(0)  # pcm_alignment_zero_bit
            yb = y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16]
            ub = u[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8]
            vb = v[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8]
            for row in yb:
                for s in row:
                    w.write_bits(int(s), 8)
            for blk in (ub, vb):
                for row in blk:
                    for s in row:
                        w.write_bits(int(s), 8)
    w.rbsp_trailing_bits()
    nal_type = NAL_SLICE_IDR if idr else NAL_SLICE_NON_IDR
    return annexb_nal(3, nal_type, w.get_bytes())
