"""TorchH264Encoder: frame in, Annex-B access unit out, on a CUDA card.

Counterpart of ``selkies_tpu/models/h264/encoder.py``'s ``TPUH264Encoder``
in its device-conversion configuration (``host_convert=False,
pipeline_depth=0, frame_batch=1, entropy_coder="cavlc", tile_cache=0``):

* the whole packed frame is uploaded and converted to I420 on the device,
  edge-padded to a multiple of 16 (1080 rows become 1088);
* the IDR step is ``encode_frame_planes``, the P step
  ``encode_frame_p_planes`` (whose refine search + motion compensation is
  the ME/MC CUDA kernel, ``me_mc.py``);
* the downlink is the compact header plus nonzero rows, fused into one
  int16 buffer that the host fetches with one copy (plus the spill rows
  when a frame has more than CAP_ROWS of them);
* the host unpacks the rows and CAVLC-packs the slice with the native
  packer; a frame byte-identical to the previous one is an all-skip P
  slice with no device work.

The stream is one IDR, then P frames until ``force_keyframe()`` or
``keyframe_interval``. The reconstruction stays on the device as the next
P frame's reference. Every access unit is byte-identical to the JAX
encoder's on the same frames (tests/test_torch_encoder.py).
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from selkies_tpu_torch.device import resolve_device
from selkies_tpu_torch.models.h264.bitstream import StreamParams, write_pps, write_sps
from selkies_tpu_torch.models.h264.compact import (
    i_header_words,
    p_header_words,
    split_prefix,
    unpack_i_compact,
    unpack_p_compact,
)
from selkies_tpu_torch.models.h264.encoder_core import (
    edge_pad,
    encode_frame_p_planes,
    encode_frame_planes,
    fuse_downlink,
    pack_i_compact,
    pack_p_compact,
)
from selkies_tpu_torch.models.h264.native import pack_slice_fast, pack_slice_p_fast
from selkies_tpu_torch.models.h264.numpy_ref import PFrameCoeffs
from selkies_tpu_torch.models.stats import FrameStats
from selkies_tpu_torch.ops.colorspace import bgrx_to_i420, rgb_to_i420

__all__ = ["TorchH264Encoder", "CAP_ROWS"]

# Data rows carried in the single-fetch prefix buffer; frames with more
# nonzero rows pay a second copy for the rest.
CAP_ROWS = 4096


def _convert_pad(frame, *, pad_h: int, pad_w: int, channels: int):
    """Packed frame tensor -> I420 planes edge-padded to (pad_h, pad_w)."""
    y, u, v = (bgrx_to_i420 if channels == 4 else rgb_to_i420)(frame)
    h, w = y.shape
    if (pad_h, pad_w) != (h, w):
        y = edge_pad(y, 0, pad_h - h, 0, pad_w - w)
        u = edge_pad(u, 0, (pad_h - h) // 2, 0, (pad_w - w) // 2)
        v = edge_pad(v, 0, (pad_h - h) // 2, 0, (pad_w - w) // 2)
    return y, u, v


class TorchH264Encoder:
    """Stateful per-stream encoder: frame in, Annex-B access unit out.

    ``device=None`` means ``cuda`` and raises without a card; pass
    ``device="cpu"`` to run on the CPU. Submissions complete at once
    (pipeline depth 0)."""

    def __init__(self, width: int, height: int, qp: int = 28, fps: int = 60,
                 channels: int = 4, keyframe_interval: int = 0, device=None):
        if channels not in (3, 4):
            raise ValueError(f"channels must be 3 (RGB) or 4 (BGRx), got {channels}")
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.fps = fps
        self.channels = channels
        self.keyframe_interval = int(keyframe_interval)  # 0 = infinite GOP
        self.set_qp(qp)
        self.params = StreamParams(width=width, height=height, qp=self.qp, fps=fps)
        self._headers = write_sps(self.params) + write_pps(self.params)
        self._pad_h = (height + 15) // 16 * 16
        self._pad_w = (width + 15) // 16 * 16
        self._mbh, self._mbw = self._pad_h // 16, self._pad_w // 16
        self._hdr_words_i = i_header_words(self._mbh, self._mbw)
        self._hdr_words_p = p_header_words(self._mbh, self._mbw)
        self._ref: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None
        self._prev_frame: np.ndarray | None = None
        self._allskip: PFrameCoeffs | None = None
        self.frame_index = 0
        self._frames_since_idr = 0
        self._idr_pic_id = 0
        self._force_idr = True
        self.last_stats: FrameStats | None = None

    # -- live retune API --

    def set_qp(self, qp: int) -> None:
        if not 0 <= qp <= 51:
            raise ValueError(f"qp {qp} out of range")
        self.qp = int(qp)

    def force_keyframe(self) -> None:
        self._force_idr = True

    def load_jax_state(self, state: dict) -> None:
        """Continue a stream that the JAX encoder started.

        ``state`` holds numpy arrays and ints: ``ref`` (the reference
        recon planes, ``np.asarray(enc._ref[i])``), ``frame_index``,
        ``frames_since_idr``, ``idr_pic_id``, ``qp``, ``pic_init_qp`` (the
        QP the stream's PPS carries, ``enc.params.qp``: slice QPs are coded
        relative to it) and optionally ``prev_frame`` (the last captured
        frame, for static detection) and ``force_idr``. This system has no
        weights: its state is the reference frame on the device plus these
        counters."""
        ref = tuple(np.array(a, dtype=np.uint8) for a in state["ref"])
        want = ((self._pad_h, self._pad_w), (self._pad_h // 2, self._pad_w // 2),
                (self._pad_h // 2, self._pad_w // 2))
        if tuple(a.shape for a in ref) != want:
            raise ValueError(f"reference planes {[a.shape for a in ref]} != {list(want)}")
        self._ref = tuple(torch.from_numpy(a).to(self.device) for a in ref)
        self.frame_index = int(state["frame_index"])
        self._frames_since_idr = int(state["frames_since_idr"])
        self._idr_pic_id = int(state["idr_pic_id"])
        self.set_qp(int(state["qp"]))
        self.params = replace(self.params, qp=int(state["pic_init_qp"]))
        self._headers = write_sps(self.params) + write_pps(self.params)
        self._force_idr = bool(state.get("force_idr", False))
        prev = state.get("prev_frame")
        self._prev_frame = None if prev is None else np.array(prev, copy=True)

    # -- encoding --

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _classify(self, frame: np.ndarray) -> str:
        """"static" when byte-identical to the previous capture, else "full"."""
        if self._prev_frame is None or self._prev_frame.shape != frame.shape:
            self._prev_frame = frame.copy()
            return "full"
        if np.array_equal(self._prev_frame, frame):
            return "static"
        np.copyto(self._prev_frame, frame)
        return "full"

    def _allskip_slice(self, frame_num: int) -> bytes:
        """P slice with every MB P_Skip: recon == ref exactly (zero MV,
        full-pel, no residual), so the device reference stays valid."""
        if self._allskip is None:
            mbh, mbw = self._mbh, self._mbw
            self._allskip = PFrameCoeffs(
                mvs=np.zeros((mbh, mbw, 2), np.int32),
                skip=np.ones((mbh, mbw), bool),
                luma_ac=np.zeros((mbh, mbw, 4, 4, 4, 4), np.int32),
                chroma_dc=np.zeros((mbh, mbw, 2, 2, 2), np.int32),
                chroma_ac=np.zeros((mbh, mbw, 2, 2, 2, 4, 4), np.int32),
                qp=self.qp,
            )
        self._allskip.qp = self.qp
        return pack_slice_p_fast(self._allskip, self.params, frame_num=frame_num)

    def _upload(self, frame: np.ndarray) -> torch.Tensor:
        want = (self.height, self.width, self.channels)
        if frame.shape != want or frame.dtype != np.uint8:
            raise ValueError(f"frame must be {want} uint8, got {frame.shape} {frame.dtype}")
        return torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)

    def _planes(self, frame_t: torch.Tensor):
        return _convert_pad(frame_t, pad_h=self._pad_h, pad_w=self._pad_w,
                            channels=self.channels)

    def _step_i(self, frame_t: torch.Tensor):
        """IDR device step -> (prefix, rows, recon planes)."""
        out = encode_frame_planes(*self._planes(frame_t), self.qp)
        header, buf = pack_i_compact(out)
        prefix = fuse_downlink(header, buf, CAP_ROWS)
        return prefix, buf, (out["recon_y"], out["recon_u"], out["recon_v"])

    def _step_p(self, frame_t: torch.Tensor):
        """P device step against the resident reference."""
        out = encode_frame_p_planes(*self._planes(frame_t), *self._ref, self.qp)
        header, buf = pack_p_compact(out)
        prefix = fuse_downlink(header, buf, CAP_ROWS)
        return prefix, buf, (out["recon_y"], out["recon_u"], out["recon_v"])

    def _fetch(self, prefix: torch.Tensor, buf: torch.Tensor, hdr_words: int):
        """One copy of the fused prefix; a second for rows past CAP_ROWS."""
        header, data, n = split_prefix(prefix.cpu().numpy(), hdr_words)
        if n > CAP_ROWS:
            data = np.concatenate([data, buf[CAP_ROWS:n].cpu().numpy()])
        return header, data

    def submit(self, frame: np.ndarray, qp: int | None = None, meta=None) -> list:
        """Encode one (H, W, channels) uint8 frame; returns
        ``[(au, FrameStats, meta)]`` (depth 0: the frame completes at once)."""
        if qp is not None:
            self.set_qp(qp)
        idr = (
            self._force_idr
            or self.frame_index == 0
            or self._ref is None
            or (self.keyframe_interval > 0 and self._frames_since_idr >= self.keyframe_interval)
        )
        t0 = time.perf_counter()
        kind = self._classify(frame)
        classify_ms = (time.perf_counter() - t0) * 1e3
        if kind == "static" and not idr:
            # unchanged capture: all-skip P slice host-side, no device work
            au = self._allskip_slice(self._frames_since_idr % 256)
            stats = FrameStats(
                frame_index=self.frame_index, idr=False, qp=self.qp, bytes=len(au),
                device_ms=(time.perf_counter() - t0) * 1e3, pack_ms=0.0,
                skipped_mbs=self._mbh * self._mbw, upload_kind="static",
                upload_ms=classify_ms, classify_ms=classify_ms)
        else:
            try:
                au, stats = self._encode(frame, idr, t0, classify_ms)
            except Exception:
                # the decoder never gets this frame: encoding successors
                # against its recon would desync it, so force an IDR
                self._ref = None
                raise
        self.frame_index += 1
        self._frames_since_idr += 1
        self.last_stats = stats
        return [(au, stats, meta)]

    def _encode(self, frame: np.ndarray, idr: bool, t0: float, classify_ms: float):
        frame_t = self._upload(frame)
        self._sync()
        t_disp = time.perf_counter()
        if idr:
            prefix, buf, self._ref = self._step_i(frame_t)
            hdr_words = self._hdr_words_i
        else:
            prefix, buf, self._ref = self._step_p(frame_t)
            hdr_words = self._hdr_words_p
        self._sync()
        t_ready = time.perf_counter()
        header, data = self._fetch(prefix, buf, hdr_words)
        t1 = time.perf_counter()
        skipped = 0
        if idr:
            fc = unpack_i_compact(header, data, self.qp)
            tu = time.perf_counter()
            au = self._headers + pack_slice_fast(fc, self.params, frame_num=0, idr=True,
                                                 idr_pic_id=self._idr_pic_id)
            self._frames_since_idr = 0
            self._idr_pic_id = (self._idr_pic_id + 1) % 2
            self._force_idr = False
        else:
            pfc = unpack_p_compact(header, data, self.qp)
            tu = time.perf_counter()
            skipped = int(pfc.skip.sum())
            au = pack_slice_p_fast(pfc, self.params, frame_num=self._frames_since_idr % 256)
        t2 = time.perf_counter()
        stats = FrameStats(
            frame_index=self.frame_index, idr=idr, qp=self.qp, bytes=len(au),
            device_ms=(t1 - t0) * 1e3, pack_ms=(t2 - t1) * 1e3, skipped_mbs=skipped,
            unpack_ms=(tu - t1) * 1e3, cavlc_ms=(t2 - tu) * 1e3,
            upload_ms=(t_disp - t0) * 1e3,
            step_ms=(t_ready - t_disp) * 1e3, fetch_ms=(t1 - t_ready) * 1e3,
            classify_ms=classify_ms, upload_kind="full",
            downlink_mode="" if idr else "coeff")
        return au, stats

    def flush(self) -> list:
        """Nothing is ever in flight (depth 0)."""
        return []

    def encode_frame(self, frame: np.ndarray, qp: int | None = None) -> bytes:
        """Synchronous encode: complete Annex-B access unit out (SPS/PPS
        prepended on IDR)."""
        return self.submit(frame, qp)[-1][0]

    def recon_planes(self, frame: np.ndarray):
        """Debug helper: (recon_y, recon_u, recon_v) of an IDR encode of
        ``frame``, as numpy; the stream state is not touched."""
        _, _, (ry, ru, rv) = self._step_i(self._upload(frame))
        return ry.cpu().numpy(), ru.cpu().numpy(), rv.cpu().numpy()
