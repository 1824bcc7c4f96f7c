"""The tile-column codec mesh of the VP9/AV1 rows, on one card.

Counterpart of ``selkies_tpu/parallel/codec_mesh.py``. AV1/VP9 tile
columns are the codec-native analogue of the H.264 bands: a frame splits
into vertical columns whose entropy coding is independent per column.
The hybrid rows split their work in two:

* **device half**: the capture-delta front-end (per-MB dirty map and
  coarse-ME vote hints) per column shard (``MeshDeltaFrontend``). JAX
  shards one column per chip over a ``col`` mesh axis and psums the vote
  histograms over it. The port puts column ``k`` on the row's device
  ``k`` when the row lists a device per column, sums the histograms on
  column 0's card, and otherwise runs the same per-column graphs in a
  loop on one card; either way the maps and hints equal JAX's mesh
  element for element;
* **entropy half**: libaom / libvpx, driven by the column carve. AV1
  (``TileColumnAV1Encoder``) runs one pinned lossless
  ``AomStripEncoder`` per 64-px column and splices the column payloads
  into one conformant frame (``models/av1/stitch.py``); clean columns
  re-splice their cached payload and an unchanged frame ships a 5-byte
  ``show_existing_frame`` TU. VP9 (``TileColumnVP9Encoder``) pins
  libvpx's own tile-column split and thread count to the carve.

``SELKIES_TILE_COLS`` picks the column count of both rows (the registry
routes ``cols > 1`` here). Given the same frames, the AUs equal JAX's
byte for byte (tests/test_torch_codec_mesh.py).
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from selkies_tpu_torch.device import device_list
from selkies_tpu_torch.models.h264.encoder_core import _downsample4, coarse_votes, select_coarse
from selkies_tpu_torch.models.h264.numpy_ref import TOPK
from selkies_tpu_torch.models.hybrid_frontend import (
    DeviceDeltaFrontend,
    HybridFrontendMixin,
    default_frontend_mode,
)
from selkies_tpu_torch.models.stats import FrameStats
from selkies_tpu_torch.ops.colorspace import bgrx_to_luma

logger = logging.getLogger("parallel.codec_mesh")

__all__ = [
    "MeshDeltaFrontend",
    "TileColumnAV1Encoder",
    "TileColumnVP9Encoder",
    "budget_cols",
    "cols_from_env",
    "cols_log2_for",
    "floor_cols_log2",
]


def cols_from_env() -> int:
    """SELKIES_TILE_COLS: tile columns for the AV1/VP9 mesh rows (1 =
    single-column, the solo hybrid path)."""
    env = os.environ.get("SELKIES_TILE_COLS")
    if not env:
        return 1
    try:
        return max(1, min(64, int(env)))
    except ValueError:
        logger.warning("SELKIES_TILE_COLS=%r is not an integer; using 1", env)
        return 1


def cols_log2_for(cols: int) -> int:
    """Smallest log2 whose uniform tile spacing yields >= ``cols`` columns
    on a wide-enough frame (AV1 tile_info codes the count as a log2)."""
    k = 0
    while (1 << k) < cols:
        k += 1
    return k


def floor_cols_log2(cols: int) -> int:
    """Largest log2 with 2**k <= ``cols``: both mesh rows round a budget
    down, so a non-power-of-two budget never carves more tile columns than
    it has devices for."""
    k = 0
    while (2 << k) <= cols:
        k += 1
    return k


def budget_cols(chips: int) -> int:
    """A session's tile-column budget: the devices the placer granted it,
    clamped by SELKIES_TILE_COLS when the operator pins one."""
    if os.environ.get("SELKIES_TILE_COLS"):
        return max(1, min(cols_from_env(), max(chips, 1)))
    return max(chips, 1)


def _row_device(devices, device):
    """The device a row's own work runs on: the first of ``devices`` (a
    fleet row), else ``device``. The row's device front-end takes the
    whole row (``_row_devices``)."""
    return list(devices)[0] if devices else device


def _row_devices(devices, device) -> list:
    """The devices a row's column front-end may spread over: the row, else
    the row's one device."""
    return list(devices) if devices else [device]


# ---------------------------------------------------------------------------
# column-sharded device front-end


class MeshDeltaFrontend(DeviceDeltaFrontend):
    """``DeviceDeltaFrontend`` computed as JAX's ``col`` mesh computes it.

    The capture goes into a zero frame of ``pad_h x pad_w``, where every
    column is ``col_w = ceil(width / (cols*16)) * 16`` wide, so no MB
    straddles a seam; ``pad_w`` may exceed the solo front-end's 16-aligned
    width (208 px at ``cols=4`` pads to 256) and the zero columns take
    part in the last column's vote. The dirty map equals the solo one.
    Each column votes on its own luma against its own downsampled previous
    luma, its SAD edge-padding at that column's seams; the histograms are
    summed (JAX's psum) and one ``select_coarse`` picks the hints. The
    vote runs on every step, static ones too (``votes`` counts them).

    ``devices=None`` takes the device pool's healthy cards. With at least
    ``cols`` devices listed (a list may repeat a card), column ``k`` lives
    on ``devices[k]`` (``mesh_enabled``): its slice of the capture is
    uploaded there, and its dirty map, luma and vote histogram are
    computed there; the maps and histograms are copied to column 0's card
    and summed there, and one fetch per step brings the map and the hints
    back. With fewer devices every column runs on the first, in one step.
    ``devices`` lists the cards this front-end dispatches to."""

    def __init__(self, width: int, height: int, cols: int, devices=None):
        if devices is None:
            from selkies_tpu_torch.resilience.devhealth import get_device_pool

            devices = get_device_pool().healthy_devices()
        devices = device_list(devices)
        if not devices:
            raise ValueError("need a device for the column mesh, have none")
        super().__init__(width, height, device=devices[0])
        self.cols = cols
        self.col_w = ((width + cols * 16 - 1) // (cols * 16)) * 16
        self.pad_w = self.col_w * cols
        self.mbw = self.pad_w // 16  # the padded frame's, as the base defines it
        self.mesh_enabled = cols > 1 and len(devices) >= cols
        self.devices = devices[:cols] if self.mesh_enabled else [self.device]
        self._col_stages: list | None = None  # pinned staging per column (cuda)

    def _upload_cols(self, frame: np.ndarray) -> list[torch.Tensor]:
        """Each column of the capture into its card's zero-padded column
        buffer that does not hold ``prev`` (the mesh's ``_upload``)."""
        if frame.shape != (self.height, self.width, 4) or frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.shape} {frame.dtype} != "
                             f"{(self.height, self.width, 4)} uint8")
        cw = self.col_w
        spans = [(k * cw, min((k + 1) * cw, self.width)) for k in range(self.cols)]
        if self._bufs is None:
            self._bufs = [[torch.zeros((self.pad_h, cw, 4), dtype=torch.uint8, device=d)
                           for d in self.devices] for _ in range(2)]
            if self.device.type == "cuda":
                self._col_stages = [torch.empty((self.height, max(x1 - x0, 0), 4),
                                                dtype=torch.uint8, pin_memory=True)
                                    for x0, x1 in spans]
        bufs = self._bufs[self._next]
        self._next ^= 1
        for k, ((x0, x1), buf) in enumerate(zip(spans, bufs)):
            if x1 <= x0:
                continue  # a column wholly past the capture stays zero
            src = torch.from_numpy(np.ascontiguousarray(frame[:, x0:x1]))
            if self._col_stages is None:
                buf[: self.height, : x1 - x0].copy_(src)
                continue
            # pinned, so the copy is asynchronous; the staging is free again
            # after the step's fetch, which follows every column's work
            self._col_stages[k].copy_(src)
            with torch.cuda.device(buf.device):
                buf[: self.height, : x1 - x0].copy_(self._col_stages[k], non_blocking=True)
        return bufs

    def step(self, frame: np.ndarray):
        """BGRx capture -> (dirty (mbh, mbw) bool | None, hints (TOPK, 2)
        int32 in pixel units | None); None on the first frame."""
        t0 = time.perf_counter()
        frame = np.asarray(frame)
        if self.mesh_enabled:
            f = self._upload_cols(frame)
            y = [bgrx_to_luma(t) for t in f]
        else:
            f = self._upload(frame)
            y = bgrx_to_luma(f)
        if self._prev is None:
            self._prev, self._prev_luma = f, y
            for d in dict.fromkeys(self.devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            self.last_device_ms = (time.perf_counter() - t0) * 1e3
            return None, None
        cw = self.col_w
        if self.mesh_enabled:
            # each column on its card; its map and histogram to column 0's
            dev0 = self.devices[0]
            maps, votes = [], 0
            for fk, pk, yk, lk in zip(f, self._prev, y, self._prev_luma):
                d = (fk != pk).reshape(self.mbh, 16, cw // 16, 16, 4).any(dim=(1, 3, 4))
                v = coarse_votes(yk.to(torch.int32), _downsample4(lk))
                maps.append(d.to(dev0, non_blocking=True))
                votes = votes + v.to(dev0, non_blocking=True)
            dirty = torch.cat(maps, dim=1)
        else:
            dirty = (f != self._prev).reshape(self.mbh, 16, self.mbw, 16, 4).any(dim=(1, 3, 4))
            cur = y.to(torch.int32)
            rd = _downsample4(self._prev_luma)
            votes = 0
            for k in range(self.cols):
                votes = votes + coarse_votes(cur[:, k * cw:(k + 1) * cw],
                                             rd[:, k * cw // 4:(k + 1) * cw // 4])
        hints = select_coarse(votes)
        self.votes += 1
        out = torch.cat([dirty.reshape(-1).to(torch.int32), hints.reshape(-1)])
        out = out.cpu().numpy()  # the step's one sync
        n = dirty.numel()
        mbw = (self.width + 15) // 16  # the map is cropped to the capture's MBs
        dirty_np = out[:n].reshape(dirty.shape).astype(bool)[: (self.height + 15) // 16, :mbw]
        hints_np = out[n:].reshape(TOPK, 2) * 4  # downsampled -> pixel units
        self._prev, self._prev_luma = f, y
        self.last_device_ms = (time.perf_counter() - t0) * 1e3
        return dirty_np, hints_np


# ---------------------------------------------------------------------------
# AV1: per-column strip encoders + bitstream splice


class TileColumnAV1Encoder(HybridFrontendMixin):
    """tpuav1enc's tile-column mesh mode (see the module docstring).

    The encoder rows' interface: ``encode_frame(frame, qp)``,
    ``last_stats``, ``force_keyframe``, ``set_bitrate`` / ``set_qp``,
    ``close``. The rate knobs are accepted and ignored: the splice is
    pinned lossless. ``device=None`` means ``cuda`` and raises without a
    card; ``devices`` (a fleet row) runs the row on its first entry, and
    the device front-end, ``MeshDeltaFrontend``, over the whole row (else
    on that one device)."""

    codec = "av1"

    def __init__(self, width: int, height: int, fps: int = 60,
                 cols: int = 2, frontend: str | None = None,
                 cpu_used: int = 6, devices=None,
                 keyframe_interval: int = 0, device=None, **_ignored):
        from selkies_tpu_torch.models.av1 import stitch
        from selkies_tpu_torch.models.libaom_enc import AomStripEncoder

        if width % 2 or height % 2:
            raise ValueError("4:2:0 requires even dimensions")
        self._stitch = stitch
        self.width, self.height, self.fps = width, height, fps
        # ``cols`` is a budget: the uniform tile spacing carves only some
        # column counts, so round the log2 down until the carve fits
        k = cols_log2_for(cols)
        while k > 0 and len(stitch.tile_columns(width, k)) > cols:
            k -= 1
        self.cols_log2 = k
        self.carve = stitch.tile_columns(width, self.cols_log2)
        self.cols = len(self.carve)
        if self.cols != cols:
            logger.info(
                "AV1 uniform tile spacing carves %dpx into %d columns "
                "(budget %d)", width, self.cols, cols)
        self.keyframe_interval = keyframe_interval
        self._strips = [AomStripEncoder(w, height, cpu_used=cpu_used)
                        for (_x0, w) in self.carve]
        self._template = AomStripEncoder(width, height, cpu_used=cpu_used)
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, min(self.cols, os.cpu_count() or 1)),
            thread_name_prefix="av1-strip")
        self._row = list(devices) if devices else None
        self._init_frontend(width, height, frontend, _row_device(devices, device))
        # per-column splice state
        self._payloads: list[bytes | None] = [None] * self.cols
        self._fields = [None] * self.cols
        self._seq = None            # SequenceInfo of the stitched stream
        self._seq_payload = None    # full-dims sequence header OBU payload
        self._strip_seq = [None] * self.cols
        self._strip_seq_payload = [None] * self.cols
        self._have_ref = False
        self._show_ok = False       # slot 0 holds a re-showable frame
        self._force_idr = True
        self.frame_index = 0
        self.qp = 0
        self.last_stats: FrameStats | None = None
        self.static_frames = 0
        self.cached_columns = 0     # clean columns spliced without encode
        self.stitch_fallbacks = 0   # frames that left the splice envelope

    def _make_device_frontend(self, width: int, height: int):
        # the row's devices: a column per card when the row has enough
        return MeshDeltaFrontend(width, height, self.cols,
                                 devices=_row_devices(self._row, self.device))

    def close(self) -> None:
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._pool = None
        for enc in getattr(self, "_strips", []):
            enc.close()
        self._strips = []
        tpl = getattr(self, "_template", None)
        if tpl is not None:
            tpl.close()
            self._template = None

    def force_keyframe(self) -> None:
        self._force_idr = True

    def set_qp(self, qp: int) -> None:
        """Interface parity; the splice is pinned lossless."""

    def set_bitrate(self, bitrate_kbps: int) -> None:
        """Interface parity; the splice is pinned lossless (rate follows
        content: static columns cost 0, clean frames 5 bytes)."""

    # -- encoding ------------------------------------------------------

    def _dirty_columns(self, dirty: np.ndarray | None) -> list[bool]:
        if dirty is None:
            return [True] * self.cols
        return [bool(dirty[:, x0 // 16: (x0 + w + 15) // 16].any())
                for (x0, w) in self.carve]

    def _encode_column(self, k: int, y, u, v) -> None:
        x0, w = self.carve[k]
        tu = self._strips[k].encode_planes(
            np.ascontiguousarray(y[:, x0:x0 + w]),
            np.ascontiguousarray(u[:, x0 // 2:(x0 + w) // 2]),
            np.ascontiguousarray(v[:, x0 // 2:(x0 + w) // 2]))
        s = self._stitch.extract_strip(tu, self._strip_seq[k],
                                       self._strip_seq_payload[k])
        self._strip_seq[k] = s.seq
        self._strip_seq_payload[k] = s.seq_payload
        self._payloads[k] = s.tile_payload
        self._fields[k] = s.frame

    def _ensure_template(self, y, u, v) -> None:
        """First frame: one full-width strip encode supplies the sequence
        header with the full frame's max dims (strip sequence headers
        carry strip dims) and arms the fallback encoder."""
        if self._seq_payload is not None:
            return
        tu = self._template.encode_planes(y, u, v)
        s = self._stitch.extract_strip(tu)
        self._seq_payload, self._seq = s.seq_payload, s.seq

    def _fallback_au(self, y, u, v) -> bytes:
        """The splice left its envelope: ship one full-frame strip TU (its
        own KEY frame, still lossless and conformant)."""
        self.stitch_fallbacks += 1
        self._show_ok = False
        self._payloads = [None] * self.cols  # the cache is keyed to the splice
        return self._template.encode_planes(y, u, v)

    def encode_frame(self, frame: np.ndarray, qp: int | None = None) -> bytes:
        from selkies_tpu_torch.models.av1 import headers
        from selkies_tpu_torch.models.libvpx_enc import _bgrx_to_i420_np

        t0 = time.perf_counter()
        frame = np.asarray(frame)
        dirty = self._classify_mbs(frame)
        mb_total = ((self.height + 15) // 16) * ((self.width + 15) // 16)
        unchanged = dirty is not None and not dirty.any()
        if (unchanged and self._have_ref and not self._force_idr
                and self._show_ok):
            # show_existing_frame_tu carries its own temporal delimiter
            au = headers.show_existing_frame_tu(0)
            self.static_frames += 1
            self.last_stats = FrameStats(
                frame_index=self.frame_index, idr=False, qp=0,
                bytes=len(au),
                device_ms=self.frontend_device_ms or
                (time.perf_counter() - t0) * 1e3,
                pack_ms=0.0, skipped_mbs=mb_total, cols=self.cols)
            self.frame_index += 1
            return au
        t1 = time.perf_counter()
        y, u, v = _bgrx_to_i420_np(frame)
        keyframe = self._force_idr or not self._have_ref or (
            self.keyframe_interval
            and self.frame_index % max(self.keyframe_interval, 1) == 0)
        dirty_cols = self._dirty_columns(None if keyframe else dirty)
        todo = [k for k in range(self.cols)
                if dirty_cols[k] or self._payloads[k] is None]
        t2 = time.perf_counter()
        try:
            self._ensure_template(y, u, v)
            if len(todo) > 1:
                list(self._pool.map(
                    lambda k: self._encode_column(k, y, u, v), todo))
            else:
                for k in todo:
                    self._encode_column(k, y, u, v)
            t3 = time.perf_counter()
            template = self._fields[0]
            for k in range(1, self.cols):
                if not template.splice_compatible(self._fields[k]):
                    raise self._stitch.StitchError(
                        f"column {k} frame fields diverged")
            for k in range(self.cols):
                if not self._seq.tile_compatible(self._strip_seq[k]):
                    raise self._stitch.StitchError(
                        f"column {k} sequence header diverged")
            if keyframe:
                au = self._stitch.build_stitched_tu(
                    self._seq_payload, self._seq, template,
                    headers.KEY_FRAME, 0xFF, self.width, self.height,
                    self.cols_log2, list(self._payloads))
                self._show_ok = False
            else:
                au = self._stitch.build_stitched_tu(
                    None, self._seq, template, headers.INTRA_ONLY_FRAME,
                    0x01, self.width, self.height, self.cols_log2,
                    list(self._payloads))
                self._show_ok = True
        except (ValueError, IndexError) as exc:
            # StitchError and the bit reader's overruns: anything outside
            # the constrained envelope ships the full-frame TU
            logger.warning("AV1 splice fell back to full-frame encode: %s", exc)
            t3 = time.perf_counter()
            au = self._fallback_au(y, u, v)
            keyframe = True
        t4 = time.perf_counter()
        self.cached_columns += self.cols - len(todo)
        if keyframe:
            self._force_idr = False
        self._have_ref = True
        skipped = 0
        if dirty is not None and not keyframe:
            skipped = int(mb_total - dirty.sum())
        self.last_stats = FrameStats(
            frame_index=self.frame_index, idr=keyframe, qp=0,
            bytes=len(au),
            device_ms=(self.frontend_device_ms or (t1 - t0) * 1e3)
            + (t3 - t2) * 1e3,           # column strip encodes
            pack_ms=(t2 - t1) * 1e3 + (t4 - t3) * 1e3,  # convert + splice
            skipped_mbs=skipped, cols=self.cols)
        self.frame_index += 1
        return au


# ---------------------------------------------------------------------------
# VP9: mesh front-end + carve-pinned libvpx tile columns


class TileColumnVP9Encoder:
    """tpuvp9enc's tile-column mesh mode: the hybrid VP9 row with libvpx's
    tile-column split and thread count pinned to the carve and, in device
    mode, ``MeshDeltaFrontend`` as its front-end. Constructing one returns
    that ``TorchVP9Encoder``. ``device`` / ``devices`` as
    ``TileColumnAV1Encoder``'s."""

    def __new__(cls, width: int, height: int, fps: int = 60,
                bitrate_kbps: int = 2000, cols: int = 2,
                frontend: str | None = None, devices=None, device=None, **_ignored):
        from selkies_tpu_torch.models.vp9.encoder import TorchVP9Encoder

        device = _row_device(devices, device)
        # ``cols`` is a budget: round down to a power of two, so libvpx's
        # tile split and the front-end shards cover the same columns
        log2 = floor_cols_log2(max(1, cols))
        eff_cols = 1 << log2
        # built on the host front-end, then the mesh swapped in: the solo
        # device front-end would only be replaced
        enc = TorchVP9Encoder(width=width, height=height, fps=fps,
                              bitrate_kbps=bitrate_kbps, frontend="host",
                              tile_columns_log2=log2, threads=eff_cols, device=device)
        enc.cols = eff_cols
        mode = (frontend if frontend in ("host", "device")
                else default_frontend_mode(enc.device))
        if mode == "device":
            enc._device_fe = MeshDeltaFrontend(width, height, eff_cols,
                                               devices=_row_devices(devices, enc.device))
            enc._prep = None
            enc.frontend_mode = "device"
        return enc
