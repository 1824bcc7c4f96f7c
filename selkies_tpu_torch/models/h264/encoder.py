"""TorchH264Encoder: frame in, Annex-B access unit out, on a CUDA card.

Counterpart of ``selkies_tpu/models/h264/encoder.py``'s ``TPUH264Encoder``
with ``pipeline_depth=0, frame_batch=1, entropy_coder="cavlc",
device_entropy=False, ltr_scenes=False``, in its two configurations:

* **host conversion** (``host_convert=True``, the default, as the
  registry's row): BGRx->I420 on the host (``models/frameprep.py``); a
  fused dirty-tile scan classifies each capture as static (an all-skip P
  slice, no device work), delta (only the dirty 16-row tiles cross to the
  card and are written into the resident source planes; with the tile
  cache, tiles already in the card's slot pool cross as 8-byte remaps) or
  full (three I420 planes uploaded). Delta P frames fetch a sparse
  downlink (bit-packed rows by default) sized by a fetch hint, and the
  host packs it with the native sparse packer;
* **device conversion** (``host_convert=False``): the whole packed frame is
  uploaded and converted on the device, with the dense compact downlink.

The IDR step is ``encode_frame_planes``, the P step ``encode_frame_p_planes``
(whose refine search + motion compensation is the ME/MC CUDA kernel,
``me_mc.py``). Reconstruction and source planes stay on the device. Every
access unit is byte-identical to the JAX encoder's on the same frames
(tests/test_torch_encoder.py, tests/test_torch_encoder_host.py).

No host sync inside a device step: the delta steps' tile lists are applied
as scatters whose duplicates are resolved on the device
(``encoder_core.last_writer``), the sparse packers write at device-side
offsets, and the hint-sized fetch slice is cut before anything is read.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, replace

import numpy as np
import torch

from selkies_tpu_torch.device import resolve_device
from selkies_tpu_torch.models.frameprep import FramePrep, delta_buckets_for, tile_width_for
from selkies_tpu_torch.models.h264.bitstream import StreamParams, write_pps, write_sps
from selkies_tpu_torch.models.h264.compact import (
    i_header_words,
    p_header_words,
    p_sparse_packed_words,
    p_sparse_var_words,
    split_prefix,
    unpack_i_compact,
    unpack_p_compact,
)
from selkies_tpu_torch.models.h264.encoder_core import (
    edge_pad,
    encode_frame_p_planes,
    encode_frame_planes,
    fuse_downlink,
    last_writer,
    pack_i_compact,
    pack_p_compact,
    pack_p_sparse_packed,
    pack_p_sparse_var,
    scatter_tiles,
    tile_view,
)
from selkies_tpu_torch.models.h264.native import pack_slice_fast, pack_slice_p_fast
from selkies_tpu_torch.models.h264.numpy_ref import PFrameCoeffs
from selkies_tpu_torch.models.h264.sparse_complete import complete_sparse_slice, fetch_rest, host
from selkies_tpu_torch.models.stats import FrameStats, LinkByteCounter
from selkies_tpu_torch.models.tilecache import TileCache
from selkies_tpu_torch.ops.colorspace import bgrx_to_i420, rgb_to_i420

__all__ = ["TorchH264Encoder", "CAP_ROWS"]

# Data rows carried in the single-fetch prefix buffer; frames with more
# nonzero rows pay a second copy for the rest.
CAP_ROWS = 4096
# Delta frames' sparse downlink: the row cap and the non-skip MB cap only
# bound the device buffer (the fetch is sized by the hint, PFX_SMALL).
CAP_ROWS_DELTA = 4096
NSCAP = 4096


def _convert_pad(frame, *, pad_h: int, pad_w: int, channels: int):
    """Packed frame tensor -> I420 planes edge-padded to (pad_h, pad_w)."""
    y, u, v = (bgrx_to_i420 if channels == 4 else rgb_to_i420)(frame)
    h, w = y.shape
    if (pad_h, pad_w) != (h, w):
        y = edge_pad(y, 0, pad_h - h, 0, pad_w - w)
        u = edge_pad(u, 0, (pad_h - h) // 2, 0, (pad_w - w) // 2)
        v = edge_pad(v, 0, (pad_h - h) // 2, 0, (pad_w - w) // 2)
    return y, u, v


# ---------------------------------------------------------------------------
# Device steps (module functions, as the JAX encoder's)
# ---------------------------------------------------------------------------

def _i_planes_step(y, u, v, qp: int):
    """IDR on padded planes -> (prefix, rows buf, recon y, u, v)."""
    out = encode_frame_planes(y, u, v, qp)
    header, buf = pack_i_compact(out)
    prefix = fuse_downlink(header, buf, CAP_ROWS)
    return prefix, buf, out["recon_y"], out["recon_u"], out["recon_v"]


def _p_planes_step(y, u, v, qp: int, ref_y, ref_u, ref_v):
    """Full P on padded planes -> (prefix, rows buf, recon y, u, v)."""
    out = encode_frame_p_planes(y, u, v, ref_y, ref_u, ref_v, qp)
    header, buf = pack_p_compact(out)
    prefix = fuse_downlink(header, buf, CAP_ROWS)
    return prefix, buf, out["recon_y"], out["recon_u"], out["recon_v"]


def _i_resident_step(qp: int, sy, su, sv):
    """IDR over unchanged content (a forced keyframe on a static screen):
    no upload, encoded from the resident source planes."""
    return _i_planes_step(sy, su, sv, qp)


def _unpack_delta(packed, w: int):
    """packed uint8: [idx int32 LE (k,)] ++ yb ++ ub ++ vb, k inferred;
    ``w`` is the tile width in luma columns."""
    k = packed.shape[0] // (4 + 24 * w)
    idx = packed[: 4 * k].view(torch.int32)
    off = 4 * k
    yb = packed[off: off + k * 16 * w].reshape(k, 16, w)
    off += k * 16 * w
    ub = packed[off: off + k * 8 * (w // 2)].reshape(k, 8, w // 2)
    off += k * 8 * (w // 2)
    vb = packed[off: off + k * 8 * (w // 2)].reshape(k, 8, w // 2)
    return yb, ub, vb, idx


def _pack_sparse_p(out: dict, nscap: int, cap: int, density: int | None):
    """Delta-P downlink: 16-lane rows (density None) or bit-packed rows with
    that dense-fallback percentage."""
    if density is None:
        return pack_p_sparse_var(out, nscap, cap)
    return pack_p_sparse_packed(out, nscap, cap, density)


def _p_scatter_step(packed, qp: int, sy, su, sv, ref_y, ref_u, ref_v, *, nscap: int,
                    cap: int, tile_w: int, density: int | None = None):
    """Delta P without the tile cache: scatter the uploaded tiles into the
    source planes (in place), encode, pack the sparse downlink."""
    yb, ub, vb, idx = _unpack_delta(packed, tile_w)
    y, u, v = scatter_tiles(sy, su, sv, yb, ub, vb, idx, tile_w)
    out = encode_frame_p_planes(y, u, v, ref_y, ref_u, ref_v, qp)
    prefix, dense, buf = _pack_sparse_p(out, nscap, cap, density)
    return prefix, dense, buf, out["recon_y"], out["recon_u"], out["recon_v"], y, u, v


def _i_scatter_step(packed, qp: int, sy, su, sv, *, tile_w: int):
    yb, ub, vb, idx = _unpack_delta(packed, tile_w)
    y, u, v = scatter_tiles(sy, su, sv, yb, ub, vb, idx, tile_w)
    return (*_i_planes_step(y, u, v, qp), y, u, v)


def _unpack_delta2(packed, w: int, bucket: int, cbucket: int):
    """Tile-cache upload: [upload idx (bucket int32, -1 pads)] ++ [pool slot
    of each upload (bucket int32)] ++ [(src_slot, dst_idx) copy pairs
    (cbucket x 2 int32, src -1 pads)] ++ yb ++ ub ++ vb."""
    k = bucket
    up_idx = packed[: 4 * k].view(torch.int32)
    pool_dst = packed[4 * k: 8 * k].view(torch.int32)
    off = 8 * k
    pairs = packed[off: off + 8 * cbucket].view(torch.int32).reshape(cbucket, 2)
    off += 8 * cbucket
    yb = packed[off: off + k * 16 * w].reshape(k, 16, w)
    off += k * 16 * w
    ub = packed[off: off + k * 8 * (w // 2)].reshape(k, 8, w // 2)
    off += k * 8 * (w // 2)
    vb = packed[off: off + k * 8 * (w // 2)].reshape(k, 8, w // 2)
    return up_idx, pool_dst, pairs, yb, ub, vb


def _put_last(views, band, tile, blocks, win):
    """Write each entry's winning tile (``blocks[win]``) at (band, tile) of
    every plane view; entries without a winner (win -1) write the tile's
    current content back. Entries sharing a position share a winner, so
    duplicate writes carry identical bytes."""
    has = (win >= 0)[:, None, None]
    w0 = win.clamp(min=0)
    for view, blk in zip(views, blocks):
        view[band, tile] = torch.where(has, blk[w0], view[band, tile])


def _apply_tiles2(sy, su, sv, py, pu, pv, packed, *, tile_w: int, bucket: int, cbucket: int):
    """Copy remaps (pool -> planes), then pixel uploads (-> planes and their
    pool slots), in place; the result equals the JAX encoder's sequential
    loops. Copies all complete before any upload and read the pool as it
    was before this step's inserts. At every plane position and pool slot
    the entry latest in list order wins; pads (-1) write nothing new."""
    up_idx, pool_dst, pairs, yb, ub, vb = _unpack_delta2(packed, tile_w, bucket, cbucket)
    ctw = tile_w // 2
    views = (tile_view(sy, 16, tile_w), tile_view(su, 8, ctw), tile_view(sv, 8, ctw))
    pools = (py, pu, pv)
    if cbucket:
        src = pairs[:, 0].to(torch.int64)
        d = pairs[:, 1].to(torch.int64).clamp(min=0)
        win = last_writer(d, src >= 0)
        slots = src.clamp(min=0)
        _put_last(views, d // 1024, d % 1024, [p[slots] for p in pools], win)
    if not bucket:  # pure-remap frame
        return sy, su, sv, py, pu, pv
    idx = up_idx.to(torch.int64)
    d = idx.clamp(min=0)
    _put_last(views, d // 1024, d % 1024, (yb, ub, vb), last_writer(d, idx >= 0))
    dst = pool_dst.to(torch.int64)
    pwin = last_writer(dst)
    for pool, blk in zip(pools, (yb, ub, vb)):
        pool[dst] = blk[pwin]  # pads and uncached uploads land in the scratch row
    return sy, su, sv, py, pu, pv


def _pool_seed_step(pairs, sy, su, sv, py, pu, pv, *, tile_w: int, sbucket: int):
    """Fill pool slots (in place) by gathering tiles from the resident
    source planes: pairs (sbucket, 2) int32 (slot, dst_idx), pads target
    the scratch slot. The last entry per slot wins."""
    slot = pairs[:, 0].to(torch.int64)
    d = pairs[:, 1].to(torch.int64).clamp(min=0)
    win = last_writer(slot)
    band, tile = (d // 1024)[win], (d % 1024)[win]
    ctw = tile_w // 2
    for plane, pool, th, tw in ((sy, py, 16, tile_w), (su, pu, 8, ctw), (sv, pv, 8, ctw)):
        pool[slot] = tile_view(plane, th, tw)[band, tile]
    return py, pu, pv


def _p_scatter_step2(packed, qp: int, sy, su, sv, py, pu, pv, ref_y, ref_u, ref_v, *,
                     nscap: int, cap: int, tile_w: int, bucket: int, cbucket: int,
                     density: int | None):
    y, u, v, qy, qu, qv = _apply_tiles2(sy, su, sv, py, pu, pv, packed, tile_w=tile_w,
                                        bucket=bucket, cbucket=cbucket)
    out = encode_frame_p_planes(y, u, v, ref_y, ref_u, ref_v, qp)
    prefix, dense, buf = _pack_sparse_p(out, nscap, cap, density)
    return (prefix, dense, buf, out["recon_y"], out["recon_u"], out["recon_v"],
            y, u, v, qy, qu, qv)


def _i_scatter_step2(packed, qp: int, sy, su, sv, py, pu, pv, *, tile_w: int, bucket: int,
                     cbucket: int):
    y, u, v, qy, qu, qv = _apply_tiles2(sy, su, sv, py, pu, pv, packed, tile_w=tile_w,
                                        bucket=bucket, cbucket=cbucket)
    return (*_i_planes_step(y, u, v, qp), y, u, v, qy, qu, qv)


@dataclass
class _Pending:
    """One dispatched frame awaiting its fetch and host pack."""

    kind: str  # "i" | "p" (full P, dense downlink) | "pd" (delta P, sparse downlink)
    frame_index: int
    qp: int
    frame_num: int
    idr_pic_id: int
    t0: float
    prefix_d: object = None
    pfx_slice_d: object = None  # pd: hint-sized slice, cut at dispatch
    buf_d: object = None
    hdr_d: object = None  # pd: dense header for the ns > nscap fallback
    t_disp: float = 0.0
    up_ms: float = 0.0
    classify_ms: float = 0.0
    convert_ms: float = 0.0
    h2d_ms: float = 0.0
    scene_cut: bool = False
    n_up: int = 0
    n_remap: int = 0


def _unsupported(knob: str, item: str):
    return NotImplementedError(
        f"TorchH264Encoder does not support {knob} yet (ROADMAP queue 1: {item})")


class TorchH264Encoder:
    """Stateful per-stream encoder: frame in, Annex-B access unit out.

    ``device=None`` means ``cuda`` and raises without a card; pass
    ``device="cpu"`` to run on the CPU. Submissions complete at once
    (pipeline depth 0). Keyword names and env defaults
    (``SELKIES_TILE_CACHE``, ``SELKIES_PACK_DENSITY`` and FramePrep's) are
    the JAX encoder's; knobs of later port slices raise
    NotImplementedError."""

    # submit() takes capture-layer damage-rect hints (FramePrep.scan)
    accepts_damage = True
    # small delta-downlink fetch (int16 words); the only other fetch size
    # is the whole fused buffer
    PFX_SMALL = 1 << 14

    def __init__(self, width: int, height: int, qp: int = 28, fps: int = 60,
                 channels: int = 4, keyframe_interval: int = 0, host_convert: bool = True,
                 pipeline_depth: int = 0, frame_batch: int = 1, scene_qp_boost: int = 0,
                 device_entropy: bool = False, entropy_coder: str = "cavlc",
                 ltr_scenes: bool = False, tile_cache: int | None = None,
                 packed_downlink: bool | None = None, pack_density: int | None = None,
                 device=None):
        if channels not in (3, 4):
            raise ValueError(f"channels must be 3 (RGB) or 4 (BGRx), got {channels}")
        if int(frame_batch) > 1:
            raise _unsupported("frame_batch > 1", "grouped dispatch")
        if int(pipeline_depth) > 0:
            raise _unsupported("pipeline_depth > 0", "pipelined submit")
        if ltr_scenes:
            raise _unsupported("ltr_scenes=True", "the LTR scene cache")
        if device_entropy:
            raise _unsupported("device_entropy=True", "device CAVLC/CABAC")
        if entropy_coder not in (None, "cavlc"):
            raise _unsupported(f"entropy_coder={entropy_coder!r}", "device CAVLC/CABAC")
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.fps = fps
        self.channels = channels
        self.keyframe_interval = int(keyframe_interval)  # 0 = infinite GOP
        self.scene_qp_boost = int(scene_qp_boost)
        self.set_qp(qp)
        self.params = StreamParams(width=width, height=height, qp=self.qp, fps=fps)
        self._headers = write_sps(self.params) + write_pps(self.params)
        self._pad_h = (height + 15) // 16 * 16
        self._pad_w = (width + 15) // 16 * 16
        self._mbh, self._mbw = self._pad_h // 16, self._pad_w // 16
        self._hdr_words_i = i_header_words(self._mbh, self._mbw)
        self._hdr_words_p = p_header_words(self._mbh, self._mbw)
        # the sparse downlink: bit-packed rows unless SELKIES_PACK_DENSITY=0;
        # explicit arguments win over the env
        dens_env = os.environ.get("SELKIES_PACK_DENSITY", "")
        if packed_downlink is None:
            packed_downlink = dens_env != "0"
        if pack_density is None:
            try:
                pack_density = int(dens_env) if dens_env not in ("", "0") else 75
            except ValueError:
                pack_density = 75
        self._density = int(pack_density) if packed_downlink else None
        self._nscap, self._cap_delta = NSCAP, CAP_ROWS_DELTA
        self._tile_w = tile_width_for(width)
        self._prep = (FramePrep(width, height, self._pad_w, self._pad_h, nslots=2)
                      if host_convert and channels == 4 else None)
        self._ntiles = self._mbh * (self._pad_w // self._tile_w)
        self._delta_buckets = delta_buckets_for(width, height)
        if tile_cache is None:
            tile_cache = int(os.environ.get("SELKIES_TILE_CACHE", "1024") or "0")
        self.tile_cache_slots = (int(tile_cache)
                                 if self._prep is not None and self._delta_buckets else 0)
        self._tcache = (TileCache(height, width, self._tile_w, self.tile_cache_slots)
                        if self.tile_cache_slots > 0 else None)
        self._pool_d: tuple | None = None  # device slot pool, allocated lazily
        # over-budget dirty counts up to 4x the delta cap still try the cache
        self._tc_try_cap = (min(4 * self._delta_buckets[-1], self._ntiles)
                            if self._delta_buckets else 0)
        self._copy_buckets = (tuple(sorted({16, self._delta_buckets[-1], self._tc_try_cap}))
                              if self._delta_buckets else ())
        self._up_buckets = (0,) + self._delta_buckets
        self.link_bytes = LinkByteCounter()
        # the delta-downlink fetch hint (int16 words), from recent frames
        self._pfx_total = (p_sparse_var_words if self._density is None else p_sparse_packed_words)(
            self._mbh, self._mbw, self._nscap, self._cap_delta)
        self._pfx_hint = min(self.PFX_SMALL, self._pfx_total)
        self._pfx_recent: deque = deque(maxlen=8)
        self._ref: tuple | None = None  # recon planes: the next P frame's reference
        self._src: tuple | None = None  # resident source planes: the delta base
        self._prev_frame: np.ndarray | None = None  # device-conversion mode only
        self._prev_kind = "full"  # the first frame is not a scene cut
        self._full_run = 0
        self._allskip: PFrameCoeffs | None = None
        self._t_conv_ms = self._t_h2d_ms = self._t_disp0 = 0.0
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

        ``state`` holds numpy arrays and plain Python values:

        * ``ref`` (the reference recon planes, ``np.asarray(enc._ref[i])``),
          ``frame_index``, ``frames_since_idr``, ``idr_pic_id``, ``qp``,
          ``pic_init_qp`` (the PPS's QP, ``enc.params.qp``: slice QPs are
          coded relative to it), optionally ``force_idr``;
        * device conversion: optionally ``prev_frame`` (``enc._prev_frame``);
        * host conversion: ``src`` (``enc._src``), ``pool`` (``enc._pool_d``
          or None), ``prep_prev`` and ``scan_count`` (``enc._prep._prev``,
          ``._scan_count``), ``prev_kind``, ``full_run``, ``pfx_hint``,
          ``pfx_recent`` and ``tile_cache`` (the TileCache's ``_hash2slot``,
          ``_slot_hash``, ``_free``, ``_stamp``, ``_clock``, ``_store``,
          ``hits``, ``misses``, ``evictions``, or None).

        This system has no weights: its state is these planes on the device
        and this host bookkeeping."""
        plane = ((self._pad_h, self._pad_w), (self._pad_h // 2, self._pad_w // 2),
                 (self._pad_h // 2, self._pad_w // 2))

        def planes(arrs, want, what):
            arrs = tuple(np.array(a, dtype=np.uint8) for a in arrs)
            if tuple(a.shape for a in arrs) != want:
                raise ValueError(f"{what} planes {[a.shape for a in arrs]} != {list(want)}")
            return tuple(torch.from_numpy(a).to(self.device) for a in arrs)

        self._ref = planes(state["ref"], plane, "reference")
        self.frame_index = int(state["frame_index"])
        self._frames_since_idr = int(state["frames_since_idr"])
        self._idr_pic_id = int(state["idr_pic_id"])
        self.set_qp(int(state["qp"]))
        self.params = replace(self.params, qp=int(state["pic_init_qp"]))
        self._headers = write_sps(self.params) + write_pps(self.params)
        self._force_idr = bool(state.get("force_idr", False))
        prev = state.get("prev_frame")
        self._prev_frame = None if prev is None else np.array(prev, copy=True)
        if self._prep is None:
            return
        src = state.get("src")
        self._src = None if src is None else planes(src, plane, "source")
        pool = state.get("pool")
        if pool is not None and self._tcache is not None:
            s, tw = self.tile_cache_slots + 1, self._tile_w
            pool = planes(pool, ((s, 16, tw), (s, 8, tw // 2), (s, 8, tw // 2)), "pool")
        self._pool_d = pool if self._tcache is not None else None
        prep_prev = state.get("prep_prev")
        self._prep._prev = None if prep_prev is None else np.array(prep_prev, copy=True)
        self._prep._scan_count = int(state.get("scan_count", 0))
        self._prev_kind = str(state.get("prev_kind", "full"))
        self._full_run = int(state.get("full_run", 0))
        self._pfx_hint = int(state.get("pfx_hint", self._pfx_hint))
        self._pfx_recent = deque((int(n) for n in state.get("pfx_recent", ())), maxlen=8)
        tc = state.get("tile_cache")
        if self._tcache is not None:
            if tc is None:
                self._tcache.reset()
            else:
                c = self._tcache
                c._hash2slot = {int(h): int(s) for h, s in tc["hash2slot"].items()}
                c._slot_hash = [None if h is None else int(h) for h in tc["slot_hash"]]
                c._free = [int(s) for s in tc["free"]]
                c._stamp = np.array(tc["stamp"], np.int64)
                c._clock = int(tc["clock"])
                c._store = np.array(tc["store"], np.uint8)
                c.hits, c.misses, c.evictions = (
                    int(tc[k]) for k in ("hits", "misses", "evictions"))

    # -- frame classification (static / delta / full upload) --

    def _classify(self, frame: np.ndarray, damage=None):
        """-> ("static" | "delta" | "full", payload).

        With host conversion the fused scan compares 16-row x tile_w tiles
        against the previous capture. "delta" needs resident source planes
        and a dirty count within the delta buckets (with the tile cache:
        the post-remap upload count, tried for up to _tc_try_cap dirty
        tiles). payload: dirty indices (band*1024 + tile) without the
        cache, the cache's (up_idx, pool_dst, pairs) with it, or
        ("seed", idx, hashes) for an over-budget frame whose tiles should
        seed the pool after its full upload."""
        if self._prep is None:
            if self._prev_frame is None or self._prev_frame.shape != frame.shape:
                self._prev_frame = frame.copy()
                return "full", None
            if np.array_equal(self._prev_frame, frame):
                return "static", None
            np.copyto(self._prev_frame, frame)
            return "full", None
        res = self._prep.scan(frame, self._tile_w, damage=damage,
                              want_hashes=self._tcache is not None)
        if res is None:
            return "full", None
        if not res.tiles.any():
            return "static", None
        if self._src is None or not self._delta_buckets:
            return "full", None
        band_i, tile_i = np.nonzero(res.tiles)
        cap = self._delta_buckets[-1]
        if len(band_i) > (self._tc_try_cap if self._tcache is not None else cap):
            return "full", None
        idx = (band_i * 1024 + tile_i).astype(np.int32)
        if self._tcache is None:
            return "delta", idx
        # a sampled probe skips the split when over-budget content is not
        # pool-resident (video), so sustained motion reads ~8 hashes a frame
        if len(band_i) > cap and self._tcache.probe(frame, idx, hashes=res.hashes) < 0.5:
            return "full", ("seed", idx, res.hashes)
        payload = self._tcache.split(frame, idx, max_up=cap, hashes=res.hashes)
        if payload is None:
            return "full", ("seed", idx, res.hashes)
        return "delta", payload

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

    # -- uploads and the full steps --

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _put_timed(self, arr: np.ndarray) -> torch.Tensor:
        """One host-to-device copy (a copy on the CPU too: the resident
        planes are written in place and must not alias host buffers)."""
        t0 = time.perf_counter()
        out = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, copy=True)
        self._t_h2d_ms += (time.perf_counter() - t0) * 1e3
        return out

    def _convert_timed(self, frame: np.ndarray):
        t0 = time.perf_counter()
        planes = self._prep.convert(frame)
        self._t_conv_ms += (time.perf_counter() - t0) * 1e3
        return planes

    def _convert_tiles_timed(self, frame: np.ndarray, idx):
        t0 = time.perf_counter()
        out = self._prep.convert_tiles(frame, idx, self._tile_w)
        self._t_conv_ms += (time.perf_counter() - t0) * 1e3
        return out

    def _upload_planes(self, frame: np.ndarray):
        """Host conversion + one copy per plane; the planes become the
        resident delta base."""
        planes = self._convert_timed(frame)
        self.link_bytes.add("up_full", sum(p.nbytes for p in planes))
        return tuple(self._put_timed(p) for p in planes)

    def _upload_frame(self, frame: np.ndarray) -> torch.Tensor:
        self.link_bytes.add("up_full", frame.nbytes)
        return self._put_timed(frame)

    def _device_planes(self, frame_t: torch.Tensor):
        return _convert_pad(frame_t, pad_h=self._pad_h, pad_w=self._pad_w,
                            channels=self.channels)

    def _run_step_i(self, frame: np.ndarray):
        if self._prep is not None:
            y, u, v = self._upload_planes(frame)
            self._t_disp0 = time.perf_counter()
            out = _i_planes_step(y, u, v, self.qp)
            self._src = (y, u, v)
            return out
        frame_t = self._upload_frame(frame)
        self._t_disp0 = time.perf_counter()
        return _i_planes_step(*self._device_planes(frame_t), self.qp)

    def _run_step_p(self, frame: np.ndarray):
        if self._prep is not None:
            y, u, v = self._upload_planes(frame)
            self._t_disp0 = time.perf_counter()
            out = _p_planes_step(y, u, v, self.qp, *self._ref)
            self._src = (y, u, v)
            return out
        frame_t = self._upload_frame(frame)
        self._t_disp0 = time.perf_counter()
        return _p_planes_step(*self._device_planes(frame_t), self.qp, *self._ref)

    # -- delta uploads and the tile cache --

    @staticmethod
    def _pack_tiles(yb, ub, vb, idx, bucket: int) -> np.ndarray:
        """Pad to ``bucket`` tiles by repeating the last one and pack one
        upload buffer: [idx int32 bytes] ++ yb ++ ub ++ vb."""
        k = len(idx)
        if k < bucket:
            reps = bucket - k
            yb = np.concatenate([yb, np.repeat(yb[-1:], reps, 0)])
            ub = np.concatenate([ub, np.repeat(ub[-1:], reps, 0)])
            vb = np.concatenate([vb, np.repeat(vb[-1:], reps, 0)])
            idx = np.concatenate([idx, np.full(reps, idx[-1], np.int32)])
        return np.concatenate([idx.view(np.uint8), yb.ravel(), ub.ravel(), vb.ravel()])

    def _get_pool(self):
        """Device tile slot pool (slots + 1 rows; the last is scratch)."""
        if self._pool_d is None:
            s, tw = self.tile_cache_slots + 1, self._tile_w
            self._pool_d = tuple(torch.zeros(shape, dtype=torch.uint8, device=self.device)
                                 for shape in ((s, 16, tw), (s, 8, tw // 2), (s, 8, tw // 2)))
        return self._pool_d

    def _reset_tile_cache(self) -> None:
        """The host index and the device pool drop together: after a failed
        dispatch the pool's contents are unknowable."""
        if self._tcache is not None:
            self._tcache.reset()
        self._pool_d = None

    def _seed_pool(self, frame: np.ndarray, idx: np.ndarray, hashes=None) -> None:
        """After an over-budget full upload: commit the dirty tiles to the
        host cache and fill their pool slots on the device from the freshly
        resident planes (only the (slot, idx) list is uploaded)."""
        up_idx, pool_dst, _pairs = self._tcache.split(frame, idx, hashes=hashes)
        if not len(up_idx):
            return
        sbucket = next(cb for cb in self._copy_buckets if cb >= len(up_idx))
        pr = np.zeros((sbucket, 2), np.int32)
        pr[:, 0] = self.tile_cache_slots  # scratch padding
        pr[: len(up_idx), 0] = pool_dst
        pr[: len(up_idx), 1] = up_idx
        self.link_bytes.add("up_seed", pr.nbytes)
        _pool_seed_step(self._put_timed(pr), *self._src, *self._get_pool(),
                        tile_w=self._tile_w, sbucket=sbucket)

    def _pack_tiles2(self, yb, ub, vb, up_idx, pool_dst, pairs, bucket: int,
                     cbucket: int) -> np.ndarray:
        """Tile-cache upload buffer (see _unpack_delta2): uploads pad with
        idx -1 (identity writes) into the scratch slot; pairs pad with
        src -1."""
        tw = self._tile_w
        k = len(up_idx)
        pad = bucket - k
        idxp = np.concatenate([up_idx, np.full(pad, -1, np.int32)])
        dstp = np.concatenate([pool_dst, np.full(pad, self.tile_cache_slots, np.int32)])
        if pad:
            zy = np.zeros((pad, 16, tw), np.uint8)
            zc = np.zeros((pad, 8, tw // 2), np.uint8)
            yb = np.concatenate([yb, zy]) if k else zy
            ub = np.concatenate([ub, zc]) if k else zc
            vb = np.concatenate([vb, zc]) if k else zc
        pr = np.full((cbucket, 2), -1, np.int32)
        pr[:, 1] = 0
        if len(pairs):
            pr[: len(pairs)] = pairs
        return np.concatenate([idxp.view(np.uint8), dstp.view(np.uint8),
                               pr.reshape(-1).view(np.uint8), yb.ravel(), ub.ravel(), vb.ravel()])

    def _pack_payload2(self, frame: np.ndarray, payload):
        """Cache split -> (packed buffer, bucket, cbucket)."""
        up_idx, pool_dst, pairs = payload
        bucket = next(b for b in self._up_buckets if b >= len(up_idx))
        cbucket = next(cb for cb in self._copy_buckets if cb >= len(pairs))
        yb, ub, vb = self._convert_tiles_timed(frame, up_idx)
        return self._pack_tiles2(yb, ub, vb, up_idx, pool_dst, pairs, bucket, cbucket), \
            bucket, cbucket

    def _run_step_delta(self, frame: np.ndarray, payload, idr: bool):
        """Upload only the dirty tiles (remapping pool-resident ones);
        scatter + encode on the device. -> (prefix, dense header or None,
        rows buf, recon y, u, v)."""
        qp = self.qp
        if self._tcache is not None:
            packed, bucket, cbucket = self._pack_payload2(frame, payload)
            self.link_bytes.add("up_delta", packed.nbytes)
            packed_d = self._put_timed(packed)
            pool = self._get_pool()
            self._t_disp0 = time.perf_counter()
            consts = dict(tile_w=self._tile_w, bucket=bucket, cbucket=cbucket)
            if idr:
                prefix_d, buf_d, ry, ru, rv, *_ = _i_scatter_step2(
                    packed_d, qp, *self._src, *pool, **consts)
                hdr_d = None
            else:
                prefix_d, hdr_d, buf_d, ry, ru, rv, *_ = _p_scatter_step2(
                    packed_d, qp, *self._src, *pool, *self._ref, nscap=self._nscap,
                    cap=self._cap_delta, density=self._density, **consts)
            return prefix_d, hdr_d, buf_d, ry, ru, rv
        bucket = next(b for b in self._delta_buckets if b >= len(payload))
        yb, ub, vb = self._convert_tiles_timed(frame, payload)
        packed = self._pack_tiles(yb, ub, vb, payload, bucket)
        self.link_bytes.add("up_delta", packed.nbytes)
        packed_d = self._put_timed(packed)
        self._t_disp0 = time.perf_counter()
        if idr:
            prefix_d, buf_d, ry, ru, rv, *_ = _i_scatter_step(
                packed_d, qp, *self._src, tile_w=self._tile_w)
            hdr_d = None
        else:
            prefix_d, hdr_d, buf_d, ry, ru, rv, *_ = _p_scatter_step(
                packed_d, qp, *self._src, *self._ref, nscap=self._nscap, cap=self._cap_delta,
                tile_w=self._tile_w, density=self._density)
        return prefix_d, hdr_d, buf_d, ry, ru, rv

    # -- the delta downlink's fetch hint --

    def _update_pfx_hint(self) -> None:
        """The fetch length from recent frames: the small slice while 1.5x
        the recent need fits it, else the whole fused buffer."""
        want = max([2048] + [n * 3 // 2 for n in self._pfx_recent])
        self._pfx_hint = self.PFX_SMALL if want <= self.PFX_SMALL else self._pfx_total

    def _pfx_slice(self, prefix_d):
        """Hint-sized view of a fused delta downlink, cut at dispatch."""
        return prefix_d[: self._pfx_hint] if self._pfx_hint < self._pfx_total else prefix_d

    def _note_need(self, need: int) -> None:
        self._pfx_recent.append(need)

    # -- encoding --

    def submit(self, frame: np.ndarray, qp: int | None = None, meta=None, damage=None) -> list:
        """Encode one (H, W, channels) uint8 frame; returns
        ``[(au, FrameStats, meta)]`` (depth 0: the frame completes at once).

        ``damage``: optional (x, y, w, h) rects known to cover every
        changed pixel; they bound the classification scan and never change
        the bytes."""
        want = (self.height, self.width, self.channels)
        if frame.shape != want or frame.dtype != np.uint8:
            raise ValueError(f"frame must be {want} uint8, got {frame.shape} {frame.dtype}")
        if qp is not None:
            self.set_qp(qp)
        idr = (
            self._force_idr
            or self.frame_index == 0
            or self._ref is None
            or (self.keyframe_interval > 0 and self._frames_since_idr >= self.keyframe_interval)
        )
        t0 = time.perf_counter()
        kind, payload = self._classify(frame, damage)
        classify_ms = (time.perf_counter() - t0) * 1e3
        orig_qp = self.qp
        # a scene cut is the transition into a full-frame change: that one
        # frame is coded with scene_qp_boost added to its QP
        scene_cut = kind == "full" and self._src is not None and self._prev_kind != "full"
        self._prev_kind = kind
        self._full_run = self._full_run + 1 if kind == "full" else 0
        if scene_cut and self.scene_qp_boost:
            self.qp = min(51, self.qp + self.scene_qp_boost)
        rec = None
        if kind == "static" and not idr:
            # unchanged capture: all-skip P slice on the host, no device work
            au = self._allskip_slice(self._frames_since_idr % 256)
            stats = FrameStats(
                frame_index=self.frame_index, idr=False, qp=self.qp, bytes=len(au),
                device_ms=(time.perf_counter() - t0) * 1e3, pack_ms=0.0,
                skipped_mbs=self._mbh * self._mbw, upload_kind="static",
                upload_ms=classify_ms, classify_ms=classify_ms)
        else:
            try:
                rec = self._dispatch(frame, kind, payload, idr, t0, classify_ms, scene_cut)
            except Exception:
                # the old planes may be half-written: drop the chain so the
                # next frame self-heals as a full-upload IDR
                self._ref = self._src = None
                self._reset_tile_cache()
                self.qp = orig_qp
                raise
        self.qp = orig_qp
        self.frame_index += 1
        self._frames_since_idr += 1
        if rec is not None:
            try:
                au, stats = self._complete(rec)
            except Exception:
                # the decoder never gets this frame: encoding successors
                # against its recon would desync it, so force an IDR
                self._ref = self._src = None
                self._reset_tile_cache()
                raise
        self.last_stats = stats
        return [(au, stats, meta)]

    def _dispatch(self, frame, kind, payload, idr, t0, classify_ms, scene_cut) -> _Pending:
        """Upload and run the device step; the recon becomes the reference."""
        t_d0 = time.perf_counter()
        self._t_conv_ms = self._t_h2d_ms = self._t_disp0 = 0.0
        hdr_d = None
        n_up = n_remap = 0
        if idr:
            if kind == "delta":
                prefix_d, hdr_d, buf_d, ry, ru, rv = self._run_step_delta(frame, payload, idr=True)
            elif kind == "static" and self._src is not None:
                self._t_disp0 = time.perf_counter()
                prefix_d, buf_d, ry, ru, rv = _i_resident_step(self.qp, *self._src)
            else:
                prefix_d, buf_d, ry, ru, rv = self._run_step_i(frame)
            rec = _Pending(kind="i", frame_index=self.frame_index, qp=self.qp, frame_num=0,
                           idr_pic_id=self._idr_pic_id, t0=t0)
            self._frames_since_idr = 0
            self._idr_pic_id = (self._idr_pic_id + 1) % 2
            self._force_idr = False
        elif kind == "delta":
            prefix_d, hdr_d, buf_d, ry, ru, rv = self._run_step_delta(frame, payload, idr=False)
            if isinstance(payload, tuple):  # tile-cache split
                n_up, n_remap = len(payload[0]), len(payload[2])
            else:
                n_up = len(payload)
            rec = _Pending(kind="pd", frame_index=self.frame_index, qp=self.qp,
                           frame_num=self._frames_since_idr % 256, idr_pic_id=0, t0=t0)
            rec.pfx_slice_d = self._pfx_slice(prefix_d)
        else:
            prefix_d, buf_d, ry, ru, rv = self._run_step_p(frame)
            rec = _Pending(kind="p", frame_index=self.frame_index, qp=self.qp,
                           frame_num=self._frames_since_idr % 256, idr_pic_id=0, t0=t0)
        self._ref = (ry, ru, rv)
        rec.prefix_d, rec.buf_d, rec.hdr_d = prefix_d, buf_d, hdr_d
        rec.scene_cut, rec.n_up, rec.n_remap = scene_cut, n_up, n_remap
        rec.t_disp = self._t_disp0 or time.perf_counter()
        rec.classify_ms, rec.convert_ms, rec.h2d_ms = classify_ms, self._t_conv_ms, self._t_h2d_ms
        rec.up_ms = classify_ms + (rec.t_disp - t_d0) * 1e3
        # an over-budget frame that fell back to a full upload seeds the pool
        # from the now-resident planes (first two frames of a full run only)
        if (self._tcache is not None and kind == "full" and isinstance(payload, tuple)
                and self._src is not None and self._full_run <= 2):
            self._seed_pool(frame, payload[1], payload[2])
        if kind == "full":
            # the frames after a full-frame change carry a frame-wide
            # residual tail: grow the fetch hint now
            self._pfx_recent.append(self._pfx_total // 2)
            self._update_pfx_hint()
        return rec

    def _complete(self, rec: _Pending):
        """Fetch the downlink, unpack and pack the slice -> (au, FrameStats)."""
        self._sync()
        t_ready = time.perf_counter()
        step_ms = (t_ready - rec.t_disp) * 1e3
        skipped = 0
        if rec.kind == "pd":
            fused = host(rec.pfx_slice_d)
            t1 = time.perf_counter()
            au, skipped, tu, mode = complete_sparse_slice(
                fused, mbh=self._mbh, mbw=self._mbw, nscap=self._nscap,
                cap_rows=self._cap_delta, qp=rec.qp, frame_num=rec.frame_num,
                params=self.params, packed=self._density is not None,
                full_d=rec.prefix_d, buf_d=rec.buf_d, dense_d=rec.hdr_d,
                link_bytes=self.link_bytes, prefix_bytes=fused.nbytes,
                note_need=self._note_need)
            self._update_pfx_hint()
        else:
            prefix = host(rec.prefix_d)
            self.link_bytes.add("down_prefix", prefix.nbytes)
            header, data, n = split_prefix(
                prefix, self._hdr_words_i if rec.kind == "i" else self._hdr_words_p)
            if n > CAP_ROWS:  # rows spilled past the prefix
                rest = fetch_rest(rec.buf_d, n, CAP_ROWS)
                self.link_bytes.add("down_spill", rest.nbytes)
                data = np.concatenate([data, rest])
            t1 = time.perf_counter()
            if rec.kind == "i":
                fc = unpack_i_compact(header, data, rec.qp)
                tu = time.perf_counter()
                au = self._headers + pack_slice_fast(fc, self.params, frame_num=0, idr=True,
                                                     idr_pic_id=rec.idr_pic_id)
                mode = ""
            else:
                pfc = unpack_p_compact(header, data, rec.qp)
                tu = time.perf_counter()
                skipped = int(pfc.skip.sum())
                au = pack_slice_p_fast(pfc, self.params, frame_num=rec.frame_num)
                mode = "coeff"
        t2 = time.perf_counter()
        fetch_ms = (t1 - t_ready) * 1e3
        delta = rec.kind == "pd"
        dirty = rec.n_up + rec.n_remap
        stats = FrameStats(
            frame_index=rec.frame_index, idr=rec.kind == "i", qp=rec.qp, bytes=len(au),
            device_ms=(t1 - rec.t0) * 1e3, pack_ms=(t2 - t1) * 1e3, skipped_mbs=skipped,
            scene_cut=rec.scene_cut, unpack_ms=(tu - t1) * 1e3, cavlc_ms=(t2 - tu) * 1e3,
            upload_ms=rec.up_ms, step_ms=step_ms, fetch_ms=fetch_ms,
            classify_ms=rec.classify_ms, convert_ms=rec.convert_ms, h2d_ms=rec.h2d_ms,
            downlink_mode=mode, upload_kind="delta" if delta else "full",
            dirty_frac=min(1.0, dirty / self._ntiles) if delta else 1.0,
            remap_frac=rec.n_remap / dirty if delta and dirty else 0.0)
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
        if self._prep is not None:
            planes = [torch.from_numpy(p).to(self.device, copy=True)
                      for p in self._prep.convert(frame)]
        else:
            planes = self._device_planes(torch.from_numpy(np.ascontiguousarray(frame))
                                         .to(self.device))
        _, _, ry, ru, rv = _i_planes_step(*planes, self.qp)
        return ry.cpu().numpy(), ru.cpu().numpy(), rv.cpu().numpy()
