"""TorchH264Encoder: frame in, Annex-B access unit out, on a CUDA card.

Counterpart of ``selkies_tpu/models/h264/encoder.py``'s ``TPUH264Encoder``,
in its two configurations:

* **host conversion** (``host_convert=True``, the default, as the
  registry's row): BGRx->I420 on the host (``models/frameprep.py``); a
  fused dirty-tile scan classifies each capture as static (an all-skip P
  slice, no device work), delta (only the dirty 16-row tiles cross to the
  card and are written into the resident source planes; with the tile
  cache, tiles already in the card's slot pool cross as 8-byte remaps) or
  full (three I420 planes uploaded). Delta P frames fetch a sparse
  downlink (bit-packed rows by default) sized by a fetch hint, and the
  host packs it with the native sparse packer. Consecutive deltas are
  grouped (``frame_batch``) into one upload, one dispatch and one fetch;
  the LTR scene cache (``ltr_scenes``) serves a switch back to a
  remembered window as a small delta against a long-term reference;
* **device conversion** (``host_convert=False``): the whole packed frame is
  uploaded and converted on the device, with the dense compact downlink.

The entropy coder is CAVLC (Baseline) or CABAC (Main, ``entropy_coder``);
the host packs every slice unless ``device_entropy`` is on (host
conversion only), where full P frames ship their slice bits (CAVLC,
``device_cavlc.py``) or token stream (CABAC, ``device_cabac.py``) and each
delta frame decides on the device whether to ship those or its sparse
coefficients (busy frames, at least ``bits_min_mbs`` coded MBs, ship the
coded slice). The bytes are the same either way.

Both pipeline ``pipeline_depth`` device round trips: a frame's fetch and
host pack run on a completion worker while the next frames dispatch. The
defaults are the JAX constructor's (depth 2, groups of 4, LTR on).

The IDR step is ``encode_frame_planes``, the P step ``encode_frame_p_planes``
(whose refine search + motion compensation is the ME/MC CUDA kernel,
``me_mc.py``). Reconstruction and source planes stay on the device. Every
access unit is byte-identical to the JAX encoder's on the same frames
(tests/test_torch_encoder*.py, test_torch_group.py, test_torch_pipeline.py,
test_torch_ltr.py).

No host sync inside a device step: the delta steps' tile lists are applied
as scatters whose duplicates are resolved on the device
(``encoder_core.last_writer``), the sparse packers write at device-side
offsets, and the hint-sized fetch slice is cut before anything is read.
On the card each step's downlink copy is enqueued right behind it (pinned,
``non_blocking``) between two CUDA events that the completion worker
waits on (``device.Fetch``): a worker never synchronises the whole
device, which would wait for later frames' steps too.

The JAX encoder's hooks sit at its sites: the ``frontend`` fault site at
the top of ``submit`` (``SELKIES_FAULTS``; a raise leaves the frames in
flight deliverable in order), the tracer's ``classify`` / ``step`` /
``fetch`` / ``unpack`` / ``pack`` / ``bits_fetch`` spans, the tile-cache
counters on the telemetry bus, and a ``jitprof`` mark on a retune that
JAX would recompile for. Off, each costs one ``None`` or ``enabled`` read;
no hook changes a byte or waits on the device.
"""

from __future__ import annotations

import os
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace

import numpy as np
import torch

from selkies_tpu_torch.device import Fetch, host, resolve_device, to_device
from selkies_tpu_torch.models.frameprep import FramePrep, delta_buckets_for, tile_width_for
from selkies_tpu_torch.models.h264 import me_mc, native
from selkies_tpu_torch.models.h264.bitstream import StreamParams, write_pps, write_sps
from selkies_tpu_torch.models.h264.cabac import pack_slice_cabac, pack_slice_p_cabac
from selkies_tpu_torch.models.h264.compact import (
    i_header_words,
    p_header_words,
    p_sparse_entropy_words,
    p_sparse_packed_words,
    p_sparse_var_words,
    split_prefix,
    unpack_i_compact,
    unpack_p_compact,
)
from selkies_tpu_torch.models.h264.device_cabac import (
    assemble_p_cabac_nal,
    pack_p_slice_tokens_active,
)
from selkies_tpu_torch.models.h264.device_cavlc import WORD_CAP_DEFAULT as BITS_WORD_CAP
from selkies_tpu_torch.models.h264.device_cavlc import (
    assemble_p_nal,
    entropy_coder_default,
    pack_p_slice_bits_active,
    resolve_entropy,
)
from selkies_tpu_torch.models.h264.encoder_core import (
    _bitpack32,
    edge_pad,
    encode_frame_p_planes,
    encode_frame_planes,
    fuse_downlink,
    last_writer,
    pack_i_compact,
    pack_p_compact,
    pack_p_sparse_entropy,
    pack_p_sparse_packed,
    pack_p_sparse_var,
    scatter_tiles,
    tile_view,
)
from selkies_tpu_torch.models.h264.native import pack_slice_fast, pack_slice_p_fast
from selkies_tpu_torch.models.h264.numpy_ref import PFrameCoeffs
from selkies_tpu_torch.models.h264.sparse_complete import complete_sparse_slice, fetch_rest
from selkies_tpu_torch.models.stats import FrameStats, LinkByteCounter
from selkies_tpu_torch.models.tilecache import TileCache
from selkies_tpu_torch.monitoring import jitprof
from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.monitoring.tracing import tracer
from selkies_tpu_torch.ops.colorspace import bgrx_to_i420, rgb_to_i420
from selkies_tpu_torch.resilience.faultinject import get_injector

__all__ = ["TorchH264Encoder", "CAP_ROWS"]

# Data rows carried in the single-fetch prefix buffer; frames with more
# nonzero rows pay a second copy for the rest.
CAP_ROWS = 4096
# Delta frames' sparse downlink: the row cap and the non-skip MB cap only
# bound the device buffer (the fetch is sized by the hint, PFX_SMALL).
CAP_ROWS_DELTA = 4096
NSCAP = 4096
# Device-entropy full P frames: the prefix carries the first
# BITS_PREFIX_WORDS words of the slice bits (a larger slice pays one more
# fetch). CABAC's tokens are 16 bits, two per word, so its cap and prefix
# are twice as large.
BITS_PREFIX_WORDS = 1 << 16
TOK_WORD_CAP = 1 << 18
TOK_PREFIX_WORDS = 1 << 17


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


def _p_bits_step(y, u, v, qp: int, ref_y, ref_u, ref_v):
    """Full P with device CAVLC -> (prefix, bit words, dense header, rows
    buf, recon y, u, v). prefix = [nbits, trailing_skip, nskip] ++ the first
    BITS_PREFIX_WORDS words (int32 bit patterns); the dense header and rows
    are the overflow fallback, fetched only when nbits > BITS_WORD_CAP*32."""
    out = encode_frame_p_planes(y, u, v, ref_y, ref_u, ref_v, qp)
    words, nbits, trailing, _ns = pack_p_slice_bits_active(out, BITS_WORD_CAP)
    meta = torch.stack([nbits, trailing, out["skip"].sum(dtype=torch.int32)])
    prefix = torch.cat([meta, words[:BITS_PREFIX_WORDS]])
    header, buf = pack_p_compact(out)
    return prefix, words, header, buf, out["recon_y"], out["recon_u"], out["recon_v"]


def _p_toks_step(y, u, v, qp: int, ref_y, ref_u, ref_v):
    """Full P with the device CABAC tokenizer -> (prefix, token words,
    dense header, rows buf, recon y, u, v). prefix = [ntok, ns, nskip] ++
    skip_words ++ the coded MBs' token counts (int16 pairs) ++ the first
    TOK_PREFIX_WORDS token words; the host runs the arithmetic engine."""
    out = encode_frame_p_planes(y, u, v, ref_y, ref_u, ref_v, qp)
    words, ntok, counts, ns = pack_p_slice_tokens_active(out, TOK_WORD_CAP)
    skip = out["skip"].reshape(-1)
    cnt16 = counts.to(torch.int16)
    if cnt16.shape[0] & 1:
        cnt16 = torch.cat([cnt16, cnt16.new_zeros(1)])
    meta = torch.stack([ntok, ns, skip.sum(dtype=torch.int32)])
    prefix = torch.cat([meta, _bitpack32(skip), cnt16.view(torch.int32),
                        words[:TOK_PREFIX_WORDS]])
    header, buf = pack_p_compact(out)
    return prefix, words, header, buf, out["recon_y"], out["recon_u"], out["recon_v"]


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


def _pack_sparse_p(out: dict, nscap: int, cap: int, density: int | None, entropy=None):
    """Delta-P downlink: 16-lane rows (density None) or bit-packed rows with
    that dense-fallback percentage; ``entropy`` (bits_words, min_mbs,
    buckets, coder) wraps either in the per-frame device-entropy decision
    (encoder_core.pack_p_sparse_entropy)."""
    if entropy is not None:
        bits_words, min_mbs, buckets, coder = entropy
        return pack_p_sparse_entropy(out, nscap, cap, density, bits_words, min_mbs, buckets,
                                     entropy_coder=coder)
    if density is None:
        return pack_p_sparse_var(out, nscap, cap)
    return pack_p_sparse_packed(out, nscap, cap, density)


def _p_scatter_step(packed, qp: int, sy, su, sv, ref_y, ref_u, ref_v, *, nscap: int,
                    cap: int, tile_w: int, density: int | None = None, entropy=None):
    """Delta P without the tile cache: scatter the uploaded tiles into the
    source planes (in place), encode, pack the sparse downlink."""
    yb, ub, vb, idx = _unpack_delta(packed, tile_w)
    y, u, v = scatter_tiles(sy, su, sv, yb, ub, vb, idx, tile_w)
    out = encode_frame_p_planes(y, u, v, ref_y, ref_u, ref_v, qp)
    prefix, dense, buf = _pack_sparse_p(out, nscap, cap, density, entropy)
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
                     density: int | None, entropy=None):
    y, u, v, qy, qu, qv = _apply_tiles2(sy, su, sv, py, pu, pv, packed, tile_w=tile_w,
                                        bucket=bucket, cbucket=cbucket)
    out = encode_frame_p_planes(y, u, v, ref_y, ref_u, ref_v, qp)
    prefix, dense, buf = _pack_sparse_p(out, nscap, cap, density, entropy)
    return (prefix, dense, buf, out["recon_y"], out["recon_u"], out["recon_v"],
            y, u, v, qy, qu, qv)


def _i_scatter_step2(packed, qp: int, sy, su, sv, py, pu, pv, *, tile_w: int, bucket: int,
                     cbucket: int):
    y, u, v, qy, qu, qv = _apply_tiles2(sy, su, sv, py, pu, pv, packed, tile_w=tile_w,
                                        bucket=bucket, cbucket=cbucket)
    return (*_i_planes_step(y, u, v, qp), y, u, v, qy, qu, qv)


def _p_scatter_multi_step(packed, qps, sy, su, sv, ref_y, ref_u, ref_v, *, nscap: int,
                          cap: int, tile_w: int, density: int | None, entropy=None):
    """K delta frames in one dispatch: row k of ``packed`` (K, F) is frame
    k's tile upload, ``qps[k]`` its QP. The source planes (written in
    place) and the recon chain carry from frame k-1 to frame k, as the JAX
    scan's carry does; the K downlinks come back stacked, so the group is
    one device-to-host copy. -> (prefixes, dense headers, row buffers,
    recon y, u, v, source y, u, v)."""
    outs = []
    y, u, v, ry, ru, rv = sy, su, sv, ref_y, ref_u, ref_v
    for pk, qp in zip(packed, qps):
        prefix, dense, buf, ry, ru, rv, y, u, v = _p_scatter_step(
            pk, qp, y, u, v, ry, ru, rv, nscap=nscap, cap=cap, tile_w=tile_w, density=density,
            entropy=entropy)
        outs.append((prefix, dense, buf))
    prefixes, denses, bufs = (torch.stack(t) for t in zip(*outs))
    return prefixes, denses, bufs, ry, ru, rv, y, u, v


def _p_scatter_multi_step2(packed, qps, sy, su, sv, py, pu, pv, ref_y, ref_u, ref_v, *,
                           nscap: int, cap: int, tile_w: int, bucket: int, cbucket: int,
                           density: int | None, entropy=None):
    """Grouped ``_p_scatter_step2``: the slot pool carries too, so frame k's
    remaps may read slots that frame k-1's uploads inserted (the host
    cache's split() ran in frame order)."""
    outs = []
    y, u, v, ry, ru, rv = sy, su, sv, ref_y, ref_u, ref_v
    for pk, qp in zip(packed, qps):
        prefix, dense, buf, ry, ru, rv, y, u, v, py, pu, pv = _p_scatter_step2(
            pk, qp, y, u, v, py, pu, pv, ry, ru, rv, nscap=nscap, cap=cap, tile_w=tile_w,
            bucket=bucket, cbucket=cbucket, density=density, entropy=entropy)
        outs.append((prefix, dense, buf))
    prefixes, denses, bufs = (torch.stack(t) for t in zip(*outs))
    return prefixes, denses, bufs, ry, ru, rv, y, u, v, py, pu, pv


@dataclass
class _Pending:
    """One frame in the encode pipeline."""

    # "static" | "i" | "p" (full P, dense downlink) | "pd" (delta P, sparse
    # downlink) | "pb" (full P, device-entropy downlink)
    kind: str
    frame_index: int
    qp: int
    frame_num: int
    idr_pic_id: int
    t0: float
    t1: float = 0.0
    meta: object = None
    au: bytes | None = None  # static only
    prefix_d: object = None
    buf_d: object = None
    hdr_d: object = None  # pd: dense header for the ns > nscap fallback; pb: for the overflow
    words_d: object = None  # pb: the whole bit / token word buffer (spill fetch)
    fetch: Fetch | None = None  # the downlink copy, enqueued at dispatch (not grouped)
    future: object = None  # completion future (fetch + unpack + pack on a worker)
    batch_slot: int = -1  # >= 0: index into a shared group future's result list
    # t_disp is the wall clock just before the step's dispatch: a worker's
    # step_ms runs from it; up_ms is the host front end before it
    t_disp: float = 0.0
    up_ms: float = 0.0
    classify_ms: float = 0.0
    convert_ms: float = 0.0
    h2d_ms: float = 0.0
    # a group candidate: when it joined the pending group, and its wait
    # there until its group's dispatch started (0 for a frame dispatched
    # on its own)
    t_pend: float = 0.0
    group_wait_ms: float = 0.0
    scene_cut: bool = False
    n_up: int = 0
    n_remap: int = 0
    # LTR scene cache slice-header fields (bitstream.write_slice_header)
    ltr_ref: int | None = None  # predict from long-term reference j
    mark_ltr: int | None = None  # mark the previous frame as long-term index k
    mmco_evict: tuple = ()  # MMCO 1 differences for stale short-term frames


class TorchH264Encoder:
    """Stateful per-stream encoder: frame in, Annex-B access unit out.

    ``device=None`` means ``cuda`` and raises without a card; pass
    ``device="cpu"`` to run on the CPU. Keyword names, defaults and env
    defaults (``SELKIES_TILE_CACHE``, ``SELKIES_PACK_DENSITY``,
    ``SELKIES_PACK_WORKERS``, ``SELKIES_DEVICE_ENTROPY``,
    ``SELKIES_BITS_MIN_MBS``, ``SELKIES_ENTROPY_CODER``, ``SELKIES_BANDS``
    and FramePrep's) are the JAX encoder's; the AUTO values resolve as on
    the JAX encoder's CPU backend (device entropy off, CAVLC). The
    device-conversion path keeps
    the coder but never device entropy. ``submit`` returns the frames that
    completed, oldest first; ``flush`` completes the rest."""

    codec = "h264"
    # submit() takes capture-layer damage-rect hints (FramePrep.scan)
    accepts_damage = True
    # small delta-downlink fetch (int16 words); the only other fetch size
    # is the whole fused buffer
    PFX_SMALL = 1 << 14

    def __init__(self, width: int, height: int, qp: int = 28, fps: int = 60,
                 channels: int = 4, keyframe_interval: int = 0, host_convert: bool = True,
                 pipeline_depth: int = 2, frame_batch: int = 4, scene_qp_boost: int = 0,
                 device_entropy: bool | None = None, bits_min_mbs: int | None = None,
                 entropy_coder: str | None = None, ltr_scenes: bool = True,
                 tile_cache: int | None = None,
                 packed_downlink: bool | None = None, pack_density: int | None = None,
                 bands: int | None = None, device=None):
        if channels not in (3, 4):
            raise ValueError(f"channels must be 3 (RGB) or 4 (BGRx), got {channels}")
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.fps = fps
        self.channels = channels
        self.keyframe_interval = int(keyframe_interval)  # 0 = infinite GOP
        self.scene_qp_boost = int(scene_qp_boost)
        self.set_qp(qp)
        # CAVLC (Baseline) or CABAC (Main): PPS-scoped, so every slice of the
        # stream uses the same coder
        self._coder = entropy_coder_default(entropy_coder)
        self.params = StreamParams(width=width, height=height, qp=self.qp, fps=fps,
                                   entropy_coder=self._coder)
        self._headers = write_sps(self.params) + write_pps(self.params)
        self._pad_h = (height + 15) // 16 * 16
        self._pad_w = (width + 15) // 16 * 16
        self._mbh, self._mbw = self._pad_h // 16, self._pad_w // 16
        self._hdr_words_i = i_header_words(self._mbh, self._mbw)
        self._hdr_words_p = p_header_words(self._mbh, self._mbw)
        self.pipeline_depth = max(0, int(pipeline_depth))
        # intra-frame slicing is TorchBandedH264Encoder's (parallel/bands.py);
        # here ``bands`` only sizes the pack pool, for a caller that runs one
        # instance per band. Imported here, so that the row does not load
        # the whole parallel package
        if bands is None:
            from selkies_tpu_torch.parallel.bands import bands_from_env

            bands = bands_from_env()
        self.bands = int(bands)
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
        # one conversion slot per frame that may be in flight, plus one
        self._prep = (FramePrep(width, height, self._pad_w, self._pad_h,
                                nslots=self.pipeline_depth + 2)
                      if host_convert and channels == 4 else None)
        # device entropy: full P frames ship their coded slice; delta frames
        # decide per frame on the device (host conversion only). ``_entropy``
        # is the (bits_words, min_mbs, buckets, coder) the delta steps take
        (self.device_entropy, self.bits_min_mbs, self._bits_words,
         self._entropy) = resolve_entropy(self._mbh * self._mbw, device_entropy, bits_min_mbs,
                                          entropy_coder=self._coder)
        if self._prep is None:
            self.device_entropy, self._entropy = False, None
        ntx = self._pad_w // self._tile_w
        self._ntiles = self._mbh * ntx
        self._delta_buckets = delta_buckets_for(width, height)
        # grouped dispatch: consecutive delta frames go to the card as one
        # upload, one dispatch and one fetch; groups are frame_batch frames,
        # then a half group, then singles (_flush_batch)
        self.frame_batch = max(1, int(frame_batch))
        self._batch_sizes = tuple(
            sorted({self.frame_batch, max(2, self.frame_batch // 2)}, reverse=True)
        ) if self.frame_batch > 1 else ()
        self._batch_cap = self.frame_batch  # set_batch_cap
        self._batch_pend: list = []  # (rec, yb, ub, vb, up_idx, pool_dst, pairs)
        self.group_sizes: Counter = Counter()  # _flush_batch's dispatches by group size
        # a group's upload pads to this ladder, not the single-frame one
        self.BATCH_BUCKETS = tuple(sorted({16, 4 * ntx, 16 * ntx} | (
            {self._delta_buckets[0]} if self._delta_buckets else set())))
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
        self._up_batch_buckets = (0,) + self.BATCH_BUCKETS
        self._ltr_probe: object = ()  # _classify's scene-cache match, () if not run
        self.link_bytes = LinkByteCounter()
        # last-seen tile-cache totals, for per-frame telemetry deltas
        self._tc_seen = (0, 0, 0)
        # completion workers (fetch + unpack + pack), and a separate pool for
        # a group's per-slot packs: a group's coordinator blocks on its slots,
        # so the two must not share workers
        self._inflight: deque = deque()
        self._workers = ThreadPoolExecutor(max_workers=max(2, self.pipeline_depth + 1),
                                           thread_name_prefix="h264-complete")
        pack_workers = int(os.environ.get("SELKIES_PACK_WORKERS", "0") or 0)
        if pack_workers <= 0:
            pack_workers = min(os.cpu_count() or 4,
                               max(2, self.bands * self.frame_batch
                                   * max(1, self.pipeline_depth)))
        self._pack_pool = (ThreadPoolExecutor(max_workers=pack_workers,
                                              thread_name_prefix="h264-pack")
                           if self.frame_batch > 1 else None)
        # the delta-downlink fetch hint (int16 words), from recent frames;
        # completion workers update it, the submit thread reads it
        self._pfx_recent: deque = deque(maxlen=8)
        self._pfx_lock = threading.Lock()
        self._size_downlink()
        self._ref: tuple | None = None  # recon planes: the next P frame's reference
        self._src: tuple | None = None  # resident source planes: the delta base
        self._prev_frame: np.ndarray | None = None  # device-conversion mode only
        self._prev_kind = "full"  # the first frame is not a scene cut
        self._full_run = 0  # consecutive full frames
        self._allskip: PFrameCoeffs | None = None
        # LTR scene cache: two slots of a scene-cut frame's source and recon
        # planes and its capture. The frame after a cut marks it long-term
        # (MMCO 3); a full frame that matches a slot within the delta budget
        # is coded as a delta against that long-term reference. New scenes
        # go to the slot that was not most recently used (_ltr_mru).
        self.ltr_scenes = bool(ltr_scenes) and self._prep is not None
        self._ltr_slots: list[dict | None] = [None, None]
        self._ltr_mru = 1
        self._ltr_candidate: dict | None = None
        self.ltr_restores = 0
        # the decoder's short-term reference frame_nums in decode order:
        # marking slices replace the sliding window, so they evict these
        # themselves (MMCO 1)
        self._dpb_st: list[int] = []
        self._t_conv_ms = self._t_h2d_ms = self._t_disp0 = 0.0
        self._gpu0 = None  # the step's first-op event (tracing on, a card)
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

    @property
    def entropy_coder(self) -> str:
        """The stream's entropy coder, "cavlc" or "cabac"."""
        return self._coder

    @property
    def h264_profile(self) -> str:
        """The profile the SPS declares: "main" (CABAC) or "baseline"."""
        return "main" if self._coder == "cabac" else "baseline"

    def retune_entropy(self, device_entropy: bool | None = None,
                       bits_min_mbs: int | None = None,
                       entropy_coder: str | None = None) -> bool:
        """Re-resolve the device-entropy knobs at run time; returns True when
        anything changed. The downlink knobs change no byte, only what
        crosses the link, and the downlink sizing follows them (refused
        while frames are in flight, whose completion reads that sizing,
        unless the delta steps' consts stay the same). ``entropy_coder``
        switches the stream's coder, which changes the bitstream: refused
        with frames in flight; new SPS/PPS go out with a forced IDR. The
        device-conversion path has no device entropy and returns False."""
        if self._prep is None:
            return False
        coder = self._coder if entropy_coder is None else entropy_coder_default(entropy_coder)
        de, bm, bw, ent = resolve_entropy(self._mbh * self._mbw, device_entropy, bits_min_mbs,
                                          entropy_coder=coder)
        if de == self.device_entropy and bm == self.bits_min_mbs and coder == self._coder:
            return False
        if coder == self._coder and ent == self._entropy and bw == self._bits_words:
            # only the threshold with the device coder off: nothing to resize
            self.device_entropy, self.bits_min_mbs = de, bm
            return True
        if self._inflight or self._batch_pend:
            raise RuntimeError("retune_entropy with frames in flight; flush first")
        # recompile sentinel: where JAX's partials rebuild (the port builds
        # nothing here, so the mark attributes no build)
        jitprof.mark("actuation", "entropy-coder-switch" if coder != self._coder
                     else "entropy-retune")
        self.device_entropy, self.bits_min_mbs = de, bm
        self._bits_words, self._entropy = bw, ent
        if coder != self._coder:
            self._coder = coder
            self.params = StreamParams(width=self.width, height=self.height, qp=self.qp,
                                       fps=self.fps, entropy_coder=coder)
            self._headers = write_sps(self.params) + write_pps(self.params)
            # the decoder must see the new PPS before a slice of the other coder
            self.force_keyframe()
        self._size_downlink()
        return True

    def _size_downlink(self) -> None:
        """The delta downlink's full length and a fresh fetch hint, for the
        current layout (sparse, bit-packed, entropy-wrapped)."""
        if self._entropy is not None:
            total = p_sparse_entropy_words(self._mbh, self._mbw, self._nscap, self._cap_delta,
                                           self._density is not None, self._bits_words,
                                           entropy_coder=self._coder)
        elif self._density is not None:
            total = p_sparse_packed_words(self._mbh, self._mbw, self._nscap, self._cap_delta)
        else:
            total = p_sparse_var_words(self._mbh, self._mbw, self._nscap, self._cap_delta)
        with self._pfx_lock:
            self._pfx_total = total
            self._pfx_recent.clear()
            self._pfx_hint = min(self.PFX_SMALL, total)

    def set_tile_cache(self, enabled: bool) -> bool:
        """Turn the uplink tile cache on or off at run time (the policy
        actuator's knob); returns True when the state changed. Byte-safe at
        any frame boundary: a remap reproduces the pixels an upload would.
        Only an encoder built with cache slots can toggle it, and turning it
        back on starts from an empty cache (the pool went stale meanwhile).
        Pending group payloads were split for the old mode: they dispatch
        first."""
        enabled = bool(enabled)
        if self.tile_cache_slots <= 0 or not self._delta_buckets:
            return False
        if enabled == (self._tcache is not None):
            return False
        self._flush_batch()
        self._tcache = (TileCache(self.height, self.width, self._tile_w, self.tile_cache_slots)
                        if enabled else None)
        self._pool_d = None
        return True

    def set_batch_cap(self, cap: int) -> bool:
        """Cap the grouped-dispatch size; returns True when it changed. The
        cap snaps down to a group size _flush_batch uses (1, frame_batch//2,
        frame_batch). Grouped and single dispatches give the same bytes, so
        this is safe at any frame boundary."""
        cap = max(1, min(int(cap), self.frame_batch))
        cap = max(s for s in (1,) + self._batch_sizes if s <= cap)
        if cap == self._batch_cap:
            return False
        self._batch_cap = cap
        if len(self._batch_pend) >= cap:
            self._flush_batch()
        return True

    def load_jax_state(self, state: dict) -> None:
        """Continue a stream that the JAX encoder started (taken after its
        ``flush()``: nothing pending or in flight on either side).

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
          ``hits``, ``misses``, ``evictions``, or None);
        * the LTR scene cache, optionally: ``ltr_slots`` (two entries, each
          None or a dict of ``src`` and ``ref`` planes and the ``cap``
          capture), ``ltr_candidate`` (None or such a dict with its
          ``slot``), ``ltr_mru``, ``dpb_st``, ``ltr_restores``.

        This system has no weights: its state is these planes on the device
        and this host bookkeeping."""
        if self._inflight or self._batch_pend:
            raise RuntimeError("load_jax_state with frames in flight; flush() first")
        plane = ((self._pad_h, self._pad_w), (self._pad_h // 2, self._pad_w // 2),
                 (self._pad_h // 2, self._pad_w // 2))

        def planes(arrs, want, what):
            arrs = tuple(np.array(a, dtype=np.uint8) for a in arrs)
            if tuple(a.shape for a in arrs) != want:
                raise ValueError(f"{what} planes {[a.shape for a in arrs]} != {list(want)}")
            return tuple(torch.from_numpy(a).to(self.device) for a in arrs)

        def scene(s, what):
            if s is None:
                return None
            out = {"src": planes(s["src"], plane, what + " source"),
                   "ref": planes(s["ref"], plane, what + " reference"),
                   "cap": np.array(s["cap"], copy=True)}
            if "slot" in s:
                out["slot"] = int(s["slot"])
            return out

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
        with self._pfx_lock:
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
        slots = state.get("ltr_slots") or (None, None)
        self._ltr_slots = [scene(s, f"LTR slot {j}") for j, s in enumerate(slots)]
        self._ltr_candidate = scene(state.get("ltr_candidate"), "LTR candidate")
        self._ltr_mru = int(state.get("ltr_mru", 1))
        self._dpb_st = [int(n) for n in state.get("dpb_st", ())]
        self.ltr_restores = int(state.get("ltr_restores", 0))

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
        seed the pool after its full upload. An over-budget frame that a
        remembered scene covers is "full" for the LTR restore; the match
        is kept in _ltr_probe for submit."""
        self._ltr_probe = ()
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
        if len(band_i) > cap:
            if self.ltr_scenes:
                self._ltr_probe = self._ltr_match(frame)
                if self._ltr_probe is not None:
                    return "full", None
            # a sampled probe skips the split when over-budget content is
            # not pool-resident (video), so sustained motion reads ~8 hashes
            if self._tcache.probe(frame, idx, hashes=res.hashes) < 0.5:
                return "full", ("seed", idx, res.hashes)
        payload = self._tcache.split(frame, idx, max_up=cap, hashes=res.hashes)
        if payload is None:
            return "full", ("seed", idx, res.hashes)
        return "delta", payload

    def _emit_classify_telemetry(self, kind: str, payload) -> None:
        """Fold one frame's classification into the telemetry bus: per-tile
        cache hit/miss/evict deltas and the frame's upload class (a delta
        whose upload list is empty is a pure-remap frame). Called only when
        telemetry is enabled."""
        tc = self._tcache
        if tc is not None:
            hits, misses, evs = tc.hits, tc.misses, tc.evictions
            dh, dm, de = (hits - self._tc_seen[0], misses - self._tc_seen[1],
                          evs - self._tc_seen[2])
            self._tc_seen = (hits, misses, evs)
            if dh:
                telemetry.count("selkies_tile_cache_tiles_total", dh, result="hit")
            if dm:
                telemetry.count("selkies_tile_cache_tiles_total", dm, result="miss")
            if de:
                telemetry.count("selkies_tile_cache_tiles_total", de, result="evict")
            if kind == "delta" and isinstance(payload, tuple) and len(payload[0]) == 0:
                kind = "remap_only"
        telemetry.count("selkies_tile_cache_frames_total", kind=kind)

    def _allskip_slice(self, frame_num: int, mark_ltr: int | None = None,
                       mmco_evict: tuple = ()) -> bytes:
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
        if self._coder == "cabac":
            return pack_slice_p_cabac(self._allskip, self.params, frame_num, mark_ltr=mark_ltr,
                                      mmco_evict=mmco_evict)
        return pack_slice_p_fast(self._allskip, self.params, frame_num=frame_num,
                                 mark_ltr=mark_ltr, mmco_evict=mmco_evict)

    # -- uploads and the full steps --

    def _put_timed(self, arr: np.ndarray) -> torch.Tensor:
        t0 = time.perf_counter()
        out = to_device(arr, self.device)
        self._t_h2d_ms += (time.perf_counter() - t0) * 1e3
        return out

    def _convert_timed(self, frame: np.ndarray):
        t0 = time.perf_counter()
        planes = self._prep.convert(frame)
        t1 = time.perf_counter()
        self._t_conv_ms += (t1 - t0) * 1e3
        tracer.record("convert", t0, t1)
        return planes

    def _convert_tiles_timed(self, frame: np.ndarray, idx):
        t0 = time.perf_counter()
        out = self._prep.convert_tiles(frame, idx, self._tile_w)
        t1 = time.perf_counter()
        self._t_conv_ms += (t1 - t0) * 1e3
        tracer.record("convert", t0, t1)
        return out

    def _upload_planes(self, frame: np.ndarray):
        """Host conversion + one copy per plane; the planes become the
        resident delta base."""
        planes = self._convert_timed(frame)
        self.link_bytes.add("up_full", sum(p.nbytes for p in planes))
        with tracer.span("h2d"):
            return tuple(self._put_timed(p) for p in planes)

    def _upload_frame(self, frame: np.ndarray) -> torch.Tensor:
        self.link_bytes.add("up_full", frame.nbytes)
        with tracer.span("h2d"):
            return self._put_timed(frame)

    def _step_begin(self) -> None:
        """Stamp the start of a device step's issue (``_t_disp0``, where
        ``step_ms`` starts) and, with tracing on, its first-op event."""
        self._t_disp0 = time.perf_counter()
        self._gpu0 = tracer.gpu_mark(self.device)

    def _step_issued(self) -> None:
        """The step call returned: its issue is a ``device-step`` span."""
        tracer.record("device-step", self._t_disp0)

    def _device_planes(self, frame_t: torch.Tensor):
        return _convert_pad(frame_t, pad_h=self._pad_h, pad_w=self._pad_w,
                            channels=self.channels)

    def _run_step_i(self, frame: np.ndarray):
        if self._prep is not None:
            y, u, v = self._upload_planes(frame)
            self._step_begin()
            out = _i_planes_step(y, u, v, self.qp)
            self._step_issued()
            self._src = (y, u, v)
            return out
        frame_t = self._upload_frame(frame)
        self._step_begin()
        out = _i_planes_step(*self._device_planes(frame_t), self.qp)
        self._step_issued()
        return out

    def _run_step_p(self, frame: np.ndarray):
        """Full P -> (kind, prefix, words or None, dense header or None, rows
        buf, recon y, u, v): kind "pb" with device entropy, else "p"."""
        if self._prep is not None:
            y, u, v = self._upload_planes(frame)
            self._step_begin()
            if self.device_entropy:
                step = _p_toks_step if self._coder == "cabac" else _p_bits_step
                out = step(y, u, v, self.qp, *self._ref)
                self._step_issued()
                self._src = (y, u, v)
                return ("pb", *out)
            out = _p_planes_step(y, u, v, self.qp, *self._ref)
            self._step_issued()
            self._src = (y, u, v)
            return ("p", out[0], None, None, *out[1:])
        frame_t = self._upload_frame(frame)
        self._step_begin()
        out = _p_planes_step(*self._device_planes(frame_t), self.qp, *self._ref)
        self._step_issued()
        return ("p", out[0], None, None, *out[1:])

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
        with tracer.span("h2d"):
            pr_d = self._put_timed(pr)
        _pool_seed_step(pr_d, *self._src, *self._get_pool(), tile_w=self._tile_w,
                        sbucket=sbucket)

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

    def _p_consts(self) -> dict:
        return dict(nscap=self._nscap, cap=self._cap_delta, tile_w=self._tile_w,
                    density=self._density, entropy=self._entropy)

    def _pack_uploads(self, frames: list, batch: bool):
        """Pack each frame's converted tiles (``_delta_tiles``) into an
        upload buffer padded to one bucket, the smallest that holds the
        largest frame on the single-frame ladder or, for a group
        (``batch``), the batch ladder. -> (buffers, bucket, cbucket)."""
        most = max(len(t[3]) for t in frames)
        if self._tcache is not None:
            ladder = self._up_batch_buckets if batch else self._up_buckets
            bucket = next(b for b in ladder if b >= most)
            cbucket = next(cb for cb in self._copy_buckets if cb >= max(len(t[5]) for t in frames))
            return [self._pack_tiles2(*t, bucket, cbucket) for t in frames], bucket, cbucket
        bucket = next(b for b in (self.BATCH_BUCKETS if batch else self._delta_buckets)
                      if b >= most)
        return [self._pack_tiles(*t[:4], bucket) for t in frames], bucket, None

    def _delta_tiles(self, frame: np.ndarray, payload) -> tuple:
        """A delta payload -> (yb, ub, vb, up_idx, pool_dst, pairs): the
        upload tiles converted now. With the tile cache the payload is its
        split; without it, dirty indices (no pool slots, no remaps)."""
        up_idx, pool_dst, pairs = payload if self._tcache is not None else (payload, None, None)
        return (*self._convert_tiles_timed(frame, up_idx), up_idx, pool_dst, pairs)

    def _step_tiles(self, tiles: tuple, qp: int, *, idr: bool = False, stash: dict | None = None):
        """Upload one frame's converted dirty tiles (``_delta_tiles``) and run
        its delta step: the tiles are scattered into the resident source
        planes (in place) and the frame is encoded against the reference.
        An LTR restore (``stash``) scatters into a clone of the stash's
        source planes instead and encodes against the stash's recon: the
        stash must come out unchanged, as the same slot may be restored
        again before this frame's candidate replaces it. The scattered
        planes become the resident ones. -> (prefix, dense header or None,
        rows buf, recon y, u, v)."""
        tc = self._tcache is not None
        with tracer.span("h2d"):
            (packed,), bucket, cbucket = self._pack_uploads([tiles], batch=False)
            self.link_bytes.add("up_delta" if stash is None else "up_ltr", packed.nbytes)
            packed_d = self._put_timed(packed)
        pool = self._get_pool() if tc else ()
        self._step_begin()
        if stash is None:
            src, ref = self._src, self._ref
        else:
            src, ref = tuple(p.clone() for p in stash["src"]), stash["ref"]
        hdr_d = None
        if tc and idr:
            prefix_d, buf_d, ry, ru, rv, sy, su, sv, *_ = _i_scatter_step2(
                packed_d, qp, *src, *pool, tile_w=self._tile_w, bucket=bucket, cbucket=cbucket)
        elif tc:
            prefix_d, hdr_d, buf_d, ry, ru, rv, sy, su, sv, *_ = _p_scatter_step2(
                packed_d, qp, *src, *pool, *ref, bucket=bucket, cbucket=cbucket,
                **self._p_consts())
        elif idr:
            prefix_d, buf_d, ry, ru, rv, sy, su, sv = _i_scatter_step(
                packed_d, qp, *src, tile_w=self._tile_w)
        else:
            prefix_d, hdr_d, buf_d, ry, ru, rv, sy, su, sv = _p_scatter_step(
                packed_d, qp, *src, *ref, **self._p_consts())
        self._step_issued()
        self._src = (sy, su, sv)
        return prefix_d, hdr_d, buf_d, ry, ru, rv

    # -- LTR scene cache (a switch back to a remembered window) --

    def _dirty_vs(self, frame: np.ndarray, cap: np.ndarray) -> np.ndarray:
        """Per-tile inequality of two captures in FramePrep's geometry."""
        d = (frame != cap).any(axis=2)
        h, w = d.shape
        pb = np.zeros((self._pad_h, self._pad_w), bool)
        pb[:h, :w] = d
        nb, nt = self._pad_h // 16, self._pad_w // self._tile_w
        return pb.reshape(nb, 16, nt, self._tile_w).any(axis=(1, 3))

    @staticmethod
    def _ltr_quick_reject(frame: np.ndarray, cap: np.ndarray) -> bool:
        """Sampled pre-filter: a restore differs from its scene in at most
        the delta budget, so a >35% sampled mismatch cannot match."""
        s1, s2 = frame[8::48, 16::128], cap[8::48, 16::128]
        return float((s1 != s2).any(axis=-1).mean()) > 0.35

    def _ltr_match(self, frame: np.ndarray):
        """-> (slot, dirty_idx) of the best-matching remembered scene, or
        None when no slot matches within the delta-bucket budget."""
        if not self._delta_buckets:
            return None
        best = None
        for j, s in enumerate(self._ltr_slots):
            if s is None or s["cap"].shape != frame.shape:
                continue
            if self._ltr_quick_reject(frame, s["cap"]):
                continue
            band_i, tile_i = np.nonzero(self._dirty_vs(frame, s["cap"]))
            if len(band_i) > self._delta_buckets[-1]:
                continue
            if best is None or len(band_i) < len(best[1]):
                best = (j, (band_i * 1024 + tile_i).astype(np.int32))
        if best is None:
            return None
        j, idx = best
        if len(idx) == 0:
            # the capture equals the stash: rewrite tile 0 with its own
            # content so the scatter step has an input
            idx = np.zeros(1, np.int32)
        return j, idx

    def _stash_candidate(self, frame: np.ndarray, slot: int) -> None:
        """Snapshot this full frame as the pending LTR candidate: clones of
        the six planes (the next delta writes the resident ones in place)
        and the capture. The slot commits when the next frame emits MMCO 3."""
        if self._src is None or self._ref is None:
            return
        self._ltr_candidate = {
            "slot": int(slot),
            "src": tuple(p.clone() for p in self._src),
            "ref": tuple(p.clone() for p in self._ref),
            "cap": np.array(frame, copy=True),
        }

    # -- grouped delta dispatch (frame_batch > 1) --

    def _flush_batch(self) -> None:
        """Dispatch the pending delta frames: full groups of frame_batch,
        then a half group, then singles. Runs before any other dispatch, so
        the device's source and reference chain advances in frame order."""
        pend = self._batch_pend
        if not pend:
            return
        self._batch_pend = []
        tc = self._tcache is not None
        try:
            i = 0
            while i < len(pend):
                t_d0 = time.perf_counter()
                take = next((s for s in self._batch_sizes if len(pend) - i >= s), 1)
                group = pend[i: i + take]
                i += take
                self._t_h2d_ms = 0.0
                for g in group:
                    g[0].group_wait_ms = (t_d0 - g[0].t_pend) * 1e3
                if take == 1:
                    rec = group[0][0]
                    prefix_d, hdr_d, buf_d, ry, ru, rv = self._step_tiles(group[0][1:], rec.qp)
                    self._ref = (ry, ru, rv)
                    rec.prefix_d, rec.hdr_d, rec.buf_d = prefix_d, hdr_d, buf_d
                    rec.fetch = Fetch(self._pfx_slice(prefix_d), self._gpu0)
                    rec.batch_slot = -1
                    rec.t_disp = self._t_disp0
                    rec.h2d_ms += self._t_h2d_ms
                    rec.up_ms = rec.classify_ms + rec.convert_ms + (rec.t_disp - t_d0) * 1e3
                    self.group_sizes[1] += 1
                    rec.future = self._workers.submit(self._complete_work, rec)
                    continue
                qps = [g[0].qp for g in group]
                with tracer.span("h2d"):
                    bufs, bucket, cbucket = self._pack_uploads([g[1:] for g in group],
                                                               batch=True)
                    packed = np.stack(bufs)
                    self.link_bytes.add("up_delta", packed.nbytes)
                    packed_d = self._put_timed(packed)
                self._step_begin()
                if tc:
                    prefixes_d, denses_d, bufs_d, ry, ru, rv, sy, su, sv, *_ = (
                        _p_scatter_multi_step2(packed_d, qps, *self._src, *self._get_pool(),
                                               *self._ref, bucket=bucket, cbucket=cbucket,
                                               **self._p_consts()))
                else:
                    prefixes_d, denses_d, bufs_d, ry, ru, rv, sy, su, sv = (
                        _p_scatter_multi_step(packed_d, qps, *self._src, *self._ref,
                                              **self._p_consts()))
                self._step_issued()
                self._src, self._ref = (sy, su, sv), (ry, ru, rv)
                fetch = Fetch(self._pfx_slice(prefixes_d), self._gpu0)
                recs = [g[0] for g in group]
                # the group's host front end (pack + h2d) is stamped on every
                # member, beside each frame's own classify and convert
                t_disp = self._t_disp0
                grp_ms = (t_disp - t_d0) * 1e3
                for rec in recs:
                    rec.t_disp = t_disp
                    rec.h2d_ms += self._t_h2d_ms
                    rec.up_ms = rec.classify_ms + rec.convert_ms + grp_ms
                self.group_sizes[take] += 1
                shared = self._workers.submit(self._complete_batch, recs, fetch,
                                              list(prefixes_d), denses_d, bufs_d)
                for slot, rec in enumerate(recs):
                    rec.future = shared
                    rec.batch_slot = slot
        except Exception:
            # frames not yet dispatched never produce AUs: drop their
            # records (the forced IDR next frame heals the frame_num gap);
            # groups already dispatched stay deliverable
            dropped = {id(g[0]) for g in pend if g[0].future is None}
            self._inflight = deque(r for r in self._inflight if id(r) not in dropped)
            self._ref = self._src = None
            self._reset_tile_cache()
            raise

    # -- the delta downlink's fetch hint --

    def _update_pfx_hint(self) -> None:
        """The fetch length from recent frames: the small slice while 1.5x
        the recent need fits it, else the whole fused buffer. Completion
        workers and the submit thread both run it."""
        with self._pfx_lock:
            want = max([2048] + [n * 3 // 2 for n in self._pfx_recent])
            self._pfx_hint = self.PFX_SMALL if want <= self.PFX_SMALL else self._pfx_total

    def _pfx_slice(self, prefix_d):
        """Hint-sized view of a fused delta downlink (or a group's stack of
        them), cut on the submit thread right behind the step."""
        with self._pfx_lock:
            n = self._pfx_hint
        if n >= self._pfx_total:
            return prefix_d
        return prefix_d[:n] if prefix_d.dim() == 1 else prefix_d[:, :n]

    def _note_need(self, need: int) -> None:
        with self._pfx_lock:
            self._pfx_recent.append(need)

    # -- encoding --

    def submit(self, frame: np.ndarray, qp: int | None = None, meta=None, damage=None) -> list:
        """Encode one (H, W, channels) uint8 frame; returns the frames that
        completed as ``[(au, FrameStats, meta)]``, oldest first: empty while
        the pipeline fills (``pipeline_depth`` device round trips, a group
        counting once) or a group accumulates.

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
        fi = get_injector()
        if fi is not None:
            # the "frontend" chaos site: a raise here leaves every frame in
            # flight deliverable in order (nothing has changed yet)
            fi.check("frontend")
        with tracer.span("classify"):
            kind, payload = self._classify(frame, damage)
        classify_ms = (time.perf_counter() - t0) * 1e3
        if telemetry.enabled:
            self._emit_classify_telemetry(kind, payload)
        batch_full = False
        orig_qp = self.qp
        # a scene cut is the transition into a full-frame change: that one
        # frame is coded with scene_qp_boost added to its QP
        scene_cut = kind == "full" and self._src is not None and self._prev_kind != "full"
        self._prev_kind = kind
        self._full_run = self._full_run + 1 if kind == "full" else 0
        # LTR: any full frame may be a switch back to a remembered scene,
        # matched against the slot table as it stands (the pending
        # candidate commits below, as the decoder applies this slice's
        # marking only after decoding it)
        ltr_hit = ltr_stash = None
        if self.ltr_scenes and not idr and kind == "full" and self._src is not None:
            hit = self._ltr_probe if self._ltr_probe != () else self._ltr_match(frame)
            if hit is not None:
                ltr_hit, ltr_stash = hit, self._ltr_slots[hit[0]]
        # this slice's MMCO 3 marks the previous full frame long-term
        mark_ltr = None
        if self.ltr_scenes and not idr and self._ltr_candidate is not None:
            cand, self._ltr_candidate = self._ltr_candidate, None
            self._ltr_slots[cand["slot"]] = cand
            mark_ltr = cand["slot"]
        # the decoder's DPB: a marking slice bypasses the sliding window and
        # must evict stale short-terms itself (MMCO 1), or the DPB would
        # exceed max_num_ref_frames = 3
        mmco_evict: tuple = ()
        if idr:
            self._dpb_st = [0]
        else:
            cur_fn = self._frames_since_idr % 256
            if mark_ltr is not None:
                prev_fn = (cur_fn - 1) % 256
                if prev_fn in self._dpb_st:
                    self._dpb_st.remove(prev_fn)  # it becomes long-term
                mmco_evict = tuple(sorted(((cur_fn - s) % 256) - 1 for s in self._dpb_st))
                self._dpb_st = [cur_fn]
            else:
                lt_count = sum(1 for s in self._ltr_slots if s is not None)
                if len(self._dpb_st) + lt_count >= 3:  # sliding window
                    self._dpb_st.pop(0)
                self._dpb_st.append(cur_fn)
        # a restore predicts from its own scene: no boost
        if scene_cut and self.scene_qp_boost and ltr_hit is None:
            self.qp = min(51, self.qp + self.scene_qp_boost)
        if kind == "static" and not idr:
            # unchanged capture: all-skip P slice on the host, no device
            # work; the screen went idle, so pending deltas dispatch now
            self._flush_batch()
            with tracer.span("allskip"):
                au = self._allskip_slice(self._frames_since_idr % 256, mark_ltr=mark_ltr,
                                         mmco_evict=mmco_evict)
            rec = _Pending(kind="static", frame_index=self.frame_index, qp=self.qp,
                           frame_num=self._frames_since_idr % 256, idr_pic_id=0, t0=t0,
                           t1=time.perf_counter(), meta=meta, au=au, mark_ltr=mark_ltr,
                           mmco_evict=mmco_evict, classify_ms=classify_ms, up_ms=classify_ms)
        elif (not idr and kind == "delta" and self.frame_batch > 1
              and (len(payload[0]) if self._tcache is not None else len(payload))
              <= self.BATCH_BUCKETS[-1]):
            # group candidate: convert the (post-remap) upload tiles now, as
            # the capture may be reused before the group dispatches
            self._t_conv_ms = 0.0
            tiles = self._delta_tiles(frame, payload)
            up_idx, pairs = tiles[3], tiles[5]
            rec = _Pending(kind="pd", frame_index=self.frame_index, qp=self.qp,
                           frame_num=self._frames_since_idr % 256, idr_pic_id=0, t0=t0,
                           meta=meta, mark_ltr=mark_ltr, mmco_evict=mmco_evict,
                           n_up=len(up_idx), n_remap=len(pairs) if pairs is not None else 0,
                           classify_ms=classify_ms, convert_ms=self._t_conv_ms)
            rec.t_pend = time.perf_counter()
            self._batch_pend.append((rec, *tiles))
            batch_full = len(self._batch_pend) >= self._batch_cap
        else:
            try:
                # dispatch order is frame order: pending deltas go first
                self._flush_batch()
                rec = self._dispatch(frame, kind, payload, idr, t0, classify_ms, scene_cut,
                                     meta, ltr_hit, ltr_stash, mark_ltr, mmco_evict)
            except Exception:
                # the old planes may be half-written: drop the chain so the
                # next frame self-heals as a full-upload IDR (which also
                # clears the LTR slots); frames already in flight stay
                # deliverable
                self._ref = self._src = None
                self._ltr_candidate = None
                self._reset_tile_cache()
                self.qp = orig_qp
                raise
        self.qp = orig_qp
        self.frame_index += 1
        self._frames_since_idr += 1
        self._inflight.append(rec)
        if batch_full:
            self._flush_batch()
        out = []
        while self._inflight:
            head = self._inflight[0]
            if head.au is not None or (head.future is not None and head.future.done()):
                out.append(self._emit(self._inflight.popleft()))
                continue
            # depth counts device round trips (distinct futures): a group
            # of K frames is one
            busy = len({id(r.future) for r in self._inflight
                        if r.future is not None and not r.future.done()})
            if busy > self.pipeline_depth:
                out.append(self._emit(self._inflight.popleft()))  # waits
                continue
            # frame backstop: pipeline_depth round trips of groups plus the
            # group accumulating
            if len(self._inflight) > (self.pipeline_depth + 1) * self.frame_batch:
                if head.future is None:
                    self._flush_batch()  # give the stalled head a future
                else:
                    out.append(self._emit(self._inflight.popleft()))
                continue
            break
        return out

    def _dispatch(self, frame, kind, payload, idr, t0, classify_ms, scene_cut, meta,
                  ltr_hit, ltr_stash, mark_ltr, mmco_evict) -> _Pending:
        """Upload and run one frame's device step, enqueue its downlink
        copy and hand its completion to a worker; the recon becomes the
        reference."""
        t_d0 = time.perf_counter()
        self._t_conv_ms = self._t_h2d_ms = self._t_disp0 = 0.0
        self._gpu0 = None
        hdr_d = words_d = None
        if idr:
            if kind == "delta":
                prefix_d, hdr_d, buf_d, ry, ru, rv = self._step_tiles(
                    self._delta_tiles(frame, payload), self.qp, idr=True)
            elif kind == "static" and self._src is not None:
                self._step_begin()
                prefix_d, buf_d, ry, ru, rv = _i_resident_step(self.qp, *self._src)
                self._step_issued()
            else:
                prefix_d, buf_d, ry, ru, rv = self._run_step_i(frame)
            rec = _Pending(kind="i", frame_index=self.frame_index, qp=self.qp, frame_num=0,
                           idr_pic_id=self._idr_pic_id, t0=t0, meta=meta)
            rec.fetch = Fetch(prefix_d, self._gpu0)
            self._frames_since_idr = 0
            self._idr_pic_id = (self._idr_pic_id + 1) % 2
            self._force_idr = False
        else:
            n_up = n_remap = 0
            ltr_ref = None
            if ltr_hit is not None:
                # scene restore: a few tiles against the slot's long-term
                # reference instead of a full-frame upload
                idx = ltr_hit[1]
                tiles = self._delta_tiles(
                    frame, self._tcache.split(frame, idx) if self._tcache is not None else idx)
                prefix_d, hdr_d, buf_d, ry, ru, rv = self._step_tiles(tiles, self.qp,
                                                                      stash=ltr_stash)
                pk, ltr_ref, n_up = "pd", ltr_hit[0], len(idx)
                self.ltr_restores += 1
            elif kind == "delta":
                prefix_d, hdr_d, buf_d, ry, ru, rv = self._step_tiles(
                    self._delta_tiles(frame, payload), self.qp)
                pk = "pd"
                if isinstance(payload, tuple):  # tile-cache split
                    n_up, n_remap = len(payload[0]), len(payload[2])
                else:
                    n_up = len(payload)
            else:
                pk, prefix_d, words_d, hdr_d, buf_d, ry, ru, rv = self._run_step_p(frame)
            rec = _Pending(kind=pk, frame_index=self.frame_index, qp=self.qp,
                           frame_num=self._frames_since_idr % 256, idr_pic_id=0, t0=t0,
                           meta=meta, scene_cut=scene_cut, n_up=n_up, n_remap=n_remap,
                           ltr_ref=ltr_ref, mark_ltr=mark_ltr, mmco_evict=mmco_evict)
            rec.fetch = Fetch(self._pfx_slice(prefix_d) if pk == "pd" else prefix_d,
                               self._gpu0)
        self._ref = (ry, ru, rv)
        rec.prefix_d, rec.buf_d, rec.hdr_d, rec.words_d = prefix_d, buf_d, hdr_d, words_d
        rec.t_disp = self._t_disp0 or time.perf_counter()
        rec.classify_ms, rec.convert_ms, rec.h2d_ms = classify_ms, self._t_conv_ms, self._t_h2d_ms
        rec.up_ms = classify_ms + (rec.t_disp - t_d0) * 1e3
        # an over-budget frame that fell back to a full upload seeds the pool
        # from the now-resident planes (first two frames of a full run only)
        if (self._tcache is not None and kind == "full" and isinstance(payload, tuple)
                and self._src is not None and self._full_run <= 2):
            self._seed_pool(frame, payload[1], payload[2])
        # every full frame (IDR, full P, restore) becomes the pending LTR
        # candidate: a restore refreshes its own slot and becomes the most
        # recently used, a new scene goes to the other slot
        if self.ltr_scenes:
            if idr:
                self._ltr_slots = [None, None]  # the decoder dropped every reference
                self._ltr_candidate = None
                self._ltr_mru = 0
                self._stash_candidate(frame, 0)
            elif ltr_hit is not None:
                self._ltr_mru = ltr_hit[0]
                self._stash_candidate(frame, ltr_hit[0])
            elif kind == "full" and self._full_run <= 2:
                self._stash_candidate(frame, 1 - self._ltr_mru)
        if kind == "full" and ltr_hit is None:
            # the frames after a full-frame change carry a frame-wide
            # residual tail: grow the fetch hint now
            self._note_need(self._pfx_total // 2)
            self._update_pfx_hint()
        rec.future = self._workers.submit(self._complete_work, rec)
        return rec

    def flush(self) -> list:
        """Complete every frame in flight, oldest first."""
        self._flush_batch()
        out = []
        while self._inflight:
            out.append(self._emit(self._inflight.popleft()))
        return out

    def _emit(self, rec: _Pending):
        """Resolve one frame (waiting on its worker if needed)."""
        if rec.kind == "static":
            stats = FrameStats(
                frame_index=rec.frame_index, idr=False, qp=rec.qp, bytes=len(rec.au),
                device_ms=(rec.t1 - rec.t0) * 1e3, pack_ms=0.0,
                skipped_mbs=self._mbh * self._mbw, upload_kind="static",
                upload_ms=rec.up_ms, classify_ms=rec.classify_ms)
            self.last_stats = stats
            return rec.au, stats, rec.meta
        try:
            with tracer.span("complete_wait"):
                res = rec.future.result()
            if rec.batch_slot >= 0:
                res = res[rec.batch_slot]
        except Exception:
            # the decoder never gets this frame: encoding successors against
            # its recon would desync it, so force an IDR and drop the pipeline
            self._ref = self._src = None
            self._inflight.clear()
            self._batch_pend.clear()
            self._reset_tile_cache()
            raise
        au, skipped, t1, tu, t2, mode, step_ms, fetch_ms = res
        delta = rec.kind == "pd"
        dirty = rec.n_up + rec.n_remap
        stats = FrameStats(
            frame_index=rec.frame_index, idr=rec.kind == "i", qp=rec.qp, bytes=len(au),
            device_ms=(t1 - rec.t0) * 1e3, pack_ms=(t2 - t1) * 1e3, skipped_mbs=skipped,
            scene_cut=rec.scene_cut, unpack_ms=(tu - t1) * 1e3, cavlc_ms=(t2 - tu) * 1e3,
            upload_ms=rec.up_ms, step_ms=step_ms, fetch_ms=fetch_ms,
            classify_ms=rec.classify_ms, convert_ms=rec.convert_ms, h2d_ms=rec.h2d_ms,
            group_wait_ms=rec.group_wait_ms, downlink_mode=mode,
            upload_kind="delta" if delta else "full",
            dirty_frac=min(1.0, dirty / self._ntiles) if delta else 1.0,
            remap_frac=rec.n_remap / dirty if delta and dirty else 0.0)
        self.last_stats = stats
        return au, stats, rec.meta

    # -- completion (worker threads) --

    def _complete_sparse_p(self, fused, full_d, dense_d, buf_d, rec: _Pending):
        """One delta frame's fetched sparse prefix -> (au, skipped_mbs,
        t_start, t_unpacked, t_done, mode). ``full_d`` is the frame's whole
        fused buffer for a shortfall refetch."""
        t1 = time.perf_counter()
        au, skipped, tu, mode = complete_sparse_slice(
            fused, mbh=self._mbh, mbw=self._mbw, nscap=self._nscap,
            cap_rows=self._cap_delta, qp=rec.qp, frame_num=rec.frame_num,
            params=self.params, packed=self._density is not None,
            device_bits=self._entropy is not None, full_d=full_d, buf_d=buf_d,
            dense_d=dense_d, link_bytes=self.link_bytes, prefix_bytes=fused.nbytes,
            note_need=self._note_need, ltr_ref=rec.ltr_ref, mark_ltr=rec.mark_ltr,
            mmco_evict=rec.mmco_evict, entropy_coder=self._coder)
        return au, skipped, t1, tu, time.perf_counter(), mode

    def _complete_batch(self, recs, fetch: Fetch, rows_d, denses_d, bufs_d):
        """A group's completion: one fetch of the stacked prefixes, then each
        frame's unpack and pack fanned out over the pack pool (the slices
        are independent and the native packer releases the GIL). Results in
        slot order."""
        prefixes, step_ms, fetch_ms = fetch.wait(recs[0].t_disp)
        args = [(prefixes[k], rows_d[k], denses_d[k], bufs_d[k], rec)
                for k, rec in enumerate(recs)]
        if self._pack_pool is not None and len(recs) > 1:
            futs = [self._pack_pool.submit(self._complete_sparse_p, *a) for a in args]
            results = [f.result() for f in futs]
        else:
            results = [self._complete_sparse_p(*a) for a in args]
        self._update_pfx_hint()
        return [(*r, step_ms, fetch_ms) for r in results]

    def _complete_work(self, rec: _Pending):
        """One dispatched frame's completion: wait for its downlink copy,
        unpack and pack. -> (au, skipped_mbs, t_start, t_unpacked, t_done,
        mode, step_ms, fetch_ms)."""
        fused, step_ms, fetch_ms = rec.fetch.wait(rec.t_disp or rec.t0,
                                                  fetch_span=rec.kind == "pd")
        if rec.kind == "pb":
            complete = self._complete_toks if self._coder == "cabac" else self._complete_bits
            return (*complete(rec, fused), step_ms, fetch_ms)
        if rec.kind == "pd":
            out = self._complete_sparse_p(fused, rec.prefix_d, rec.hdr_d, rec.buf_d, rec)
            self._update_pfx_hint()
            return (*out, step_ms, fetch_ms)
        self.link_bytes.add("down_prefix", fused.nbytes)
        header, data, n = split_prefix(
            fused, self._hdr_words_i if rec.kind == "i" else self._hdr_words_p)
        if n > CAP_ROWS:  # rows spilled past the prefix
            rest = fetch_rest(rec.buf_d, n, CAP_ROWS)
            self.link_bytes.add("down_spill", rest.nbytes)
            data = np.concatenate([data, rest])
        t1 = time.perf_counter()
        skipped = 0
        if rec.kind == "i":
            with tracer.span("unpack"):
                fc = unpack_i_compact(header, data, rec.qp)
            tu = time.perf_counter()
            pack_i = pack_slice_cabac if self._coder == "cabac" else pack_slice_fast
            with tracer.span("pack"):
                au = self._headers + pack_i(fc, self.params, frame_num=0, idr=True,
                                            idr_pic_id=rec.idr_pic_id)
            mode = ""  # a P-frame label: keyframes never ship device bits
        else:
            with tracer.span("unpack"):
                pfc = unpack_p_compact(header, data, rec.qp)
            tu = time.perf_counter()
            skipped = int(pfc.skip.sum())
            with tracer.span("pack"):
                au = self._pack_p(pfc, rec)
            mode = "coeff"
        return au, skipped, t1, tu, time.perf_counter(), mode, step_ms, fetch_ms

    def _pack_p(self, pfc: PFrameCoeffs, rec: _Pending) -> bytes:
        """A P slice's coefficients -> NAL with the stream's coder."""
        if self._coder == "cabac":
            return pack_slice_p_cabac(pfc, self.params, rec.frame_num, ltr_ref=rec.ltr_ref,
                                      mark_ltr=rec.mark_ltr, mmco_evict=rec.mmco_evict)
        return pack_slice_p_fast(pfc, self.params, frame_num=rec.frame_num, ltr_ref=rec.ltr_ref,
                                 mark_ltr=rec.mark_ltr, mmco_evict=rec.mmco_evict)

    def _dense_fallback(self, rec: _Pending):
        """A device-entropy full P frame whose coded slice overflowed its
        word cap: fetch the dense header and rows and pack on the host.
        -> (au, skipped_mbs, t_start, t_unpacked, t_done, "dense")."""
        header = host(rec.hdr_d)
        data = fetch_rest(rec.buf_d, int(header[0]), 0)
        self.link_bytes.add("down_spill", header.nbytes + data.nbytes)
        t1 = time.perf_counter()
        pfc = unpack_p_compact(header, data, rec.qp)
        tu = time.perf_counter()
        au = self._pack_p(pfc, rec)
        return au, int(pfc.skip.sum()), t1, tu, time.perf_counter(), "dense"

    def _spill_words(self, rec: _Pending, words: np.ndarray, need: int, held: int):
        """The words past the prefix's ``held`` when the slice needs
        ``need``: one more fetch from the whole word buffer."""
        if need <= held:
            return words
        with tracer.span("bits_fetch"):
            rest = fetch_rest(rec.words_d, need, held)
        self.link_bytes.add("down_bits_spill", rest.nbytes)
        return np.concatenate([words, rest])

    def _complete_bits(self, rec: _Pending, arr: np.ndarray):
        """A device-CAVLC full P frame: [nbits, trailing, nskip] ++ bit words
        -> the slice, with the header spliced on. -> (au, skipped_mbs,
        t_start, t_unpacked, t_done, mode)."""
        self.link_bytes.add("down_bits", arr.nbytes)
        nbits, trailing, skipped = int(arr[0]), int(arr[1]), int(arr[2])
        if nbits > BITS_WORD_CAP * 32:
            return self._dense_fallback(rec)
        need = (nbits + 31) // 32
        words = self._spill_words(rec, arr[3:3 + min(need, BITS_PREFIX_WORDS)], need,
                                  BITS_PREFIX_WORDS)
        t1 = time.perf_counter()
        au = assemble_p_nal(words, nbits, trailing, self.params, rec.frame_num, rec.qp,
                            ltr_ref=rec.ltr_ref, mark_ltr=rec.mark_ltr, mmco_evict=rec.mmco_evict)
        return au, skipped, t1, t1, time.perf_counter(), "bits"

    def _complete_toks(self, rec: _Pending, arr: np.ndarray):
        """A device-CABAC full P frame: [ntok, ns, nskip] ++ skip bitmap ++
        token counts ++ token words -> the slice, through the host engine."""
        self.link_bytes.add("down_bits", arr.nbytes)
        ntok, ns, skipped = int(arr[0]), int(arr[1]), int(arr[2])
        if ntok > 2 * TOK_WORD_CAP:
            return self._dense_fallback(rec)
        m = self._mbh * self._mbw
        sw, cw = (m + 31) // 32, (m + 1) // 2
        skip_words = np.ascontiguousarray(arr[3:3 + sw]).view(np.uint32).astype(np.int64)
        skip = (((skip_words[:, None] >> np.arange(32)) & 1).astype(bool).reshape(-1)[:m]
                .reshape(self._mbh, self._mbw))
        counts = np.ascontiguousarray(arr[3 + sw:3 + sw + cw]).view(np.int16)[:ns].astype(np.int64)
        base = 3 + sw + cw
        need = (ntok + 1) // 2
        words = self._spill_words(rec, arr[base:base + min(need, TOK_PREFIX_WORDS)], need,
                                  TOK_PREFIX_WORDS)
        t1 = time.perf_counter()
        au = assemble_p_cabac_nal(words, ntok, counts, skip, self.params, rec.frame_num, rec.qp,
                                  ltr_ref=rec.ltr_ref, mark_ltr=rec.mark_ltr,
                                  mmco_evict=rec.mmco_evict)
        return au, skipped, t1, t1, time.perf_counter(), "cabac"

    def encode_frame(self, frame: np.ndarray, qp: int | None = None) -> bytes:
        """Synchronous encode: complete Annex-B access unit out (SPS/PPS
        prepended on IDR). Refused while frames are in flight: their AUs
        would be lost, a frame_num gap the decoder sees."""
        if self._inflight:
            raise RuntimeError("encode_frame() called with frames in flight; use flush() first")
        outs = self.submit(frame, qp)
        outs.extend(self.flush())
        return outs[-1][0]

    def prewarm(self) -> None:
        """Build the libraries and run the hot steps (an IDR and a full P
        frame of seeded noise) before the live loop, then reset the GOP
        state as the JAX encoder does: the next frame is an IDR with
        ``frame_index`` 0. On the card the ME/MC kernel is built here too,
        so the first live frame pays no build."""
        if self.device.type == "cuda":
            me_mc.build()
        native.build()
        rng = np.random.default_rng(0)
        shape = (self.height, self.width, self.channels)
        f0 = rng.integers(0, 255, shape, np.uint8)
        f1 = rng.integers(0, 255, shape, np.uint8)
        self.encode_frame(f0)  # IDR full
        self.encode_frame(f1)  # P full
        self._force_idr = True
        self._ref = None
        self._src = None
        self._reset_tile_cache()
        if self._prep is not None:
            self._prep.reset()
        self._prev_frame = None
        self.frame_index = 0
        self._frames_since_idr = 0
        self._idr_pic_id = 0
        self._prev_kind = "full"

    def close(self) -> None:
        """Discard the frames in flight and stop the completion workers."""
        self._inflight.clear()
        self._batch_pend.clear()
        self._workers.shutdown(wait=False, cancel_futures=True)
        if self._pack_pool is not None:
            self._pack_pool.shutdown(wait=False, cancel_futures=True)

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
