"""Band and tile slicing: one frame encoded as several H.264 slices on one card.

Counterpart of ``selkies_tpu/parallel/bands.py`` (``BandedH264Encoder``)
in the form the JAX class takes when its device mesh is smaller than the
carve: one device step that applies the same per-band (or per-tile) graph
in a Python loop over a static count. Nothing is batched across bands:
each band's slice comes from the graph a single band would run alone,
which is what makes the per-band oracle a byte-identity statement.

* **Bands** (``SELKIES_BANDS``): the frame splits into ``bands``
  horizontal bands of equal MB rows, each an independent slice. A band's
  motion search sees its own reference rows plus ``halo`` neighbour rows
  (``encoder_core.encode_band_p_planes``); below the full reach of the
  search the candidate window is clamped, so every chosen prediction is
  real reference content, as the decoder's full-frame MC reads it.
* **Tile grid** (``SELKIES_TILE_GRID=RxC``): each band-row also splits
  into C tiles with ``halo_cols`` neighbour columns. The tiles of a row
  sum their coarse vote histograms and select one candidate list, and
  P_Skip is derived on the row's merged MV grid, so with the default
  full-reach halos an RxC access unit equals the ``bands=R`` one. Slices
  stay one per band-row: the tiles' coefficients merge into the row's
  layout before the pack.

The AUs equal JAX ``BandedH264Encoder(..., devices=[cpu])``'s byte for
byte, and so its mesh run's (tests/test_torch_bands.py,
tests/test_torch_tile_grid.py); ``bands=1`` equals ``TorchH264Encoder``
at ``frame_batch=1, pipeline_depth=0, ltr_scenes=False``.

On one card there is no parallelism inside a frame: a P frame issues
about ``bands * cols`` times the flat step's launches (the ME/MC kernel
runs once per band or tile). The JAX multi-device bodies (``shard_map``
with ``ppermute``, ``psum`` and ``all_gather``) wait for more than one
card (ROADMAP). The host half completes each band's downlink as one
slice (``sparse_complete.complete_sparse_slice`` with the band's
``first_mb``) on the pack pool. Each band's downlink copy is enqueued on
the dispatching thread right behind the step (``encoder._Fetch``), and
the completion waits on those events only.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from selkies_tpu_torch.device import resolve_device
from selkies_tpu_torch.models.frameprep import FramePrep
from selkies_tpu_torch.models.h264.bitstream import StreamParams, write_pps, write_sps
from selkies_tpu_torch.models.h264.cabac import pack_slice_cabac, pack_slice_p_cabac
from selkies_tpu_torch.models.h264.compact import (
    i_header_words,
    p_sparse_entropy_words,
    p_sparse_var_words,
    split_prefix,
    unpack_i_compact,
)
from selkies_tpu_torch.models.h264.device_cavlc import entropy_coder_default, resolve_entropy
from selkies_tpu_torch.models.h264.encoder import _Fetch, to_device
from selkies_tpu_torch.models.h264.encoder_core import (
    _downsample4,
    _skip_mask,
    coarse_votes,
    edge_pad,
    encode_band_p_planes,
    encode_frame_planes,
    encode_tile_p_planes,
    fuse_downlink,
    pack_i_compact,
    pack_p_sparse_entropy,
    pack_p_sparse_var,
    select_coarse,
)
from selkies_tpu_torch.models.h264.native import pack_slice_fast, pack_slice_p_fast
from selkies_tpu_torch.models.h264.numpy_ref import COARSE_R, MV_PAD, PFrameCoeffs
from selkies_tpu_torch.models.h264.sparse_complete import complete_sparse_slice, fetch_rest
from selkies_tpu_torch.models.stats import FrameStats, LinkByteCounter

logger = logging.getLogger("selkies_tpu_torch.parallel.bands")

__all__ = [
    "BAND_HALO",
    "MIN_BAND_MB_ROWS",
    "MIN_TILE_MB_COLS",
    "TorchBandedH264Encoder",
    "band_spans",
    "bands_from_env",
    "grid_from_env",
    "halo_from_env",
    "tile_halo_from_env",
    "usable_bands",
    "usable_cols",
]

# Default halo: the search's full reach (34 luma rows) plus the chroma
# bilinear's one-row lookahead, rounded up to MV_PAD, so no candidate needs
# clamping. A smaller halo (SELKIES_BAND_HALO) clamps the vertical window.
BAND_HALO = MV_PAD
# A band must be tall enough that a neighbour's halo comes from it alone:
# 3 MB rows = 48 luma / 24 chroma rows cover the default 40 / 20.
MIN_BAND_MB_ROWS = 3
# The column mirror: 48 luma columns cover the 40-column halo and the
# coarse vote's COARSE_R downsampled columns (8 <= 48 / 4).
MIN_TILE_MB_COLS = 3


def grid_from_env() -> tuple[int, int] | None:
    """SELKIES_TILE_GRID=RxC -> (rows, cols), or None when unset or
    invalid. Set, it owns the carve (SELKIES_BANDS is ignored)."""
    env = os.environ.get("SELKIES_TILE_GRID", "")
    if not env:
        return None
    try:
        r_s, c_s = env.lower().replace("×", "x").split("x")
        return max(1, int(r_s)), max(1, int(c_s))
    except ValueError:
        logger.warning("SELKIES_TILE_GRID=%r is not RxC; ignoring", env)
        return None


def bands_from_env() -> int:
    env = os.environ.get("SELKIES_BANDS", "")
    if not env:
        return 1
    try:
        return max(1, int(env))
    except ValueError:
        logger.warning("SELKIES_BANDS=%r is not an integer; using 1", env)
        return 1


def _halo_env(name: str) -> int:
    env = os.environ.get(name, "")
    if not env:
        return BAND_HALO
    try:
        halo = int(env)
    except ValueError:
        logger.warning("%s=%r is not an integer; using %d", name, env, BAND_HALO)
        return BAND_HALO
    halo = max(4, min(BAND_HALO, halo))
    return halo - halo % 2  # even: chroma slabs carry halo // 2


def halo_from_env() -> int:
    """Halo rows of a band slab (SELKIES_BAND_HALO), clamped to [4, MV_PAD]
    and made even; the default is the full reach, BAND_HALO."""
    return _halo_env("SELKIES_BAND_HALO")


def tile_halo_from_env() -> int:
    """Halo columns of a tile slab (SELKIES_TILE_HALO), as halo_from_env.
    Below 36 the horizontal window clamps and an RxC grid no longer equals
    bands=R byte for byte (still a valid stream)."""
    return _halo_env("SELKIES_TILE_HALO")


def usable_cols(mb_width: int, requested: int) -> int:
    """Largest tile-column count <= ``requested`` that splits ``mb_width``
    MB columns into equal tiles of at least MIN_TILE_MB_COLS."""
    requested = max(1, int(requested))
    for cols in range(min(requested, mb_width // MIN_TILE_MB_COLS), 1, -1):
        if mb_width % cols == 0:
            return cols
    return 1


def usable_bands(mb_height: int, requested: int) -> int:
    """Largest band count <= ``requested`` that splits ``mb_height`` MB rows
    into equal bands of at least MIN_BAND_MB_ROWS."""
    requested = max(1, int(requested))
    for bands in range(min(requested, mb_height // MIN_BAND_MB_ROWS), 1, -1):
        if mb_height % bands == 0:
            return bands
    return 1


def band_spans(mb_height: int, bands: int) -> list[tuple[int, int]]:
    """(first_mb_row, mb_rows) per band, top to bottom (equal split)."""
    if mb_height % bands:
        raise ValueError(f"{bands} bands do not divide {mb_height} MB rows")
    rows = mb_height // bands
    return [(b * rows, rows) for b in range(bands)]


# ---------------------------------------------------------------------------
# Device steps: the same per-band (per-tile) function in a static loop
# ---------------------------------------------------------------------------


def _band_i_body(y, u, v, qp: int, cap_rows: int):
    out = encode_frame_planes(y, u, v, qp)
    header, buf = pack_i_compact(out)
    prefix = fuse_downlink(header, buf, cap_rows)
    return prefix, buf, out["recon_y"], out["recon_u"], out["recon_v"]


def _pack_fused(out: dict, nscap: int, cap_rows: int, entropy):
    """One band-row's P outputs -> (fused, buf). nscap is the row's MB
    count, so the dense-header fallback cannot occur. ``entropy`` is
    resolve_entropy's (bits_words, min_mbs, buckets, coder): each row then
    decides on the device whether it ships its coded slice or its rows."""
    if entropy is not None:
        bits_words, min_mbs, buckets, coder = entropy
        fused, _dense, buf = pack_p_sparse_entropy(out, nscap, cap_rows, None, bits_words,
                                                   min_mbs, buckets, entropy_coder=coder)
    else:
        fused, _dense, buf = pack_p_sparse_var(out, nscap, cap_rows)
    return fused, buf


def _band_p_body(y, u, v, qp: int, slab_y, slab_u, slab_v, *, halo: int, nscap: int,
                 cap_rows: int, entropy=None):
    out = encode_band_p_planes(y, u, v, slab_y, slab_u, slab_v, qp, halo=halo)
    fused, buf = _pack_fused(out, nscap, cap_rows, entropy)
    return fused, buf, out["recon_y"], out["recon_u"], out["recon_v"]


def _slab_indices(bands: int, rows: int, halo: int) -> np.ndarray:
    """(bands, rows + 2*halo) row indices into the stacked (bands*rows)
    plane, clipped at the picture edges (the decoder's edge replication)."""
    base = rows * np.arange(bands)[:, None]
    span = np.arange(-halo, rows + halo)[None, :]
    return np.clip(base + span, 0, bands * rows - 1)


@functools.lru_cache(maxsize=None)
def _slab_index(bands: int, rows: int, halo: int, device: torch.device) -> torch.Tensor:
    """_slab_indices, flat, as an int64 constant on ``device`` (copied there
    once: a copy per frame would synchronise the stream)."""
    return torch.from_numpy(_slab_indices(bands, rows, halo).reshape(-1)).to(device)


def _stacked_slabs(ref, halo: int):
    """(B, rows, W) stacked reference -> halo-extended (B, rows + 2*halo, W)
    slabs by one row gather."""
    b, rows, w = ref.shape
    idx = _slab_index(b, rows, halo, ref.device)
    return ref.reshape(b * rows, w).index_select(0, idx).reshape(b, rows + 2 * halo, w)


# merged tile -> row before the row's pack: what the sparse packers read,
# in MB-grid layout (dim 1 = MB column). recon stays per tile.
_ROW_MERGE_KEYS = ("mvs", "resid_zero", "luma_ac", "chroma_dc", "chroma_ac")


def _row_pack(row: dict, nscap: int, cap_rows: int, entropy):
    """A row's merged outputs -> (fused, buf): P_Skip derived on the merged
    MV grid, then the band pack."""
    row["skip"] = _skip_mask(row["mvs"], row.pop("resid_zero"))
    return _pack_fused(row, nscap, cap_rows, entropy)


def _stacked_tile_p_step(ys, us, vs, qp: int, rys, rus, rvs, *, bands: int, cols: int,
                         halo: int, halo_cols: int, nscap: int, cap_rows: int, entropy=None):
    """Tile-grid P step: the per-tile graph in a static loop, slabs and
    votes taken from the reassembled reference planes with the edge
    semantics of the mesh exchanges. Inputs (bands, cols, th, tw) and
    (bands, cols, th/2, tw/2); outputs fused/buf with a unit col axis and
    the tiles' recon in the input layout."""
    b, c, th, tw = rys.shape
    cth, ctw = th // 2, tw // 2
    hc, hcc = halo_cols, halo_cols // 2
    fy = rys.permute(0, 2, 1, 3).reshape(b * th, c * tw)
    fu = rus.permute(0, 2, 1, 3).reshape(b * cth, c * ctw)
    fv = rvs.permute(0, 2, 1, 3).reshape(b * cth, c * ctw)
    py = edge_pad(fy, halo, halo, hc, hc)
    pu = edge_pad(fu, halo // 2, halo // 2, hcc, hcc)
    pv = edge_pad(fv, halo // 2, halo // 2, hcc, hcc)
    twd = tw // 4  # downsampled tile width (the coarse vote's geometry)
    fused_rows, buf_rows = [], []
    recon = [[None] * c for _ in range(b)]
    for r in range(b):
        # the row's merged coarse votes: each tile votes over its own
        # columns plus COARSE_R real downsampled columns each side
        rd = edge_pad(_downsample4(fy[r * th:(r + 1) * th]), 0, 0, COARSE_R, COARSE_R)
        votes = sum(coarse_votes(ys[r, k], rd[:, k * twd:(k + 1) * twd + 2 * COARSE_R], COARSE_R)
                    for k in range(c))
        coarse = select_coarse(votes)
        touts = []
        for k in range(c):
            sy = py[r * th:(r + 1) * th + 2 * halo, k * tw:(k + 1) * tw + 2 * hc]
            su = pu[r * cth:(r + 1) * cth + halo, k * ctw:(k + 1) * ctw + 2 * hcc]
            sv = pv[r * cth:(r + 1) * cth + halo, k * ctw:(k + 1) * ctw + 2 * hcc]
            out = encode_tile_p_planes(ys[r, k], us[r, k], vs[r, k], sy, su, sv, qp, halo=halo,
                                       halo_cols=hc, coarse=coarse, defer_skip=True)
            touts.append(out)
            recon[r][k] = (out["recon_y"], out["recon_u"], out["recon_v"])
        row = {key: torch.cat([t[key] for t in touts], dim=1) for key in _ROW_MERGE_KEYS}
        fused, buf = _row_pack(row, nscap, cap_rows, entropy)
        fused_rows.append(fused)
        buf_rows.append(buf)
    return (torch.stack(fused_rows)[:, None], torch.stack(buf_rows)[:, None],
            *(torch.stack([torch.stack([recon[r][k][i] for k in range(c)]) for r in range(b)])
              for i in range(3)))


def _stacked_tile_i_step(ys, us, vs, qp: int, *, bands: int, cols: int, cap_rows: int):
    """Tile-grid IDR: row 0 of an I slice is a DC-prediction chain across
    the whole row, so each band-row is encoded whole and each tile keeps
    its crop of the row's recon as its reference."""
    b, c, th, tw = ys.shape
    prefixes, bufs, ry, ru, rv = [], [], [], [], []
    for r in range(b):
        gy = ys[r].permute(1, 0, 2).reshape(th, c * tw)
        gu = us[r].permute(1, 0, 2).reshape(th // 2, c * tw // 2)
        gv = vs[r].permute(1, 0, 2).reshape(th // 2, c * tw // 2)
        prefix, buf, ry_, ru_, rv_ = _band_i_body(gy, gu, gv, qp, cap_rows)
        prefixes.append(prefix)
        bufs.append(buf)
        ry.append(torch.stack([ry_[:, k * tw:(k + 1) * tw] for k in range(c)]))
        ru.append(torch.stack([ru_[:, k * (tw // 2):(k + 1) * (tw // 2)] for k in range(c)]))
        rv.append(torch.stack([rv_[:, k * (tw // 2):(k + 1) * (tw // 2)] for k in range(c)]))
    return (torch.stack(prefixes)[:, None], torch.stack(bufs)[:, None],
            torch.stack(ry), torch.stack(ru), torch.stack(rv))


def _stacked_i_step(ys, us, vs, qp: int, *, bands: int, cap_rows: int):
    outs = [_band_i_body(ys[b], us[b], vs[b], qp, cap_rows) for b in range(bands)]
    return tuple(torch.stack([o[k] for o in outs]) for k in range(5))


def _stacked_p_step(ys, us, vs, qp: int, rys, rus, rvs, *, bands: int, halo: int, nscap: int,
                    cap_rows: int, entropy=None):
    sy = _stacked_slabs(rys, halo)
    su = _stacked_slabs(rus, halo // 2)
    sv = _stacked_slabs(rvs, halo // 2)
    outs = [_band_p_body(ys[b], us[b], vs[b], qp, sy[b], su[b], sv[b], halo=halo, nscap=nscap,
                         cap_rows=cap_rows, entropy=entropy)
            for b in range(bands)]
    return tuple(torch.stack([o[k] for o in outs]) for k in range(5))


def _step_ready(fetch: _Fetch) -> float:
    """Wall clock once the step that wrote ``fetch``'s buffer has finished
    (its ``step_done`` event; a CPU step is finished when it returns)."""
    if fetch.step_done is not None:
        fetch.step_done.synchronize()
    return time.perf_counter()


class _PendingFrame:
    """A dispatched frame: its bands' downlink copies and device handles,
    and the QP / GOP values its completion packs with. A static frame
    carries its all-skip AU instead."""

    __slots__ = ("idr", "static_au", "static_stats", "qp", "frame_num", "idr_pic_id",
                 "fetches", "full_h", "buf_h", "t0", "t_up", "classify_ms", "convert_ms",
                 "h2d_ms")

    def __init__(self, *, idr: bool, static_au: bytes | None = None):
        self.idr = idr
        self.static_au = static_au


class TorchBandedH264Encoder:
    """Band/tile-sliced H.264 encoder: frame in, multi-slice Annex-B access
    unit out, on one device.

    One IDR, then P frames (``keyframe_interval`` / ``force_keyframe`` as in
    TorchH264Encoder); every picture is ``bands`` slices, and with
    ``cols > 1`` each band-row is computed as ``cols`` tiles. This is the
    full-motion / 4K path: no delta uploads and no tile cache, but an
    unchanged capture is still an all-skip AU built on the host.

    The keyword names are the JAX constructor's, with ``device`` (None
    means ``cuda``, raising without a card) in place of ``devices``:
    ``self.devices == [self.device]`` and ``mesh_enabled`` is False.
    ``frame_batch`` and ``pipeline_depth`` only size the pack pool.
    ``dispatch_frame`` / ``complete_frame`` split ``encode_frame`` for a
    scheduler that overlaps sessions; one frame may be in flight.
    """

    codec = "h264"
    # encode_frame/submit take capture-layer damage-rect hints (FramePrep.scan)
    accepts_damage = True

    def __init__(self, width: int, height: int, qp: int = 28, fps: int = 60,
                 channels: int = 4, keyframe_interval: int = 0,
                 bands: int | None = None, halo: int | None = None,
                 cols: int | None = None, halo_cols: int | None = None,
                 frame_batch: int = 1, pipeline_depth: int = 1,
                 pack_workers: int | None = None, device_entropy: bool | None = None,
                 bits_min_mbs: int | None = None, entropy_coder: str | None = None,
                 device=None):
        if channels != 4:
            raise ValueError("band-parallel encode expects BGRx capture (channels=4)")
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.fps = fps
        self.set_qp(qp)
        self.keyframe_interval = int(keyframe_interval)
        self._pad_h = (height + 15) // 16 * 16
        self._pad_w = (width + 15) // 16 * 16
        self._mbh, self._mbw = self._pad_h // 16, self._pad_w // 16
        if bands is None and cols is None:
            grid = grid_from_env()
            if grid is not None:
                bands, cols = grid
        requested = bands if bands is not None else bands_from_env()
        cols_req = 1 if cols is None else max(1, int(cols))
        self.bands = usable_bands(self._mbh, requested)
        if self.bands != requested:
            logger.info("%dx%d: %d bands requested, using %d (%d MB rows must split into "
                        "equal bands of >= %d rows)", width, height, requested, self.bands,
                        self._mbh, MIN_BAND_MB_ROWS)
        self.cols = usable_cols(self._mbw, cols_req)
        if self.cols != cols_req:
            logger.info("%dx%d: %d tile columns requested, using %d (%d MB columns must "
                        "split into equal tiles of >= %d columns)", width, height, cols_req,
                        self.cols, self._mbw, MIN_TILE_MB_COLS)
        halo = halo_from_env() if halo is None else int(halo)
        # a real band slab needs the refine grid's reach + the chroma
        # lookahead in real rows; one band's slab is the whole reference
        self.halo = max(0, min(BAND_HALO, halo - halo % 2))
        if self.halo < 4:
            self.halo = 0 if self.bands == 1 else 4
        if self.halo != halo:
            logger.info("band halo %d adjusted to %d", halo, self.halo)
        halo_cols = tile_halo_from_env() if halo_cols is None else int(halo_cols)
        if self.cols == 1:
            self.halo_cols = 0
        else:
            self.halo_cols = max(4, min(BAND_HALO, halo_cols - halo_cols % 2))
            if self.halo_cols != halo_cols:
                logger.info("tile column halo %d adjusted to %d", halo_cols, self.halo_cols)
            if self.bands == 1:
                # one band-row spans the frame: the tile slab has the whole height
                self.halo = 0
        self.spans = band_spans(self._mbh, self.bands)
        self._band_mbh = self._mbh // self.bands
        self._band_h = 16 * self._band_mbh
        self._tile_mbw = self._mbw // self.cols
        self._tile_w = 16 * self._tile_mbw
        # downlink geometry per band-row (slices stay one per row in tile
        # mode): nscap = the row's MB count makes the dense fallback
        # unreachable; the row cap is the solo encoder's, so bands=1 fetches
        # the same shapes
        m_band = self._band_mbh * self._mbw
        self._nscap = m_band
        self._cap_p = min(26 * m_band, 4096)
        self._cap_i = min(27 * m_band, 4096)
        self._hdr_words_i = i_header_words(self._band_mbh, self._mbw)
        # PPS-scoped coder; device entropy resolved at the slice's geometry
        self._coder = entropy_coder_default(entropy_coder)
        (self.device_entropy, self.bits_min_mbs, self._bits_words,
         self._entropy) = resolve_entropy(m_band, device_entropy, bits_min_mbs,
                                          entropy_coder=self._coder)
        if self._entropy is not None:
            self._pfx_total = p_sparse_entropy_words(self._band_mbh, self._mbw, self._nscap,
                                                     self._cap_p, False, self._bits_words,
                                                     entropy_coder=self._coder)
        else:
            self._pfx_total = p_sparse_var_words(self._band_mbh, self._mbw, self._nscap,
                                                 self._cap_p)
        # two fetch lengths: the small slice and the whole buffer
        self._pfx_small = min(1 << 14, self._pfx_total)
        self._pfx_hint = self._pfx_small
        self._pfx_recent: list[int] = []
        self._pfx_lock = threading.Lock()

        # one device: no mesh, the stacked steps
        self.mesh_enabled = False
        self.mesh = None
        self.devices = [self.device]
        self.params = StreamParams(width=width, height=height, qp=self.qp, fps=fps,
                                   entropy_coder=self._coder)
        self._headers = write_sps(self.params) + write_pps(self.params)
        self._prep = FramePrep(width, height, self._pad_w, self._pad_h, nslots=2)
        if self.cols > 1:
            self._step_i = functools.partial(_stacked_tile_i_step, bands=self.bands,
                                             cols=self.cols, cap_rows=self._cap_i)
            self._step_p = functools.partial(
                _stacked_tile_p_step, bands=self.bands, cols=self.cols, halo=self.halo,
                halo_cols=self.halo_cols, nscap=self._nscap, cap_rows=self._cap_p,
                entropy=self._entropy)
        else:
            self._step_i = functools.partial(_stacked_i_step, bands=self.bands,
                                             cap_rows=self._cap_i)
            self._step_p = functools.partial(
                _stacked_p_step, bands=self.bands, halo=self.halo, nscap=self._nscap,
                cap_rows=self._cap_p, entropy=self._entropy)
            # the slab gathers' row indices reach the device now, not mid-stream
            _slab_index(self.bands, self._band_h, self.halo, self.device)
            _slab_index(self.bands, self._band_h // 2, self.halo // 2, self.device)
        # per-band completion fan-out, sized for every slice that can be in
        # flight (the solo formula with the bands factor)
        if pack_workers is None:
            pack_workers = min(os.cpu_count() or 4,
                               max(2, self.bands * max(1, frame_batch) * max(1, pipeline_depth)))
        self._pack_pool = ThreadPoolExecutor(max_workers=pack_workers,
                                             thread_name_prefix="h264-pack")
        self.link_bytes = LinkByteCounter()
        self._ref: tuple | None = None  # stacked recon planes: the next P's reference
        self._allskip: PFrameCoeffs | None = None
        self.frame_index = 0
        self._frames_since_idr = 0
        self._idr_pic_id = 0
        self._force_idr = True
        self.last_stats: FrameStats | None = None
        # at most one frame between dispatch_frame and complete_frame:
        # self._ref advances at dispatch
        self._inflight = False

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

    # -- device dispatch --

    def _put_band_planes(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Converted planes stacked on a leading band axis, (bands, cols)
        axes in tile mode, and uploaded."""
        b, bh = self.bands, self._band_h
        if self.cols > 1:
            c, tw = self.cols, self._tile_w
            ys = np.asarray(y).reshape(b, bh, c, tw).transpose(0, 2, 1, 3)
            us = np.asarray(u).reshape(b, bh // 2, c, tw // 2).transpose(0, 2, 1, 3)
            vs = np.asarray(v).reshape(b, bh // 2, c, tw // 2).transpose(0, 2, 1, 3)
        else:
            ys = np.asarray(y).reshape(b, bh, self._pad_w)
            us = np.asarray(u).reshape(b, bh // 2, self._pad_w // 2)
            vs = np.asarray(v).reshape(b, bh // 2, self._pad_w // 2)
        self.link_bytes.add("up_full", ys.nbytes + us.nbytes + vs.nbytes)
        return tuple(to_device(a, self.device) for a in (ys, us, vs))

    def _band_handles(self, arr):
        """Per-band-row views of a stacked (bands, ...) output, in band
        order (tile mode: (bands, 1, ...), the unit col axis dropped)."""
        if self.cols > 1:
            return [arr[b, 0] for b in range(self.bands)]
        return [arr[b] for b in range(self.bands)]

    def _pfx_slice_len(self) -> int:
        with self._pfx_lock:
            return self._pfx_hint

    def _note_need(self, need: int) -> None:
        with self._pfx_lock:
            self._pfx_recent.append(need)
            del self._pfx_recent[:-8]
            want = max([2048] + [n * 3 // 2 for n in self._pfx_recent])
            self._pfx_hint = self._pfx_small if want <= self._pfx_small else self._pfx_total

    # -- host completion (per band, on the pack pool) --

    def _complete_band_i(self, band: int, fetch: _Fetch, buf_d, idr_pic_id: int):
        prefix, _, fetch_ms = fetch.wait(0.0)
        t_f = time.perf_counter()
        self.link_bytes.add("down_prefix", prefix.nbytes)
        header, data, n = split_prefix(prefix, self._hdr_words_i)
        if n > self._cap_i:
            rest = fetch_rest(buf_d, n, self._cap_i)
            self.link_bytes.add("down_spill", rest.nbytes)
            data = np.concatenate([data, rest])
        # the QP held at completion, as JAX's (its coefficients were
        # quantised at the dispatch QP: a set_qp in between recodes them)
        fc = unpack_i_compact(header, data, self.qp)
        t_u = time.perf_counter()
        pack = pack_slice_cabac if self._coder == "cabac" else pack_slice_fast
        nal = pack(fc, self.params, frame_num=0, idr=True, idr_pic_id=idr_pic_id,
                   first_mb=self.spans[band][0] * self._mbw)
        # the downlink mode labels P frames only
        return nal, 0, fetch_ms / 1e3, t_u - t_f, time.perf_counter() - t_u, t_f, ""

    def _complete_band_p(self, band: int, fetch: _Fetch, full_d, buf_d, frame_num: int,
                         qp: int):
        fused, _, fetch_ms = fetch.wait(0.0)
        t_f = time.perf_counter()
        # one band is one slice: the solo delta completion with the band's
        # geometry and first_mb (no dense header: nscap = the band's MBs)
        nal, skipped, t_u, mode = complete_sparse_slice(
            fused, mbh=self._band_mbh, mbw=self._mbw, nscap=self._nscap,
            cap_rows=self._cap_p, qp=qp, frame_num=frame_num, params=self.params,
            device_bits=self._entropy is not None, full_d=full_d, buf_d=buf_d,
            link_bytes=self.link_bytes, prefix_bytes=fused.nbytes, note_need=self._note_need,
            first_mb=self.spans[band][0] * self._mbw, entropy_coder=self._coder)
        return nal, skipped, fetch_ms / 1e3, t_u - t_f, time.perf_counter() - t_u, t_f, mode

    # -- static short-circuit --

    def _allskip_au(self, frame_num: int) -> bytes:
        """Unchanged capture: every band an all-skip P slice, built on the
        host (the decoder's recon stays the device reference)."""
        if self._allskip is None:
            bm, mw = self._band_mbh, self._mbw
            self._allskip = PFrameCoeffs(
                mvs=np.zeros((bm, mw, 2), np.int32),
                skip=np.ones((bm, mw), bool),
                luma_ac=np.zeros((bm, mw, 4, 4, 4, 4), np.int32),
                chroma_dc=np.zeros((bm, mw, 2, 2, 2), np.int32),
                chroma_ac=np.zeros((bm, mw, 2, 2, 2, 4, 4), np.int32),
                qp=self.qp,
            )
        self._allskip.qp = self.qp
        if self._coder == "cabac":
            return b"".join(pack_slice_p_cabac(self._allskip, self.params, frame_num,
                                               first_mb=mb0 * self._mbw)
                            for mb0, _ in self.spans)
        return b"".join(pack_slice_p_fast(self._allskip, self.params, frame_num=frame_num,
                                          first_mb=mb0 * self._mbw)
                        for mb0, _ in self.spans)

    # -- encoding --

    def encode_frame(self, frame: np.ndarray, qp: int | None = None, damage=None) -> bytes:
        """(H, W, 4) BGRx uint8 in, multi-slice Annex-B AU out (SPS/PPS
        before an IDR): ``dispatch_frame`` then ``complete_frame``.
        ``damage``: optional dirty-rect hints bounding the static scan."""
        return self.complete_frame(self.dispatch_frame(frame, qp, damage=damage))

    def dispatch_frame(self, frame: np.ndarray, qp: int | None = None,
                       damage=None) -> _PendingFrame:
        """Front half of ``encode_frame``: the static scan, the conversion,
        the upload, the step and each band's downlink copy, all enqueued
        without waiting for the device. The reference advances here, so a
        second dispatch before ``complete_frame`` raises."""
        if self._inflight:
            raise RuntimeError("dispatch_frame while a frame is in flight; "
                               "complete_frame the previous one first")
        if qp is not None:
            self.set_qp(qp)
        t0 = time.perf_counter()
        idr = (self._force_idr or self._ref is None
               or (self.keyframe_interval > 0
                   and self._frames_since_idr >= self.keyframe_interval))
        scan = self._prep.scan(frame, self.width, damage=damage)
        static = not idr and scan is not None and not scan.tiles.any()
        classify_ms = (time.perf_counter() - t0) * 1e3
        if static:
            au = self._allskip_au(self._frames_since_idr % 256)
            pending = _PendingFrame(idr=False, static_au=au)
            pending.static_stats = FrameStats(
                frame_index=self.frame_index, idr=False, qp=self.qp, bytes=len(au),
                device_ms=(time.perf_counter() - t0) * 1e3, pack_ms=0.0,
                skipped_mbs=self._mbh * self._mbw, bands=self.bands, cols=self.cols,
                upload_ms=classify_ms, classify_ms=classify_ms, upload_kind="static")
            self._inflight = True
            return pending
        t_c0 = time.perf_counter()
        y, u, v = self._prep.convert(frame)
        t_h0 = time.perf_counter()
        parts = self._put_band_planes(y, u, v)
        t_up = time.perf_counter()
        try:
            if idr:
                prefix_d, buf_d, ry, ru, rv = self._step_i(*parts, self.qp)
            else:
                prefix_d, buf_d, ry, ru, rv = self._step_p(*parts, self.qp, *self._ref)
            self._ref = (ry, ru, rv)
            # hint-sized prefixes, their copies enqueued right behind the step
            pfx = prefix_d
            if not idr:
                hint = self._pfx_slice_len()
                if hint < self._pfx_total:
                    pfx = prefix_d[..., :hint]
            fetches = [_Fetch(h) for h in self._band_handles(pfx)]
        except Exception:
            # the client never gets this frame: restart from an IDR
            self._ref = None
            self._prep.reset()
            raise
        pending = _PendingFrame(idr=idr)
        pending.fetches = fetches
        pending.full_h = self._band_handles(prefix_d)
        pending.buf_h = self._band_handles(buf_d)
        # completion packs with the values the frame was dispatched under
        pending.qp = self.qp
        pending.frame_num = self._frames_since_idr % 256
        pending.idr_pic_id = self._idr_pic_id
        pending.t0, pending.t_up = t0, t_up
        pending.classify_ms = classify_ms
        pending.convert_ms, pending.h2d_ms = (t_h0 - t_c0) * 1e3, (t_up - t_h0) * 1e3
        self._inflight = True
        return pending

    def complete_frame(self, pending: _PendingFrame) -> bytes:
        """Back half of ``encode_frame``: each band's fetch, unpack and pack
        on the pack pool, the AU and its FrameStats, the GOP advance."""
        self._inflight = False
        if pending.static_au is not None:
            self.last_stats = pending.static_stats
            self.frame_index += 1
            self._frames_since_idr += 1
            return pending.static_au
        idr = pending.idr

        def _one(b: int):
            if idr:
                return self._complete_band_i(b, pending.fetches[b], pending.buf_h[b],
                                             pending.idr_pic_id)
            return self._complete_band_p(b, pending.fetches[b], pending.full_h[b],
                                         pending.buf_h[b], pending.frame_num, pending.qp)

        # each band's step-done time, read on this thread in band order
        # while the pool packs (a small pool would otherwise queue later
        # bands behind earlier packs and count that as step time)
        t_ready = [0.0] * self.bands
        try:
            futs = [self._pack_pool.submit(_one, b) for b in range(self.bands)]
            for b in range(self.bands):
                t_ready[b] = _step_ready(pending.fetches[b])
            results = [f.result() for f in futs]
        except Exception:
            # the reference already advanced to a frame the client lacks
            self._ref = None
            self._prep.reset()
            raise
        nals = [r[0] for r in results]
        au = (self._headers + b"".join(nals)) if idr else b"".join(nals)
        t_up = pending.t_up
        # fetch_ms is the slowest band's; unpack and pack sum over bands
        unpack_ms = sum(r[3] for r in results) * 1e3
        cavlc_ms = sum(r[4] for r in results) * 1e3
        # the frame's downlink label: "bits" / "cabac" only when every
        # slice shipped its coded payload
        modes = {r[6] for r in results}
        downlink_mode = ("dense" if "dense" in modes
                         else "bits" if modes == {"bits"}
                         else "cabac" if modes == {"cabac"}
                         else "coeff" if "coeff" in modes else "")
        stats = FrameStats(
            frame_index=self.frame_index, idr=idr, qp=pending.qp, bytes=len(au),
            device_ms=(max(r[5] for r in results) - pending.t0) * 1e3,
            pack_ms=unpack_ms + cavlc_ms, skipped_mbs=sum(r[1] for r in results),
            unpack_ms=unpack_ms, cavlc_ms=cavlc_ms, upload_ms=(t_up - pending.t0) * 1e3,
            step_ms=(max(t_ready) - t_up) * 1e3, fetch_ms=max(r[2] for r in results) * 1e3,
            bands=self.bands, cols=self.cols, classify_ms=pending.classify_ms,
            convert_ms=pending.convert_ms, h2d_ms=pending.h2d_ms,
            band_step_ms=tuple(round((t - t_up) * 1e3, 3) for t in t_ready),
            downlink_mode=downlink_mode)
        self.last_stats = stats
        if idr:
            self._frames_since_idr = 0
            self._idr_pic_id = (self._idr_pic_id + 1) % 2
            self._force_idr = False
        self.frame_index += 1
        self._frames_since_idr += 1
        return au

    def submit(self, frame: np.ndarray, qp: int | None = None, meta=None, damage=None) -> list:
        """The pipelined API (TorchH264Encoder.submit/flush): this encoder
        completes each frame at once and returns its one (au, stats, meta)."""
        au = self.encode_frame(frame, qp, damage=damage)
        return [(au, self.last_stats, meta)]

    def flush(self) -> list:
        return []  # nothing is ever left in flight

    def prewarm(self) -> None:
        """Run an IDR and a P frame of noise (the kernel builds, the tables
        reach the device), then restart the GOP."""
        rng = np.random.default_rng(0)
        shape = (self.height, self.width, 4)
        self.encode_frame(rng.integers(0, 255, shape, np.uint8))
        self.encode_frame(rng.integers(0, 255, shape, np.uint8))
        self._force_idr = True
        self._ref = None
        self._prep.reset()
        self.frame_index = 0
        self._frames_since_idr = 0
        self._idr_pic_id = 0

    def close(self) -> None:
        self._pack_pool.shutdown(wait=False, cancel_futures=True)
