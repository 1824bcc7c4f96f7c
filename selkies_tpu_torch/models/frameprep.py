"""Host-side frame preparation: ctypes binding for ``native/frameprep.cc``.

Counterpart of ``selkies_tpu/models/frameprep.py``. Converts captured BGRx
frames to padded I420 planes on the host CPU (1.5 bytes a pixel cross to
the card instead of 4) and runs the fused dirty-tile scan: one pass per
band computes the dirty-tile map, copies dirty tiles into the previous
frame and emits the tile cache's content hashes. Bands shard over a small
shared worker pool (``SELKIES_FRONTEND_WORKERS``; ``SELKIES_PARALLEL_FRONTEND=0``
forces the serial scan, byte-identical). ``damage`` rect hints bound the
scan (superset contract), with a forced full scan every
``SELKIES_DAMAGE_FULL_SCAN``-th call.

The port builds ``native/frameprep.cc`` with ``g++`` at first use into
``build/torch_kernels/libframeprep-<hash>.so`` (``utils/build.py``); it
never runs ``make`` in ``native/``. A build or load failure, or a missing
symbol, raises: there is no quiet numpy fallback on the encoder's path.
``_numpy_convert_pad`` and ``FramePrep._scan_chunk_numpy`` are the plain
versions the tests hold the native build against.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from selkies_tpu_torch.utils.build import REPO_ROOT, BuildResult, build_shared

logger = logging.getLogger("selkies_tpu_torch.frameprep")

_SOURCE = REPO_ROOT / "native" / "frameprep.cc"
# the flags of native/Makefile's libframeprep.so rule
_COMMAND = ["g++", "-O3", "-Wall", "-fPIC", "-std=c++17", "-shared"]

_lib: ctypes.CDLL | None = None
_build: BuildResult | None = None
_load_lock = threading.Lock()

BAND_ROWS = 16  # dirty-detection granularity = one MB row

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def parallel_frontend_enabled() -> bool:
    """SELKIES_PARALLEL_FRONTEND gate (default on): 0 forces the serial
    single-call scan, the byte-identity oracle for the sharded path."""
    return os.environ.get("SELKIES_PARALLEL_FRONTEND", "1") != "0"


def frontend_workers() -> int:
    """Front-end scan/convert pool width (SELKIES_FRONTEND_WORKERS
    overrides; default min(cores, 4))."""
    env = os.environ.get("SELKIES_FRONTEND_WORKERS", "")
    if env:
        try:
            return max(1, min(16, int(env)))
        except ValueError:
            logger.warning("SELKIES_FRONTEND_WORKERS=%r not an integer; using default", env)
    return max(1, min(os.cpu_count() or 2, 4))


def damage_full_scan_interval() -> int:
    """Every Nth scan ignores damage hints and walks the whole frame (the
    safety ratchet against a non-superset hint source); 0 disables it."""
    env = os.environ.get("SELKIES_DAMAGE_FULL_SCAN", "")
    if env:
        try:
            return max(0, int(env))
        except ValueError:
            logger.warning("SELKIES_DAMAGE_FULL_SCAN=%r not an integer; using default", env)
    return 120


# below this many bands per worker the thread fan-out costs more than the
# memcmp it parallelises
_MIN_BANDS_PER_CHUNK = 8

_fe_pool: ThreadPoolExecutor | None = None
_fe_pool_lock = threading.Lock()


def _frontend_pool() -> ThreadPoolExecutor:
    """Process-wide front-end pool (scan shards and band converts), shared
    by every encoder of the process."""
    global _fe_pool
    with _fe_pool_lock:
        if _fe_pool is None:
            _fe_pool = ThreadPoolExecutor(max_workers=frontend_workers(),
                                          thread_name_prefix="frontend")
        return _fe_pool


def tile_width_for(width: int) -> int:
    """Delta-tile column width for ``width``: the largest power-of-two tile
    of 128..16 that divides the padded plane (else the padded width, i.e.
    full bands)."""
    pad_w = (width + 15) // 16 * 16
    return next((t for t in (128, 64, 32, 16) if pad_w % t == 0), pad_w)


def delta_buckets_for(width: int, height: int) -> tuple[int, ...]:
    """Delta bucket ladder for a geometry: dirty-tile counts round up to
    one of these; frames dirtier than the largest take the full upload."""
    pad_h = (height + 15) // 16 * 16
    pad_w = (width + 15) // 16 * 16
    ntiles = (pad_h // 16) * (pad_w // tile_width_for(width))
    return tuple(
        b for b in (8, 16, 32, 64, 128, 256, 512) if b <= ntiles // 2
    ) or ((ntiles // 2,) if ntiles >= 2 else ())


def build() -> BuildResult:
    """Build (or find) the library; returns the build record."""
    _load()
    return _build


def _load() -> ctypes.CDLL:
    global _lib, _build
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            res = build_shared("libframeprep", [_SOURCE], _COMMAND)
            lib = ctypes.CDLL(str(res.path))
            # a missing symbol raises AttributeError here, by design
            lib.bgrx_to_i420_pad.restype = None
            lib.bgrx_to_i420_pad.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, _U8P, _U8P, _U8P]
            lib.bgrx_to_i420_tiles.restype = None
            lib.bgrx_to_i420_tiles.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, _I32P, ctypes.c_int,
                                               _U8P, _U8P, _U8P]
            lib.tile_hash.restype = None
            lib.tile_hash.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U64P]
            lib.frontend_scan.restype = ctypes.c_int
            lib.frontend_scan.argtypes = [
                _U8P, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, _U64P]
            lib.gather_tiles.restype = None
            lib.gather_tiles.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         _I32P, ctypes.c_int, _U8P]
            lib.bgrx_to_i420_pad_rows.restype = None
            lib.bgrx_to_i420_pad_rows.argtypes = [
                _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, _U8P, _U8P, _U8P]
            lib.pad_i420_bottom.restype = None
            lib.pad_i420_bottom.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            _U8P, _U8P, _U8P]
            _build, _lib = res, lib
    return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _numpy_convert_pad(frame: np.ndarray, ph: int, pw: int):
    """Plain version of bgrx_to_i420_pad (and of ops/colorspace.py)."""
    f = frame.astype(np.int32)
    r, g, b = f[..., 2], f[..., 1], f[..., 0]
    y = np.clip(((66 * r + 129 * g + 25 * b + 128) >> 8) + 16, 16, 235)
    u = np.clip(((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128, 16, 240)
    v = np.clip(((112 * r - 94 * g - 18 * b + 128) >> 8) + 128, 16, 240)
    h, w = y.shape

    def sub(p):
        return (p.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3)) + 2) >> 2

    u, v = sub(u), sub(v)

    def pad(p, th, tw):
        return np.pad(p, ((0, th - p.shape[0]), (0, tw - p.shape[1])), mode="edge")

    return (
        pad(y, ph, pw).astype(np.uint8),
        pad(u, ph // 2, pw // 2).astype(np.uint8),
        pad(v, ph // 2, pw // 2).astype(np.uint8),
    )


@dataclass
class ScanResult:
    """One fused scan's outputs: ``tiles`` (nbands, ntiles) bool dirty map;
    ``hashes`` (nbands, ntiles) uint64 content hashes, valid only at dirty
    cacheable tiles (None unless asked for); ``full_scan`` whether the
    whole frame was walked."""

    tiles: np.ndarray
    hashes: np.ndarray | None
    full_scan: bool


class FramePrep:
    """Per-stream host prep state: conversion buffers + previous frame."""

    def __init__(self, width: int, height: int, pad_w: int, pad_h: int, nslots: int = 4):
        self.width, self.height = width, height
        # odd geometry is edge-replicated to even before conversion (the
        # converters walk 2x2 quads); the extra row/column lands in the pad
        self._even_w = width + (width & 1)
        self._even_h = height + (height & 1)
        if pad_w < self._even_w or pad_h < self._even_h:
            raise ValueError(
                f"pad {pad_w}x{pad_h} cannot hold the even-padded "
                f"{self._even_w}x{self._even_h} frame")
        self.pad_w, self.pad_h = pad_w, pad_h
        self._lib = _load()
        # rotating output buffers: each convert() writes the next slot, so
        # nslots must cover every upload that may still read one
        self._nslots = max(2, int(nslots))
        self._bufs: list | None = None
        self._slot = 0
        self._prev: np.ndarray | None = None
        self.nbands = (height + BAND_ROWS - 1) // BAND_ROWS
        self._scan_count = 0
        self._full_every = damage_full_scan_interval()

    def _check(self, frame: np.ndarray) -> None:
        """The native calls walk raw bytes: shape and dtype must match."""
        if frame.shape != (self.height, self.width, 4) or frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.shape} {frame.dtype} != "
                             f"{(self.height, self.width, 4)} uint8")

    def _even(self, frame: np.ndarray) -> np.ndarray:
        self._check(frame)
        if (self._even_h, self._even_w) != (self.height, self.width):
            frame = np.pad(frame, ((0, self._even_h - self.height),
                                   (0, self._even_w - self.width), (0, 0)), mode="edge")
        return np.ascontiguousarray(frame)

    def convert(self, frame: np.ndarray):
        """(H, W, 4) BGRx uint8 -> (y, u, v) padded planes, in the next of
        the rotating slot buffers."""
        frame = self._even(frame)
        if self._bufs is None:
            self._bufs = [
                (np.empty((self.pad_h, self.pad_w), np.uint8),
                 np.empty((self.pad_h // 2, self.pad_w // 2), np.uint8),
                 np.empty((self.pad_h // 2, self.pad_w // 2), np.uint8))
                for _ in range(self._nslots)
            ]
        y, u, v = self._bufs[self._slot]
        self._slot = (self._slot + 1) % self._nslots
        lib = self._lib
        eh, ew = self._even_h, self._even_w
        workers = frontend_workers() if parallel_frontend_enabled() else 1
        # band-parallel: workers convert disjoint even-row ranges of the same
        # planes (byte-identical to one call); the bottom pad replicates after
        nchunks = min(workers, max(1, eh // (2 * 16 * _MIN_BANDS_PER_CHUNK)))
        if nchunks <= 1:
            lib.bgrx_to_i420_pad(_u8p(frame), eh, ew, self.pad_h, self.pad_w,
                                 _u8p(y), _u8p(u), _u8p(v))
        else:
            step = (-(-eh // (2 * nchunks))) * 2  # even row chunks
            futs = [
                _frontend_pool().submit(
                    lib.bgrx_to_i420_pad_rows, _u8p(frame), eh, ew, self.pad_h, self.pad_w,
                    r0, min(r0 + step, eh), _u8p(y), _u8p(u), _u8p(v))
                for r0 in range(0, eh, step)
            ]
            for f in futs:
                f.result()
            lib.pad_i420_bottom(eh, self.pad_h, self.pad_w, _u8p(y), _u8p(u), _u8p(v))
        return y, u, v

    def reset(self) -> None:
        """Forget the previous frame: the next scan reports a first frame."""
        self._prev = None

    def convert_tiles(self, frame: np.ndarray, idx: np.ndarray, tile_w: int):
        """Convert only the 16-row x tile_w-col tiles listed in ``idx``
        (int32, band*1024 + tile) -> (k, 16, tile_w) luma and
        (k, 8, tile_w/2) chroma, equal to the same region of convert()."""
        if tile_w % 16 or self.pad_w % tile_w:
            raise ValueError(f"tile_w {tile_w} must be a 16-multiple dividing {self.pad_w}")
        frame = self._even(frame)
        idx = np.ascontiguousarray(idx, np.int32)
        k = len(idx)
        yb = np.empty((k, 16, tile_w), np.uint8)
        ub = np.empty((k, 8, tile_w // 2), np.uint8)
        vb = np.empty((k, 8, tile_w // 2), np.uint8)
        self._lib.bgrx_to_i420_tiles(
            _u8p(frame), self._even_h, self._even_w, self.pad_w, tile_w,
            idx.ctypes.data_as(_I32P), k, _u8p(yb), _u8p(ub), _u8p(vb))
        return yb, ub, vb

    # -- fused band-parallel dirty scan --

    def _damage_box(self, damage, tile_w: int) -> tuple[int, int, int, int]:
        """Damage rects (x, y, w, h) -> (b0, b1, t0, t1) bounding box in
        band/tile units, clipped to the frame; empty -> zero bands."""
        ntiles = (self.width + tile_w - 1) // tile_w
        b0, b1, t0, t1 = self.nbands, 0, ntiles, 0
        for (x, y, w, h) in damage:
            if w <= 0 or h <= 0:
                continue
            x0, y0 = max(0, int(x)), max(0, int(y))
            x1 = min(self.width, int(x) + int(w))
            y1 = min(self.height, int(y) + int(h))
            if x1 <= x0 or y1 <= y0:
                continue
            b0 = min(b0, y0 // BAND_ROWS)
            b1 = max(b1, (y1 + BAND_ROWS - 1) // BAND_ROWS)
            t0 = min(t0, x0 // tile_w)
            t1 = max(t1, (x1 + tile_w - 1) // tile_w)
        if b1 <= b0 or t1 <= t0:
            return 0, 0, 0, 0
        return b0, b1, t0, t1

    def _scan_chunk_numpy(self, frame: np.ndarray, tile_w: int,
                          b0: int, b1: int, t0: int, t1: int,
                          out: np.ndarray, hashes: np.ndarray | None) -> None:
        """Plain version of native frontend_scan over bands [b0, b1) x
        tiles [t0, t1): dirty map, prev updated for dirty tiles only,
        tile_hash_numpy values for dirty cacheable tiles."""
        from selkies_tpu_torch.models.tilecache import tile_hash_numpy

        h, w = self.height, self.width
        r0, r1 = b0 * BAND_ROWS, min(b1 * BAND_ROWS, h)
        c0, c1 = t0 * tile_w, min(t1 * tile_w, w)
        nb, nt = b1 - b0, t1 - t0
        neq = (frame[r0:r1, c0:c1] != self._prev[r0:r1, c0:c1]).any(axis=2)
        pad = np.zeros((nb * BAND_ROWS, nt * tile_w), bool)
        pad[: r1 - r0, : c1 - c0] = neq
        dirty = pad.reshape(nb, BAND_ROWS, nt, tile_w).any(axis=(1, 3))
        out[b0:b1, t0:t1] = dirty
        band_i, tile_i = np.nonzero(dirty)
        full_bands, full_tiles = h // BAND_ROWS, w // tile_w
        raws, hash_pos = [], []
        for bi, ti in zip(band_i + b0, tile_i + t0):
            rr0, rr1 = bi * BAND_ROWS, min((bi + 1) * BAND_ROWS, h)
            cc0, cc1 = ti * tile_w, min((ti + 1) * tile_w, w)
            if hashes is not None and bi < full_bands and ti < full_tiles:
                raws.append(frame[rr0:rr1, cc0:cc1].reshape(-1))
                hash_pos.append((bi, ti))
            self._prev[rr0:rr1, cc0:cc1] = frame[rr0:rr1, cc0:cc1]
        if raws:
            for (bi, ti), hv in zip(hash_pos, tile_hash_numpy(np.stack(raws))):
                hashes[bi, ti] = hv

    def scan(self, frame: np.ndarray, tile_w: int, *, damage=None,
             want_hashes: bool = False, plain: bool = False) -> ScanResult | None:
        """Fused scan: dirty-tile map + previous-frame update (+ content
        hashes of dirty cacheable tiles) in one pass.

        Returns None on the first frame (prev seeded; the caller takes the
        full upload). ``damage`` rects bound the scan to their box; every
        ``SELKIES_DAMAGE_FULL_SCAN``-th call ignores them. ``plain`` runs
        the numpy version instead of the native scan (tests only)."""
        self._check(frame)
        frame = np.ascontiguousarray(frame)
        ntiles = (self.width + tile_w - 1) // tile_w
        if self._prev is None:
            self._prev = frame.copy()
            return None
        self._scan_count += 1
        full_scan = (damage is None
                     or (self._full_every > 0 and self._scan_count % self._full_every == 0))
        b0, b1, t0, t1 = (0, self.nbands, 0, ntiles) if full_scan else \
            self._damage_box(damage, tile_w)
        out = np.zeros((self.nbands, ntiles), np.uint8)
        hashes = np.zeros((self.nbands, ntiles), np.uint64) if want_hashes else None
        if b1 > b0 and plain:
            self._scan_chunk_numpy(frame, tile_w, b0, b1, t0, t1, out, hashes)
        elif b1 > b0:
            hp = hashes.ctypes.data_as(_U64P) if hashes is not None else None
            workers = frontend_workers() if parallel_frontend_enabled() else 1
            nchunks = min(workers, max(1, (b1 - b0) // _MIN_BANDS_PER_CHUNK))
            step = -(-(b1 - b0) // nchunks)
            spans = [(b0 + i * step, min(b0 + (i + 1) * step, b1)) for i in range(nchunks)]
            args = (_u8p(frame), _u8p(self._prev), self.height, self.width, BAND_ROWS, tile_w)
            if nchunks <= 1:
                self._lib.frontend_scan(*args, b0, b1, t0, t1, _u8p(out), hp)
            else:
                # the C call releases the GIL; chunks touch disjoint rows
                futs = [_frontend_pool().submit(self._lib.frontend_scan, *args,
                                                s0, s1, t0, t1, _u8p(out), hp)
                        for s0, s1 in spans if s1 > s0]
                for f in futs:
                    f.result()
        return ScanResult(tiles=out.astype(bool), hashes=hashes, full_scan=bool(full_scan))
