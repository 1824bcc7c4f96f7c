"""Content-hash tile cache: the uplink's CopyRect analogue (host half).

Counterpart of ``selkies_tpu/models/tilecache.py``. The card keeps an LRU
pool of previously uploaded I420 tiles; this class keeps a content-hash
index of what each pool slot holds and the BGRx bytes it was filled from.
A dirty tile whose bytes hash-match and memcmp-verify against a slot
becomes an 8-byte (slot -> position) remap instead of a pixel upload. The
hash only nominates a slot: a remap is emitted only after an exact
compare, so a collision costs a compare, never a wrong pixel. Edge tiles
(whose I420 bytes embed replicated padding) are never cached.

The encoder owns the device half (``encoder._apply_tiles2``); this state
must be reset whenever the device pool is discarded. Hashing and the tile
gather run in the port's frameprep library (``frameprep.py``);
``tile_hash_numpy`` is their plain version.
"""

from __future__ import annotations

import numpy as np

from selkies_tpu_torch.models import frameprep

__all__ = ["TileCache", "tile_hash_np", "tile_hash_numpy"]

# splitmix64 constants, shared with native/frameprep.cc tile_hash
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser (wrapping uint64 arithmetic)."""
    x = (x + _SM_GAMMA).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x = (x * _SM_M1).astype(np.uint64)
    x ^= x >> np.uint64(27)
    x = (x * _SM_M2).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


_mult_cache: dict[int, np.ndarray] = {}


def _mults(nwords: int) -> np.ndarray:
    """Per-position odd multipliers: splitmix64(position) | 1."""
    m = _mult_cache.get(nwords)
    if m is None:
        m = _splitmix64(np.arange(nwords, dtype=np.uint64)) | np.uint64(1)
        _mult_cache[nwords] = m
    return m


def tile_hash_numpy(tiles_u8: np.ndarray) -> np.ndarray:
    """Plain version of tile_hash_np: (k, nbytes) uint8 -> (k,) uint64."""
    k, nbytes = tiles_u8.shape
    words = np.ascontiguousarray(tiles_u8).view(np.uint64).reshape(k, nbytes // 8)
    with np.errstate(over="ignore"):
        h = np.bitwise_xor.reduce(words * _mults(words.shape[1]), axis=1)
    return _splitmix64(h)


def tile_hash_np(tiles_u8: np.ndarray) -> np.ndarray:
    """(k, nbytes) uint8 tile rows -> (k,) uint64 content hashes (native).

    XOR-fold of each 8-byte lane times a per-position splitmix64-derived
    odd multiplier, then a splitmix64 avalanche."""
    k, nbytes = tiles_u8.shape
    tiles_u8 = np.ascontiguousarray(tiles_u8)
    out = np.empty(k, np.uint64)
    frameprep._load().tile_hash(frameprep._u8p(tiles_u8), k, nbytes,
                                out.ctypes.data_as(frameprep._U64P))
    return out


class TileCache:
    """Host half of the device tile-slot pool: hash index + LRU + the BGRx
    bytes each slot was filled from (for exact verification).

    Slot ids are [0, slots); slot id ``slots`` is the device pool's
    scratch row (writes land there when a tile should not be kept)."""

    def __init__(self, height: int, width: int, tile_w: int, slots: int):
        self.height, self.width, self.tile_w = height, width, tile_w
        self.slots = int(slots)
        # only tiles fully inside the unpadded capture are cacheable
        self._full_bands = height // 16
        self._full_tiles = width // tile_w
        self._tile_bytes = 16 * tile_w * 4
        self._store = np.zeros((self.slots, self._tile_bytes), np.uint8)
        self._hash2slot: dict[int, int] = {}
        self._slot_hash: list[int | None] = [None] * self.slots
        self._free = list(range(self.slots - 1, -1, -1))
        self._stamp = np.zeros(self.slots, np.int64)
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def reset(self) -> None:
        """Forget everything (the device pool was discarded)."""
        self._hash2slot.clear()
        self._slot_hash = [None] * self.slots
        self._free = list(range(self.slots - 1, -1, -1))
        self._stamp[:] = 0
        self._clock = 0

    def _gather_tiles(self, frame: np.ndarray, cidx: list[int]) -> np.ndarray:
        """(k, tile_bytes) stack of the listed tiles' BGRx bytes (native
        per-row memcpy gather)."""
        frame = np.ascontiguousarray(frame)
        cid = np.ascontiguousarray(cidx, np.int32)
        out = np.empty((len(cid), self._tile_bytes), np.uint8)
        frameprep._load().gather_tiles(
            frameprep._u8p(frame), self.height, self.width, self.tile_w,
            cid.ctypes.data_as(frameprep._I32P), len(cid), frameprep._u8p(out))
        return out

    def probe(self, frame: np.ndarray, idx: np.ndarray, samples: int = 8,
              hashes: np.ndarray | None = None) -> float:
        """Fraction of a sampled subset of dirty tiles whose content hash is
        already in the index (no memcmp, no state change). ``hashes`` is the
        fused scan's (nbands, ntiles) hash array; without it the sampled
        tiles are gathered and hashed."""
        step = max(1, len(idx) // samples)
        cand = [int(d) for d in idx[::step][:samples]
                if (int(d) // 1024 < self._full_bands and int(d) % 1024 < self._full_tiles)]
        if not cand:
            return 0.0
        if hashes is not None:
            hs = [int(hashes[d // 1024, d % 1024]) for d in cand]
        else:
            hs = [int(h) for h in tile_hash_np(self._gather_tiles(frame, cand))]
        return sum(h in self._hash2slot for h in hs) / len(cand)

    def split(self, frame: np.ndarray, idx: np.ndarray, max_up: int | None = None,
              hashes: np.ndarray | None = None):
        """Dirty tiles -> (upload_idx, pool_dst, copy_pairs), or None.

        upload_idx: tiles whose pixels must be uploaded; pool_dst[i]: the
        pool slot upload i is kept in (``slots`` = scratch, not kept);
        copy_pairs (kc, 2) int32 rows (src_slot, dst_idx) for pool-resident
        tiles. With ``max_up``, a frame needing more uploads returns None
        without any state change (decisions run on shadow copies and commit
        at the end). Slots assigned in this call are never the source of
        this call's copies: the device applies copies before inserts."""
        uploads: list[int] = []
        pool_dst: list[int] = []
        pairs: list[tuple[int, int]] = []
        cacheable = [int(d) // 1024 < self._full_bands and int(d) % 1024 < self._full_tiles
                     for d in idx]
        tiles_bytes = {}
        verified: dict[int, bool] = {}
        cidx = [int(d) for d, c in zip(idx, cacheable) if c]
        if cidx:
            stack = self._gather_tiles(frame, cidx)
            if hashes is not None:
                cid = np.asarray(cidx, np.int64)
                hvals = hashes[cid // 1024, cid % 1024]
            else:
                hvals = tile_hash_np(stack)
            tiles_bytes = {d: (stack[i], int(hvals[i])) for i, d in enumerate(cidx)}
            # one vectorised compare of every pre-call hash hit against its
            # stored bytes (an in-call insert or eviction never reads these)
            cand = [(i, self._hash2slot.get(int(hvals[i]))) for i in range(len(cidx))]
            cand = [(i, s) for i, s in cand if s is not None]
            if cand:
                ci = np.fromiter((i for i, _ in cand), np.int64, len(cand))
                cs = np.fromiter((s for _, s in cand), np.int64, len(cand))
                eq = (stack[ci] == self._store[cs]).all(axis=1)
                verified = {cidx[int(i)]: bool(e) for i, e in zip(ci, eq)}
        # shadow state: committed only if the frame fits the budget
        h2s = dict(self._hash2slot)
        slot_hash = list(self._slot_hash)
        free = list(self._free)
        stamp = self._stamp.copy()
        clock = self._clock + 1
        store_w: dict[int, np.ndarray] = {}
        hits = misses = evictions = 0
        new_slots: set[int] = set()
        for d, c in zip(idx, cacheable):
            d = int(d)
            if not c:
                uploads.append(d)
                pool_dst.append(self.slots)  # scratch: never kept
                if max_up is not None and len(uploads) > max_up:
                    return None
                continue
            raw, h = tiles_bytes[d]
            slot = h2s.get(h)
            if slot is not None and slot not in new_slots and verified.get(d, False):
                pairs.append((slot, d))
                stamp[slot] = clock
                hits += 1
                continue
            misses += 1
            if slot is None:
                if free:
                    slot = free.pop()
                else:
                    slot = int(np.argmin(stamp))  # LRU
                    old = slot_hash[slot]
                    if old is not None and old in h2s:
                        del h2s[old]
                    evictions += 1
                h2s[h] = slot
                slot_hash[slot] = h
            # else: a hash collision or a same-call duplicate refreshes the
            # existing slot with this content
            store_w[slot] = raw
            stamp[slot] = clock
            new_slots.add(slot)
            uploads.append(d)
            pool_dst.append(slot)
            if max_up is not None and len(uploads) > max_up:
                return None
        self._hash2slot = h2s
        self._slot_hash = slot_hash
        self._free = free
        self._stamp = stamp
        self._clock = clock
        for slot, raw in store_w.items():
            self._store[slot] = raw
        self.hits += hits
        self.misses += misses
        self.evictions += evictions
        return (
            np.array(uploads, np.int32),
            np.array(pool_dst, np.int32),
            np.array(pairs, np.int32).reshape(-1, 2),
        )
