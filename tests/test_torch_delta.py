"""Port parity for the delta path's tile writes: scatter_tiles,
_apply_tiles2 and _pool_seed_step against the JAX encoder's sequential
loops, including duplicate positions and slots, scratch writes and pads.
Every comparison is exact: whole planes and the whole pool, the scratch
row included."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from selkies_tpu.models.h264 import encoder as J
from selkies_tpu.models.h264 import encoder_core as JC
from selkies_tpu_torch.models.h264 import encoder as T
from selkies_tpu_torch.models.h264 import encoder_core as TC

TW = 64  # tile width at 320 columns
PH, PW = 192, 320  # 12 bands x 5 tiles
SLOTS = 6  # pool rows 0..5, scratch row 6


def _planes(rng):
    return (rng.integers(0, 256, (PH, PW), np.uint8),
            rng.integers(0, 256, (PH // 2, PW // 2), np.uint8),
            rng.integers(0, 256, (PH // 2, PW // 2), np.uint8))


def _pool(rng):
    return (rng.integers(0, 256, (SLOTS + 1, 16, TW), np.uint8),
            rng.integers(0, 256, (SLOTS + 1, 8, TW // 2), np.uint8),
            rng.integers(0, 256, (SLOTS + 1, 8, TW // 2), np.uint8))


def _tiles(rng, k):
    return (rng.integers(0, 256, (k, 16, TW), np.uint8),
            rng.integers(0, 256, (k, 8, TW // 2), np.uint8),
            rng.integers(0, 256, (k, 8, TW // 2), np.uint8))


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _eq_all(got, want, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _d(band, tile):
    return band * 1024 + tile


# idx lists: duplicates inside the list and the host's padding (the last
# tile repeated)
_SCATTER = {
    "distinct": [_d(0, 0), _d(3, 4), _d(11, 2)],
    "duplicates": [_d(2, 1), _d(5, 3), _d(2, 1), _d(7, 0), _d(5, 3), _d(2, 1)],
    "padded": [_d(1, 1), _d(9, 4), _d(9, 4), _d(9, 4), _d(9, 4)],
}


@pytest.mark.parametrize("case", list(_SCATTER))
def test_scatter_tiles_matches_jax(case):
    rng = np.random.default_rng(len(case))
    planes = _planes(rng)
    idx = np.array(_SCATTER[case], np.int32)
    tiles = _tiles(rng, len(idx))
    want = JC.scatter_tiles(*_j(planes), *_j(tiles), jnp.asarray(idx), TW)
    got = TC.scatter_tiles(*_t(planes), *_t(tiles), torch.from_numpy(idx), TW)
    _eq_all(got, want, "yuv")


def _pack2(up_idx, pool_dst, pairs, yb, ub, vb):
    return np.concatenate([
        np.asarray(up_idx, np.int32).view(np.uint8), np.asarray(pool_dst, np.int32).view(np.uint8),
        np.asarray(pairs, np.int32).reshape(-1).view(np.uint8), yb.ravel(), ub.ravel(), vb.ravel()])


S = SLOTS  # the scratch slot id
# (upload idx, pool slot of each upload, copy pairs (src slot, dst idx));
# -1 uploads are pads (identity writes into the scratch row), -1 copy
# sources are pads
_APPLY = {
    "pure_remap": ([], [], [(0, _d(1, 1)), (3, _d(4, 2)), (5, _d(11, 4)), (-1, 0)]),
    "pure_upload": ([_d(0, 0), _d(6, 3), _d(10, 1), -1], [1, 2, S, S], [(-1, 0)] * 3),
    "mixed": ([_d(2, 2), _d(8, 0), -1, -1], [4, S, S, S],
              [(0, _d(3, 3)), (1, _d(2, 2)), (2, _d(0, 0)), (-1, 0)]),
    # two uploads of one call into one slot (same-call duplicate and the
    # hash-collision case: two different contents), several scratch writes
    "duplicate_slots": ([_d(1, 0), _d(1, 1), _d(5, 2), _d(6, 3), _d(7, 4), -1],
                        [2, 2, S, 3, S, S], [(-1, 0), (-1, 0)]),
    # copies onto one position (the later wins), a copy onto a position an
    # upload also writes (the upload wins), duplicate upload positions
    "duplicate_positions": ([_d(4, 4), _d(9, 1), _d(4, 4), -1, -1], [0, 1, 5, S, S],
                            [(2, _d(9, 1)), (3, _d(6, 0)), (4, _d(6, 0)), (1, _d(0, 0)),
                             (-1, 0), (0, _d(6, 0))]),
}


@pytest.mark.parametrize("case", list(_APPLY))
def test_apply_tiles2_matches_jax(case):
    up_idx, pool_dst, pairs = _APPLY[case]
    rng = np.random.default_rng(100 + len(case))
    planes, pool = _planes(rng), _pool(rng)
    bucket, cbucket = len(up_idx), len(pairs)
    tiles = _tiles(rng, bucket)
    # the host packer fills pad uploads with zeros
    for t in tiles:
        t[[i for i, d in enumerate(up_idx) if d < 0]] = 0
    packed = _pack2(up_idx, pool_dst, pairs, *tiles)
    want = J._apply_tiles2(*_j(planes), *_j(pool), jnp.asarray(packed), tile_w=TW,
                           bucket=bucket, cbucket=cbucket)
    got = T._apply_tiles2(*_t(planes), *_t(pool), torch.from_numpy(packed),
                          tile_w=TW, bucket=bucket, cbucket=cbucket)
    _eq_all(got, want, ("y", "u", "v", "pool_y", "pool_u", "pool_v"))


def test_pool_seed_step_matches_jax():
    """Seed pairs (slot, idx) with a duplicate slot and scratch pads, which
    gather tile 0 into the scratch row."""
    rng = np.random.default_rng(7)
    planes, pool = _planes(rng), _pool(rng)
    pairs = np.array([[0, _d(3, 1)], [4, _d(0, 4)], [0, _d(11, 2)], [S, _d(5, 4)],
                      [S, 0], [S, 0]], np.int32)
    want = J._pool_seed_step(jnp.asarray(pairs), *_j(planes), *_j(pool), tile_w=TW,
                             sbucket=len(pairs))
    got = T._pool_seed_step(torch.from_numpy(pairs), *_t(planes), *_t(pool),
                            tile_w=TW, sbucket=len(pairs))
    _eq_all(got, want, ("pool_y", "pool_u", "pool_v"))


def test_last_writer():
    keys = torch.tensor([3, 1, 3, 2, 1, 3])
    assert TC.last_writer(keys).tolist() == [5, 4, 5, 3, 4, 5]
    valid = torch.tensor([True, True, False, True, False, False])
    assert TC.last_writer(keys, valid).tolist() == [0, 1, 0, 3, 1, 0]
    assert TC.last_writer(torch.tensor([7, 7]), torch.tensor([False, False])).tolist() == [-1, -1]
