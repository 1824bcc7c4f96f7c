"""ME/MC kernel module (selkies_tpu_torch/models/h264/me_mc.py).

The plain version is held against the TPU kernel ``hier_me_mc_pallas``
run in interpret mode on the four cases of tests/test_pallas_me.py, as
that file runs it: MVs and predictions must be equal element for element.
The wrapper takes the plain version for CPU tensors. The CUDA kernel
itself is compared with the plain version on a card, in
tests/test_torch_gpu.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from selkies_tpu.models.h264.pallas_me import hier_me_mc_pallas
from selkies_tpu_torch.models.h264 import encoder_core as T
from selkies_tpu_torch.models.h264 import me_mc
from selkies_tpu_torch.models.h264.numpy_ref import MV_PAD


def _planes(h, w, seed, motion=(0, 0), noise=0):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 255, (h, w), np.int32)
    ref = np.roll(cur, motion, (0, 1)).astype(np.int64)
    if noise:
        ref = ref + rng.integers(-noise, noise + 1, ref.shape)
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    cu = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
    cv = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
    return cur, ref, cu, cv


def _pads(ref, cu, cv):
    return [np.pad(p, MV_PAD, mode="edge") for p in (ref, cu, cv)]


@pytest.mark.parametrize(
    "h,w,motion,noise",
    [
        (64, 128, (0, 0), 0),      # static content -> zero MVs everywhere
        (128, 256, (5, -9), 0),    # uniform motion within reach
        (96, 192, (-30, 22), 3),   # near max reach + noise
        (128, 128, (7, 7), 40),    # heavy noise: many distinct winners
    ],
)
def test_plain_matches_pallas_kernel(h, w, motion, noise):
    cur, ref, cu, cv = _planes(h, w, seed=h + w, motion=motion, noise=noise)
    pads = _pads(ref, cu, cv)
    want = hier_me_mc_pallas(jnp.asarray(cur), jnp.asarray(ref),
                             *(jnp.asarray(p) for p in pads), interpret=True)
    got = T.hier_me_mc(torch.from_numpy(cur), torch.from_numpy(ref),
                       *(torch.from_numpy(p) for p in pads))
    for name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_cpu_tensors_take_plain_version():
    cur, ref, cu, cv = _planes(32, 48, seed=3, motion=(1, 2))
    pads = [torch.from_numpy(p) for p in _pads(ref, cu, cv)]
    cands = T.hier_candidates(torch.from_numpy(cur), torch.from_numpy(ref))
    before = me_mc.launches
    got = me_mc.me_mc(cands, torch.from_numpy(cur), *pads)
    want = me_mc.me_mc_plain(cands, torch.from_numpy(cur), *pads)
    assert me_mc.launches == before  # no kernel on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_candidate_order_breaks_ties():
    """Duplicate and equal-SAD candidates: the earliest one wins."""
    cur, ref, cu, cv = _planes(32, 32, seed=5)
    pads = [torch.from_numpy(p) for p in _pads(np.full_like(ref, 9), cu, cv)]
    cur_t = torch.full((32, 32), 9, dtype=torch.int32)  # every shift has SAD 0
    cands = torch.tensor([[3, -1], [0, 0], [3, -1]], dtype=torch.int32)
    mvs, *_ = me_mc.me_mc_plain(cands, cur_t, *pads)
    assert (mvs == torch.tensor([3, -1], dtype=torch.int32)).all()


@pytest.mark.parametrize("bad", ["shape", "reach", "count"])
def test_wrapper_rejects_bad_input(bad):
    cur, ref, cu, cv = _planes(32, 32, seed=1)
    pads = [torch.from_numpy(p) for p in _pads(ref, cu, cv)]
    cands = torch.zeros((1, 2), dtype=torch.int32)
    if bad == "shape":
        pads[1] = pads[1][1:]
    elif bad == "reach":
        cands = torch.tensor([[0, MV_PAD + 1]], dtype=torch.int32)
    else:  # the plain version's int32 SAD*scale + rank would overflow
        cands = torch.zeros((me_mc.MAX_CANDS + 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        me_mc.me_mc(cands, torch.from_numpy(cur), *pads)


def test_candidate_limit_is_exact_in_int32():
    """At MAX_CANDS the plain version's cost still fits int32: the last
    candidate wins where it is the only exact match."""
    cur, ref, cu, cv = _planes(16, 16, seed=2)
    pads = [torch.from_numpy(p) for p in _pads(ref, cu, cv)]
    cands = torch.full((me_mc.MAX_CANDS, 2), MV_PAD, dtype=torch.int32)
    cands[-1] = 0
    mvs, pred_y, *_ = me_mc.me_mc(cands, torch.from_numpy(cur), *pads)
    assert mvs.tolist() == [[[0, 0]]]
    assert torch.equal(pred_y, torch.from_numpy(cur))

