"""Port tests that need a CUDA card (``gpu`` marker).

Each test decides inside itself whether a card exists and skips without
one. This file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from selkies_tpu_torch.models.h264 import encoder_core as core
from selkies_tpu_torch.models.h264 import me_mc
from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
from selkies_tpu_torch.models.h264.numpy_ref import MV_PAD

W, H = 320, 192


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ME/MC kernel has no CPU mode")


def _planes(h, w, seed, motion, noise):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 255, (h, w), np.int32)
    ref = np.roll(cur, motion, (0, 1)).astype(np.int64)
    if noise:
        ref = ref + rng.integers(-noise, noise + 1, ref.shape)
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    cu = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
    cv = rng.integers(0, 255, (h // 2, w // 2), np.uint8)
    return cur, ref, cu, cv


@pytest.mark.gpu
@pytest.mark.parametrize("seed,motion,noise", [(0, (0, 0), 0), (1, (12, -20), 0),
                                               (2, (-31, 30), 25)])
def test_kernel_matches_plain_on_card(seed, motion, noise):
    _need_card()
    dev = torch.device("cuda")
    cur, ref, cu, cv = (torch.from_numpy(a).to(dev)
                        for a in _planes(H, W, seed, motion, noise))
    pads = [core.edge_pad(p, MV_PAD) for p in (ref, cu, cv)]
    cands = core.hier_candidates(cur, ref)
    before = me_mc.launches
    got = me_mc.me_mc(cands, cur, *pads)
    want = me_mc.me_mc_plain(cands, cur, *pads)
    torch.cuda.synchronize()
    assert me_mc.launches == before + 1
    for name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
        assert torch.equal(a, b), name


_TRAP_SCRIPT = """
import torch
from selkies_tpu_torch.models.h264 import encoder_core as core, me_mc
from selkies_tpu_torch.models.h264.numpy_ref import MV_PAD
dev = torch.device("cuda")
cur = torch.zeros((32, 32), dtype=torch.int32, device=dev)
pads = [core.edge_pad(torch.zeros(s, dtype=torch.uint8, device=dev), MV_PAD)
        for s in ((32, 32), (16, 16), (16, 16))]
cands = torch.tensor([[0, 0], [MV_PAD + 1, 0]], dtype=torch.int32, device=dev)
try:
    me_mc.me_mc(cands, cur, *pads)
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("raised:", type(exc).__name__, me_mc.launches)
"""


@pytest.mark.gpu
def test_kernel_out_of_reach_candidate_raises():
    """The documented contract: the kernel traps and the launch or the next
    sync raises. Run in a child process: the trap leaves its CUDA context
    unusable."""
    _need_card()
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT], cwd=root, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(root)})
    assert "raised:" in res.stdout, res.stdout + res.stderr


def _trace(seed=1):
    rng = np.random.default_rng(seed)
    cur = np.kron(rng.integers(40, 200, (H // 16, W // 16, 4), np.uint8),
                  np.ones((16, 16, 1), np.uint8))
    frames = [cur, np.roll(cur, 8, 0)]
    cur = frames[-1].copy()
    cur[40:56, 40:200, :3] = rng.integers(0, 255, (16, 160, 3), np.uint8)
    frames += [cur, cur.copy(), np.roll(cur, (-5, 3), (0, 1)),
               rng.integers(0, 255, (H, W, 4), np.uint8)]
    return frames


def _drive(enc, frames):
    out = []
    for i, f in enumerate(frames):
        if i == 4:
            enc.force_keyframe()
        au = enc.encode_frame(f, qp=34 if i == 5 else None)
        out.append(hashlib.sha256(au).hexdigest())
    return out


@pytest.mark.gpu
def test_cuda_encoder_matches_cpu_bytes():
    _need_card()
    frames = _trace()
    before = me_mc.launches
    got = _drive(TorchH264Encoder(W, H, device="cuda"), frames)
    launched = me_mc.launches - before
    assert got == _drive(TorchH264Encoder(W, H, device="cpu"), frames)
    assert launched == 3  # 6 frames less 2 IDRs and 1 static repeat
