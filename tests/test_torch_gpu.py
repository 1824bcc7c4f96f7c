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


def _rand_cands(rng, n):
    """n seeded candidates within +-MV_PAD; the first four have dx = 0..3 mod 4."""
    c = rng.integers(-MV_PAD, MV_PAD + 1, (n, 2)).astype(np.int32)
    c[:4, 0] = [-40, 13, -2, 39][:n]
    return torch.from_numpy(c)


# name -> (h, w, seed, motion, noise, candidate list)
_CASES = {
    "320x192-static": (H, W, 0, (0, 0), 0, "hier"),
    "320x192-motion": (H, W, 1, (12, -20), 0, "hier"),
    "320x192-near-reach-noise": (H, W, 2, (-31, 30), 25, "hier"),
    # ragged strips of 8 MBs: 21 MB columns, one MB, and the 1080p width
    "336x208-ragged": (208, 336, 3, (5, -7), 4, "hier"),
    "16x16-one-mb": (16, 16, 4, (1, 2), 0, "hier"),
    "1920x1088": (1088, 1920, 5, (-24, 29), 6, "hier"),
    # the clamped lists a band (rows) and a tile (rows and columns) search
    "336x208-band-clamped": (208, 336, 6, (-30, 9), 3, "band"),
    "336x208-tile-clamped": (208, 336, 7, (21, -33), 3, "tile"),
    # candidate counts around a warp's 32 lanes and the 256-entry chunk
    "count-1": (208, 336, 8, (0, 0), 5, 1),
    "count-77": (208, 336, 9, (3, 3), 5, 77),
    "count-300": (208, 336, 10, (-9, 14), 20, 300),
    "count-600": (64, 96, 11, (2, -1), 40, 600),
    # cur and ry off 16-byte alignment: the kernel's byte- and int-load path
    "336x208-unaligned": (208, 336, 12, (-6, 11), 8, "unaligned"),
    # constant planes: every candidate has SAD 0 and the first must win in
    # every MB, across lanes and staged chunks, before a later duplicate
    "tie-3": (48, 336, 13, (0, 0), 0, "tie"),
    "tie-300": (48, 336, 14, (0, 0), 0, "tie"),
}


def _unaligned(t):
    """A contiguous copy of t whose data starts one element past an
    allocation's (16-byte aligned) start."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


def _case_inputs(name, dev):
    h, w, seed, motion, noise, kind = _CASES[name]
    cur, ref, cu, cv = (torch.from_numpy(a).to(dev) for a in _planes(h, w, seed, motion, noise))
    pads = [core.edge_pad(p, MV_PAD) for p in (ref, cu, cv)]
    rng = np.random.default_rng(seed)
    if kind == "hier":
        cands = core.hier_candidates(cur, ref)
    elif kind == "unaligned":
        cands = core.hier_candidates(cur, ref)
        cur, pads[0] = _unaligned(cur), _unaligned(pads[0])
    elif kind in ("band", "tile"):
        coarse = core.coarse_vote_candidates(cur, ref)
        clamp = {"dy_max": 16} if kind == "band" else {"dy_max": 24, "dx_max": 12}
        cands = core._refine_cands(coarse, **clamp)
    elif kind == "tie":
        cur = torch.full_like(cur, 9)
        pads = [torch.full_like(p, 9) for p in pads]
        cands = _rand_cands(rng, int(name.split("-")[1]))
        cands[-1] = cands[0]
    elif kind == 1:
        cands = torch.zeros((1, 2), dtype=torch.int32)
    elif kind == 77:  # the hierarchical list, then the true motion
        cands = torch.cat([core.hier_candidates(cur, ref).cpu(),
                           torch.tensor([[motion[1], motion[0]]], dtype=torch.int32)])
    else:
        cands = _rand_cands(rng, kind)
        cands[5] = torch.tensor([motion[1], motion[0]], dtype=torch.int32)
    return cands.to(dev), cur, *pads


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_CASES))
def test_kernel_matches_plain_on_card(case):
    _need_card()
    args = _case_inputs(case, torch.device("cuda"))
    before = me_mc.launches
    got = me_mc.me_mc(*args)
    want = me_mc.me_mc_plain(*args)
    torch.cuda.synchronize()
    assert me_mc.launches == before + 1
    for name, a, b in zip(("mvs", "pred_y", "pred_u", "pred_v"), got, want):
        assert torch.equal(a, b), name
    if _CASES[case][-1] == "tie":
        assert (got[0] == args[0][0]).all()


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
