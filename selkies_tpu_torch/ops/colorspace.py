"""Color conversion: packed BGRx/RGB capture frames -> planar YUV 4:2:0.

Counterpart of ``selkies_tpu/ops/colorspace.py``. Output is BT.601
limited-range I420 from the fixed-point matrix

    Y = (( 66 R + 129 G +  25 B + 128) >> 8) + 16
    U = ((-38 R -  74 G + 112 B + 128) >> 8) + 128
    V = ((112 R -  94 G -  18 B + 128) >> 8) + 128

with chroma subsampled by a rounded 2x2 mean of the clipped full-res U/V
planes. All arithmetic is int32 (uint8 is widened first: torch's uint8
arithmetic wraps), so the planes equal the JAX version bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["bgrx_to_i420", "rgb_to_i420"]


def _mix(r, g, b):
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128
    return y, u, v


def _subsample(plane: torch.Tensor) -> torch.Tensor:
    """2x2 mean with rounding; plane is int32 (..., H, W), H and W even."""
    *lead, h, w = plane.shape
    q = plane.reshape(*lead, h // 2, 2, w // 2, 2)
    return (q.sum(dim=(-3, -1), dtype=torch.int32) + 2) >> 2


def _to_i420(r, g, b):
    y, u, v = _mix(r, g, b)
    y = y.clamp(16, 235).to(torch.uint8)
    u = _subsample(u.clamp(16, 240))
    v = _subsample(v.clamp(16, 240))
    return y, u.to(torch.uint8), v.to(torch.uint8)


def bgrx_to_i420(frame: torch.Tensor):
    """(..., H, W, 4) uint8 BGRx (X11 ZPixmap layout) -> (y, u, v) uint8
    planes (..., H, W) and (..., H/2, W/2): a leading session axis is kept."""
    f = frame.to(torch.int32)
    return _to_i420(f[..., 2], f[..., 1], f[..., 0])


def rgb_to_i420(frame: torch.Tensor):
    """(..., H, W, 3) uint8 RGB -> (y, u, v) uint8 planes."""
    f = frame.to(torch.int32)
    return _to_i420(f[..., 0], f[..., 1], f[..., 2])
