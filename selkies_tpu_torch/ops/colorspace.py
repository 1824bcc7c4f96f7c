"""Color conversion: packed BGRx/RGB capture frames -> planar YUV 4:2:0.

Counterpart of ``selkies_tpu/ops/colorspace.py``. Output is BT.601
limited-range I420 from the fixed-point matrix

    Y = (( 66 R + 129 G +  25 B + 128) >> 8) + 16
    U = ((-38 R -  74 G + 112 B + 128) >> 8) + 128
    V = ((112 R -  94 G -  18 B + 128) >> 8) + 128

with chroma subsampled by a rounded 2x2 mean of the clipped full-res U/V
planes. All arithmetic is int32 (uint8 is widened first: torch's uint8
arithmetic wraps), so the planes equal the JAX version bit for bit.

``bgrx_to_i420`` on a CUDA tensor is one launch of a hand-written kernel
(``csrc/colorspace.cu``), which replaces no Pallas kernel: it stands in
for JAX's XLA conversion and, on the batched serving tick, for the host's
``native/frameprep.cc``. What bounds it on an H100 is its bytes: 8 x 1088
x 1920 frames read 66.8 MB and write 25.1 MB, 0.0274 ms at 3.35 TB/s. Its
design is one streaming pass, a thread a run of 2x2 quads along a row
pair with 16-byte loads and vector stores (the source has the details).
A CPU tensor takes the plain version, ``bgrx_to_i420_plain``; a CUDA
tensor launches the kernel or raises. ``launches`` counts its calls.
``bgrx_to_luma`` and ``rgb_to_i420`` are plain on every device.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from selkies_tpu_torch.utils.build import (
    REPO_ROOT,
    BuildResult,
    build_shared,
    nvcc_shared_command,
)

__all__ = ["bgrx_to_i420", "bgrx_to_i420_plain", "bgrx_to_luma", "i420_to_rgb", "rgb_to_i420"]

SOURCE = REPO_ROOT / "selkies_tpu_torch" / "csrc" / "colorspace.cu"
REPLACES = "selkies_tpu/ops/colorspace.py bgrx_to_i420 (XLA; no Pallas kernel)"

launches = 0  # calls of bgrx_to_i420 that launched the kernel

_lib: ctypes.CDLL | None = None
_build: BuildResult | None = None
_load_lock = threading.Lock()


def build() -> BuildResult:
    """Build (or find) the kernel library; returns the build record
    (``log`` holds ``-Xptxas -v``'s register and spill report)."""
    _load()
    return _build


def _load() -> ctypes.CDLL:
    global _lib, _build
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            res = build_shared("colorspace", [SOURCE], nvcc_shared_command())
            lib = ctypes.CDLL(str(res.path))
            lib.selkies_bgrx_to_i420.restype = ctypes.c_int
            lib.selkies_bgrx_to_i420.argtypes = [
                ctypes.c_int, ctypes.c_void_p,  # device, stream
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, h, w
                *[ctypes.c_void_p] * 4,  # bgrx, y, u, v
            ]
            lib.selkies_bgrx_to_i420_error_string.restype = ctypes.c_char_p
            lib.selkies_bgrx_to_i420_error_string.argtypes = [ctypes.c_int]
            _build, _lib = res, lib
    return _lib


def _luma(r, g, b):
    return ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16


def _mix(r, g, b):
    y = _luma(r, g, b)
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


def bgrx_to_i420_plain(frame: torch.Tensor):
    """(..., H, W, 4) uint8 BGRx (X11 ZPixmap layout) -> (y, u, v) uint8
    planes (..., H, W) and (..., H/2, W/2): a leading session axis is kept."""
    f = frame.to(torch.int32)
    return _to_i420(f[..., 2], f[..., 1], f[..., 0])


def bgrx_to_i420(frame: torch.Tensor):
    """``bgrx_to_i420_plain``'s planes: on the CPU by it, on a card by one
    kernel launch on the card's current stream (nothing is synchronised).

    A CUDA frame is (H, W, 4) or (N, H, W, 4) uint8, contiguous, with H and
    W even; the planes keep its leading axis. Errors: ValueError for a
    shape, dtype, layout or device the kernel does not take, before any
    build or launch; RuntimeError if the kernel cannot build or the launch
    fails."""
    global launches
    dev = frame.device
    if dev.type == "cpu":
        return bgrx_to_i420_plain(frame)
    if dev.type != "cuda":
        raise ValueError(f"bgrx_to_i420 runs on the CPU or a card, got {dev}")
    if frame.dtype != torch.uint8:
        raise ValueError(f"frame must be uint8, got {frame.dtype}")
    if frame.dim() not in (3, 4) or frame.shape[-1] != 4:
        raise ValueError(f"frame must be (H, W, 4) or (N, H, W, 4), got {tuple(frame.shape)}")
    *lead, h, w, _ = frame.shape
    if h < 2 or w < 2 or h % 2 or w % 2:
        raise ValueError(f"frame {h}x{w} must have an even height and width")
    n = lead[0] if lead else 1
    if n < 1:
        raise ValueError("no frames")
    if not frame.is_contiguous():
        raise ValueError("frame must be contiguous")
    lib = _load()
    y = torch.empty((*lead, h, w), dtype=torch.uint8, device=dev)
    u = torch.empty((*lead, h // 2, w // 2), dtype=torch.uint8, device=dev)
    v = torch.empty_like(u)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the launcher selects ``dev`` (cudaSetDevice); the guard puts the
    # thread's current card back afterwards
    with torch.cuda.device(dev):
        err = lib.selkies_bgrx_to_i420(dev.index, stream, n, h, w, frame.data_ptr(),
                                       y.data_ptr(), u.data_ptr(), v.data_ptr())
    if err != 0:
        msg = lib.selkies_bgrx_to_i420_error_string(err).decode()
        raise RuntimeError(f"bgrx_to_i420 kernel launch failed: {msg} ({err})")
    launches += 1
    return y, u, v


def bgrx_to_luma(frame: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 4) uint8 BGRx -> the y plane of ``bgrx_to_i420`` alone
    (the hybrid rows' front-end needs no chroma)."""
    f = frame.to(torch.int32)
    return _luma(f[..., 2], f[..., 1], f[..., 0]).clamp(16, 235).to(torch.uint8)


def rgb_to_i420(frame: torch.Tensor):
    """(..., H, W, 3) uint8 RGB -> (y, u, v) uint8 planes."""
    f = frame.to(torch.int32)
    return _to_i420(f[..., 0], f[..., 1], f[..., 2])


def i420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse (approximate; for tests and previews only): (H, W) and
    (H/2, W/2) uint8 planes -> (H, W, 3) uint8 RGB, in float32."""
    h, w = y.shape
    yf = (y.to(torch.float32) - 16.0) * (255.0 / 219.0)

    def up(c):
        c = (c.to(torch.float32) - 128.0).repeat_interleave(2, 0).repeat_interleave(2, 1)
        return c[:h, :w] * (255.0 / 224.0)

    up_, vp = up(u), up(v)
    r = yf + 1.402 * vp
    g = yf - 0.344136 * up_ - 0.714136 * vp
    b = yf + 1.772 * up_
    return (torch.stack([r, g, b], dim=-1) + 0.5).clamp(0, 255).to(torch.uint8)
