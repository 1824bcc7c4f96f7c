"""The IDR step's intra loops as one CUDA kernel: wrapper and contract.

Replaces no Pallas kernel. It replaces the ``lax.scan`` intra loops of
``selkies_tpu/models/h264/encoder_core.py`` (``_encode_row0``, and the row
scan of ``encode_frame_planes``), which the port ran as Python loops of
tensor ops: ~64k ops for one 1080p IDR. Those loops stay as the plain
version, ``encoder_core._encode_intra_plain``, which CPU tensors take.

What bounds it on an H100 is its serial chain, not its bytes: row 0 is a
DC chain of left neighbours and every later row predicts from the recon
row above, so the last MB of a 1920x1088 session waits on 120 + 67 = 187
MB steps, while its ~16-28 MB of planes, levels and recon (one session
to eight) take ~5-8 us at 3.35 TB/s. The design (``csrc/intra.cu``)
makes one warp one MB step, every 4x4 block's transform and quantisation
in a lane's registers and the DC Hadamards and the next prediction passed
by shuffles, so no step of the chain goes through memory: one warp per
session walks row 0, then one warp per (session, MB column) walks down the
rows, every column at once.

``encode_intra`` is the wrapper ``encoder_core._encode_intra`` calls for a
CUDA tensor: it launches or raises. ``launches`` counts its calls (two
kernel launches each, one for an MB row's height).
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

SOURCE = REPO_ROOT / "selkies_tpu_torch" / "csrc" / "intra.cu"
REPLACES = "selkies_tpu/models/h264/encoder_core.py:207 (lax.scan loops; no Pallas kernel)"
QP_ROW = 88  # encoder_core._qp_table's row: luma constants, then chroma

launches = 0  # calls of encode_intra that launched

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
            res = build_shared("intra", [SOURCE], nvcc_shared_command())
            lib = ctypes.CDLL(str(res.path))
            lib.selkies_intra.restype = ctypes.c_int
            lib.selkies_intra.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # device, stream, nsess
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, u8
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # y, u, v
                ctypes.c_void_p, ctypes.c_int,  # qp rows, qp stride
                *[ctypes.c_void_p] * 9,  # the outputs
            ]
            lib.selkies_intra_error_string.restype = ctypes.c_char_p
            lib.selkies_intra_error_string.argtypes = [ctypes.c_int]
            _build, _lib = res, lib
    return _lib


def check(y, u, v, qp_rows) -> tuple[int, int, int]:
    """The shape contract, on any device: y (H, W) or (N, H, W), H and W
    multiples of 16; u, v (..., H/2, W/2) with y's leading axis; qp_rows
    (1 or N, QP_ROW). -> (N, H, W), N = 1 without a leading axis."""
    if y.dim() not in (2, 3):
        raise ValueError(f"y must be (H, W) or (N, H, W), got {tuple(y.shape)}")
    *lead, h, w = y.shape
    if h < 16 or w < 16 or h % 16 or w % 16:
        raise ValueError(f"y {h}x{w} is not a multiple of 16")
    want = (*lead, h // 2, w // 2)
    for name, t in (("u", u), ("v", v)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
    n = lead[0] if lead else 1
    if n < 1:
        raise ValueError("no sessions")
    if qp_rows.dim() != 2 or qp_rows.shape[1] != QP_ROW or qp_rows.shape[0] not in (1, n):
        raise ValueError(f"qp_rows must be (1, {QP_ROW}) or ({n}, {QP_ROW}), "
                         f"got {tuple(qp_rows.shape)}")
    return n, h, w


def encode_intra(y, u, v, qp_rows) -> dict:
    """``encoder_core._encode_intra`` on CUDA planes in one kernel call.

    y, u, v: uint8 or int32 (all three alike), contiguous, on one card;
    qp_rows: ``_QPRows.rows``, int32 on the same card, one row for every
    session or one row each. Returns the plain version's dict, every
    tensor made here with ``torch.empty`` and written on the planes'
    card's current stream; nothing is synchronised.

    Errors: ValueError for a shape, device, dtype, layout or alignment
    the kernel does not take, before any build or launch; RuntimeError if
    the kernel cannot build or the launch fails."""
    global launches
    n, h, w = check(y, u, v, qp_rows)
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"the intra kernel needs CUDA planes, got {dev}")
    if y.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"y must be uint8 or int32, got {y.dtype}")
    align = 4 if y.dtype == torch.uint8 else 16
    for name, t, dtype in (("y", y, y.dtype), ("u", u, y.dtype), ("v", v, y.dtype),
                           ("qp_rows", qp_rows, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, y on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "qp_rows" and t.data_ptr() % align:
            raise ValueError(f"{name} must start {align}-byte aligned")
    lib = _load()
    lead = tuple(y.shape[:-2])
    mbh, mbw = h // 16, w // 16

    def empty(*shape, dtype=torch.int32):
        return torch.empty((*lead, *shape), dtype=dtype, device=dev)

    out = {
        "luma_mode": empty(mbh, mbw),
        "chroma_mode": empty(mbh, mbw),
        "luma_dc": empty(mbh, mbw, 4, 4),
        "luma_ac": empty(mbh, mbw, 4, 4, 4, 4),
        "chroma_dc": empty(mbh, mbw, 2, 2, 2),
        "chroma_ac": empty(mbh, mbw, 2, 2, 2, 4, 4),
        "recon_y": empty(h, w, dtype=torch.uint8),
        "recon_u": empty(h // 2, w // 2, dtype=torch.uint8),
        "recon_v": empty(h // 2, w // 2, dtype=torch.uint8),
    }
    stream = torch.cuda.current_stream(dev).cuda_stream
    qp_stride = QP_ROW if qp_rows.shape[0] > 1 else 0
    # the launcher selects ``dev`` (cudaSetDevice); the guard puts the
    # thread's current card back afterwards
    with torch.cuda.device(dev):
        err = lib.selkies_intra(
            dev.index, stream, n, h, w, int(y.dtype == torch.uint8),
            y.data_ptr(), u.data_ptr(), v.data_ptr(), qp_rows.data_ptr(), qp_stride,
            *(t.data_ptr() for t in out.values()))
    if err != 0:
        msg = lib.selkies_intra_error_string(err).decode()
        raise RuntimeError(f"intra kernel launch failed: {msg} ({err})")
    launches += 1
    return out
