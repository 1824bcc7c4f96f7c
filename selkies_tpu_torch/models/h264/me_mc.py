"""Fused motion estimation + motion compensation: CUDA kernel, plain version, wrapper.

Replaces the TPU kernel ``selkies_tpu/models/h264/pallas_me.py``
(``_me_mc_kernel`` via ``pl.pallas_call`` in ``_me_mc_call``, entry
``hier_me_mc_pallas``). For every 16x16 macroblock and every candidate
shift of a given list it takes the SAD of the current block against the
MV_PAD edge-padded reference, keeps the first minimum in candidate order
(the same winner as JAX's ``cost = SAD*scale + rank``), and writes the
winner's MV, its full-pel luma prediction and its half-pel bilinear
chroma predictions (8.4.2.2.2).

What bounds it on an H100: at 1920x1088 with 76 candidates it takes
76 x 1920 x 1088 absolute differences of bytes (about 0.16 G) on ~24.6 MB
of input and output. ``cuobjdump -sass`` of the kernel shows ``__vsadu4``
as one native instruction on sm_90a (``VABSDIFF4.U8.ACC``, 64 per MB and
candidate), so the operations take ~2.4 us at 64 int32 lanes per SM
against ~7.3 us for the bytes at 3.35 TB/s: the bytes set the bound.
The design (``csrc/me_mc.cu``) keeps the rest of the work near the SAD
instructions and pays no barrier per candidate: a block holds a strip of
8 MBs of one MB row, one warp per MB; it loads the reference window every
candidate within +-MV_PAD can reach (96 x 208 bytes) and the strip's
current pixels packed to bytes into shared memory once; each lane sums
whole candidates' SADs four pixels at a time, and one warp min-reduction
of ``SAD << 16 | rank`` per MB picks the first minimum in candidate
order. The luma prediction is written from the window with coalesced
16-byte stores. The TPU kernel's bf16 one-hot row-select matmuls and f32
cost trick exist only to keep the TPU's matrix unit exact and have no
counterpart here.

``me_mc`` is the wrapper: CPU tensors go to ``me_mc_plain``; CUDA tensors
launch the kernel or raise. ``me_mc_batch`` / ``me_mc_batch_plain`` are
the same over a leading session axis (the multi-session tick,
``parallel/sessions.py``): every session has its own candidate list, and
one launch covers every session (``blockIdx.z`` is the session; a solo
frame is the one-session launch). ``launches`` counts kernel launches, one
per batched launch.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path

import torch

from selkies_tpu_torch.models.h264.numpy_ref import MV_PAD
from selkies_tpu_torch.utils.build import REPO_ROOT, BuildResult, build_shared

SOURCE = REPO_ROOT / "selkies_tpu_torch" / "csrc" / "me_mc.cu"
REPLACES = "selkies_tpu/models/h264/pallas_me.py:219"
# The kernel keys a candidate by SAD << 16 | rank, and the plain version's
# int32 SAD * scale + rank overflows above this count.
MAX_CANDS = 1 << 15
MAX_SESSIONS = 65535  # gridDim.z

launches = 0  # kernel launches by me_mc() and me_mc_batch()

_lib: ctypes.CDLL | None = None
_build: BuildResult | None = None
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the ME/MC kernel needs the CUDA toolkit")


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
            command = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                       "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
            res = build_shared("me_mc", [SOURCE], command)
            lib = ctypes.CDLL(str(res.path))
            lib.selkies_me_mc.restype = ctypes.c_int
            lib.selkies_me_mc.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # device, stream, nsess
                ctypes.c_void_p, ctypes.c_int,  # cands, ncand
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # cur, h, w
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ry, ru, rv
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outs
            ]
            lib.selkies_cuda_error_string.restype = ctypes.c_char_p
            lib.selkies_cuda_error_string.argtypes = [ctypes.c_int]
            _build, _lib = res, lib
    return _lib


def _check(cands, cur, ry_pad, ru_pad, rv_pad) -> tuple[int, int]:
    if cands.dim() != 2 or cands.shape[1] != 2 or not 1 <= cands.shape[0] <= MAX_CANDS:
        raise ValueError(f"cands must be (N, 2) with 1 <= N <= {MAX_CANDS}, "
                         f"got {tuple(cands.shape)}")
    if cur.dim() != 2:
        raise ValueError(f"cur must be 2-D, got {tuple(cur.shape)}")
    h, w = cur.shape
    if h % 16 or w % 16:
        raise ValueError(f"cur {h}x{w} is not a multiple of 16")
    want = {"ry_pad": (h + 2 * MV_PAD, w + 2 * MV_PAD),
            "ru_pad": (h // 2 + 2 * MV_PAD, w // 2 + 2 * MV_PAD),
            "rv_pad": (h // 2 + 2 * MV_PAD, w // 2 + 2 * MV_PAD)}
    for name, t in (("ry_pad", ry_pad), ("ru_pad", ru_pad), ("rv_pad", rv_pad)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want[name]}")
    return h, w


def mc_luma(ry_pad, mvs):
    """Full-pel luma MC: the per-MB-shifted reference plane (int32)."""
    mbh, mbw = mvs.shape[:2]
    h, w = mbh * 16, mbw * 16
    dev = ry_pad.device
    mvx = mvs[..., 0].repeat_interleave(16, 0).repeat_interleave(16, 1)
    mvy = mvs[..., 1].repeat_interleave(16, 0).repeat_interleave(16, 1)
    iy = torch.arange(h, device=dev)[:, None] + mvy + MV_PAD
    ix = torch.arange(w, device=dev)[None, :] + mvx + MV_PAD
    return ry_pad[iy, ix].to(torch.int32)


def mc_chroma(rc_pad, mvs):
    """Chroma MC (8.4.2.2.2): full-pel luma MVs land chroma on half-pel;
    bilinear blend of the 4 neighbours with weights from frac in {0, 4}."""
    mbh, mbw = mvs.shape[:2]
    h, w = mbh * 8, mbw * 8
    dev = rc_pad.device
    mvx = mvs[..., 0].repeat_interleave(8, 0).repeat_interleave(8, 1)
    mvy = mvs[..., 1].repeat_interleave(8, 0).repeat_interleave(8, 1)
    xf, yf = 4 * (mvx & 1), 4 * (mvy & 1)
    iy = torch.arange(h, device=dev)[:, None] + (mvy >> 1) + MV_PAD
    ix = torch.arange(w, device=dev)[None, :] + (mvx >> 1) + MV_PAD
    p = rc_pad.to(torch.int32)
    a, b = p[iy, ix], p[iy, ix + 1]
    c, d = p[iy + 1, ix], p[iy + 1, ix + 1]
    return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
            + (8 - xf) * yf * c + xf * yf * d + 32) >> 6


def me_mc_plain(cands, cur, ry_pad, ru_pad, rv_pad):
    """Plain PyTorch version of the kernel (any device).

    cands (N, 2) int32 (dx, dy) in rank order; cur (h, w) integer luma;
    ry_pad/ru_pad/rv_pad the MV_PAD edge-padded reference planes. Returns
    (mvs (h/16, w/16, 2) int32, pred_y (h, w), pred_u, pred_v (h/2, w/2)
    int32). Cost per MB and candidate is SAD*scale + rank (scale a power of
    two above the rank), so the minimum is the first minimum SAD in order.
    """
    h, w = _check(cands, cur, ry_pad, ru_pad, rv_pad)
    mbh, mbw = h // 16, w // 16
    cur = cur.to(torch.int32)
    cl = cands.tolist()
    scale = 1 << (len(cl) - 1).bit_length()
    best = None
    for k, (dx, dy) in enumerate(cl):
        if max(abs(dx), abs(dy)) > MV_PAD:
            raise ValueError(f"candidate ({dx}, {dy}) exceeds MV_PAD={MV_PAD}")
        ys = ry_pad[MV_PAD + dy:MV_PAD + dy + h, MV_PAD + dx:MV_PAD + dx + w].to(torch.int32)
        sad = (cur - ys).abs().reshape(mbh, 16, mbw, 16).sum(dim=(1, 3), dtype=torch.int32)
        cost = sad * scale + k
        best = cost if best is None else torch.minimum(best, cost)
    best_rank = (best & (scale - 1)).long()
    mvs = cands.to(device=cur.device, dtype=torch.int32)[best_rank]
    return mvs, mc_luma(ry_pad, mvs), mc_chroma(ru_pad, mvs), mc_chroma(rv_pad, mvs)


def me_mc_batch_plain(cands, cur, ry_pad, ru_pad, rv_pad):
    """Plain PyTorch version of the batched kernel (any device): cands (N,
    K, 2), cur (N, h, w), the padded planes with a leading N. Session i's
    outputs are ``me_mc_plain`` of session i's inputs; each output gains a
    leading N."""
    _check_batch(cands, cur, ry_pad, ru_pad, rv_pad)
    outs = [me_mc_plain(cands[i], cur[i], ry_pad[i], ru_pad[i], rv_pad[i])
            for i in range(cur.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def _check_batch(cands, cur, ry_pad, ru_pad, rv_pad) -> int:
    if cur.dim() != 3 or not 1 <= cur.shape[0] <= MAX_SESSIONS:
        raise ValueError(f"cur must be (N, h, w) with 1 <= N <= {MAX_SESSIONS}, "
                         f"got {tuple(cur.shape)}")
    n = cur.shape[0]
    for name, t in (("cands", cands), ("ry_pad", ry_pad), ("ru_pad", ru_pad),
                    ("rv_pad", rv_pad)):
        if t.dim() != 3 or t.shape[0] != n:
            raise ValueError(f"{name} must be 3-D with {n} sessions, got {tuple(t.shape)}")
    _check(cands[0], cur[0], ry_pad[0], ru_pad[0], rv_pad[0])
    return n


def _launch(n: int, cands, cur, ry_pad, ru_pad, rv_pad):
    """One launch over n sessions' slabs (the arrays' leading axis, or one
    session without it); validates device, dtype and layout first."""
    global launches
    h, w = cur.shape[-2:]
    for name, t, dtype in (("cands", cands, torch.int32), ("cur", cur, torch.int32),
                           ("ry_pad", ry_pad, torch.uint8), ("ru_pad", ru_pad, torch.uint8),
                           ("rv_pad", rv_pad, torch.uint8)):
        if t.device != cur.device:
            raise ValueError(f"{name} is on {t.device}, cur on {cur.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _load()
    dev = cur.device
    lead = tuple(cur.shape[:-2])
    mvs = torch.empty((*lead, h // 16, w // 16, 2), dtype=torch.int32, device=dev)
    pred_y = torch.empty((*lead, h, w), dtype=torch.int32, device=dev)
    pred_u = torch.empty((*lead, h // 2, w // 2), dtype=torch.int32, device=dev)
    pred_v = torch.empty((*lead, h // 2, w // 2), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.selkies_me_mc(
        dev.index, stream, n, cands.data_ptr(), cands.shape[-2], cur.data_ptr(), h, w,
        ry_pad.data_ptr(), ru_pad.data_ptr(), rv_pad.data_ptr(),
        mvs.data_ptr(), pred_y.data_ptr(), pred_u.data_ptr(), pred_v.data_ptr())
    if err != 0:
        msg = lib.selkies_cuda_error_string(err).decode()
        raise RuntimeError(f"me_mc kernel launch failed: {msg} ({err})")
    launches += 1
    return mvs, pred_y, pred_u, pred_v


def me_mc_batch(cands, cur, ry_pad, ru_pad, rv_pad):
    """ME + MC of N sessions, each over its own candidate list: the plain
    version for CPU tensors, ONE kernel launch for CUDA tensors (raises if
    it cannot build or launch). Inputs as ``me_mc_batch_plain``, on CUDA
    with the dtypes and layout of ``me_mc``; same error contract."""
    if cur.device.type == "cpu":
        return me_mc_batch_plain(cands, cur, ry_pad, ru_pad, rv_pad)
    if cur.device.type != "cuda":
        raise ValueError(f"unsupported device {cur.device}")
    n = _check_batch(cands, cur, ry_pad, ru_pad, rv_pad)
    return _launch(n, cands, cur, ry_pad, ru_pad, rv_pad)


def me_mc(cands, cur, ry_pad, ru_pad, rv_pad):
    """ME + MC over a candidate list: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (raises if it cannot build or launch).

    On CUDA: cands (N, 2) int32, cur (h, w) int32 luma in 0..255, the padded
    planes uint8, all contiguous on one device. Same outputs as
    ``me_mc_plain``.

    Errors: ValueError for a bad device, dtype, shape or layout, or for
    N > MAX_CANDS, before any launch; RuntimeError if the kernel cannot build
    or launch. The candidate list stays on the card (reading it would cost a
    sync), so a candidate with |dx| or |dy| > MV_PAD is caught by the
    kernel, not here: it traps, the next synchronising call (or launch)
    raises a CUDA error (``tests/test_torch_gpu.py`` holds this), and the
    process's CUDA context is unusable from then on. The CPU path raises
    ValueError for the same input. ``encoder_core._refine_cands`` never
    makes such a candidate."""
    if cur.device.type == "cpu":
        return me_mc_plain(cands, cur, ry_pad, ru_pad, rv_pad)
    if cur.device.type != "cuda":
        raise ValueError(f"unsupported device {cur.device}")
    _check(cands, cur, ry_pad, ru_pad, rv_pad)
    return _launch(1, cands, cur, ry_pad, ru_pad, rv_pad)
