"""Multi-session encode: N concurrent streams of one geometry in one device tick.

Counterpart of ``selkies_tpu/parallel/sessions.py`` (``MultiSessionEncoder``).
JAX ``vmap``s one encode step over a ``session`` mesh axis, one chip per
session. On one card the port puts every session on a leading batch axis
of the same device ops: a tick issues one session's worth of launches for
all N sessions, and the ME/MC kernel launches once per tick
(``encoder_core.encode_frame_planes_batch`` /
``encode_frame_p_planes_batch``, ``me_mc.me_mc_batch``). QP is an (N,)
vector, so each session's rate controller retunes without a new program.

The mixed tick picks IDR or P per session. JAX runs a per-chip
``lax.cond`` and fills the other branch's fields with zeros; here the host
knows ``idrs``, so the batched IDR step runs over the sessions that key,
the batched P step over the others (each subset picked by Python-int
indexing and ``torch.stack``), and the same dict is assembled: the same
keys, shapes and dtypes, with zero fillers. Session i's outputs equal the
JAX encoder's element for element (tests/test_torch_sessions.py).

Reference frames stay on the device and never escape in the public
return (``_keep_ref``), as in JAX, where they are donated.
"""

from __future__ import annotations

import numpy as np
import torch

from selkies_tpu_torch.device import resolve_device
from selkies_tpu_torch.models.h264.encoder import to_device
from selkies_tpu_torch.models.h264.encoder_core import (
    encode_frame_p_planes_batch,
    encode_frame_planes_batch,
)
from selkies_tpu_torch.ops.colorspace import bgrx_to_i420

__all__ = ["TorchMultiSessionEncoder", "dryrun"]

# the fields only one branch of the mixed tick produces, with their
# per-session shape (in MBs) and dtype; the other branch's sessions get zeros
I_ONLY = {"luma_mode": ((), torch.int32), "chroma_mode": ((), torch.int32),
          "luma_dc": ((4, 4), torch.int32)}
P_ONLY = {"mvs": ((2,), torch.int32), "skip": ((), torch.bool)}


class TorchMultiSessionEncoder:
    """Batched encode of N independent sessions of one geometry on one card.

    ``device=None`` means ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the CPU. ``host_convert=True`` (the serving
    layer's mode) takes (y, u, v) I420 plane batches; ``False`` takes a
    (N, H, W, 4) BGRx batch and converts on the device. Inputs may be
    numpy arrays (uploaded pinned, ``non_blocking``) or tensors (a CPU
    tensor is copied over ``non_blocking``; pin it to keep the copy
    asynchronous)."""

    def __init__(self, n_sessions: int, width: int, height: int, device=None,
                 host_convert: bool = True):
        if width % 16 or height % 16:
            raise ValueError("multi-session geometry must be MB-aligned")
        self.n = n_sessions
        self.width = width
        self.height = height
        self.host_convert = bool(host_convert)
        self.device = resolve_device(device)
        self._ref: tuple | None = None

    def _upload(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a if a.device == self.device else a.to(self.device, non_blocking=True)
        return to_device(np.asarray(a), self.device)

    def _check_batch(self, t: torch.Tensor, shape: tuple, what: str) -> torch.Tensor:
        if tuple(t.shape) != (self.n, *shape):
            raise ValueError(f"{what} batch {tuple(t.shape)} != {(self.n, *shape)}")
        return t

    def put_frames(self, frames) -> torch.Tensor:
        """(N, H, W, 4) uint8 BGRx batch -> device tensor."""
        return self._check_batch(self._upload(frames), (self.height, self.width, 4), "frame")

    def _put_inputs(self, frames_or_planes) -> tuple:
        """host_convert: (y, u, v) batched plane arrays; else a BGRx batch."""
        if self.host_convert:
            h, w = self.height, self.width
            return tuple(self._check_batch(self._upload(p), s, "plane") for p, s in zip(
                frames_or_planes, ((h, w), (h // 2, w // 2), (h // 2, w // 2))))
        return (self.put_frames(frames_or_planes),)

    def _planes(self, frames) -> tuple:
        """Device I420 plane batches of a tick's input."""
        inputs = self._put_inputs(frames)
        return inputs if self.host_convert else bgrx_to_i420(inputs[0])

    def _qps(self, qps) -> torch.Tensor:
        q = (qps.to(self.device, torch.int32) if isinstance(qps, torch.Tensor)
             else to_device(np.asarray(qps, np.int32), self.device))
        return self._check_batch(q, (), "qp")

    def _keep_ref(self, out: dict) -> dict:
        # recon planes are the next P step's references: internal state
        # that does not escape in the public return
        self._ref = (out.pop("recon_y"), out.pop("recon_u"), out.pop("recon_v"))
        return out

    def encode_idr(self, frames, qps) -> dict:
        return self._keep_ref(encode_frame_planes_batch(*self._planes(frames), self._qps(qps)))

    def encode_p(self, frames, qps) -> dict:
        if self._ref is None:
            raise RuntimeError("encode_idr must run first (no reference frames)")
        return self._keep_ref(
            encode_frame_p_planes_batch(*self._planes(frames), *self._ref, self._qps(qps)))

    def _fillers(self, fields: dict, k: int) -> dict:
        mbh, mbw = self.height // 16, self.width // 16
        return {name: torch.zeros((k, mbh, mbw, *shape), dtype=dtype, device=self.device)
                for name, (shape, dtype) in fields.items()}

    def encode_mixed(self, frames, qps, idrs) -> dict:
        """Per-session I/P in one device tick: ``idrs`` (N,) bool picks the
        branch per session. Requires an established reference (the first
        tick goes through encode_idr). ``frames`` is (y, u, v) plane
        batches in host_convert mode, a BGRx batch otherwise."""
        if self._ref is None:
            raise RuntimeError("encode_idr must run first (no reference frames)")
        idrs = np.asarray(idrs, bool)
        if idrs.shape != (self.n,):
            raise ValueError(f"idrs {idrs.shape} != ({self.n},)")
        y, u, v = self._planes(frames)
        q = self._qps(qps)
        i_idx = [i for i in range(self.n) if idrs[i]]
        p_idx = [i for i in range(self.n) if not idrs[i]]
        if not i_idx:
            out = encode_frame_p_planes_batch(y, u, v, *self._ref, q)
            return self._keep_ref({**out, **self._fillers(I_ONLY, self.n)})
        if not p_idx:
            out = encode_frame_planes_batch(y, u, v, q)
            return self._keep_ref({**out, **self._fillers(P_ONLY, self.n)})

        def pick(t, idx):
            return torch.stack([t[i] for i in idx])

        out_i = encode_frame_planes_batch(pick(y, i_idx), pick(u, i_idx), pick(v, i_idx),
                                          pick(q, i_idx))
        out_p = encode_frame_p_planes_batch(
            pick(y, p_idx), pick(u, p_idx), pick(v, p_idx),
            *(pick(r, p_idx) for r in self._ref), pick(q, p_idx))
        out_i.update(self._fillers(P_ONLY, len(i_idx)))
        out_p.update(self._fillers(I_ONLY, len(p_idx)))
        # session i's row: its branch's output at its place in that branch
        src = [(out_i, i_idx.index(i)) if idrs[i] else (out_p, p_idx.index(i))
               for i in range(self.n)]
        out = {k: torch.stack([o[k][j] for o, j in src]) for k in out_i}
        return self._keep_ref(out)


def _host_planes(frames: np.ndarray):
    """Batched host BGRx->I420 through the serving path's converter
    (FramePrep, the native path the service runs per session)."""
    from selkies_tpu_torch.models.frameprep import FramePrep

    n, h, w, _ = frames.shape
    prep = FramePrep(w, h, w, h, nslots=1)
    ys, us, vs = zip(*(tuple(np.array(p, copy=True) for p in prep.convert(f))
                       for f in frames))
    return np.stack(ys), np.stack(us), np.stack(vs)


def dryrun(n_sessions: int, device=None) -> None:
    """Run the whole multi-session step (the IDR tick, the P tick with ME
    and a mixed tick) at 64x64 in host-convert mode, and the
    device-convert IDR tick."""
    h = w = 64
    rng = np.random.default_rng(0)
    enc = TorchMultiSessionEncoder(n_sessions, w, h, device=device)
    frames = rng.integers(0, 256, (n_sessions, h, w, 4), dtype=np.uint8)
    qps = np.full(n_sessions, 28, np.int32)
    enc.encode_idr(_host_planes(frames), qps)
    frames2 = np.roll(frames, 3, axis=2)
    out_p = enc.encode_p(_host_planes(frames2), qps)
    assert out_p["mvs"].shape == (n_sessions, h // 16, w // 16, 2)
    assert enc._ref[0].shape == (n_sessions, h, w)
    # the serving tick is the mixed step: heterogeneous for any n >= 2
    idrs = np.zeros(n_sessions, bool)
    idrs[::2] = True
    out_m = enc.encode_mixed(_host_planes(np.roll(frames2, 2, axis=1)), qps, idrs)
    assert out_m["mvs"].shape == (n_sessions, h // 16, w // 16, 2)
    assert out_m["luma_mode"].shape == (n_sessions, h // 16, w // 16)
    enc2 = TorchMultiSessionEncoder(n_sessions, w, h, device=device, host_convert=False)
    out2 = enc2.encode_idr(frames, qps)
    assert out2["luma_ac"].shape == (n_sessions, h // 16, w // 16, 4, 4, 4, 4)
    if enc.device.type == "cuda":
        torch.cuda.synchronize(enc.device)
