"""Multi-session encode: N concurrent streams of one geometry in one device tick.

Counterpart of ``selkies_tpu/parallel/sessions.py`` (``MultiSessionEncoder``).
JAX ``vmap``s one encode step over a ``session`` mesh axis, one chip per
session. The port puts the sessions of one device on a leading batch axis
of the same device ops: a tick issues one session's worth of launches for
all of them, and the ME/MC kernel launches once per device and tick
(``encoder_core.encode_frame_planes_batch`` /
``encode_frame_p_planes_batch``, ``me_mc.me_mc_batch``). QP is an (N,)
vector, so each session's rate controller retunes without a new program.
Given ``devices``, the sessions split into contiguous groups, one batched
step per device; one device (the default) is one group. A tick issues
about the same device ops at any N, so one group per card is the unit:
spreading N sessions over k cards costs k times the launches of one.

The mixed tick picks IDR or P per session. JAX runs a per-chip
``lax.cond`` and fills the other branch's fields with zeros; here the host
knows ``idrs``, so within each group the batched IDR step runs over the
sessions that key, the batched P step over the others (each subset
picked by Python-int indexing and ``torch.stack``), and the same dict is
assembled: the same keys, shapes and dtypes, with zero fillers. Session
i's outputs equal the JAX encoder's element for element
(tests/test_torch_sessions.py, tests/test_torch_mesh.py).

Reference frames stay on their group's device and never escape in the
public return, as in JAX, where they are donated.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from selkies_tpu_torch.device import device_list, resolve_device
from selkies_tpu_torch.models.h264.encoder import to_device
from selkies_tpu_torch.models.h264.encoder_core import (
    encode_frame_p_planes_batch,
    encode_frame_planes_batch,
)
from selkies_tpu_torch.monitoring.tracing import tracer
from selkies_tpu_torch.ops.colorspace import bgrx_to_i420
from selkies_tpu_torch.resilience.devhealth import get_device_pool

__all__ = ["TorchMultiSessionEncoder", "dryrun"]

logger = logging.getLogger("selkies_tpu_torch.parallel.sessions")

# the fields only one branch of the mixed tick produces, with their
# per-session shape (in MBs) and dtype; the other branch's sessions get zeros
I_ONLY = {"luma_mode": ((), torch.int32), "chroma_mode": ((), torch.int32),
          "luma_dc": ((4, 4), torch.int32)}
P_ONLY = {"mvs": ((2,), torch.int32), "skip": ((), torch.bool)}


def _session_device() -> torch.device:
    """The card for ``device=None``, from the health plane
    (resilience/devhealth.py): the first healthy card. JAX's rule for a
    session mesh that the healthy chips cannot hold holds here too: with no
    healthy card the build falls back to the full enumeration (a
    quarantined card included) and never raises short."""
    pool = get_device_pool()
    healthy = pool.healthy_devices()
    if healthy:
        return healthy[0]
    logger.warning("the sessions need a card but none is healthy; using the full "
                   "enumeration (quarantined cards included)")
    return pool.all_devices()[0]


class _Group:
    """One device's share of the sessions: ``[lo, hi)`` and their batched
    reference planes, which stay on that device."""

    __slots__ = ("device", "lo", "hi", "ref")

    def __init__(self, device: torch.device, lo: int, hi: int):
        self.device, self.lo, self.hi = device, lo, hi
        self.ref: tuple | None = None


class TorchMultiSessionEncoder:
    """Batched encode of N independent sessions of one geometry.

    ``device=None`` takes the first healthy card of the health plane
    (``_session_device``) and raises without a card; pass
    ``device="cpu"`` for the CPU. ``devices``, a list of k devices (a list
    may repeat one), splits the sessions into k contiguous groups whose
    sizes differ by at most one (session i goes to group ``i*k//n``; at
    most n groups): each group is one batched step on its device, and its
    sessions' reference planes stay there. ``host_convert=True`` (the
    serving layer's mode) takes (y, u, v) I420 plane batches; ``False``
    takes a (N, H, W, 4) BGRx batch and converts on the device. Inputs may
    be numpy arrays (uploaded pinned, ``non_blocking``) or tensors (a CPU
    tensor is copied over ``non_blocking``; pin it to keep the copy
    asynchronous).

    ``encode_idr`` / ``encode_p`` / ``encode_mixed`` return the outputs in
    session order, gathered onto the first group's device when there are
    several groups; ``put_groups`` and ``step_groups`` are the same step
    without the gather (the serving layer fetches each group from its own
    device)."""

    def __init__(self, n_sessions: int, width: int, height: int, device=None,
                 host_convert: bool = True, devices=None):
        if width % 16 or height % 16:
            raise ValueError("multi-session geometry must be MB-aligned")
        if device is not None and devices is not None:
            raise ValueError("pass device or devices, not both")
        self.n = n_sessions
        self.width = width
        self.height = height
        self.host_convert = bool(host_convert)
        if devices is not None:
            devs = device_list(devices)
            if not devs:
                raise ValueError("need a device for the sessions, have none")
        else:
            devs = [resolve_device(device) if device is not None else _session_device()]
        k = min(len(devs), n_sessions)
        # group g holds the sessions i with i*k//n == g
        lo = [-(-g * n_sessions // k) for g in range(k + 1)]
        self.groups = [_Group(devs[g], lo[g], lo[g + 1]) for g in range(k)]
        self.device = devs[0]
        # each group's device, in group order
        self.devices = [g.device for g in self.groups]
        # per group, the first-op event of its last step (tracing on, a
        # card; else None): the serving layer's downlink hands it to the
        # tracer's device track
        self.last_marks: list = [None] * len(self.groups)

    @property
    def _ref(self) -> tuple | None:
        """The reference planes (recon_y, recon_u, recon_v) batched in
        session order, None before the first IDR. With several groups a
        copy gathered onto the first group's device (each group's planes
        stay on its own)."""
        refs = [g.ref for g in self.groups]
        if any(r is None for r in refs):
            return None
        if len(refs) == 1:
            return refs[0]
        return tuple(torch.cat([r[i].to(self.device) for r in refs]) for i in range(3))

    @_ref.setter
    def _ref(self, ref) -> None:
        """Session-ordered reference planes (or None): each group's rows go
        to its device."""
        for g in self.groups:
            g.ref = None if ref is None else tuple(r[g.lo:g.hi].to(g.device) for r in ref)

    @staticmethod
    def _upload(a, device: torch.device) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a if a.device == device else a.to(device, non_blocking=True)
        return to_device(np.asarray(a), device)

    def _check_batch(self, t, shape: tuple, what: str):
        if tuple(t.shape) != (self.n, *shape):
            raise ValueError(f"{what} batch {tuple(t.shape)} != {(self.n, *shape)}")
        return t

    def put_frames(self, frames) -> torch.Tensor:
        """(N, H, W, 4) uint8 BGRx batch -> device tensor (one group)."""
        frames = self._check_batch(frames, (self.height, self.width, 4), "frame")
        return self._upload(frames, self.device)

    def put_groups(self, frames_or_planes) -> list[tuple]:
        """A tick's input, checked, sliced per group and uploaded to each
        group's device: per group the (y, u, v) planes in host_convert mode,
        else the one BGRx batch."""
        if self.host_convert:
            h, w = self.height, self.width
            arrs = tuple(self._check_batch(p, s, "plane") for p, s in zip(
                frames_or_planes, ((h, w), (h // 2, w // 2), (h // 2, w // 2))))
        else:
            arrs = (self._check_batch(frames_or_planes, (self.height, self.width, 4), "frame"),)
        return [tuple(self._upload(a[g.lo:g.hi], g.device) for a in arrs) for g in self.groups]

    def _planes(self, inputs: tuple) -> tuple:
        """Device I420 plane batches of one group's uploaded input."""
        return inputs if self.host_convert else bgrx_to_i420(inputs[0])

    def _qps(self, qps, g: _Group) -> torch.Tensor:
        if isinstance(qps, torch.Tensor):
            q = self._check_batch(qps, (), "qp")[g.lo:g.hi].to(g.device, torch.int32)
        else:
            q = np.asarray(qps, np.int32)
            q = to_device(self._check_batch(q, (), "qp")[g.lo:g.hi], g.device)
        return q

    def _fillers(self, fields: dict, k: int, device: torch.device) -> dict:
        mbh, mbw = self.height // 16, self.width // 16
        return {name: torch.zeros((k, mbh, mbw, *shape), dtype=dtype, device=device)
                for name, (shape, dtype) in fields.items()}

    def _group_step(self, g: _Group, inputs: tuple, qps, idrs: np.ndarray, fill: bool) -> dict:
        """One group's step: the batched IDR step over its sessions that key,
        the batched P step over the others; with ``fill`` (the mixed tick)
        each branch's fields get zero fillers for the other's sessions."""
        y, u, v = self._planes(inputs)
        q = self._qps(qps, g)
        i_idx = [i for i in range(g.hi - g.lo) if idrs[g.lo + i]]
        p_idx = [i for i in range(g.hi - g.lo) if not idrs[g.lo + i]]
        if not i_idx or not p_idx:
            if not i_idx:
                with tracer.span("step-p"):
                    out = encode_frame_p_planes_batch(y, u, v, *g.ref, q)
            else:
                with tracer.span("step-i"):
                    out = encode_frame_planes_batch(y, u, v, q)
            if fill:
                out.update(self._fillers(P_ONLY if not p_idx else I_ONLY, len(q), g.device))
        else:
            def pick(t, idx):
                return torch.stack([t[i] for i in idx])

            # the picks, fillers and the stack stay outside the branch spans
            args_i = [pick(t, i_idx) for t in (y, u, v, q)]
            with tracer.span("step-i"):
                out_i = encode_frame_planes_batch(*args_i)
            args_p = [pick(t, p_idx) for t in (y, u, v, *g.ref, q)]
            with tracer.span("step-p"):
                out_p = encode_frame_p_planes_batch(*args_p)
            out_i.update(self._fillers(P_ONLY, len(i_idx), g.device))
            out_p.update(self._fillers(I_ONLY, len(p_idx), g.device))
            # session i's row: its branch's output at its place in that branch
            src = [(out_i, i_idx.index(i)) if idrs[g.lo + i] else (out_p, p_idx.index(i))
                   for i in range(g.hi - g.lo)]
            out = {k: torch.stack([o[k][j] for o, j in src]) for k in out_i}
        # recon planes are the next P step's references: internal state
        # that does not escape in the public return
        g.ref = (out.pop("recon_y"), out.pop("recon_u"), out.pop("recon_v"))
        return out

    def step_groups(self, inputs: list, qps, idrs, *, fill: bool = True) -> list[dict]:
        """Each group's step on its device, from ``put_groups``' inputs:
        ``idrs`` (N,) bool picks IDR or P per session (a P session needs
        its group's reference). -> the groups' output dicts, in group
        order, each on its group's device."""
        idrs = np.asarray(idrs, bool)
        if idrs.shape != (self.n,):
            raise ValueError(f"idrs {idrs.shape} != ({self.n},)")
        if not idrs.all() and any(g.ref is None for g in self.groups):
            raise RuntimeError("encode_idr must run first (no reference frames)")
        outs = []
        for k, (g, x) in enumerate(zip(self.groups, inputs)):
            self.last_marks[k] = tracer.gpu_mark(g.device)
            outs.append(self._group_step(g, x, qps, idrs, fill))
        return outs

    def _gather(self, outs: list[dict]) -> dict:
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}

    def encode_idr(self, frames, qps) -> dict:
        return self._gather(self.step_groups(self.put_groups(frames), qps,
                                             np.ones(self.n, bool), fill=False))

    def encode_p(self, frames, qps) -> dict:
        return self._gather(self.step_groups(self.put_groups(frames), qps,
                                             np.zeros(self.n, bool), fill=False))

    def encode_mixed(self, frames, qps, idrs) -> dict:
        """Per-session I/P in one device tick: ``idrs`` (N,) bool picks the
        branch per session. Requires an established reference (the first
        tick goes through encode_idr). ``frames`` is (y, u, v) plane
        batches in host_convert mode, a BGRx batch otherwise."""
        if any(g.ref is None for g in self.groups):
            raise RuntimeError("encode_idr must run first (no reference frames)")
        return self._gather(self.step_groups(self.put_groups(frames), qps, idrs))


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
