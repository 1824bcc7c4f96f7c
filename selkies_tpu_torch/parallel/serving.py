"""Multi-session serving: N session streams from one batched device tick.

Counterpart of ``selkies_tpu/parallel/serving.py``'s
``MultiSessionH264Service``: ``TorchMultiSessionEncoder`` (one card, the
sessions on a batch axis) plus what a serving path needs per session:
GOP state (frame_num, idr_pic_id, force_keyframe), per-session QP, the
coefficient fetch and concurrent host CAVLC packing, one pool worker per
session. Every session's access units are byte-identical to JAX's service
and to a solo ``TorchH264Encoder`` fed the same frames and QPs
(tests/test_torch_serving.py).

The tick splits into ``dispatch_tick`` (host conversion on the pool, one
pinned upload, the device step and the downlink copy enqueued behind it)
and ``complete_tick`` (the wait on that copy's events, the packs, the GOP
advance). ``dispatch_tick`` makes no synchronising CUDA call, so it
returns with the card still stepping. The fetch is the dense coefficients,
as JAX's, narrowed to int16 on the device: the packers take int16, so the
bytes are the same and half cross the link.

Not ported here (queued with the device-health plane): the per-tick
``check_device_faults``, the tracer spans, and the persistent compilation
cache (the port compiles nothing per geometry).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace

import numpy as np
import torch

from selkies_tpu_torch.models.frameprep import FramePrep
from selkies_tpu_torch.models.h264.bitstream import StreamParams, write_pps, write_sps
from selkies_tpu_torch.models.h264.encoder import _Fetch
from selkies_tpu_torch.models.h264.native import pack_slice_fast, pack_slice_p_fast
from selkies_tpu_torch.models.h264.numpy_ref import FrameCoeffs, PFrameCoeffs
from selkies_tpu_torch.parallel.sessions import I_ONLY, P_ONLY, TorchMultiSessionEncoder

__all__ = ["TorchMultiSessionH264Service"]


class _SessionState:
    __slots__ = ("frames_since_idr", "idr_pic_id", "force_idr", "qp")

    def __init__(self, qp: int):
        self.frames_since_idr = 0
        self.idr_pic_id = 0
        self.force_idr = True
        self.qp = qp


@dataclass
class _PendingTick:
    """One dispatched tick: its IDR flags, the downlink copy and the layout
    of the fetched buffer (field, per-tick shape, offset), host times."""

    idrs: np.ndarray
    fetch: _Fetch
    layout: list
    t_disp: float
    convert_ms: float
    h2d_ms: float
    dispatch_ms: float


class TorchMultiSessionH264Service:
    """N synchronized session streams; one batched encode per tick.

    Ticks run in lockstep (one frame per session per tick) but GOP policy
    is per session: the mixed tick picks IDR or P from each session's own
    force_keyframe / GOP state. Only the very first tick (no reference
    planes yet) is the batch-wide IDR step. ``device=None`` means ``cuda``;
    ``device="cpu"`` runs on the CPU. ``last_timing`` holds the last
    completed tick's host-clock split in ms."""

    def __init__(self, n_sessions: int, width: int, height: int, *,
                 qp: int = 28, fps: int = 60, device=None):
        self.enc = TorchMultiSessionEncoder(n_sessions, width, height, device=device)
        self.device = self.enc.device
        self.n = n_sessions
        # per-session IDR flags of the most recent tick; the batched step
        # has no per-frame downlink attribution, so last_modes stays ""
        self.last_idrs: list[bool] = [True] * n_sessions
        self.last_modes: list[str] = [""] * n_sessions
        self.params = StreamParams(width=width, height=height, qp=qp, fps=fps)
        self._headers = write_sps(self.params) + write_pps(self.params)
        self.sessions = [_SessionState(qp) for _ in range(n_sessions)]
        self._pool = ThreadPoolExecutor(max_workers=n_sessions, thread_name_prefix="ms-pack")
        # host BGRx->I420, one native converter per session, run on the pool
        self._preps = [FramePrep(width, height, width, height, nslots=2)
                       for _ in range(n_sessions)]
        # persistent batch planes the workers convert into: pinned on the
        # card, so the upload is one non-blocking copy per plane
        pin = self.device.type == "cuda"
        shapes = ((height, width), (height // 2, width // 2), (height // 2, width // 2))
        self._batch_t = tuple(torch.empty((n_sessions, *s), dtype=torch.uint8, pin_memory=pin)
                              for s in shapes)
        self._batch = tuple(t.numpy() for t in self._batch_t)
        self._uploaded: torch.cuda.Event | None = None  # the last upload of the planes
        self._inflight = 0
        self.last_timing: dict = {}

    def set_qp(self, session: int, qp: int) -> None:
        if not 0 <= qp <= 51:
            raise ValueError(f"qp {qp} out of range")
        self.sessions[session].qp = int(qp)

    def force_keyframe(self, session: int) -> None:
        self.sessions[session].force_idr = True

    def encode_tick(self, frames: np.ndarray) -> list[bytes]:
        """(N, H, W, 4) BGRx batch -> one Annex-B access unit per session:
        :meth:`dispatch_tick` then :meth:`complete_tick`."""
        return self.complete_tick(self.dispatch_tick(frames))

    def _convert_into(self, frames: np.ndarray, i: int) -> None:
        for dst, plane in zip(self._batch, self._preps[i].convert(frames[i])):
            np.copyto(dst[i], plane)

    def dispatch_tick(self, frames: np.ndarray) -> _PendingTick:
        """Front half of :meth:`encode_tick`: per-session host conversion,
        the upload, the device step and its downlink copy, all enqueued;
        the card is still stepping when this returns."""
        if frames.shape[0] != self.n:
            raise ValueError(f"expected {self.n} frames, got {frames.shape[0]}")
        idrs = np.array([s.force_idr or s.frames_since_idr == 0 for s in self.sessions], bool)
        t0 = time.perf_counter()
        # the previous tick's upload must have read the pinned planes
        if self._uploaded is not None and not self._uploaded.query():
            self._uploaded.synchronize()
        list(self._pool.map(lambda i: self._convert_into(frames, i), range(self.n)))
        t1 = time.perf_counter()
        planes = self.enc._put_inputs(self._batch_t)
        if self.device.type == "cuda":
            self._uploaded = torch.cuda.Event()
            self._uploaded.record()
        qps = np.array([s.qp for s in self.sessions], np.int32)
        t2 = time.perf_counter()
        if self.enc._ref is None:
            # first tick: no reference planes exist, everyone starts a GOP
            idrs[:] = True
            out = self.enc.encode_idr(planes, qps)
        else:
            out = self.enc.encode_mixed(planes, qps, idrs)
        # the fetch skips the branch-filler fields no session needs
        skip = (set(I_ONLY) if not idrs.any() else set()) | (set(P_ONLY) if idrs.all() else set())
        keys = [k for k in out if k not in skip]
        layout, off = [], 0
        for k in keys:
            layout.append((k, tuple(out[k].shape), off))
            off += out[k].numel()
        flat = torch.cat([out[k].reshape(-1).to(torch.int32) for k in keys]).to(torch.int16)
        t_disp = time.perf_counter()
        fetch = _Fetch(flat)
        self._inflight += 1
        return _PendingTick(idrs, fetch, layout, t_disp, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                            (t_disp - t2) * 1e3)

    def complete_tick(self, pending: _PendingTick) -> list[bytes]:
        """Back half of :meth:`encode_tick`: the coefficient fetch (where
        the device wait lives), the per-session packs on the pool and the
        GOP state advance."""
        self._inflight -= 1
        arr, step_ms, fetch_ms = pending.fetch.wait(pending.t_disp)
        host = {k: arr[off:off + int(np.prod(shape))].reshape(shape)
                for k, shape, off in pending.layout}
        idrs = pending.idrs
        t0 = time.perf_counter()
        futures = [self._pool.submit(self._pack_one, i, host, bool(idrs[i]))
                   for i in range(self.n)]
        aus = [f.result() for f in futures]
        self.last_timing = {
            "convert_ms": pending.convert_ms, "h2d_ms": pending.h2d_ms,
            "dispatch_ms": pending.dispatch_ms, "step_ms": step_ms, "fetch_ms": fetch_ms,
            "pack_ms": (time.perf_counter() - t0) * 1e3, "down_bytes": int(arr.nbytes)}
        self.last_idrs = [bool(x) for x in idrs]
        for s, idr in zip(self.sessions, idrs):
            if idr:
                s.frames_since_idr = 1
                s.idr_pic_id = (s.idr_pic_id + 1) % 2
                s.force_idr = False
            else:
                s.frames_since_idr += 1
        return aus

    def _pack_one(self, i: int, host: dict, idr: bool) -> bytes:
        s = self.sessions[i]
        if idr:
            fc = FrameCoeffs(
                luma_mode=host["luma_mode"][i], chroma_mode=host["chroma_mode"][i],
                luma_dc=host["luma_dc"][i], luma_ac=host["luma_ac"][i],
                chroma_dc=host["chroma_dc"][i], chroma_ac=host["chroma_ac"][i],
                qp=int(s.qp),
            )
            nal = pack_slice_fast(fc, self.params, frame_num=0, idr=True,
                                  idr_pic_id=s.idr_pic_id)
            return self._headers + nal
        pfc = PFrameCoeffs(
            mvs=host["mvs"][i], skip=host["skip"][i] != 0, luma_ac=host["luma_ac"][i],
            chroma_dc=host["chroma_dc"][i], chroma_ac=host["chroma_ac"][i],
            qp=int(s.qp),
        )
        return pack_slice_p_fast(pfc, self.params, frame_num=s.frames_since_idr % 256)

    def load_jax_state(self, state: dict) -> None:
        """Continue a stream set that JAX's ``MultiSessionH264Service``
        started (between ticks). ``state`` holds numpy arrays and plain
        values: ``ref`` (``np.asarray(svc.enc._ref[i])``, the batched recon
        planes), ``sessions`` (per session a dict of ``frames_since_idr``,
        ``idr_pic_id``, ``force_idr`` and ``qp``) and ``pic_init_qp``
        (``svc.params.qp``: slice QPs are coded relative to it)."""
        if self._inflight:
            raise RuntimeError("load_jax_state with a tick in flight; complete it first")
        h, w = self.enc.height, self.enc.width
        want = ((self.n, h, w), (self.n, h // 2, w // 2), (self.n, h // 2, w // 2))
        ref = tuple(np.array(a, dtype=np.uint8) for a in state["ref"])
        if tuple(a.shape for a in ref) != want:
            raise ValueError(f"reference planes {[a.shape for a in ref]} != {list(want)}")
        if len(state["sessions"]) != self.n:
            raise ValueError(f"{len(state['sessions'])} session states for {self.n} sessions")
        self.enc._ref = tuple(torch.from_numpy(a).to(self.device) for a in ref)
        for s, st in zip(self.sessions, state["sessions"]):
            s.frames_since_idr = int(st["frames_since_idr"])
            s.idr_pic_id = int(st["idr_pic_id"])
            s.force_idr = bool(st["force_idr"])
            s.qp = int(st["qp"])
        self.params = replace(self.params, qp=int(state["pic_init_qp"]))
        self._headers = write_sps(self.params) + write_pps(self.params)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
