"""Multi-session serving: N session streams from one batched device tick.

Counterpart of ``selkies_tpu/parallel/serving.py``'s
``MultiSessionH264Service``: ``TorchMultiSessionEncoder`` (the sessions
on a batch axis, one group per listed device) plus what a serving path
needs per session:
GOP state (frame_num, idr_pic_id, force_keyframe), per-session QP, the
coefficient fetch and concurrent host CAVLC packing, one pool worker per
session. Every session's access units are byte-identical to JAX's service
and to a solo ``TorchH264Encoder`` fed the same frames and QPs
(tests/test_torch_serving.py).

The tick splits into ``dispatch_tick`` (the frames copied into a pinned
BGRx staging batch on the pool, one upload per group, the device step with
its BGRx->I420 conversion and the downlink copy enqueued behind it, each
per group on its device) and ``complete_tick`` (the wait on those copies'
events, the packs, the GOP advance). The conversion runs where the planes
are used: on a card one kernel launch per group (``ops/colorspace.py``),
so the host copies 4 bytes a pixel once and converts nothing; on the CPU
the plain version, whose planes equal the host converter's.
``dispatch_tick`` makes no synchronising CUDA call, so it returns with
the card still stepping. The fetch is the dense coefficients, as JAX's,
narrowed to int16 on the device: the packers take int16, so the bytes are
the same and half cross the link.

As JAX's, each tick first consults the ``device:<chip>`` fault site over
``self.devices`` (``resilience/devhealth.py``: the cards of the session
groups, where JAX checks one chip per session), and opens the
tracer's ``convert`` / ``device-step`` / ``fetch`` / ``pack`` spans beside
``last_timing``, and the port's ``h2d`` span around the upload, the
``step-i`` / ``step-p`` spans of the batched branches inside
``device-step`` and, with tracing on, a ``gpu-step`` device span per group
and ``last_timing["device_tail_ms"]`` (``monitoring/tracing.py``).
JAX's persistent compilation cache has no counterpart: the port compiles
nothing per geometry.

``TorchBandedFleetService`` is the counterpart of JAX's
``BandedFleetService``: N sessions, each a ``TorchBandedH264Encoder`` on
its own row of devices, behind the same interface. A row of ``bands x
cols`` devices runs its session as a mesh, a tile per device, as
JAX's does; on one card every carve of more than one chip is JAX's
shared carve: single-device rows over the healthy cards, each session
still band-sliced at the requested count (the band bytes do not depend
on where a band is placed, tests/test_torch_bands.py). ``recarve``
rebuilds a session on a new row through ``parallel/lifecycle.py``'s
checkpoint / restore, and an empty row parks it. An AV1 / VP9 session
builds the tile-column row (``parallel/codec_mesh.py``) over its row,
and degrades to h264 as JAX's does when that build fails.

``SoftwareFleetService`` is JAX's degraded-mode fleet service: N registry
encoders (``x264enc`` by default; without libx264 the registry serves
solo ``TorchH264Encoder`` rows on the card) on a thread pool.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace

import numpy as np
import torch

from selkies_tpu_torch.device import Fetch
from selkies_tpu_torch.models.h264.bitstream import StreamParams, write_pps, write_sps
from selkies_tpu_torch.models.h264.native import pack_slice_fast, pack_slice_p_fast
from selkies_tpu_torch.models.h264.numpy_ref import FrameCoeffs, PFrameCoeffs
from selkies_tpu_torch.monitoring import jitprof
from selkies_tpu_torch.monitoring.tracing import tracer
from selkies_tpu_torch.parallel.bands import (
    TorchBandedH264Encoder,
    bands_from_env,
    grid_from_env,
    partition_devices,
)
from selkies_tpu_torch.parallel.lifecycle import checkpoint_session, restore_session
from selkies_tpu_torch.parallel.sessions import I_ONLY, P_ONLY, TorchMultiSessionEncoder
from selkies_tpu_torch.resilience.devhealth import check_device_faults, get_device_pool

logger = logging.getLogger("selkies_tpu_torch.parallel.serving")

__all__ = ["SoftwareFleetService", "TorchBandedFleetService", "TorchMultiSessionH264Service"]


class _SessionState:
    __slots__ = ("frames_since_idr", "idr_pic_id", "force_idr", "qp")

    def __init__(self, qp: int):
        self.frames_since_idr = 0
        self.idr_pic_id = 0
        self.force_idr = True
        self.qp = qp


@dataclass
class _PendingTick:
    """One dispatched tick: its IDR flags, per session group the downlink
    copy and the layout of the fetched buffer (field, shape, offset), and
    host times."""

    idrs: np.ndarray
    fetches: list
    layouts: list
    t_disp: float
    convert_ms: float
    h2d_ms: float
    dispatch_ms: float


class TorchMultiSessionH264Service:
    """N synchronized session streams; one batched encode per tick.

    Ticks run in lockstep (one frame per session per tick) but GOP policy
    is per session: the mixed tick picks IDR or P from each session's own
    force_keyframe / GOP state. Only the very first tick (no reference
    planes yet) is the batch-wide IDR step. ``device=None`` takes the first
    healthy card of the health plane (raising without a card);
    ``device="cpu"`` runs on the CPU. ``devices`` (JAX's keyword) splits
    the sessions into one group per listed device
    (``TorchMultiSessionEncoder``): each group's planes are uploaded to its
    device, stepped there and fetched from there. ``self.devices`` lists
    the groups' devices, which the ``device:<chip>`` fault site checks each
    tick. ``last_timing`` holds the last completed tick's host-clock split
    in ms; on a tick with an IDR, ``idr_pack_ms`` is its longest IDR pack
    (timed in ``_pack_one``)."""

    def __init__(self, n_sessions: int, width: int, height: int, *,
                 qp: int = 28, fps: int = 60, device=None, devices=None):
        self.enc = TorchMultiSessionEncoder(n_sessions, width, height, device=device,
                                            devices=devices, host_convert=False)
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
        # the persistent BGRx batch the workers copy each tick's frames
        # into: pinned on a card, so a group's upload is one non-blocking copy
        pin = self.device.type == "cuda"
        self._stage_t = torch.empty((n_sessions, height, width, 4), dtype=torch.uint8,
                                    pin_memory=pin)
        self._stage = self._stage_t.numpy()
        # per group, the last upload of its rows of the staging batch
        self._uploaded: list = [None] * len(self.enc.groups)
        self._inflight = 0
        self.last_timing: dict = {}
        # the tick's IDR packs' times, appended by the pool's workers
        self._idr_pack_ms: list[float] = []
        # the devices of the device:<chip> fault site
        self.devices = list(self.enc.devices)

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

    def dispatch_tick(self, frames: np.ndarray) -> _PendingTick:
        """Front half of :meth:`encode_tick`: the frames' copy into the
        staging batch (the ``convert`` span and ``convert_ms``), the upload,
        the device step with its conversion and the downlink copy, all
        enqueued; the card is still stepping when this returns."""
        # the whole shape, since the copy into the staging batch broadcasts
        want = (self.n, self.enc.height, self.enc.width, 4)
        if tuple(frames.shape) != want:
            raise ValueError(f"expected {self.n} frames, got {frames.shape[0]}: "
                             f"batch {tuple(frames.shape)} != {want}")
        check_device_faults(self.devices)
        idrs = np.array([s.force_idr or s.frames_since_idr == 0 for s in self.sessions], bool)
        t0 = time.perf_counter()
        # the previous tick's uploads must have read the staging batch
        for ev in self._uploaded:
            if ev is not None and not ev.query():
                ev.synchronize()
        with tracer.span("convert"):
            # one copy per session, each on its own worker (numpy's copy
            # releases the GIL)
            list(self._pool.map(lambda i: np.copyto(self._stage[i], frames[i]), range(self.n)))
        t1 = time.perf_counter()
        with tracer.span("h2d"):
            inputs = self.enc.put_groups(self._stage_t)
        for k, g in enumerate(self.enc.groups):
            if g.device.type == "cuda":
                self._uploaded[k] = torch.cuda.Event()
                self._uploaded[k].record(torch.cuda.current_stream(g.device))
        qps = np.array([s.qp for s in self.sessions], np.int32)
        t2 = time.perf_counter()
        with tracer.span("device-step"):
            first = any(g.ref is None for g in self.enc.groups)
            if first:
                # first tick: no reference planes exist, everyone starts a GOP
                idrs[:] = True
            outs = self.enc.step_groups(inputs, qps, idrs, fill=not first)
        # the fetch skips the branch-filler fields no session needs
        skip = (set(I_ONLY) if not idrs.any() else set()) | (set(P_ONLY) if idrs.all() else set())
        flats, layouts = [], []
        for out in outs:
            keys = [k for k in out if k not in skip]
            layout, off = [], 0
            for k in keys:
                layout.append((k, tuple(out[k].shape), off))
                off += out[k].numel()
            flats.append(torch.cat([out[k].reshape(-1).to(torch.int32)
                                    for k in keys]).to(torch.int16))
            layouts.append(layout)
        t_disp = time.perf_counter()
        fetches = [Fetch(flat, mark) for flat, mark in zip(flats, self.enc.last_marks)]
        self._inflight += 1
        return _PendingTick(idrs, fetches, layouts, t_disp, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                            (t_disp - t2) * 1e3)

    def complete_tick(self, pending: _PendingTick) -> list[bytes]:
        """Back half of :meth:`encode_tick`: the coefficient fetch (where
        the device wait lives), the per-session packs on the pool and the
        GOP state advance."""
        self._inflight -= 1
        # JAX's "fetch" span covers its blocking fetch, the device wait
        # included: here the wait on each group's step-done event and copy
        hosts, step_ms, fetch_ms, down = [], 0.0, 0.0, 0
        with tracer.span("fetch"):
            for fetch, layout in zip(pending.fetches, pending.layouts):
                arr, g_step, g_fetch = fetch.wait(pending.t_disp, step_span=False)
                hosts.append({k: arr[off:off + int(np.prod(shape))].reshape(shape)
                              for k, shape, off in layout})
                step_ms, fetch_ms = max(step_ms, g_step), fetch_ms + g_fetch
                down += arr.nbytes
        idrs = pending.idrs
        self._idr_pack_ms = []
        t0 = time.perf_counter()
        with tracer.span("pack"):
            futures = [self._pool.submit(self._pack_one, g.lo + j, hosts[k], j,
                                         bool(idrs[g.lo + j]))
                       for k, g in enumerate(self.enc.groups) for j in range(g.hi - g.lo)]
            aus = [f.result() for f in futures]
        self.last_timing = {
            "convert_ms": pending.convert_ms, "h2d_ms": pending.h2d_ms,
            "dispatch_ms": pending.dispatch_ms, "step_ms": step_ms, "fetch_ms": fetch_ms,
            "pack_ms": (time.perf_counter() - t0) * 1e3, "down_bytes": int(down)}
        if self._idr_pack_ms:
            self.last_timing["idr_pack_ms"] = max(self._idr_pack_ms)
        tails = [f.tail_ms for f in pending.fetches]
        if tails and None not in tails:
            # tracing on, on a card: how far behind the host's record of
            # step-done the card ran it (the latest group)
            self.last_timing["device_tail_ms"] = max(tails)
        self.last_idrs = [bool(x) for x in idrs]
        for s, idr in zip(self.sessions, idrs):
            if idr:
                s.frames_since_idr = 1
                s.idr_pic_id = (s.idr_pic_id + 1) % 2
                s.force_idr = False
            else:
                s.frames_since_idr += 1
        return aus

    def _pack_one(self, i: int, host: dict, j: int, idr: bool) -> bytes:
        """Session ``i``'s AU from row ``j`` of its group's fetched fields."""
        s = self.sessions[i]
        if idr:
            t0 = time.perf_counter()
            fc = FrameCoeffs(
                luma_mode=host["luma_mode"][j], chroma_mode=host["chroma_mode"][j],
                luma_dc=host["luma_dc"][j], luma_ac=host["luma_ac"][j],
                chroma_dc=host["chroma_dc"][j], chroma_ac=host["chroma_ac"][j],
                qp=int(s.qp),
            )
            nal = pack_slice_fast(fc, self.params, frame_num=0, idr=True,
                                  idr_pic_id=s.idr_pic_id)
            self._idr_pack_ms.append((time.perf_counter() - t0) * 1e3)
            return self._headers + nal
        pfc = PFrameCoeffs(
            mvs=host["mvs"][j], skip=host["skip"][j] != 0, luma_ac=host["luma_ac"][j],
            chroma_dc=host["chroma_dc"][j], chroma_ac=host["chroma_ac"][j],
            qp=int(s.qp),
        )
        return pack_slice_p_fast(pfc, self.params, frame_num=s.frames_since_idr % 256)

    def load_jax_state(self, state: dict) -> None:
        """Continue a stream set that JAX's ``MultiSessionH264Service``
        started (between ticks). ``state`` holds numpy arrays and plain
        values: ``ref`` (``np.asarray(svc.enc._ref[i])``, the batched recon
        planes), ``sessions`` (per session a dict of ``frames_since_idr``,
        ``idr_pic_id``, ``force_idr`` and ``qp``) and ``pic_init_qp``
        (``svc.params.qp``: slice QPs are coded relative to it). Each
        session group's planes go to its device."""
        if self._inflight:
            raise RuntimeError("load_jax_state with a tick in flight; complete it first")
        h, w = self.enc.height, self.enc.width
        want = ((self.n, h, w), (self.n, h // 2, w // 2), (self.n, h // 2, w // 2))
        ref = tuple(np.array(a, dtype=np.uint8) for a in state["ref"])
        if tuple(a.shape for a in ref) != want:
            raise ValueError(f"reference planes {[a.shape for a in ref]} != {list(want)}")
        if len(state["sessions"]) != self.n:
            raise ValueError(f"{len(state['sessions'])} session states for {self.n} sessions")
        self.enc._ref = tuple(torch.from_numpy(a) for a in ref)
        for s, st in zip(self.sessions, state["sessions"]):
            s.frames_since_idr = int(st["frames_since_idr"])
            s.idr_pic_id = int(st["idr_pic_id"])
            s.force_idr = bool(st["force_idr"])
            s.qp = int(st["qp"])
        self.params = replace(self.params, qp=int(state["pic_init_qp"]))
        self._headers = write_sps(self.params) + write_pps(self.params)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class TorchBandedFleetService:
    """Band-sliced fleet service: N sessions, each a
    ``TorchBandedH264Encoder`` on its own row of devices, behind the
    ``TorchMultiSessionH264Service`` interface (``encode_tick`` /
    ``set_qp`` / ``force_keyframe`` / ``last_idrs`` / ``last_modes`` /
    ``close``).

    The keywords are JAX's. ``rows`` is a placer-managed carve (one device
    list per session, an empty list parks the session); without it the
    service carves ``devices`` (None: the health plane's healthy cards,
    raising without a card) with ``partition_devices``, and when that
    carve does not fit it takes JAX's shared carve: one device per
    session, round-robin, each session band-sliced at the requested count
    (the same bytes). A session's encoder takes its row as ``devices``
    with ``bands=_row_bands(row)``: a mesh when the row holds a device per
    band (tile). Sessions are independent (per-session
    GOP, QP, multi-slice AUs): ``encode_tick`` runs them concurrently on
    the service pool, and ``parallel/occupancy.py`` schedules each as its
    own unit through the encoders' ``dispatch_frame`` / ``complete_frame``.
    """

    def __init__(self, n_sessions: int, width: int, height: int, *,
                 qp: int = 28, fps: int = 60, bands: int | None = None,
                 cols: int | None = None, devices=None, rows: list[list] | None = None,
                 codecs: list[str] | None = None, shared: bool | None = None):
        self.n = n_sessions
        # per-session negotiated codec: the placer's record seeds it on a
        # service rebuild, so a restart keeps every session's codec
        self.codecs = [c.lower() if c else "h264" for c in (codecs or ["h264"] * n_sessions)]
        # sessions whose codec changed and whose re-carve has not landed:
        # the recompile sentinel's attribution (set_codec -> recarve)
        self._codec_pending: set[int] = set()
        if bands is None and cols is None:
            grid = grid_from_env()
            if grid is not None:
                bands, cols = grid  # SELKIES_TILE_GRID=RxC owns the carve
            else:
                bands = bands_from_env()
        bands = 1 if bands is None else max(1, int(bands))
        self.cols = 1 if cols is None else max(1, int(cols))
        # the shared small-slice carve: one-device rows that still
        # band-slice at the requested count, told apart from a row that a
        # quarantine shrank, which re-slices into fewer bands (_row_bands)
        self.shared_carve = bool(shared) if shared is not None else False
        if rows is None:
            try:
                rows = partition_devices(n_sessions, bands * self.cols, devices)
            except ValueError:
                devs = list(devices if devices is not None
                            else get_device_pool().healthy_devices())
                rows = [[devs[k % len(devs)]] for k in range(n_sessions)]
                self.shared_carve = True
        self._width, self._height = width, height
        self._qp, self._fps, self._bands_req = qp, fps, bands
        # an empty row parks the session (its chips are lent out and it
        # has no client) until recarve() hands it a row again
        self.encoders = [self._build_encoder(k, rows[k]) if rows[k] else None
                         for k in range(n_sessions)]
        live = next((e for e in self.encoders if e is not None), None)
        self.bands = live.bands if live is not None else bands
        self.last_idrs: list[bool] = [True] * n_sessions
        # per-session P downlink mode of the last tick ("" = IDR, static
        # or parked)
        self.last_modes: list[str] = [""] * n_sessions
        self._pool = ThreadPoolExecutor(max_workers=n_sessions, thread_name_prefix="band-fleet")

    def set_qp(self, session: int, qp: int) -> None:
        enc = self.encoders[session]
        if enc is not None:
            enc.set_qp(qp)

    def set_bitrate(self, session: int, kbps: int) -> None:
        """Per-session rate retarget for the library-CBR rows (vp9; the
        lossless AV1 splice accepts and ignores it). The H.264 rows stay
        QP-driven through set_qp."""
        enc = self.encoders[session]
        if enc is not None and hasattr(enc, "set_bitrate"):
            enc.set_bitrate(int(kbps))

    def force_keyframe(self, session: int) -> None:
        enc = self.encoders[session]
        if enc is not None:
            enc.force_keyframe()

    def set_codec(self, session: int, codec: str) -> bool:
        """Record a session's negotiated codec; True when it changed (the
        caller then re-carves, which rebuilds the session's encoder)."""
        codec = (codec or "h264").lower()
        if codec == self.codecs[session]:
            return False
        self._codec_pending.add(session)
        self.codecs[session] = codec
        return True

    def _build_encoder(self, session: int, devices: list):
        """One session's encoder on its device row, by negotiated codec:
        av1 / vp9 build their tile-column row with the row's length as the
        column budget. A codec the fleet has no session row for, or a
        failed build, degrades to h264 (and the record with it), so the
        session always streams."""
        codec = self.codecs[session]
        if codec not in ("av1", "vp9", "h264"):
            logger.warning("fleet has no %s session row; session %d degrades to h264",
                           codec, session)
            self.codecs[session] = "h264"
            codec = "h264"
        try:
            if codec in ("av1", "vp9"):
                from selkies_tpu_torch.parallel.codec_mesh import (
                    TileColumnAV1Encoder,
                    TileColumnVP9Encoder,
                    budget_cols,
                )

                cls = TileColumnAV1Encoder if codec == "av1" else TileColumnVP9Encoder
                return cls(self._width, self._height, fps=self._fps,
                           cols=budget_cols(len(devices)), devices=devices)
        except Exception:
            logger.exception("session %d %s encoder build failed; degrading to h264",
                             session, codec)
            self.codecs[session] = "h264"
        return TorchBandedH264Encoder(
            self._width, self._height, qp=self._qp, fps=self._fps,
            bands=self._row_bands(devices), cols=self.cols, devices=devices)

    def _row_bands(self, row) -> int:
        """Band count for a device row. Borrowed chips enlarge it: a row
        wider than the constructor's carve re-slices the frame into one
        band per chip (whole band-rows of ``cols`` chips in a grid carve;
        the encoder still clamps to what the MB rows divide into). A row
        narrower than the carve outside the shared carve means a
        quarantine shrank it: fewer bands, down to 1. The shared carve's
        one-device rows always slice at the requested count."""
        n = len(row) // self.cols
        if self.shared_carve or n >= self._bands_req:
            return max(self._bands_req, n)
        return max(1, n)

    def recarve(self, session: int, devices: list) -> None:
        """Rebuild one session's encoder on a new device row. The GOP
        phase and QP carry over by checkpoint / restore and the new
        encoder opens with a forced IDR, so from that IDR on its bytes
        equal an encoder that was never re-carved and was forced a
        keyframe at the same frame (while the band count is unchanged).
        No tick may be in flight. An empty row parks the session; a later
        row un-parks it. On a failure the old encoder keeps serving: the
        ``migrate`` fault fires in ``checkpoint_session`` before any state
        is read, and a failed restore closes the half-built encoder."""
        # the recompile sentinel: a pending set_codec makes this rebuild a
        # negotiation's, otherwise it is a re-carve's
        if session in self._codec_pending:
            self._codec_pending.discard(session)
            jitprof.mark("codec_switch", f"session-{session}:{self.codecs[session]}")
        else:
            jitprof.mark("recarve", f"session-{session}")
        old = self.encoders[session]
        if not devices:
            self.encoders[session] = None
            if old is not None:
                try:
                    old.close()
                except Exception:
                    logger.exception("closing parked encoder %d", session)
            return
        # checkpoint / restore carries the H.264 GOP across an h264 ->
        # h264 rebuild only; a codec switch opens fresh
        h264_to_h264 = (old is not None and self.codecs[session] == "h264"
                        and getattr(old, "codec", "h264") == "h264")
        ck = checkpoint_session(self, session) if h264_to_h264 else None
        # built with the service's QP, not the session's dynamic one: the
        # PPS's pic_init_qp and every slice_qp_delta derive from it. The
        # dynamic QP comes back through restore_session -> set_qp
        enc = self._build_encoder(session, devices)
        if ck is not None:
            try:
                restore_session(ck, enc)
            except Exception:
                try:
                    enc.close()
                except Exception:
                    logger.exception("closing failed replacement encoder %d", session)
                raise
        self.encoders[session] = enc
        if old is not None:
            try:
                old.close()
            except Exception:
                logger.exception("closing re-carved encoder %d", session)

    def encode_tick(self, frames: np.ndarray) -> list[bytes]:
        """(N, H, W, 4) BGRx batch -> one Annex-B AU per session (``b""``
        for a parked session), the sessions encoded concurrently."""
        if frames.shape[0] != self.n:
            raise ValueError(f"expected {self.n} frames, got {frames.shape[0]}")

        def _one(i: int) -> bytes:
            enc = self.encoders[i]
            if enc is None:  # parked
                return b""
            return enc.encode_frame(frames[i])

        # "encode", not "device-step": this covers the fetch and the host
        # pack too; each encoder's own spans split device from host
        with tracer.span("encode"):
            aus = list(self._pool.map(_one, range(self.n)))
        self.last_idrs = [bool(e.last_stats.idr) if e is not None else False
                          for e in self.encoders]
        self.last_modes = [getattr(e.last_stats, "downlink_mode", "") if e is not None else ""
                           for e in self.encoders]
        return aus

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        for enc in self.encoders:
            if enc is not None:
                enc.close()


class SoftwareFleetService:
    """Degraded-mode fleet service: N independent registry encoders behind
    the ``TorchMultiSessionH264Service`` interface (``encode_tick`` /
    ``set_qp`` / ``set_bitrate`` / ``force_keyframe`` / ``last_idrs`` /
    ``last_modes`` / ``close``).

    The resilience ladder's last load-shedding rung: sessions keep
    streaming off the CPU x264 row (``models/x264enc.py``), which the
    registry degrades to solo ``TorchH264Encoder`` rows on ``device`` when
    libx264 is absent. Each tick runs the sessions concurrently on one
    thread pool, as JAX's does."""

    def __init__(self, n_sessions: int, width: int, height: int, *,
                 qp: int = 28, fps: int = 60,
                 bitrate_kbps: int | list[int] = 2000,
                 encoder: str = "x264enc", device=None):
        from selkies_tpu_torch.models.registry import create_encoder

        self.n = n_sessions
        # per-session bitrates: each slot's target carries over into the
        # degraded mode (a scalar applies to every session)
        if isinstance(bitrate_kbps, int):
            bitrate_kbps = [bitrate_kbps] * n_sessions
        self.encoders = [
            create_encoder(encoder, width=width, height=height, fps=fps,
                           bitrate_kbps=int(bitrate_kbps[i]), qp=qp, device=device)
            for i in range(n_sessions)
        ]
        self._qps = [qp] * n_sessions
        self.last_idrs: list[bool] = [True] * n_sessions
        self.last_modes: list[str] = [""] * n_sessions
        self._pool = ThreadPoolExecutor(max_workers=n_sessions, thread_name_prefix="sw-fleet")

    def set_qp(self, session: int, qp: int) -> None:
        self._qps[session] = int(qp)
        enc = self.encoders[session]
        if hasattr(enc, "set_qp"):
            enc.set_qp(int(qp))

    def set_bitrate(self, session: int, kbps: int) -> None:
        """Live per-session rate retarget (x264's CBR owns the quantizer,
        so the client's rate drive lands here, not in set_qp)."""
        enc = self.encoders[session]
        if hasattr(enc, "set_bitrate"):
            enc.set_bitrate(int(kbps))

    def force_keyframe(self, session: int) -> None:
        self.encoders[session].force_keyframe()

    def encode_tick(self, frames: np.ndarray) -> list[bytes]:
        if frames.shape[0] != self.n:
            raise ValueError(f"expected {self.n} frames, got {frames.shape[0]}")

        def _one(i: int) -> bytes:
            return self.encoders[i].encode_frame(frames[i], self._qps[i])

        aus = list(self._pool.map(_one, range(self.n)))
        self.last_idrs = [bool(e.last_stats.idr) for e in self.encoders]
        self.last_modes = [getattr(e.last_stats, "downlink_mode", "") for e in self.encoders]
        return aus

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        for enc in self.encoders:
            if hasattr(enc, "close"):
                try:
                    enc.close()
                except Exception:
                    logger.exception("closing a software fleet encoder")
