"""Asyncio pipeline primitives: sources, the video pipeline loop, sinks.

The port's copy of ``selkies_tpu/pipeline/elements.py``, on the port's
tracer, telemetry bus, fault injector (the ``capture`` and ``encoder``
sites are checked here, once per tick) and device health plane.

Re-imagines the reference's GStreamer element graph (ximagesrc ! convert !
encode ! pay ! webrtcbin, gstwebrtc_app.py:200-1000) as a small asyncio
loop: a ticker pulls frames from a FrameSource, the encoder runs in a
worker thread (device dispatch is async anyway), and access units flow to
a sink callback. Queues are depth-1 latest-wins — a slow consumer drops
frames instead of adding latency (the reference gets this from leaky
queues + zero jitterbuffer, gstwebrtc_app.py:169,1082).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Awaitable, Callable, Protocol

import numpy as np

from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.monitoring.tracing import tracer
from selkies_tpu_torch.resilience.faultinject import get_injector

logger = logging.getLogger("pipeline")


class FrameSource(Protocol):
    width: int
    height: int

    def capture(self) -> np.ndarray:
        """Return the current frame as (H, W, 4) BGRx uint8."""
        ...


class SyntheticSource:
    """Animated desktop-like test source (the stack's videotestsrc).

    Publishes ``last_damage`` after every capture — the rects that cover
    everything that changed since the previous grab (cursor old+new
    positions, the scrolling noise region), mirroring what the X11
    source reports from XDamage, including its one-drop immunity: the
    published list is the UNION of the previous and current captures'
    rects, so a consumer whose reference is one frame older than the
    latest grab (a dropped/failed tick) still holds a superset. The
    pipeline forwards them to the encoder's damage-bounded classifier; a
    superset is always valid, so the first capture reports the whole
    frame."""

    def __init__(self, width: int = 1280, height: int = 720, seed: int = 0):
        self.width = width
        self.height = height
        rng = np.random.default_rng(seed)
        self._base = np.full((height, width, 4), 230, np.uint8)
        self._base[: height // 10] = (70, 60, 60, 0)
        self._base[height // 3 : 2 * height // 3, width // 8 : width // 2] = (250, 250, 250, 0)
        self._noise = rng.integers(0, 255, (height // 3, width // 3, 4), dtype=np.uint8)
        self._tick = 0
        self._prev_cursor: tuple[int, int] | None = None
        self._prev_rects: list[tuple[int, int, int, int]] | None = None
        self.last_damage: list[tuple[int, int, int, int]] | None = None

    def capture(self) -> np.ndarray:
        f = self._base.copy()
        # moving cursor block + scrolling noise region (screen-content-ish)
        x = (self._tick * 7) % (self.width - 40)
        y = (self._tick * 3) % (self.height - 40)
        f[y : y + 16, x : x + 16] = (0, 0, 0, 0)
        h3, w3 = self._noise.shape[:2]
        f[-h3:, -w3:] = np.roll(self._noise, self._tick, axis=1)
        if self._prev_cursor is None:
            rects = None  # first grab: no reference
        else:
            px, py = self._prev_cursor
            rects = [
                (px, py, 16, 16), (x, y, 16, 16),
                (self.width - w3, self.height - h3, w3, h3),
            ]
        self.last_damage = (None if rects is None or self._prev_rects is None
                            else self._prev_rects + rects)
        self._prev_rects = rects
        self._prev_cursor = (x, y)
        self._tick += 1
        return f


def scroll_trace(width: int, height: int, n: int, *, band0: int = 2,
                 bands: int = 8, seed: int = 0) -> list[np.ndarray]:
    """Terminal-scroll workload: a full-width texture region scrolls up
    by exactly 16 rows per frame while one new random line enters at the
    bottom — the tile-cache's headline case (every scrolled tile's bytes
    already crossed the link last frame). Tile-aligned by construction:
    16-row steps keep band boundaries stable, so a CopyRect-style cache
    can remap instead of re-uploading. Shared by tests/test_tile_cache.py
    and tools/profile_link_bytes.py."""
    if 16 * (band0 + bands) > height:
        raise ValueError(
            f"scroll region bands {band0}..{band0 + bands} exceeds height {height}")
    rng = np.random.default_rng(seed)
    base = np.full((height, width, 4), 230, np.uint8)
    base[: height // 10] = (70, 60, 60, 0)
    # texture strip taller than the visible window so fresh content keeps
    # entering; every 16-row line is unique (no accidental dedup)
    strip = rng.integers(0, 255, (16 * (bands + n), width, 4), np.uint8)
    frames = []
    r0 = band0 * 16
    for i in range(n):
        f = base.copy()
        f[r0 : r0 + bands * 16] = strip[16 * i : 16 * (i + bands)]
        frames.append(f)
    return frames


def window_move_x(i: int, width: int, tile_w: int) -> int:
    """Frame i's window x-position in window_move_trace (one tile per
    frame right, then back left). Single definition so the bench's
    damage-rect hints (bench._scenario_damage) derive the changed
    region from the SAME formula the trace draws with — a drifted copy
    would silently break the hint's superset contract."""
    ww = 3 * tile_w
    max_x = (width - ww) // tile_w
    step = i % (2 * max_x)
    return (step if step < max_x else 2 * max_x - step) * tile_w


def window_move_trace(width: int, height: int, n: int, *, tile_w: int | None = None,
                      seed: int = 0) -> list[np.ndarray]:
    """Window-drag workload: a tile-periodic 'window' slides horizontally
    by one tile per frame (right, then back left). Newly covered tiles
    repeat window content the device already holds; re-exposed tiles
    repeat wallpaper content — both remap-able by a content-addressed
    tile cache. Shared by tests and tools/profile_link_bytes.py."""
    rng = np.random.default_rng(seed)
    if tile_w is None:
        # align to the encoder's tile geometry so the tile-granular
        # machinery (delta upload, tile cache) engages
        from selkies_tpu_torch.models.frameprep import tile_width_for

        tile_w = tile_width_for(width)
    # tile-periodic wallpaper: every (16 x tile_w) tile is identical, so
    # re-exposed background matches pool content regardless of position
    wp_tile = rng.integers(40, 200, (16, tile_w, 4), np.uint8)
    reps_y = (height + 15) // 16
    reps_x = (width + tile_w - 1) // tile_w
    base = np.tile(wp_tile, (reps_y, reps_x, 1))[:height, :width]
    win_tile = rng.integers(0, 255, (16, tile_w, 4), np.uint8)
    wh, ww = 6 * 16, 3 * tile_w  # window: 6 bands x 3 tiles
    win = np.tile(win_tile, (6, 3, 1))
    y0 = 32
    max_x = (width - ww) // tile_w
    if max_x < 1 or y0 + wh > height:
        raise ValueError(
            f"{width}x{height} too small for a {ww}x{wh} window moving by {tile_w}")
    frames = []
    for i in range(n):
        x = window_move_x(i, width, tile_w)
        f = base.copy()
        f[y0 : y0 + wh, x : x + ww] = win
        frames.append(f)
    return frames


class DownscaleSource:
    """2x subsampling wrapper around a FrameSource — the recovery ladder's
    resolution step-down (resilience/supervisor.py rung 4 level 2): the
    pipeline sees half-size frames, its geometry-change machinery rebuilds
    the encoder at the reduced size, and unwrapping restores full
    resolution the same way. Output stays macroblock-aligned (16) so the
    H.264 rows take it without padding."""

    def __init__(self, inner: FrameSource):
        self.inner = inner

    @property
    def width(self) -> int:
        return max(16, (self.inner.width // 2) // 16 * 16)

    @property
    def height(self) -> int:
        return max(16, (self.inner.height // 2) // 16 * 16)

    def capture(self) -> np.ndarray:
        frame = self.inner.capture()
        h, w = self.height, self.width
        return np.ascontiguousarray(frame[: 2 * h : 2, : 2 * w : 2])


@dataclass
class EncodedFrame:
    au: bytes
    timestamp_90k: int
    wall_time: float
    idr: bool
    qp: int
    device_ms: float
    pack_ms: float
    scene_cut: bool = False
    # completion sub-stage split (pack_ms = unpack_ms + cavlc_ms; 0 for
    # encoder rows that don't attribute it)
    unpack_ms: float = 0.0
    cavlc_ms: float = 0.0
    # device-stage split (device_ms ≈ upload_ms + step_ms + fetch_ms) and
    # band-parallel slice count (parallel/bands.py; 1 = single slice);
    # cols > 1 = each band-row additionally tile-split across a 2D
    # (band, col) chip mesh (SELKIES_TILE_GRID)
    upload_ms: float = 0.0
    step_ms: float = 0.0
    fetch_ms: float = 0.0
    # front-end sub-split of upload_ms (models/stats.FrameStats): fused
    # dirty scan + hash/split, BGRx->I420 of the upload payload, h2d
    # transfer enqueues
    classify_ms: float = 0.0
    convert_ms: float = 0.0
    h2d_ms: float = 0.0
    bands: int = 1
    cols: int = 1
    # P downlink payload mode ("coeff"/"bits"/"dense"; "" = no downlink
    # or unattributed) — see models/stats.FrameStats.downlink_mode
    downlink_mode: str = ""
    # scenario-policy signals (models/stats.FrameStats): the encoder's
    # upload class and dirty/remap tile fractions; metadata only
    upload_kind: str = ""
    dirty_frac: float = 0.0
    remap_frac: float = 0.0
    skipped_mbs: int = 0
    # telemetry correlation id assigned at capture (0 = telemetry off);
    # metadata only — never touches the encoded bytes
    frame_id: int = 0


VideoSink = Callable[[EncodedFrame], Awaitable[None]]


class VideoPipeline:
    """Ticker → capture → encode → rate control → sink."""

    def __init__(
        self,
        source: FrameSource,
        encoder,
        rate_controller,
        sink: VideoSink,
        fps: float = 60.0,
    ):
        self.source = source
        self.encoder = encoder
        self.rc = rate_controller
        self.sink = sink
        self.fps = fps
        # called with (width, height) when source geometry changes; returns
        # a fresh encoder for the new size (wired by TorchWebRTCApp)
        self.on_geometry_change: Callable[[int, int], object] | None = None
        # optional SlotSupervisor (resilience/supervisor.py), wired by
        # TorchWebRTCApp: with one attached the loop NEVER gives up — tick
        # failures climb the recovery ladder instead
        self.supervisor = None
        self._task: asyncio.Task | None = None
        self._sender: asyncio.Task | None = None
        self._watchdog: asyncio.Task | None = None
        # True while a capture/encode (or a policy tick, which may drain
        # the encoder) is awaited on a worker thread; the app's
        # encoder-swap path reads it to defer closing an encoder that
        # may still be executing (pipeline/app.py). Unlike JAX's loop,
        # which holds it True to the end of the tick, it drops once the
        # encoder call has returned: a swap from the tick's own ladder
        # bookkeeping then closes the old encoder at once, where JAX's
        # closer waits for an idle instant between ticks, which a loop
        # running behind its clock never has (up to the closer's 30 s).
        self._tick_in_flight = False
        # ordered handoff to the sender task: every ENCODED frame must be
        # sent (dropping a P frame mid-chain would desync the decoder's
        # reference chain); a slow sink instead backpressures pre-encode —
        # capture ticks are skipped while the outbox is full, matching the
        # reference's leaky queue upstream of the encoder.
        self._outbox: deque[EncodedFrame] = deque()
        self._frame_ready = asyncio.Event()
        self.outbox_depth = 4
        self.frames = 0
        self.dropped_ticks = 0
        self.dropped_frames = 0
        # IDRs DELIVERED to the sink (not merely encoded): the solo
        # drain path (orchestrator._drain_flush) waits on this so the
        # client holds a decodable recovery point before teardown
        self.idr_sent = 0
        # telemetry session label + submit-path frame-id ledger: the
        # pipelined encoder returns EARLIER frames, keyed by the 90 kHz
        # timestamp we dispatched them with
        self.session = "0"
        self._fid_by_ts: dict[int, int] = {}
        # optional serving-SLO plane (monitoring/slo.py), wired by
        # TorchWebRTCApp when SELKIES_SLO=1: per-frame capture→AU-ready
        # latency feeds the burn-rate windows and the outlier trigger.
        # _t_by_ts is the submit-time ledger (same shape as _fid_by_ts)
        # so a pipelined completion is charged its OWN dispatch time
        self.slo = None
        self._t_by_ts: dict[int, float] = {}
        # optional scenario-policy runtime (selkies_tpu_torch/policy), wired by
        # TorchWebRTCApp when SELKIES_POLICY=1: observes every encoded
        # frame and retunes the encoder's runtime-safe knobs. Its tick
        # NEVER raises (a wedged engine disarms back to static knobs).
        self.policy = None
        # optional decode-and-compare quality probe (monitoring/quality.py),
        # wired by TorchWebRTCApp when SELKIES_QUALITY=1: samples 1-in-N
        # captures, decodes the GOP through the codec's oracle off-thread
        # and scores PSNR/SSIM/VMAF against the pre-encode source. None
        # (the default) keeps the hot path untouched by construction.
        self.quality = None
        self._last_tick_t = 0.0
        # frames a policy drain completed on the to_thread worker; the
        # loop delivers them right after the tick await (asyncio.Event
        # is not thread-safe, so the worker never touches the outbox)
        self._policy_drained: list[EncodedFrame] = []
        # damage hints are only forwarded while the encoder's previous-
        # frame state is exactly one capture behind the source's rects;
        # any failed/dropped tick AFTER a capture breaks that pairing
        # and forces one full-scan submit to resync (superset contract)
        self._damage_stale = True
        # device health plane (resilience/devhealth.py): called with a
        # chip key when a tick failure crossed the quarantine threshold
        # — the app rebuilds the encoder immediately on the surviving
        # carve instead of waiting for the ladder's RESTART rung
        self.on_device_fault: Callable[[str], None] | None = None

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    def set_framerate(self, fps: float) -> None:
        fps = float(fps)
        if not fps > 0:
            raise ValueError(f"framerate must be positive, got {fps}")
        self.rc.set_framerate(fps)
        self.fps = fps

    async def start(self) -> None:
        if self.running:
            return
        self._task = asyncio.create_task(self._run(), name="video-pipeline")
        self._sender = asyncio.create_task(self._send_loop(), name="video-sender")
        if self.supervisor is not None:
            self._watchdog = asyncio.create_task(
                self._watchdog_loop(), name="video-watchdog")

    async def _watchdog_loop(self) -> None:
        """Tick-deadline watchdog: a capture/encode call that neither
        returns nor raises keeps _run silent — escalate through the same
        ladder so the stall is at least acted on (IDR, encoder restart)."""
        while True:
            await asyncio.sleep(1.0)
            self.supervisor.check_deadline()
            try:
                # probation probes / readmits for quarantined chips — a
                # readmitted chip re-enters the pool's healthy view and
                # the next encoder rebuild carves over it again. No-op
                # (and no CUDA init) while no pool exists. Probes can
                # block (device round-trips to sick hardware, injected
                # delay faults), so they run off the event loop.
                from selkies_tpu_torch.resilience.devhealth import peek_device_pool

                pool = peek_device_pool()
                if pool is not None:
                    await asyncio.to_thread(pool.tick)
            except Exception:
                logger.exception("device health tick failed")

    def _note_device_failure(self, exc: BaseException) -> None:
        """Classify a failed tick as a device error (a DeviceFault in
        the chain names the chip; CUDA-shaped errors probe the
        encoder's carve) and feed the health plane. Crossing the
        threshold quarantines the chip and fires ``on_device_fault`` so
        the app rebuilds on the surviving carve at once. Never raises.
        The serving loop runs the (possibly probing, hence blocking)
        classification half via to_thread instead of this sync whole."""
        self._fire_device_fault(self._classify_device_failure(exc))

    def _classify_device_failure(self, exc: BaseException) -> str | None:
        try:
            from selkies_tpu_torch.resilience.devhealth import note_tick_failure

            return note_tick_failure(
                exc, getattr(self.encoder, "devices", None))
        except Exception:
            logger.exception("device-failure classification failed")
            return None

    def _fire_device_fault(self, key: str | None) -> None:
        if key is not None and self.on_device_fault is not None:
            try:
                self.on_device_fault(key)
            except Exception:
                logger.exception("on_device_fault(%s) failed", key)

    async def stop(self) -> None:
        for attr in ("_task", "_sender", "_watchdog"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)

    MAX_CONSECUTIVE_FAILURES = 30

    async def _run(self) -> None:
        t0 = time.monotonic()
        next_tick = t0
        failures = 0
        while True:
            self._tick_in_flight = False
            now = time.monotonic()
            if now < next_tick:
                await asyncio.sleep(next_tick - now)
            next_tick = max(next_tick + 1.0 / self.fps, time.monotonic() - 0.5 / self.fps)

            if len(self._outbox) >= self.outbox_depth:
                # sink can't keep up: skip this capture tick (pre-encode
                # drop keeps the encoded P-chain gapless). This is
                # TRANSPORT backpressure, not an encoder stall — refresh
                # the supervisor's deadline clock or a wedged client
                # would trigger pointless encoder restarts/degradation
                if self.supervisor is not None:
                    self.supervisor.note_idle()
                self.dropped_frames += 1
                tracer.instant("frame-drop")
                continue
            # frame correlation id: assigned at capture, carried through
            # classify/encode/send and echoed by the client's ack
            fid = telemetry.next_frame_id() if telemetry.enabled else 0
            tick_start = time.monotonic()
            try:
                fi = get_injector()
                if fi is not None:
                    act = fi.check("capture")
                    if act is not None and act[0] == "delay":
                        # scheduled latency fault: stall the tick (the
                        # SLO plane must see it as frame latency)
                        await asyncio.sleep(act[1] / 1e3)
                self._tick_in_flight = True
                with tracer.span("capture"), \
                        telemetry.span("capture", fid, session=self.session):
                    frame = await asyncio.to_thread(self.source.capture)
                if frame.shape[:2] != (self.encoder.height, self.encoder.width):
                    # xrandr resize landed (capture.py re-arms its SHM at the
                    # new geometry): rebuild the encoder for the new size —
                    # the reference restarts the whole pipeline on resize.
                    if self.on_geometry_change is None:
                        logger.warning(
                            "frame %dx%d != encoder %dx%d and no resize handler; dropping",
                            frame.shape[1], frame.shape[0], self.encoder.width, self.encoder.height,
                        )
                        self._damage_stale = True  # captured but not encoded
                        continue
                    old = self.encoder
                    self.encoder = self.on_geometry_change(frame.shape[1], frame.shape[0])
                    if old is not self.encoder and hasattr(old, "close"):
                        # drain + stop the old encoder's worker pool; its
                        # in-flight frames are stale-geometry, discard them
                        await asyncio.to_thread(old.close)
                    if frame.shape[:2] != (self.encoder.height, self.encoder.width):
                        # rebuild failed (handler kept the last-good
                        # encoder): DROP the mismatched frame instead of
                        # feeding it to the wrong-geometry encoder — that
                        # would turn one failed resize into a per-tick
                        # encode exception and climb the recovery ladder
                        self.dropped_frames += 1
                        self._damage_stale = True  # captured but not encoded
                        continue
                qp = self.rc.frame_qp()
                ts = int((time.monotonic() - t0) * 90000)
                if self.quality is not None:
                    # sampled frames retain a pre-encode I420 luma copy,
                    # keyed by the same 90 kHz ts the AU will carry back
                    self.quality.note_frame(ts, frame)
                if fi is not None:
                    act = fi.check("encoder")
                    if act is not None and act[0] == "delay":
                        await asyncio.sleep(act[1] / 1e3)
                if hasattr(self.encoder, "submit"):
                    # pipelined path: dispatch this frame, emit whichever
                    # earlier frames completed (device latency hidden)
                    if fid:
                        self._fid_by_ts[ts] = fid
                        if len(self._fid_by_ts) > 1024:  # failed-tick leaks
                            self._fid_by_ts.clear()
                    if self.slo is not None:
                        self._t_by_ts[ts] = tick_start
                        if len(self._t_by_ts) > 1024:
                            self._t_by_ts.clear()
                    # telemetry.span also sets the frame ContextVar, which
                    # asyncio.to_thread copies — the encoder's tile-cache
                    # events correlate without API changes
                    with tracer.span("submit"), \
                            telemetry.span("submit", fid, session=self.session):
                        if getattr(self.encoder, "accepts_damage", False):
                            # capture-layer damage hints (XDamage /
                            # synthetic dirty boxes) bound the encoder's
                            # classify scan — supersets of the changed
                            # pixels, never byte-bearing. After a failed
                            # or dropped tick the hints are STALE: the
                            # encoder's previous-frame state is >=2
                            # captures behind while the source's rects
                            # only cover the latest deltas, so a hinted
                            # scan could miss real changes (superset
                            # contract broken). One full scan resyncs.
                            damage = (None if self._damage_stale
                                      else getattr(self.source,
                                                   "last_damage", None))
                            done = await asyncio.to_thread(
                                self.encoder.submit, frame, qp, ts,
                                damage=damage)
                            self._damage_stale = False
                        else:
                            done = await asyncio.to_thread(
                                self.encoder.submit, frame, qp, ts)
                    efs = [
                        self._ef_from_stats(au, stats, meta,
                                            self._fid_by_ts.pop(meta, 0))
                        for au, stats, meta in done
                    ]
                    waits = [getattr(stats, "group_wait_ms", 0.0)
                             for _, stats, _ in done]
                else:
                    with tracer.span("encode"), \
                            telemetry.span("encode", fid, session=self.session):
                        au = await asyncio.to_thread(self.encoder.encode_frame, frame, qp)
                    efs = [self._ef_from_stats(au, self.encoder.last_stats,
                                               ts, fid)]
                    waits = [getattr(self.encoder.last_stats, "group_wait_ms", 0.0)]
                self._tick_in_flight = False
                for ef in efs:
                    self.rc.update(len(ef.au), idr=ef.idr or ef.scene_cut)
                self.frames += len(efs)
                if self.quality is not None:
                    for ef in efs:
                        self.quality.note_au(ef.timestamp_90k, ef.au,
                                             ef.idr or ef.scene_cut)
                if telemetry.enabled:
                    for ef, wait in zip(efs, waits):
                        telemetry.frame_done(
                            ef.frame_id, len(ef.au), idr=ef.idr,
                            session=self.session, device_ms=ef.device_ms,
                            pack_ms=ef.pack_ms, unpack_ms=ef.unpack_ms,
                            cavlc_ms=ef.cavlc_ms,
                            classify_ms=ef.classify_ms,
                            convert_ms=ef.convert_ms, h2d_ms=ef.h2d_ms,
                            group_wait_ms=wait,
                            downlink_mode=ef.downlink_mode,
                            bits_fetch_ms=(ef.fetch_ms
                                           if ef.downlink_mode
                                           in ("bits", "cabac")
                                           else 0.0),
                            qp=ef.qp,
                            rc_fullness=getattr(self.rc, "fullness", None),
                            entropy_coder=getattr(self.encoder,
                                                  "entropy_coder", ""))
                failures = 0
                if self.supervisor is not None:
                    self.supervisor.tick_ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self._tick_in_flight = False
                failures += 1
                # the capture (and its damage drain) may have happened
                # before the failure: the next hinted scan would miss
                # the lost frame's rects — resync with one full scan
                self._damage_stale = True
                logger.exception("video pipeline frame error (%d consecutive)", failures)
                # classification may probe (blocking device round-trips)
                # — off the loop; the rebuild hook fires back on it
                self._fire_device_fault(await asyncio.to_thread(
                    self._classify_device_failure, exc))
                if self.supervisor is not None:
                    # supervised: the ladder handles escalation (force IDR,
                    # encoder restart, degradation, recycle) and the loop
                    # NEVER gives up — a dead loop freezes the client
                    self.supervisor.failure(exc)
                elif failures >= self.MAX_CONSECUTIVE_FAILURES:
                    logger.error("video pipeline giving up after %d failures", failures)
                    return
                continue
            self._outbox.extend(efs)
            if efs:
                self._frame_ready.set()
            slo_frames = list(efs) if self.slo is not None else None
            if self.policy is not None and not self.policy.engine.dead:
                # after the outbox extend so a policy-triggered drain
                # (drain_inflight) queues NEWER frames behind this
                # tick's, keeping the sender strictly in frame order.
                # PolicyRuntime.tick never raises (and once the engine
                # disarms, this block stops paying the per-frame thread
                # hop). Off the event loop: an actuation drain blocks
                # on in-flight device work (like every other encoder
                # touch in this loop).
                now = time.monotonic()
                interval_ms = ((now - self._last_tick_t) * 1e3
                               if self._last_tick_t else 0.0)
                self._last_tick_t = now
                self._tick_in_flight = True
                with tracer.span("policy"):
                    await asyncio.to_thread(self.policy.tick, efs,
                                            interval_ms)
                if self._policy_drained:
                    if slo_frames is not None:
                        slo_frames.extend(self._policy_drained)
                    self._outbox.extend(self._policy_drained)
                    self._policy_drained.clear()
                    self._frame_ready.set()
            if slo_frames is not None:
                # SLO intake: per-frame capture→AU-ready latency from the
                # dispatch ledger (pipelined completions are EARLIER
                # frames — charging them this tick's span would be
                # flattering). evaluate() is internally gated to ~1/s;
                # breach hooks / outlier dumps never raise into the loop,
                # and neither may the intake itself.
                try:
                    now_m = time.monotonic()
                    for ef in slo_frames:
                        t_sub = self._t_by_ts.pop(ef.timestamp_90k,
                                                  tick_start)
                        self.slo.observe_frame((now_m - t_sub) * 1e3,
                                               len(ef.au),
                                               fid=ef.frame_id)
                    self.slo.evaluate()
                except Exception:
                    logger.exception("SLO intake failed")

    def _ef_from_stats(self, au: bytes, stats, ts: int,
                       fid: int) -> EncodedFrame:
        """One encoder completion -> EncodedFrame (shared by the
        pipelined submit path, the synchronous encode path, and the
        policy drain)."""
        return EncodedFrame(
            au=au,
            timestamp_90k=ts,
            wall_time=time.time(),
            idr=stats.idr,
            qp=stats.qp,
            device_ms=stats.device_ms,
            pack_ms=stats.pack_ms,
            scene_cut=getattr(stats, "scene_cut", False),
            unpack_ms=getattr(stats, "unpack_ms", 0.0),
            cavlc_ms=getattr(stats, "cavlc_ms", 0.0),
            upload_ms=getattr(stats, "upload_ms", 0.0),
            step_ms=getattr(stats, "step_ms", 0.0),
            fetch_ms=getattr(stats, "fetch_ms", 0.0),
            classify_ms=getattr(stats, "classify_ms", 0.0),
            convert_ms=getattr(stats, "convert_ms", 0.0),
            h2d_ms=getattr(stats, "h2d_ms", 0.0),
            bands=getattr(stats, "bands", 1),
            cols=getattr(stats, "cols", 1),
            downlink_mode=getattr(stats, "downlink_mode", ""),
            upload_kind=getattr(stats, "upload_kind", ""),
            dirty_frac=getattr(stats, "dirty_frac", 0.0),
            remap_frac=getattr(stats, "remap_frac", 0.0),
            skipped_mbs=getattr(stats, "skipped_mbs", 0),
            frame_id=fid,
        )

    def drain_inflight(self) -> None:
        """Complete every in-flight encoder frame — the policy
        actuator's barrier before a knob retune that rebuilds
        executables (EncoderActuator drain). Drained frames go through
        the same rate-control / telemetry accounting as the tick path
        and are staged in _policy_drained; the loop appends them to the
        outbox right after the policy tick returns (BEHIND anything
        already queued, so the P-chain reaches the client gapless and
        in order). Runs on the policy tick's worker thread — it must
        not touch the asyncio Event."""
        enc = self.encoder
        if not hasattr(enc, "flush"):
            return
        for au, stats, meta in enc.flush():
            ef = self._ef_from_stats(au, stats, meta,
                                     self._fid_by_ts.pop(meta, 0))
            self.rc.update(len(ef.au), idr=ef.idr or ef.scene_cut)
            self.frames += 1
            if self.quality is not None:
                self.quality.note_au(ef.timestamp_90k, ef.au,
                                     ef.idr or ef.scene_cut)
            if telemetry.enabled:
                telemetry.frame_done(
                    ef.frame_id, len(ef.au), idr=ef.idr,
                    session=self.session, device_ms=ef.device_ms,
                    pack_ms=ef.pack_ms, unpack_ms=ef.unpack_ms,
                    cavlc_ms=ef.cavlc_ms, classify_ms=ef.classify_ms,
                    convert_ms=ef.convert_ms, h2d_ms=ef.h2d_ms,
                    group_wait_ms=getattr(stats, "group_wait_ms", 0.0),
                    downlink_mode=ef.downlink_mode,
                    bits_fetch_ms=(ef.fetch_ms
                                   if ef.downlink_mode
                                   in ("bits", "cabac") else 0.0),
                    qp=ef.qp,
                    rc_fullness=getattr(self.rc, "fullness", None),
                    entropy_coder=getattr(self.encoder,
                                          "entropy_coder", ""))
            self._policy_drained.append(ef)

    async def _send_loop(self) -> None:
        while True:
            await self._frame_ready.wait()
            self._frame_ready.clear()
            while self._outbox:
                ef = self._outbox.popleft()
                try:
                    with tracer.span("send"), \
                            telemetry.span("send", ef.frame_id,
                                           session=self.session,
                                           bytes=len(ef.au)):
                        await self.sink(ef)
                    if ef.idr:
                        self.idr_sent += 1
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception("video sink error")
