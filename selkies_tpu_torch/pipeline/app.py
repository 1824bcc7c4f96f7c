"""TorchWebRTCApp — the port's app core: it builds and serves the pipeline.

The port's copy of ``selkies_tpu/pipeline/app.py`` (``TPUWebRTCApp``), on
the port's registry, rate controller, supervisor, policy engine, SLO and
quality planes, telemetry and recompile sentinel. The one difference is
``device``: ``None`` means ``cuda`` (raising without a card), and every
encoder the app builds — at construction, on a geometry change and on a
ladder swap (restart, software fallback and its reversal, recycle) — is
built on that device. The CPU serves only an explicit ``device="cpu"``.

API parity with the reference's GSTWebRTCApp (gstwebrtc_app.py:67): the
same lifecycle (start_pipeline/stop_pipeline), live retune entry points
(set_video_bitrate/set_framerate/set_audio_bitrate), SDP/ICE plumbing
(set_sdp/set_ice + on_sdp/on_ice callbacks), and the server→client data
channel vocabulary (send_* methods emitting {"type": t, "data": {...}}
JSON, gstwebrtc_app.py:1454-1579). The media plane differs by design:
frames flow through the encoder pipeline (pipeline/elements.py), and
the byte plane is a pluggable Transport, not webrtcbin.

set_video_bitrate(cc=True) is the GCC congestion-control entry point —
the rtpgccbwe estimated-bitrate signal lands here and drives the CBR
controller's target (reference wiring gstwebrtc_app.py:1638-1655).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import time
from typing import Any, Awaitable, Callable, Protocol

from selkies_tpu_torch.device import resolve_device
from selkies_tpu_torch.models.registry import create_encoder, encoder_exists
from selkies_tpu_torch.models.h264.ratecontrol import CbrRateController
from selkies_tpu_torch.monitoring import jitprof
from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.pipeline.elements import (
    DownscaleSource,
    EncodedFrame,
    FrameSource,
    SyntheticSource,
    VideoPipeline,
)
from selkies_tpu_torch.resilience import SlotSupervisor

logger = logging.getLogger("torchwebrtc_app")

DEFAULT_VIDEO_BITRATE_KBPS = 2000

SOFTWARE_FALLBACK_ENCODER = "x264enc"

REBUILD_RETRY_S = 2.0  # min seconds between retries of a failing rebuild


class _AppRecovery:
    """RecoveryActions for the solo session (resilience/supervisor.py).

    Degradation ladder: level 1 halves the tick rate, level 2 wraps the
    source in a 2x DownscaleSource (the pipeline's geometry-change path
    rebuilds the encoder at the reduced size on the next frame), level 3
    swaps to the software x264 row. Reversal walks the same steps back
    after sustained health."""

    def __init__(self, app: "TorchWebRTCApp"):
        self.app = app
        self._pre_degrade_fps: int | None = None

    def warn(self, msg: str) -> None:
        logger.warning("%s", msg)

    def force_idr(self) -> None:
        self.app.force_keyframe()

    def restart_encoder(self) -> None:
        self.app._restart_encoder()

    def degrade(self, level: int) -> None:
        app = self.app
        if level == 1:
            self._pre_degrade_fps = int(app.framerate)
            app.set_framerate(max(1, int(app.framerate) // 2))
            app.send_framerate(int(app.framerate))
        elif level == 2:
            if app.pipeline is not None and not isinstance(
                    app.pipeline.source, DownscaleSource):
                app.pipeline.source = DownscaleSource(app.source)
        elif level >= 3:
            app._enter_software_fallback()

    def undegrade(self, level: int) -> None:
        app = self.app
        if level < 3:
            app._exit_software_fallback()
        if level < 2 and app.pipeline is not None and isinstance(
                app.pipeline.source, DownscaleSource):
            app.pipeline.source = app.source
        if level < 1 and self._pre_degrade_fps:
            app.set_framerate(self._pre_degrade_fps)
            app.send_framerate(self._pre_degrade_fps)
            self._pre_degrade_fps = None

    def recycle(self) -> None:
        self.app._schedule_recycle()


class Transport(Protocol):
    """Byte-plane the app talks to (WebSocket or WebRTC implementations)."""

    @property
    def data_channel_ready(self) -> bool: ...

    def send_data_channel(self, message: str) -> None: ...

    async def send_video(self, frame: EncodedFrame) -> None: ...


class TorchWebRTCApp:
    REBUILD_RETRY_S = REBUILD_RETRY_S

    def __init__(
        self,
        source: FrameSource | None = None,
        transport: Transport | None = None,
        encoder: str = "tpuh264enc",
        width: int = 1280,
        height: int = 720,
        framerate: int = 60,
        video_bitrate_kbps: int = DEFAULT_VIDEO_BITRATE_KBPS,
        congestion_control: bool = False,
        device=None,
    ):
        if not encoder_exists(encoder):
            raise ValueError(f"unknown encoder {encoder!r} (see models.registry)")
        self.encoder_name = encoder
        if source is not None and (source.width, source.height) != (width, height) and (width, height) != (1280, 720):
            # width/height args only size the default synthetic source; an
            # explicit conflicting pair is a caller bug, not a silent crop.
            raise ValueError(
                f"source is {source.width}x{source.height} but width/height args say {width}x{height}"
            )
        self.source = source or SyntheticSource(width, height)
        # every encoder this app builds lands here (None -> cuda)
        self.device = resolve_device(device)
        self.transport = transport
        self.framerate = framerate
        self.congestion_control = congestion_control
        self.video_bitrate_kbps = video_bitrate_kbps
        # the configured bitrate reaches library-RC rows (x264/x265/
        # libvpx/libaom run their own CBR) at construction — without it
        # they'd start at their registry default until the first GCC
        # retune, streaming minutes at the wrong rate on lossless links
        self.encoder = create_encoder(encoder, width=self.source.width,
                                      height=self.source.height, fps=framerate,
                                      bitrate_kbps=int(video_bitrate_kbps),
                                      device=self.device)
        self.rc = CbrRateController(bitrate_kbps=video_bitrate_kbps, fps=framerate)
        self.pipeline: VideoPipeline | None = None
        # per-session supervisor: one instance for the app's lifetime so
        # restart backoff and degradation state survive pipeline recycles
        self.supervisor = SlotSupervisor(
            "session", _AppRecovery(self), fps=float(framerate))
        self.software_fallback = False
        self._rebuild_failed: tuple = (None, 0.0)  # (geometry, monotonic)
        self._recycle_task: asyncio.Task | None = None

        # callbacks wired by the orchestrator (__main__.py parity :684-871)
        self.on_sdp: Callable[[str, str], None] = lambda t, s: None
        self.on_ice: Callable[[int, str], None] = lambda m, c: None
        self.on_data_message: Callable[[str], Awaitable[None] | None] = lambda m: None
        self.on_data_open: Callable[[], None] = lambda: None
        self.on_frame: Callable[[EncodedFrame], None] = lambda f: None

        self.last_cursor_sent: Any = None

        # scenario-adaptive policy engine (selkies_tpu_torch/policy): one per
        # app lifetime so classification state survives pipeline
        # recycles; the runtime binding to the live pipeline/encoder is
        # rebuilt in start_pipeline. Off (None) unless SELKIES_POLICY=1.
        self.policy_engine = None
        from selkies_tpu_torch.policy import (
            PolicyEngine, policy_enabled, preset_from_env)

        if policy_enabled():
            from selkies_tpu_torch.policy import EncoderActuator

            self.policy_engine = PolicyEngine(
                session="0", preset=preset_from_env(),
                # skip-fraction fallback denominator for encoder rows
                # without upload attribution (banded SELKIES_BANDS rows)
                total_mbs=((self.source.height + 15) // 16)
                * ((self.source.width + 15) // 16))
            # sustained link congestion sheds BYTES (the ladder's resolution
            # rung) before anything touches the tick rate
            self.policy_engine.on_link_pressure = self._policy_link_degrade
            self.policy_engine.on_link_relief = self._policy_link_undegrade
            # ONE actuator for the app's lifetime, like the engine: a
            # pipeline restart reuses the live (possibly actuated)
            # encoder, and a fresh actuator would capture those knobs
            # as "constructed defaults" — poisoning every later plan
            # merge and the disarm restore contract. The closure reads
            # the encoder THROUGH the pipeline so swaps/rebuilds are
            # picked up (refresh re-captures from the NEW object).
            self.policy_actuator = EncoderActuator(
                lambda: (self.pipeline.encoder
                         if self.pipeline is not None else self.encoder),
                drain=self._policy_drain)
            telemetry.register_provider("policy", self._policy_stats)

        # serving SLO plane (monitoring/slo.py, SELKIES_SLO=1): burn-rate
        # objectives over every delivered frame, the XLA recompile
        # sentinel, and latency-outlier black-box capture. The plane IS
        # a telemetry consumer, so opting in also turns the bus on.
        self.slo = None
        from selkies_tpu_torch.monitoring.slo import SessionSLO, slo_enabled

        if slo_enabled():
            telemetry.enable()
            jitprof.install()
            self.slo = SessionSLO(session="0", supervisor=self.supervisor)
            # acute breach = the session is failing its latency/fps/byte
            # promise NOW: shed bytes the same way the policy congestion
            # overlay does (downscale BEFORE any fps-halving); relief
            # restores it. Both callbacks are idempotent and defer to
            # the failure ladder when it owns the source.
            self.slo.on_pressure = self._policy_link_degrade
            self.slo.on_relief = self._policy_link_undegrade
            if self.policy_engine is not None:
                # scenario transitions retarget the live objectives
                self.policy_engine.on_scenario = self.slo.set_scenario
            telemetry.register_provider("slo", self._slo_stats)
            telemetry.register_provider("compile", jitprof.stats)
            telemetry.register_slo(self._slo_health)

        # decode-and-compare quality probe (monitoring/quality.py,
        # SELKIES_QUALITY=1): samples 1-in-N delivered frames, decodes
        # the enclosing GOP through the codec's reference oracle on a
        # background worker and scores PSNR/SSIM/VMAF against the
        # pre-encode source. A telemetry consumer like the SLO plane,
        # so opting in turns the bus on; scores also feed the SLO
        # quality objective when both planes are armed.
        self.quality = None
        from selkies_tpu_torch.monitoring.quality import (
            QualityProbe, decoder_available, quality_enabled)

        if quality_enabled():
            codec = getattr(self.encoder, "codec", "h264")
            if not decoder_available(codec):
                logger.warning(
                    "SELKIES_QUALITY=1 but no decode oracle for %r; "
                    "quality probe disabled", codec)
            else:
                telemetry.enable()
                self.quality = QualityProbe(
                    session="0", codec=codec, slo=self.slo)
                if self.policy_engine is not None:
                    # scenario transitions retag quality samples too;
                    # chain rather than replace the SLO retarget hook
                    prev = self.policy_engine.on_scenario

                    def _on_scenario(name: str, _prev=prev) -> None:
                        if _prev is not None:
                            _prev(name)
                        self.quality.set_scenario(name)

                    self.policy_engine.on_scenario = _on_scenario
                telemetry.register_provider("quality", self._quality_stats)

        # /statz live read-side: the encoder's link-byte counters (reads
        # through self.encoder so supervisor swaps/rebuilds stay covered)
        # and the pipeline's frame/drop accounting
        telemetry.register_provider("link_bytes", self._link_bytes_snapshot)
        telemetry.register_provider("pipeline", self._pipeline_stats)

    def _slo_stats(self) -> dict:
        return {"0": self.slo.stats()} if self.slo is not None else {}

    def _quality_stats(self) -> dict:
        return ({"0": self.quality.stats()}
                if self.quality is not None else {})

    def _slo_health(self) -> dict:
        return {"0": self.slo.health_view()} if self.slo is not None else {}

    def _link_bytes_snapshot(self) -> dict:
        lb = getattr(self.encoder, "link_bytes", None)
        return lb.snapshot() if lb is not None else {}

    def _pipeline_stats(self) -> dict:
        p = self.pipeline
        if p is None:
            return {"running": False,
                    "software_fallback": self.software_fallback}
        return {
            "running": p.running, "fps": p.fps, "frames": p.frames,
            "dropped_ticks": p.dropped_ticks,
            "dropped_frames": p.dropped_frames, "outbox": len(p._outbox),
            "software_fallback": self.software_fallback,
            "encoder": self._active_encoder_name(),
            # active entropy backend ("cavlc"/"cabac"; "" for rows
            # without one, e.g. AV1/VP9) — the /statz view of which
            # coder the session's PPS pinned
            "entropy_coder": getattr(self.encoder, "entropy_coder", ""),
        }

    # ------------------------------------------------------------------
    # lifecycle (reference :1759, :1810)

    async def start_pipeline(self) -> None:
        if self.pipeline is not None:
            # never orphan a live pipeline's tasks: a session restart that
            # lands while a supervisor recycle is mid-flight must replace,
            # not leak, the previous ticker/sender/watchdog
            await self.stop_pipeline()
        logger.info(
            "starting pipeline: %s %dx%d@%d, %d kbps",
            self.encoder_name, self.source.width, self.source.height, self.framerate, self.video_bitrate_kbps,
        )
        if hasattr(self.encoder, "prewarm"):
            # compile the IDR + full-P executables before the first real
            # frame (the device-entropy program is a large cold build);
            # the jitprof scope attributes these eager compiles exactly,
            # even past the sentinel's startup grace (session restarts)
            logger.info("prewarming encoder executables")
            enc = self.encoder

            def _prewarm() -> None:
                with jitprof.scope("startup", "prewarm"):
                    enc.prewarm()

            await asyncio.to_thread(_prewarm)
        self.pipeline = VideoPipeline(
            source=self.source,
            encoder=self.encoder,
            rate_controller=self.rc,
            sink=self._video_sink,
            fps=self.framerate,
        )
        self.pipeline.on_geometry_change = self._rebuild_encoder
        self.pipeline.supervisor = self.supervisor
        self.pipeline.on_device_fault = self._on_device_fault
        self.pipeline.slo = self.slo
        self.pipeline.quality = self.quality
        if self.policy_engine is not None:
            from selkies_tpu_torch.policy import PolicyRuntime

            self.pipeline.policy = PolicyRuntime(
                self.policy_engine, self.policy_actuator)
        await self.pipeline.start()

    async def stop_pipeline(self) -> None:
        # an external stop (client disconnect) owns teardown: a pending
        # supervisor recycle must not resurrect the pipeline afterwards
        t = self._recycle_task
        if t is not None and not t.done() and t is not asyncio.current_task():
            t.cancel()
            self._recycle_task = None
        if self.pipeline is not None:
            await self.pipeline.stop()
            self.pipeline = None
            logger.info("pipeline stopped")

    def _active_encoder_name(self) -> str:
        return (SOFTWARE_FALLBACK_ENCODER if self.software_fallback
                else self.encoder_name)

    # ------------------------------------------------------------------
    # scenario-policy plumbing (selkies_tpu_torch/policy, docs/policy.md)

    def _policy_stats(self) -> dict:
        eng = self.policy_engine
        return {"0": eng.stats()} if eng is not None else {}

    def _policy_drain(self) -> None:
        """Actuator drain for the app-lifetime actuator: delivers the
        LIVE pipeline's in-flight frames (no-op between sessions)."""
        if self.pipeline is not None:
            self.pipeline.drain_inflight()

    def _policy_link_degrade(self) -> None:
        """Congestion overlay: the link (not the encoder) is the
        bottleneck, so step straight onto the recovery ladder's RESOLUTION
        rung — a 2x DownscaleSource cuts the per-frame bytes ~4x while
        the tick rate (interactivity) is untouched; fps-halving stays
        the failure ladder's own move. No-op while the supervisor's
        failure-driven degradation already owns the source: the two
        controllers must not fight over it."""
        if self.supervisor.degrade_level > 0:
            return
        pipe = self.pipeline
        if pipe is not None and not isinstance(pipe.source, DownscaleSource):
            logger.warning("policy: link congested — downscaling source "
                           "(bytes shed before fps)")
            pipe.source = DownscaleSource(self.source)

    def _policy_link_undegrade(self) -> None:
        if self.supervisor.degrade_level > 0:
            return
        pipe = self.pipeline
        if pipe is not None and isinstance(pipe.source, DownscaleSource):
            logger.info("policy: link recovered — restoring full "
                        "resolution")
            pipe.source = self.source

    def _rebuild_encoder(self, width: int, height: int):
        """Display geometry changed (xrandr resize): new encoder + SPS/PPS
        at the new size (the reference tears down and rebuilds the whole
        GStreamer pipeline for this; our encoder is the only sized stage).

        If construction throws the PREVIOUS encoder stays wired — the
        stream keeps flowing at the old geometry (frames are dropped until
        the size settles) instead of the pipeline dying mid-resize — and
        the failure is reported on the data channel."""
        name = self._active_encoder_name()
        # rate-limit retries of a failing rebuild: the pipeline calls this
        # every tick while the frame geometry mismatches, and re-attempting
        # construction (plus a data-channel error) 60x/s helps nobody
        failed_geom, failed_at = self._rebuild_failed
        if (width, height) == failed_geom and \
                time.monotonic() - failed_at < self.REBUILD_RETRY_S:
            return self.encoder
        logger.info("rebuilding %s for %dx%d", name, width, height)
        jitprof.mark("resize", f"{width}x{height}")
        try:
            self.encoder = create_encoder(
                name, width=width, height=height, fps=self.framerate,
                bitrate_kbps=int(self.video_bitrate_kbps), device=self.device,
            )
            self._rebuild_failed = (None, 0.0)
        except Exception as exc:
            self._rebuild_failed = ((width, height), time.monotonic())
            logger.exception("encoder rebuild for %dx%d failed; keeping the "
                             "previous %dx%d encoder", width, height,
                             self.encoder.width, self.encoder.height)
            self._send("error", {
                "message": (f"resize to {width}x{height} failed ({exc!r}); "
                            f"continuing at {self.encoder.width}x"
                            f"{self.encoder.height}")})
        return self.encoder

    # ------------------------------------------------------------------
    # recovery ladder plumbing (called via _AppRecovery / the supervisor)

    def _swap_encoder(self, name: str, width: int, height: int,
                      **encoder_kw) -> bool:
        """Replace the live encoder in place (same geometry contract as
        the ladder caller established). Keeps the old encoder when
        construction fails; True on success. ``encoder_kw`` forwards
        row-specific knobs (the negotiated tile-column budget for the
        av1/vp9 mesh rows — orchestrator._negotiate_codec)."""
        try:
            new = create_encoder(
                name, width=width, height=height, fps=self.framerate,
                bitrate_kbps=int(self.video_bitrate_kbps), device=self.device,
                **encoder_kw)
        except Exception as exc:
            logger.exception("encoder swap to %s failed; keeping current", name)
            self._send("error", {"message": f"encoder swap failed: {exc!r}"})
            return False
        old = self.encoder
        self.encoder = new
        if self.pipeline is not None:
            self.pipeline.encoder = new
        if old is not new:
            self._dispose_encoder(old)
        self.encoder.force_keyframe()
        self.send_codec()  # the fallback row may negotiate a new bitstream
        return True

    def _dispose_encoder(self, old) -> None:
        """Close a replaced encoder — but not under a worker thread that
        may still be inside its encode (a watchdog-triggered swap races
        the in-flight tick; closing libx264 mid-encode is native UB).
        Deferred close polls until the tick finishes, with a hard 30 s
        cap for permanently wedged calls."""
        if not hasattr(old, "close"):
            return
        pipe = self.pipeline
        if pipe is None or not getattr(pipe, "_tick_in_flight", False):
            try:
                old.close()
            except Exception:
                logger.exception("closing replaced encoder")
            return

        async def _close_when_idle() -> None:
            for _ in range(300):
                if self.pipeline is not pipe or not pipe._tick_in_flight:
                    break
                await asyncio.sleep(0.1)
            try:
                old.close()
            except Exception:
                logger.exception("closing replaced encoder (deferred)")

        try:
            asyncio.get_running_loop().create_task(_close_when_idle())
        except RuntimeError:  # no loop (sync caller in tests)
            try:
                old.close()
            except Exception:
                logger.exception("closing replaced encoder")

    def _on_device_fault(self, chip: str) -> None:
        """A chip this session encodes on was just quarantined
        (resilience/devhealth.py): rebuild the encoder immediately on
        the surviving carve — the registry's pool-routed device default
        enumerates only healthy chips, shrinking the band count when the
        quarantine leaves fewer chips than the carve — instead of the
        ladder grinding three more failures to its RESTART rung on the
        dead device."""
        logger.error("chip %s quarantined; rebuilding the encoder on the "
                     "surviving carve", chip)
        self._restart_encoder()

    def _restart_encoder(self) -> None:
        """Ladder rung 3: same row, fresh instance — recovers encoders
        whose device state is poisoned (stale executables, wedged worker
        pools) without touching geometry or codec."""
        enc = self.encoder
        src = self.pipeline.source if self.pipeline is not None else self.source
        jitprof.mark("restart", self._active_encoder_name())
        self._swap_encoder(self._active_encoder_name(),
                           getattr(enc, "width", src.width),
                           getattr(enc, "height", src.height))

    def _enter_software_fallback(self) -> None:
        if self.software_fallback:
            return
        w, h = self.encoder.width, self.encoder.height
        logger.warning("falling back to the software %s row at %dx%d",
                       SOFTWARE_FALLBACK_ENCODER, w, h)
        if self._swap_encoder(SOFTWARE_FALLBACK_ENCODER, w, h):
            self.software_fallback = True

    def _exit_software_fallback(self) -> None:
        if not self.software_fallback:
            return
        src = self.pipeline.source if self.pipeline is not None else self.source
        logger.info("restoring the %s row", self.encoder_name)
        jitprof.mark("restart", "undegrade")
        if self._swap_encoder(self.encoder_name, src.width, src.height):
            self.software_fallback = False

    def _schedule_recycle(self) -> None:
        """Last rung: rebuild the whole pipeline. Scheduled as a task —
        the supervisor calls this from inside the pipeline loop it is
        about to tear down."""

        async def _recycle() -> None:
            logger.error("recycling video pipeline")
            await self.stop_pipeline()
            src = self.source
            # the fresh pipeline must come back AT the supervisor's
            # current degradation level, not silently undegraded — the
            # overload that climbed the ladder is usually still there
            # (fps shedding lives in self.framerate and the software
            # fallback in _active_encoder_name, both already persistent;
            # only the source downscale needs re-applying)
            if self.supervisor.degrade_level >= 2:
                src = DownscaleSource(self.source)
            self._swap_encoder(self._active_encoder_name(),
                               src.width, src.height)
            await self.start_pipeline()
            if self.supervisor.degrade_level >= 2 and self.pipeline is not None:
                self.pipeline.source = src

        if self._recycle_task is not None and not self._recycle_task.done():
            return  # one recycle at a time
        self._recycle_task = asyncio.get_running_loop().create_task(_recycle())

    async def _video_sink(self, ef: EncodedFrame) -> None:
        self.on_frame(ef)
        if self.transport is not None:
            await self.transport.send_video(ef)

    # ------------------------------------------------------------------
    # live retune (reference :1217, :1296, :1414, :1442)

    def set_framerate(self, framerate: int) -> None:
        self.framerate = int(framerate)
        if self.pipeline is not None:
            self.pipeline.set_framerate(framerate)
        else:
            self.rc.set_framerate(framerate)

    def set_video_bitrate(self, bitrate_kbps: int, cc: bool = False) -> None:
        """Retarget video bitrate; cc=True marks a congestion-control
        update (not persisted / not echoed to the client UI)."""
        self.rc.set_bitrate(bitrate_kbps)
        if hasattr(self.encoder, "set_bitrate"):
            # encoders that own their rate control (libvpx CBR) take the
            # target directly, like the reference poking `target-bitrate`
            self.encoder.set_bitrate(int(bitrate_kbps))
        if not cc:
            self.video_bitrate_kbps = int(bitrate_kbps)

    def set_audio_bitrate(self, bitrate: int) -> None:
        self.audio_bitrate = int(bitrate)

    def set_pointer_visible(self, visible: bool) -> None:
        self.pointer_visible = bool(visible)

    def force_keyframe(self) -> None:
        # unthrottled on purpose: internal callers (transport handover,
        # session start) are never retried, so they must always land.
        # The PLI/FIR flood floor lives in the transport
        # (webrtc/peer.py _on_srtcp), shared with the fleet path.
        self.encoder.force_keyframe()

    # ------------------------------------------------------------------
    # SDP/ICE plumbing: delegated to the transport when it supports WebRTC

    def set_sdp(self, sdp_type: str, sdp: str) -> None:
        if self.transport is not None and hasattr(self.transport, "set_remote_sdp"):
            self.transport.set_remote_sdp(sdp_type, sdp)

    def set_ice(self, mlineindex: int, candidate: str) -> None:
        if self.transport is not None and hasattr(self.transport, "add_remote_ice"):
            self.transport.add_remote_ice(mlineindex, candidate)

    # ------------------------------------------------------------------
    # data channel vocabulary (reference :1454-1579)

    def is_data_channel_ready(self) -> bool:
        return self.transport is not None and self.transport.data_channel_ready

    def _send(self, msg_type: str, data: Any) -> None:
        if not self.is_data_channel_ready():
            logger.debug("dropping %s: data channel not ready", msg_type)
            return
        self.transport.send_data_channel(json.dumps({"type": msg_type, "data": data}))

    def send_clipboard_data(self, data: str) -> None:
        payload = base64.b64encode(data.encode()).decode("utf-8")
        if len(payload) > 65400:
            logger.warning("clipboard too large for data channel (%d b64 bytes)", len(payload))
            return
        self._send("clipboard", {"content": payload})

    def send_cursor_data(self, data: Any) -> None:
        self.last_cursor_sent = data
        self._send("cursor", data)

    def send_gpu_stats(self, load: float, memory_total: float, memory_used: float) -> None:
        self._send("gpu_stats", {"load": load, "memory_total": memory_total, "memory_used": memory_used})

    def send_tpu_stats(self, duty_cycle: float, hbm_total: float, hbm_used: float) -> None:
        """TPU twin of send_gpu_stats (the client renders either)."""
        self._send("gpu_stats", {"load": duty_cycle, "memory_total": hbm_total, "memory_used": hbm_used})

    def send_reload_window(self) -> None:
        self._send("system", {"action": "reload"})

    def send_framerate(self, framerate: int) -> None:
        self._send("system", {"action": f"framerate,{framerate}"})

    def send_video_bitrate(self, bitrate: int) -> None:
        self._send("system", {"action": f"video_bitrate,{bitrate}"})

    def send_audio_bitrate(self, bitrate: int) -> None:
        self._send("system", {"action": f"audio_bitrate,{bitrate}"})

    def send_encoder(self, encoder: str) -> None:
        self._send("system", {"action": f"encoder,{encoder}"})

    def send_codec(self) -> None:
        """Tell the client which bitstream the media plane carries so it
        can configure its WebCodecs decoder (h264 / vp9 / vp8)."""
        self._send("codec", {"codec": getattr(self.encoder, "codec", "h264")})

    def send_resize_enabled(self, resize_enabled: bool) -> None:
        # lowercase on the wire: clients persist the token and compare
        # against "true" (a Python-cased "True" broke checkbox restore)
        self._send("system", {"action": f"resize,{str(resize_enabled).lower()}"})

    def send_remote_resolution(self, res: str) -> None:
        self._send("system", {"action": f"resolution,{res}"})

    def send_ping(self, t: float) -> None:
        self._send("ping", {"start_time": float(f"{t:.3f}")})

    def send_latency_time(self, latency_ms: float) -> None:
        self._send("latency_measurement", {"latency_ms": latency_ms})

    def send_system_stats(self, cpu_percent: float, mem_total: float, mem_used: float) -> None:
        self._send("system_stats", {"cpu_percent": cpu_percent, "mem_total": mem_total, "mem_used": mem_used})

    async def handle_data_message(self, message: str) -> None:
        """Entry point for client→server data channel messages."""
        result = self.on_data_message(message)
        if asyncio.iscoroutine(result):
            await result
