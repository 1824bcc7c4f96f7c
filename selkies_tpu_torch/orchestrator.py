"""Orchestrator — the ``selkies-tpu`` entrypoint of the port.

The port's copy of ``selkies_tpu/orchestrator.py``, whole, run as
``python -m selkies_tpu_torch``. Where it differs from JAX's:

* ``Orchestrator(cfg, *, device=None)``: ``None`` means ``cuda`` and raises
  without a card; the app's encoders and the device monitor take
  ``device``. On an explicit ``device="cpu"`` no device monitor is built
  and no ``gpu_stats`` are sent.
* ``TransportMux`` lives in ``transport/mux.py``, which the fleet imports
  without the server stack; this module re-exports it. Its WebRTC plane is
  the port's ``WebRTCTransport`` (``transport/webrtc/``), built as JAX's.
* ``main`` routes ``tpu_sessions > 1`` to the port's ``FleetOrchestrator``
  (``parallel/fleet.py``), passing ``device`` through as its one device.
  With ``SELKIES_CLUSTER_PEERS`` set the solo server heartbeats its
  capacity digest and routes client HELLOs through the port's cluster
  plane (``cluster/``), as JAX's does.

Parity target: the reference __main__.py main() (:335-992): resolve config
(flags ⇄ env ⇄ JSON overlay), resolve the TURN credential chain, start the
combined signalling/web server, wire every callback between the app core,
input host, monitors and metrics, then supervise sessions forever.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os

from selkies_tpu_torch.audio import AudioPipeline, open_best_audio_source, opus_available
from selkies_tpu_torch.cluster import cluster_enabled
from selkies_tpu_torch.config import Config, parse_config
from selkies_tpu_torch.input_host import HostInput
from selkies_tpu_torch.input_host.resize import resize_display, set_cursor_size, set_dpi
from selkies_tpu_torch.device import resolve_device
from selkies_tpu_torch.monitoring import DeviceMonitor, Metrics, SystemMonitor
from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.pipeline.app import TorchWebRTCApp
from selkies_tpu_torch.signalling import (
    SignallingOptions,
    SignallingServer,
    generate_rtc_config,
    parse_rtc_config,
    stun_only_rtc_config,
)
from selkies_tpu_torch.signalling.rtc_monitors import (
    HMACRTCMonitor,
    RESTRTCMonitor,
    RTCConfigFileMonitor,
    fetch_cloudflare_turn,
    fetch_turn_rest,
    make_turn_rtc_config_json_legacy,
)
from selkies_tpu_torch.signalling.client import (
    SignallingClient,
    SignallingErrorNoPeer,
    reconnect_backoff,
    run_reconnect_loop,
)
from selkies_tpu_torch.transport.congestion import GccController
from selkies_tpu_torch.transport.mux import TransportMux
from selkies_tpu_torch.transport.webrtc.transport import WebRTCTransport
from selkies_tpu_torch.transport.websocket import WebSocketTransport

logger = logging.getLogger("orchestrator")

# reference peer-id convention (__main__.py:555): the browser registers
# as 1, the server-side client pairs with it
BROWSER_PEER_ID = 1
SERVER_CLIENT_ID = 2


def _first_ice_servers(stun_servers: str, turn_servers: str):
    """First stun/turn entries from the csv 'scheme://[user:pass@]host:port'
    forms -> IceAgent kwargs."""
    kw: dict = {"stun_server": None, "turn_server": None,
                "turn_username": "", "turn_password": "",
                "turn_transport": "udp"}
    for uri in (stun_servers or "").split(","):
        uri = uri.strip()
        if uri.startswith("stun://"):
            host, _, port = uri[7:].partition(":")
            port = port.split("?")[0]
            kw["stun_server"] = (host, int(port or 3478))
            break
    for uri in (turn_servers or "").split(","):
        uri = uri.strip()
        if uri.startswith("turn://"):
            rest, tls = uri[7:], False
        elif uri.startswith("turns://"):
            rest, tls = uri[8:], True
        else:
            continue
        if "@" in rest:
            creds, rest = rest.rsplit("@", 1)
            user, _, pw = creds.partition(":")
            kw["turn_username"], kw["turn_password"] = user, pw
        host, _, tail = rest.partition(":")
        host, q_sep, host_query = host.partition("?")  # no-port form: ?query glues to host
        port, _, query = (tail or "").partition("?")
        if q_sep and not query:
            query = host_query
        # reference chain parity (__main__.py:617-656): ?transport= picks
        # udp/tcp; turns:// is TLS over TCP (default port 5349)
        transport = "tls" if tls else "udp"
        for kv in query.split("&"):
            k, _, v = kv.partition("=")
            if k == "transport" and v == "tcp" and not tls:
                transport = "tcp"
        kw["turn_server"] = (host, int(port or (5349 if tls else 3478)))
        kw["turn_transport"] = transport
        break
    return kw


DEFAULT_WEB_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "web")


def make_signalling_server(cfg: Config) -> SignallingServer:
    """The combined web/signalling/TURN server, from config (shared by the
    solo Orchestrator and the fleet path, parallel/fleet.py)."""
    return SignallingServer(SignallingOptions(
        addr=cfg.addr,
        port=int(cfg.port),
        web_root=cfg.web_root or DEFAULT_WEB_ROOT,
        turn_shared_secret=cfg.turn_shared_secret,
        turn_host=cfg.turn_host,
        turn_port=str(cfg.turn_port) if cfg.turn_host else "",
        turn_protocol=cfg.turn_protocol,
        turn_tls=bool(cfg.turn_tls),
        stun_host=cfg.stun_host,
        stun_port=str(cfg.stun_port),
        rtc_config_file=cfg.rtc_config_json,
        enable_basic_auth=bool(cfg.enable_basic_auth),
        basic_auth_user=cfg.basic_auth_user,
        basic_auth_password=cfg.basic_auth_password,
        enable_https=bool(cfg.enable_https),
        https_cert=cfg.https_cert,
        https_key=cfg.https_key,
    ))


async def wait_for_app_ready(ready_file: str, app_wait_ready: bool) -> None:
    """Block until the sidecar app drops its ready file (reference :288-301)."""
    logger.info("waiting for streaming app ready")
    while app_wait_ready and not os.path.exists(ready_file):
        await asyncio.sleep(0.2)


async def resolve_rtc_config(cfg: Config) -> tuple[str, str, str]:
    """TURN credential priority chain (reference __main__.py:617-656):
    Cloudflare → rtc.json file → TURN REST → legacy long-term → HMAC →
    STUN-only fallback.  Returns (stun_servers, turn_servers, rtc_config)."""
    if cfg.enable_cloudflare_turn and cfg.cloudflare_turn_token_id:
        try:
            doc = await fetch_cloudflare_turn(
                cfg.cloudflare_turn_token_id, cfg.cloudflare_turn_api_token
            )
            data = json.dumps({"lifetimeDuration": "86400s", "iceServers": [doc["iceServers"]]})
            return parse_rtc_config(data)
        except Exception as exc:
            logger.warning("Cloudflare TURN failed (%s); falling through", exc)
    if cfg.rtc_config_json and os.path.exists(cfg.rtc_config_json):
        try:
            with open(cfg.rtc_config_json) as f:
                return parse_rtc_config(f.read())
        except Exception as exc:
            logger.warning("rtc_config_json unreadable (%s); falling through", exc)
    if cfg.turn_rest_uri:
        try:
            return await fetch_turn_rest(
                cfg.turn_rest_uri, cfg.turn_rest_username.replace(":", "-"),
                cfg.turn_rest_username_auth_header, cfg.turn_protocol,
                cfg.turn_rest_protocol_header, cfg.turn_tls, cfg.turn_rest_tls_header,
            )
        except Exception as exc:
            logger.warning("TURN REST failed (%s); falling through", exc)
    if cfg.turn_host and cfg.turn_port:
        if cfg.turn_username and cfg.turn_password:
            data = make_turn_rtc_config_json_legacy(
                cfg.turn_host, cfg.turn_port, cfg.turn_username, cfg.turn_password,
                cfg.turn_protocol, cfg.turn_tls, cfg.stun_host, cfg.stun_port,
            )
            return parse_rtc_config(data)
        if cfg.turn_shared_secret:
            data = generate_rtc_config(
                cfg.turn_host, cfg.turn_port, cfg.turn_shared_secret,
                cfg.turn_rest_username, cfg.turn_protocol, cfg.turn_tls,
                cfg.stun_host, cfg.stun_port,
            )
            return parse_rtc_config(data)
    return parse_rtc_config(stun_only_rtc_config(cfg.stun_host, cfg.stun_port))


def make_rtc_monitors(cfg: Config, on_rtc_config) -> list:
    """The live TURN-credential refreshers (reference __main__.py:919-947):
    HMAC re-mint, REST re-fetch, rtc.json file watch. Shared by the solo
    Orchestrator and the fleet path — without them /turn hands browsers
    expired credentials after the 24 h TTL."""
    monitors = []
    if cfg.turn_shared_secret and cfg.turn_host and cfg.turn_port:
        m = HMACRTCMonitor(
            cfg.turn_host, cfg.turn_port, cfg.turn_shared_secret,
            cfg.turn_rest_username, cfg.turn_protocol, bool(cfg.turn_tls),
            cfg.stun_host, cfg.stun_port,
        )
        m.on_rtc_config = on_rtc_config
        monitors.append(m)
    if cfg.turn_rest_uri:
        m = RESTRTCMonitor(
            cfg.turn_rest_uri, cfg.turn_rest_username,
            cfg.turn_rest_username_auth_header, cfg.turn_protocol,
            cfg.turn_rest_protocol_header, bool(cfg.turn_tls),
            cfg.turn_rest_tls_header,
        )
        m.on_rtc_config = on_rtc_config
        monitors.append(m)
    if cfg.rtc_config_json:
        m = RTCConfigFileMonitor(
            cfg.rtc_config_json, enabled=os.path.exists(cfg.rtc_config_json))
        m.on_rtc_config = on_rtc_config
        monitors.append(m)
    return monitors


def _loss_counters(stats_json: str) -> tuple[float, float] | None:
    """Extract cumulative (packetsLost, packetsReceived) from a client
    RTCStats upload (inbound-rtp report). Returns None when the transport
    doesn't report loss (the WS transport never does)."""
    try:
        reports = json.loads(stats_json)
    except (ValueError, TypeError):
        return None
    if isinstance(reports, dict):
        reports = [reports]
    if not isinstance(reports, list):
        return None
    for report in reports:
        if not isinstance(report, dict):
            continue
        if report.get("type") != "inbound-rtp":
            continue
        lost, received = report.get("packetsLost"), report.get("packetsReceived")
        if lost is None or received is None:
            continue
        try:
            return max(0.0, float(lost)), max(0.0, float(received))
        except (TypeError, ValueError):
            continue
    return None


class Orchestrator:
    """The solo server. ``device=None`` means ``cuda`` and raises without a
    card; the CPU serves only ``device="cpu"``."""

    def __init__(self, cfg: Config, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics = Metrics(
            port=int(cfg.metrics_http_port),
            using_webrtc_csv=bool(cfg.enable_webrtc_statistics),
        )
        self.ws_transport = WebSocketTransport()
        self.webrtc = WebRTCTransport(audio=opus_available(),
                                      turn_tls_insecure=bool(cfg.turn_tls_insecure))
        self.transport = TransportMux(self.ws_transport, self.webrtc)
        # ximagesrc parity: capture the real X root window when a DISPLAY is
        # reachable; otherwise the synthetic test source (headless rigs).
        from selkies_tpu_torch.pipeline.capture import make_frame_source

        source = make_frame_source(int(cfg.capture_width), int(cfg.capture_height))
        self.app = TorchWebRTCApp(
            transport=self.transport,
            source=source,
            encoder=cfg.encoder,
            # the live X geometry wins over the configured capture size
            width=source.width,
            height=source.height,
            framerate=int(cfg.framerate),
            video_bitrate_kbps=int(cfg.video_bitrate),
            congestion_control=bool(cfg.congestion_control),
            device=self.device,
        )
        # the encoder row decides what the WebRTC plane negotiates
        # (an AV1 row must offer AV1/90000, not H.264)
        self.webrtc.set_codec(
            getattr(self.app.encoder, "codec", "h264"),
            getattr(self.app.encoder, "h264_profile", "baseline"))
        self.audio: AudioPipeline | None = None
        if opus_available():
            self.audio = AudioPipeline(
                source=open_best_audio_source(cfg.audio_device or None),
                sink=self.transport.send_audio,
                bitrate_bps=int(cfg.audio_bitrate),
            )
        self.input = HostInput(
            uinput_mouse_socket_path=cfg.uinput_mouse_socket,
            js_socket_path=cfg.js_socket_path,
            enable_clipboard=str(cfg.enable_clipboard).lower(),
            enable_cursors=bool(cfg.enable_cursors),
            cursor_size=int(cfg.cursor_size),
            cursor_debug=bool(cfg.debug_cursors),
        )
        self.system_mon = SystemMonitor()
        # the card's monitor reads CUDA memory: none on the CPU
        self.device_mon = (DeviceMonitor(device=self.device)
                           if self.device.type == "cuda" else None)
        self.server = make_signalling_server(cfg)
        self.server.ws_routes["/media"] = self.ws_transport.handle_connection
        self._tasks: list[asyncio.Task] = []
        self._session_active = False
        self._rearm_signalling = asyncio.Event()
        self._last_loss_counters = (0.0, 0.0)
        self.last_resize_success = True
        self._uninstall_signals = None
        # graceful drain (parallel/lifecycle.py — the fleet path shares
        # the same controller): SIGTERM force-IDRs the client so it holds
        # a decodable recovery point, flushes the pipeline, flips
        # /healthz to 503 for the whole window, then stops the server so
        # run() returns instead of dying mid-frame
        from selkies_tpu_torch.parallel.lifecycle import DrainController

        self.drainer = DrainController(
            "solo", force_idr=self.app.force_keyframe,
            flush=self._drain_flush, on_drained=self._drain_exit)
        # multi-host cluster plane (selkies_tpu_torch/cluster): the solo host
        # heartbeats its capacity digest and routes client HELLOs —
        # redirecting when draining or already serving — but doesn't
        # receive migrations (one session shape, nothing to restore
        # into while occupied)
        self.cluster = None
        if cluster_enabled():
            from selkies_tpu_torch.cluster import build_cluster_plane, wire_cluster_plane

            def _solo_digest():
                # a bare solo host has no placer: occupancy is the one
                # capacity fact it owns, and without it peers would
                # keep scoring an occupied host as free and redirect
                # clients into a hang
                d = telemetry.capacity_digest()
                d["busy"] = 1 if self._session_active else 0
                d["free_slots"] = 0 if self._session_active else 1
                return d

            # pin ONLY the active session's own browser peer (the solo
            # web client registers as peer "1"): its encoder state lives
            # here even mid-drain, but a DIFFERENT client knocking on an
            # occupied or draining solo host should go through routing.
            # wire_cluster_plane owns the wire-or-refuse security policy
            # (unsigned /cluster routes on a basic-auth server)
            self.cluster = wire_cluster_plane(
                build_cluster_plane(
                    is_local_session=lambda uid: (self._session_active
                                                  and str(uid) == "1"),
                    digest_fn=_solo_digest),
                self.server, enable_basic_auth=bool(cfg.enable_basic_auth))
        self._last_rtt_ms = 0.0
        self._wire_callbacks()
        # scenario-policy congestion signals (selkies_tpu/policy): the
        # engine reads the GCC estimate/loss and the ping-channel RTT to
        # tell a link bottleneck from an encoder one (docs/policy.md)
        if self.app.policy_engine is not None and self.gcc is not None:
            self.app.policy_engine.congestion = self._policy_congestion

    def _policy_congestion(self) -> dict:
        g = self.gcc
        return {
            "rtt_ms": self._last_rtt_ms,
            "loss": getattr(g, "last_loss", 0.0),
            "target_kbps": g.estimate_kbps,
            "min_kbps": g.min_kbps,
        }

    async def _drain_flush(self) -> None:
        """Wait for one post-flag IDR to actually REACH the client (the
        drainer's force-IDR only sets a sticky flag — stopping the
        pipeline before the next tick encodes it would tear down a
        client with no recovery point), then stop the pipeline: its
        stop path flushes remaining in-flight groups to the transport.
        Deadline-bounded by the DrainController's wait_for."""
        pipe = self.app.pipeline
        if pipe is not None and pipe.running:
            target = pipe.idr_sent + 1
            while (self.app.pipeline is pipe and pipe.running
                   and pipe.idr_sent < target):
                await asyncio.sleep(0.02)
        await self._stop_session()

    async def _drain_exit(self) -> None:
        await self.server.stop()

    async def drain(self) -> bool:
        return await self.drainer.drain()

    # ------------------------------------------------------------------

    def _wire_callbacks(self) -> None:
        """Reference wiring: __main__.py:684-871."""
        cfg, app, inp = self.cfg, self.app, self.input

        # transport session lifecycle (reference on_session_handler :700)
        # both byte planes share the handlers: whichever the client uses
        # (WebRTC preferred, WS fallback) drives the same session
        self.ws_transport.on_connect = self._on_client_connected
        self.ws_transport.on_disconnect = self._on_client_disconnected
        self.ws_transport.on_data_message = inp.on_message
        self.webrtc.on_connect = self._on_client_connected
        self.webrtc.on_disconnect = self._on_webrtc_disconnected
        self.webrtc.on_data_message = inp.on_message
        self.webrtc.on_force_keyframe = app.force_keyframe
        app.on_data_open = lambda: logger.info("data channel open")

        # client → host settings
        def on_video_bitrate(bitrate_kbps: int) -> None:
            app.set_video_bitrate(bitrate_kbps)
            if self.gcc is not None:
                # the user's choice is the new cap AND the new probe point;
                # without this the next GCC estimate (still bounded by the
                # old cap) would silently revert the change
                self.gcc.set_target(int(bitrate_kbps))
            cfg.set_json_setting("video_bitrate", int(bitrate_kbps))
            app.send_video_bitrate(int(bitrate_kbps))

        def on_audio_bitrate(bitrate_bps: int) -> None:
            if self.audio is not None:
                self.audio.set_bitrate(int(bitrate_bps))
            cfg.set_json_setting("audio_bitrate", int(bitrate_bps))
            app.send_audio_bitrate(int(bitrate_bps))

        def on_set_fps(fps: int) -> None:
            app.set_framerate(int(fps))
            cfg.set_json_setting("framerate", int(fps))
            app.send_framerate(int(fps))

        def on_set_enable_resize(enabled: bool, res: str | None) -> None:
            cfg.set_json_setting("enable_resize", bool(enabled))
            app.send_resize_enabled(bool(enabled))
            if enabled and res:
                self._do_resize(res)

        inp.on_video_encoder_bit_rate = on_video_bitrate
        inp.on_audio_encoder_bit_rate = on_audio_bitrate
        inp.on_set_fps = on_set_fps
        inp.on_set_enable_resize = on_set_enable_resize
        inp.on_mouse_pointer_visible = app.set_pointer_visible
        inp.on_clipboard_read = app.send_clipboard_data
        inp.on_cursor_change = app.send_cursor_data
        inp.on_resize = self._on_resize
        inp.on_scaling_ratio = self._on_scaling_ratio
        inp.on_client_fps = self.metrics.set_fps
        inp.on_client_latency = self.metrics.set_latency
        inp.on_ping_response = self._on_ping_response
        inp.on_client_webrtc_stats = self._on_client_webrtc_stats

        # GCC congestion control: per-frame transport feedback drives the
        # encoder's CBR target (reference: rtpgccbwe notify::estimated-bitrate
        # → set_video_bitrate(cc=True), gstwebrtc_app.py:1638-1655)
        if bool(cfg.congestion_control):
            audio_kbps = max(int(cfg.audio_bitrate) // 1000, 0)
            self.gcc = GccController(
                start_kbps=int(cfg.video_bitrate),
                min_kbps=max(100 + audio_kbps, int(cfg.video_bitrate) // 10),
                max_kbps=int(cfg.video_bitrate),
                on_estimate=lambda kbps: app.set_video_bitrate(kbps, cc=True),
            )
            self.transport.ws.on_video_sent = self.gcc.on_frame_sent
            inp.on_media_ack = self.gcc.on_frame_ack
            # WebRTC plane: per-packet transport-wide-cc feedback
            self.webrtc.on_video_sent = self.gcc.on_frame_sent
            self.webrtc.on_video_acked = self.gcc.on_frame_ack
            self.webrtc.on_loss = self.gcc.on_loss_report
        else:
            self.gcc = None

        # recovery ladder (transport/recovery.py): the same RR loss tap
        # GCC consumes also drives the protection level — FEC scales
        # with smoothed loss, unrecoverable gaps force an IDR, and the
        # link-pressure degrade rungs become the LAST resort. Inert
        # under SELKIES_RECOVERY=0 (every input no-ops, so the peer
        # keeps its static constructor FEC percentage).
        from selkies_tpu_torch.transport.recovery import RecoveryController

        self.recovery = RecoveryController(session="0")
        self.recovery.on_set_fec = self.webrtc.set_fec_percentage
        # unthrottled internal path — same one transport handover uses
        self.recovery.on_force_idr = app.force_keyframe
        self.recovery.on_degrade = app._policy_link_degrade
        self.recovery.on_undegrade = app._policy_link_undegrade
        self.webrtc.on_nack = self.recovery.on_nack
        self.webrtc.on_unrecoverable = self.recovery.on_unrecoverable
        gcc_loss = self.webrtc.on_loss
        rec_loss = self.recovery.on_loss_report

        def _on_loss(fraction: float) -> None:
            gcc_loss(fraction)
            rec_loss(fraction)

        self.webrtc.on_loss = _on_loss
        telemetry.register_provider("recovery", self.recovery.stats)

        # monitors → client stats channels
        def on_timer(ts: float) -> None:
            inp.send_ping(ts)
            app.send_ping(ts)
            app.send_system_stats(
                self.system_mon.cpu_percent, self.system_mon.mem_total, self.system_mon.mem_used
            )

        self.system_mon.on_timer = on_timer
        if self.device_mon is not None:
            self.device_mon.on_stats = lambda load, total, used: (
                self.metrics.set_tpu_utilization(load * 100),
                app.send_tpu_stats(load, total, used),
            )

    # ------------------------------------------------------------------
    # resize plumbing (reference :771-823)

    def _do_resize(self, res: str) -> None:
        if not bool(self.cfg.enable_resize):
            return
        if not self.last_resize_success:
            logger.warning("skipping resize because last resize failed")
            return
        try:
            ok = resize_display(res)
        except Exception as exc:
            logger.warning("resize failed: %s", exc)
            ok = False
            self.last_resize_success = False
        if ok:
            self.app.send_remote_resolution(res)

    def _on_resize(self, res: str) -> None:
        self._do_resize(res)

    def _on_scaling_ratio(self, scale: float) -> None:
        dpi = int(96 * scale)
        set_dpi(dpi)
        cursor_size = int(16 * scale)
        set_cursor_size(cursor_size)

    def _on_ping_response(self, latency_ms: float) -> None:
        self.metrics.set_latency(latency_ms)
        self._last_rtt_ms = float(latency_ms)
        if telemetry.enabled:
            telemetry.gauge("selkies_congestion_rtt_ms", latency_ms,
                            session="0")
        self.app.send_latency_time(latency_ms)

    # ------------------------------------------------------------------
    # session lifecycle

    def _negotiate_codec(self, meta) -> None:
        """Resolve the client's codec preference list (HELLO meta)
        against the registry rows before the offer is built. No
        preferences anywhere (client or SELKIES_CODEC) keeps the
        configured encoder row untouched."""
        from selkies_tpu_torch.signalling import negotiate

        prefs = meta.get("codecs") if isinstance(meta, dict) else None
        if not prefs and not negotiate.server_preferences():
            # no preference from THIS client: a previous client's
            # negotiated row must not leak onto it — restore the
            # configured encoder if negotiation moved away from it
            # (software_fallback swaps are the ladder's, not ours)
            if (self.app.encoder_name != self.cfg.encoder
                    and not self.app.software_fallback):
                enc = self.app.encoder
                if self.app._swap_encoder(self.cfg.encoder,
                                          enc.width, enc.height):
                    self.app.encoder_name = self.cfg.encoder
            self.webrtc.set_codec(
            getattr(self.app.encoder, "codec", "h264"),
            getattr(self.app.encoder, "h264_profile", "baseline"))
            # every session start reports its live codec, preference
            # list or not — the gauge means "currently negotiated"
            self._emit_codec_gauge(getattr(self.app.encoder, "codec", "h264"))
            return
        try:
            # health-plane view: a quarantined chip must not count
            # toward the tile-column budget a negotiation carves over
            from selkies_tpu_torch.resilience.devhealth import get_device_pool

            chips = len(get_device_pool().healthy_devices())
        except Exception:
            chips = 1
        current = getattr(self.app.encoder, "codec", "h264")
        n = negotiate.resolve(prefs, session_chips=chips,
                              per_session_carve=True, fallback=current)
        if n.codec != current:
            enc = self.app.encoder
            # the mesh rows take the negotiated tile-column budget; other
            # rows must NOT see a cols kwarg (the h264 factory would read
            # it as a tile-grid carve). A later ladder rebuild re-derives
            # cols from SELKIES_TILE_COLS — the negotiated budget applies
            # to this session's swap only.
            kw = ({"cols": n.cols} if n.codec in ("av1", "vp9") else {})
            # recompile sentinel: the new row's executables compile on
            # its first frames — attribute them to this negotiation
            from selkies_tpu_torch.monitoring import jitprof

            jitprof.mark("codec_switch", n.codec)
            if self.app._swap_encoder(n.encoder, enc.width, enc.height, **kw):
                # resizes / supervisor rebuilds re-create the ACTIVE row
                # (app._active_encoder_name) — the negotiated codec must
                # survive them, not revert to the configured one
                self.app.encoder_name = n.encoder
            else:
                logger.warning("negotiated %s encoder swap failed; staying "
                               "on %s", n.codec, current)
        codec = getattr(self.app.encoder, "codec", "h264")
        self.webrtc.set_codec(
            codec, getattr(self.app.encoder, "h264_profile", "baseline"))
        logger.info("client negotiated codec %s (%s)", codec, n.reason)
        telemetry.event("codec_negotiated", codec=codec, reason=n.reason,
                        encoder=self.app.encoder_name)
        self._emit_codec_gauge(codec)

    def _emit_codec_gauge(self, codec: str | None) -> None:
        """selkies_codec_sessions for the solo (single-session) host:
        1 for the live session's codec, 0 everywhere else — None (no
        client) zeroes every series so a departed session's codec
        doesn't read as live forever."""
        if not telemetry.enabled:
            return
        for c in ("h264", "av1", "vp9", "vp8", "h265"):
            telemetry.gauge("selkies_codec_sessions",
                            1 if c == codec else 0, codec=c)

    def _on_client_connected(self) -> None:
        if self._session_active:
            # second byte plane joined the same session (e.g. WS fallback
            # while WebRTC negotiates): refresh the stream, don't restart
            logger.info("additional transport connected; forcing keyframe")
            if self.gcc is not None:
                # the new plane has its own sequence space and receive
                # clock epoch; stale ledger entries would corrupt the
                # trendline right at handover
                self.gcc.reset()
            self.app.force_keyframe()
            self.app.send_codec()
            return
        logger.info("client connected; starting pipelines")
        self._session_active = True
        if self.gcc is not None:
            # the new client's receive clock has a fresh epoch
            # (performance.now() restarts on reload): stale delay state
            # would corrupt the trendline
            self.gcc.reset()
        loop = asyncio.get_running_loop()
        loop.create_task(self._start_session())

    async def _on_client_webrtc_stats(self, stat_type: str, stats_json: str) -> None:
        await self.metrics.set_webrtc_stats(stat_type, stats_json)
        # RTCP receiver reports already feed loss on the WebRTC plane
        # (webrtc.on_loss); counting the stats upload too would apply
        # the multiplicative back-off twice for the same packets
        if self.gcc is not None and stat_type == "_stats_video" and not self.webrtc.connected:
            counters = _loss_counters(stats_json)
            if counters is not None:
                lost, received = counters
                # stats counters are cumulative; GCC wants interval loss
                p_lost, p_recv = self._last_loss_counters
                d_lost, d_recv = lost - p_lost, received - p_recv
                self._last_loss_counters = (lost, received)
                if d_lost >= 0 and d_recv >= 0 and d_lost + d_recv > 0:
                    self.gcc.on_loss_report(d_lost / (d_lost + d_recv))

    def _on_client_disconnected(self) -> None:
        if self.webrtc.connected:
            logger.info("WS transport gone; WebRTC session continues")
            return
        logger.info("client disconnected; stopping pipelines")
        self._session_active = False
        self._emit_codec_gauge(None)  # no live session, no live codec
        loop = asyncio.get_running_loop()
        loop.create_task(self._stop_session())
        # drop any half-negotiated peer and re-arm for the next browser
        # (a WS-fallback session ending must not leave WebRTC disarmed)
        loop.create_task(self.webrtc.stop_session())
        self._rearm_signalling.set()

    def _on_webrtc_disconnected(self) -> None:
        if self.ws_transport.data_channel_ready:
            logger.info("WebRTC gone; WS fallback session continues")
            return
        self._on_client_disconnected()
        # re-arm negotiation for the next browser (reload / reconnect)
        self._rearm_signalling.set()

    async def _start_session(self) -> None:
        if self.cfg.enable_webrtc_statistics:
            self.metrics.initialize_webrtc_csv_file(self.cfg.webrtc_statistics_dir)
        self.app.force_keyframe()
        self.app.send_codec()  # client picks its WebCodecs decoder config
        # push current server settings so the client drawer reflects them
        # (reference system-action loop, app.js:685-769)
        self.app.send_encoder(self.cfg.encoder)
        self.app.send_framerate(int(self.app.framerate))
        self.app.send_video_bitrate(int(self.app.video_bitrate_kbps))
        self.app.send_audio_bitrate(int(self.cfg.audio_bitrate))
        self.app.send_resize_enabled(bool(self.cfg.enable_resize))
        await self.app.start_pipeline()
        if self.audio is not None:
            await self.audio.start()

    async def _stop_session(self) -> None:
        await self.app.stop_pipeline()
        if self.app.slo is not None:
            # the departed client's SLO windows, breach state, outlier
            # baseline and sticky WARN must not be inherited by the
            # next client (the fleet's reset_session_slo precedent);
            # the pressure-hook downscale needs no undo here — the next
            # start_pipeline builds a fresh pipeline on the full source
            self.app.slo.reset()
        if self.audio is not None:
            await self.audio.stop()
        await self.input.stop_js_server()
        self.input.reset_keyboard()

    # ------------------------------------------------------------------
    # WebRTC negotiation: the in-process signalling client pairs with the
    # browser (HELLO 2 / SESSION 1, reference __main__.py:555-579) and
    # relays the offer/answer + trickle ICE both ways.

    async def _signalling_loop(self) -> None:
        cfg = self.cfg
        scheme = "wss" if bool(cfg.enable_https) else "ws"
        client = SignallingClient(
            f"{scheme}://127.0.0.1:{self.server.bound_port}/ws",
            id=SERVER_CLIENT_ID, peer_id=BROWSER_PEER_ID,
            enable_https=bool(cfg.enable_https),
            enable_basic_auth=bool(cfg.enable_basic_auth),
            basic_auth_user=cfg.basic_auth_user,
            basic_auth_password=cfg.basic_auth_password,
            # a down signalling server sees decaying, jittered retries
            # from inside connect(), not a fixed 2 s hammer
            retry_backoff=reconnect_backoff(),
        )
        self.webrtc.on_sdp = client.send_sdp
        self.webrtc.on_ice = client.send_ice

        async def call_retrying() -> None:
            await client.setup_call()

        async def on_error(exc: Exception) -> None:
            if isinstance(exc, SignallingErrorNoPeer):
                await asyncio.sleep(2.0)
                await client.setup_call()
            else:
                logger.warning("signalling client error: %s", exc)

        async def on_session(peer, meta) -> None:
            # per-client codec negotiation (signalling/negotiate.py): the
            # browser's HELLO meta carries its codec preference list;
            # resolve it before the offer so SDP, payloader and encoder
            # row agree end-to-end
            self._negotiate_codec(meta)
            await self.webrtc.start_session()
            # the fresh peer starts at the ladder's CURRENT protection
            # level (0 % on a clean link, not the static default)
            self.recovery.attach()

        client.on_connect = call_retrying
        client.on_error = on_error
        client.on_session = on_session
        client.on_sdp = lambda t, s: self.app.set_sdp(t, s)
        client.on_ice = lambda m, c: self.app.set_ice(m, c)

        async def rearm_watch() -> None:
            while True:
                await self._rearm_signalling.wait()
                self._rearm_signalling.clear()
                try:
                    await client.setup_call()
                except Exception as exc:
                    logger.warning("signalling re-arm failed: %r (will "
                                   "retry on next re-arm)", exc)

        rearm = asyncio.get_running_loop().create_task(rearm_watch())
        try:
            # shared reconnect loop: capped exponential backoff + jitter
            # instead of a fixed 2 s beat (signalling/client.py)
            await run_reconnect_loop(client, "internal signalling")
        finally:
            rearm.cancel()
            await client.stop()

    # ------------------------------------------------------------------

    async def run(self) -> None:
        cfg = self.cfg
        await wait_for_app_ready(cfg.app_ready_file, bool(cfg.app_wait_ready))

        stun_servers, turn_servers, rtc_config = await resolve_rtc_config(cfg)
        self.server.set_rtc_config(rtc_config)
        logger.info("RTC config resolved: stun=%s turn=%s", stun_servers, bool(turn_servers))
        # the server-side ICE agent uses the same resolved servers the
        # browser gets (reference passes them into webrtcbin, :149-160)
        self.webrtc.set_ice_servers(**_first_ice_servers(stun_servers, turn_servers))

        await self.server.start()
        await self.input.connect()

        def on_rtc_config(stun: str, turn: str, config: str) -> None:
            self.server.set_rtc_config(config)

        monitors = make_rtc_monitors(cfg, on_rtc_config)

        spawn = asyncio.get_running_loop().create_task
        self._tasks = [spawn(m.start()) for m in monitors]
        self._tasks.append(spawn(self.system_mon.start()))
        if self.device_mon is not None:
            self._tasks.append(spawn(self.device_mon.start()))
        self._tasks.append(spawn(self.input.start_clipboard()))
        self._tasks.append(spawn(self.input.start_cursor_monitor()))
        self._tasks.append(spawn(self._signalling_loop()))
        if cfg.enable_metrics_http:
            self._tasks.append(spawn(self.metrics.start_http()))

        if self.cluster is not None:
            await self.cluster.start()  # membership heartbeats
        # SIGTERM/SIGINT route through the drain path (lifecycle.py)
        # instead of abrupt cancellation
        from selkies_tpu_torch.parallel.lifecycle import install_signal_handlers

        self._uninstall_signals = install_signal_handlers(self.drain)
        logger.info(
            "selkies-tpu (torch) ready on %s:%s (encoder=%s, device=%s, transport=ws+webrtc)",
            cfg.addr, cfg.port, cfg.encoder, self.device,
        )
        try:
            await self.server.run()
        finally:
            await self.shutdown()

    async def shutdown(self) -> None:
        if self._uninstall_signals is not None:
            self._uninstall_signals()
            self._uninstall_signals = None
        if self.cluster is not None:
            await self.cluster.stop()
        await self.webrtc.stop_session()
        await self._stop_session()
        self.system_mon.stop()
        if self.device_mon is not None:
            self.device_mon.stop()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        await self.input.disconnect()
        await self.server.stop()


async def main(argv: list[str] | None = None, *, device=None) -> None:
    cfg = parse_config(argv)
    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if int(cfg.tpu_sessions) > 1:
        # fleet mode: N sessions off one batched device step
        # (parallel/fleet.py) on the caller's device
        from selkies_tpu_torch.parallel.fleet import FleetOrchestrator

        devices = None if device is None else [resolve_device(device)]
        await FleetOrchestrator(cfg, devices=devices).run()
        return
    await Orchestrator(cfg, device=device).run()


def entrypoint() -> None:
    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    entrypoint()
