"""Configuration system: CLI flags ⇄ SELKIES_* env vars ⇄ JSON overlay.

The port's copy of ``selkies_tpu/config.py``, unchanged: the same flag
table, so the fleet and the later server read the same settings.

Parity target: the reference's three equivalent config layers
(selkies_gstreamer/__main__.py:337-540) — every CLI flag
has a ``SELKIES_<UPPERNAME>`` environment default, and a small set of
runtime-mutable settings (framerate, video/audio bitrate, enable_resize,
encoder) round-trips through a JSON config file so UI changes persist across
reconnects (reference ``set_json_app_argument`` __main__.py:303-333).

This implementation is declarative instead of 500 lines of argparse calls:
a single ``FLAGS`` table drives argparse construction, env defaulting, JSON
overlay, and documentation.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Callable

logger = logging.getLogger("config")

ENV_PREFIX = "SELKIES_"

# Settings the client may mutate at runtime; they persist via the JSON config
# overlay (reference __main__.py:522-540).
JSON_MUTABLE = (
    "framerate",
    "video_bitrate",
    "audio_bitrate",
    "enable_resize",
    "encoder",
)


def _boolish(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    help: str
    type: Callable[[str], Any] = str

    @property
    def env(self) -> str:
        return ENV_PREFIX + self.name.upper()


def _f(name: str, default: Any, help: str, type: Callable[[str], Any] | None = None) -> Flag:
    if type is None:
        if isinstance(default, bool):
            type = _boolish
        elif isinstance(default, int):
            type = int
        elif isinstance(default, float):
            type = float
        else:
            type = str
    return Flag(name=name, default=default, help=help, type=type)


# One row per reference flag (__main__.py:337-520), plus TPU-specific flags at
# the end. Defaults mirror the reference where observable.
FLAGS: tuple[Flag, ...] = (
    # network / web
    _f("addr", "0.0.0.0", "Host for the signalling/web server to listen on."),
    _f("port", 8080, "Port for the signalling/web server."),
    _f("web_root", "", "Path to web client root (default: bundled web/ dir)."),
    _f("enable_https", False, "Serve signalling/web over TLS."),
    _f("https_cert", "/etc/ssl/certs/ssl-cert-snakeoil.pem", "TLS certificate path."),
    _f("https_key", "/etc/ssl/private/ssl-cert-snakeoil.key", "TLS key path."),
    _f("enable_basic_auth", False, "Require HTTP basic auth on web/signalling."),
    _f("basic_auth_user", os.environ.get("USER", "selkies"), "Basic auth username."),
    _f("basic_auth_password", "", "Basic auth password (required when enabled)."),
    # STUN/TURN
    _f("stun_host", "stun.l.google.com", "Fallback STUN hostname."),
    _f("stun_port", 19302, "Fallback STUN port."),
    _f("turn_host", "", "TURN server hostname."),
    _f("turn_port", 3478, "TURN server port."),
    _f("turn_protocol", "udp", "TURN transport protocol: udp or tcp."),
    _f("turn_tls", False, "Use TURN over TLS."),
    _f("turn_tls_insecure", False,
       "Skip TLS certificate verification for turns:// (self-signed coturn "
       "fleets / raw-IP TURN hosts whose certs cannot verify)."),
    _f("turn_username", "", "Legacy long-term TURN username."),
    _f("turn_password", "", "Legacy long-term TURN password."),
    _f("turn_shared_secret", "", "HMAC shared secret for short-term TURN credentials."),
    _f("turn_rest_uri", "", "TURN REST API endpoint returning RTC config."),
    _f("turn_rest_username", os.environ.get("USER", "selkies"), "Username sent to TURN REST API."),
    _f("turn_rest_username_auth_header", "x-auth-user", "Header carrying the TURN REST username."),
    _f("turn_rest_protocol_header", "x-turn-protocol", "Header carrying the TURN protocol."),
    _f("turn_rest_tls_header", "x-turn-tls", "Header carrying the TURN TLS flag."),
    _f("enable_cloudflare_turn", False, "Fetch TURN credentials from Cloudflare Calls."),
    _f("cloudflare_turn_token_id", "", "Cloudflare TURN token id."),
    _f("cloudflare_turn_api_token", "", "Cloudflare TURN API token."),
    _f("rtc_config_json", "/tmp/rtc.json", "Path to an RTC config JSON file (watched for changes)."),
    # app lifecycle
    _f("app_ready_file", "/run/appconfig/appready", "Sidecar readiness file to wait for."),
    _f("app_wait_ready", False, "Wait for app_ready_file before starting."),
    # media
    _f("encoder", "tpuh264enc", "Video encoder element (see models.registry; reference gstwebrtc_app.py:1133)."),
    _f("framerate", 60, "Capture/encode framerate."),
    _f("video_bitrate", 2000, "Video bitrate in kbps."),
    _f("audio_bitrate", 320000, "Audio bitrate in bps."),
    _f("audio_channels", 2, "Audio channel count."),
    _f("video_packetloss_percent", 0.0, "Video FEC percentage."),
    _f("audio_packetloss_percent", 0.0, "Audio FEC (Opus in-band) percentage."),
    _f("congestion_control", False, "Enable GCC congestion control driving the encoder rate controller."),
    _f("keyframe_distance", -1.0, "Keyframe distance in seconds (-1 = infinite GOP)."),
    # input / desktop integration
    _f("enable_clipboard", "true", "Clipboard sync: true|false|in|out."),
    _f("audio_device", "", "PulseAudio source device to capture (empty = server default monitor)."),
    _f("enable_cursors", True, "Forward X cursor changes to the client."),
    _f("cursor_size", -1, "XFCE cursor size."),
    _f("debug_cursors", False, "Log cursor change events."),
    _f("enable_resize", False, "Resize the X display to match the client window."),
    _f("js_socket_path", "/tmp", "Directory for gamepad unix sockets (selkies_js{0-3}.sock)."),
    _f("uinput_mouse_socket", "", "Path to a uinput mouse msgpack socket (container mode)."),
    # observability
    _f("enable_metrics_http", False, "Enable the Prometheus metrics HTTP server."),
    _f("metrics_http_port", 8000, "Prometheus metrics port."),
    _f("enable_webrtc_statistics", False, "Dump client WebRTC stats to CSV."),
    _f("webrtc_statistics_dir", "/tmp/webrtc_statistics", "Directory for WebRTC stats CSV files."),
    # config file
    _f("json_config", "/tmp/selkies_config.json", "JSON config overlay path (runtime-mutable settings)."),
    # legacy GPU flag kept for CLI compatibility; ignored by the TPU path
    _f("gpu_id", 0, "Legacy GPU index (ignored; present for CLI compatibility)."),
    # TPU-native additions
    _f("capture_width", 1280, "Capture width when no X display drives resolution (synthetic source)."),
    _f("capture_height", 720, "Capture height when no X display drives resolution (synthetic source)."),
    _f("tpu_device", 0, "TPU chip index this session's encode stream is placed on."),
    _f("tpu_sessions", 1, "Concurrent sessions to place across the TPU mesh (1 chip per stream)."),
    _f("session_displays", "", "Fleet mode: csv of X DISPLAY names, one per session (e.g. ':10,:11'); sessions beyond the list use synthetic sources."),
    _f("session_audio_devices", "", "Fleet mode: csv of PulseAudio source devices, one per session (e.g. 'sink10.monitor,sink11.monitor'); sessions with an empty entry or beyond the list get NO audio (a shared default monitor would leak audio across users)."),
    _f("transport", "auto", "Media transport: auto|webrtc|websocket."),
    _f("debug", False, "Verbose debug logging."),
)

_FLAGS_BY_NAME = {fl.name: fl for fl in FLAGS}


@dataclass
class Config:
    """Resolved configuration; attribute access per flag name."""

    values: dict[str, Any] = field(default_factory=dict)

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["values"][name]
        except KeyError:
            raise AttributeError(name) from None

    # --- JSON overlay (reference set_json_app_argument __main__.py:303-333) ---

    def set_json_setting(self, name: str, value: Any) -> None:
        """Persist a runtime-mutable setting to the JSON config overlay."""
        if name not in JSON_MUTABLE:
            raise ValueError(f"setting {name!r} is not runtime-mutable")
        self.values[name] = value
        path = self.values["json_config"]
        data: dict[str, Any] = {}
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    data = json.load(fh)
            except (ValueError, OSError):
                logger.warning("could not read JSON config %s; overwriting", path)
        data[name] = value
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, path)

    def apply_json_overlay(self) -> None:
        path = self.values.get("json_config")
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (ValueError, OSError) as exc:
            logger.warning("ignoring unreadable JSON config %s: %s", path, exc)
            return
        for key, value in data.items():
            if key in JSON_MUTABLE:
                fl = _FLAGS_BY_NAME[key]
                self.values[key] = fl.type(value) if not isinstance(value, bool) else value


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="selkies-tpu",
        description="TPU-native WebRTC remote desktop streaming server.",
    )
    for fl in FLAGS:
        env_val = os.environ.get(fl.env)
        default = fl.type(env_val) if env_val is not None else fl.default
        parser.add_argument(
            f"--{fl.name}",
            default=default,
            type=fl.type,
            help=f"{fl.help} [env: {fl.env}]",
        )
    return parser


def parse_config(argv: list[str] | None = None) -> Config:
    args = build_parser().parse_args(argv)
    cfg = Config(values=vars(args))
    cfg.apply_json_overlay()
    return cfg
