"""Signalling + web server.

The port's copy of ``selkies_tpu/signalling/server.py``: its lazy imports
of the telemetry bus, the tracer and the fault injector point at the
port's.

One aiohttp process serving, wire-compatible with the reference
``WebRTCSimpleServer`` (signalling_web.py:92):

* WebSocket signalling at ``/ws`` and ``*/signalling`` — the text protocol
  ``HELLO <uid> [meta64]`` / ``SESSION <peer>`` / ``SESSION_OK <meta64>`` /
  ``ROOM`` commands / verbatim relay of JSON ``{"sdp":…}`` ``{"ice":…}``
  (signalling_web.py:374-498).
* Static file serving from ``web_root`` with a TTL in-memory cache
  (signalling_web.py:170-176, 296-319).
* ``/health`` (200 OK), ``/turn`` returning RTC-config JSON from the HMAC
  shared secret, a pre-set config blob, or a STUN-only fallback
  (signalling_web.py:257-294).
* CORS on every response incl. OPTIONS preflight (signalling_web.py:211-234),
  optional basic auth (exempting ``/turn``), optional TLS with
  restart-on-certificate-change (signalling_web.py:579-599).

The implementation is aiohttp-native (middlewares + catch-all routing)
rather than a translation of the reference's websockets.serve hooks.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import mimetypes
import os
import ssl
import time
from dataclasses import dataclass, field
from typing import Any

from aiohttp import WSMsgType, web

from selkies_tpu_torch.signalling.turn import generate_rtc_config, stun_only_rtc_config

logger = logging.getLogger("signalling.server")
web_logger = logging.getLogger("signalling.web")

MIME_TYPES = {
    ".html": "text/html",
    ".js": "text/javascript",
    ".css": "text/css",
    ".ico": "image/x-icon",
    ".json": "application/json",
    ".wasm": "application/wasm",
    ".svg": "image/svg+xml",
    ".png": "image/png",
}


@dataclass
class SignallingOptions:
    addr: str = "0.0.0.0"
    port: int = 8443
    web_root: str = ""
    keepalive_timeout: float = 30.0
    health_path: str = "/health"
    cache_ttl: float = 300.0
    # TURN
    turn_shared_secret: str = ""
    turn_host: str = ""
    turn_port: str = ""
    turn_protocol: str = "udp"
    turn_tls: bool = False
    turn_auth_header_name: str = "x-auth-user"
    stun_host: str = "stun.l.google.com"
    stun_port: str = "19302"
    rtc_config: str = ""
    rtc_config_file: str = "/tmp/rtc.json"
    # auth / TLS
    enable_basic_auth: bool = False
    basic_auth_user: str = ""
    basic_auth_password: str = ""
    enable_https: bool = False
    https_cert: str = ""
    https_key: str = ""
    cert_restart: bool = False

    def __post_init__(self) -> None:
        if self.turn_protocol.lower() != "tcp":
            self.turn_protocol = "udp"
        else:
            self.turn_protocol = "tcp"
        if self.turn_shared_secret and not (self.turn_host and self.turn_port):
            raise ValueError("turn_shared_secret requires turn_host and turn_port")
        if self.enable_basic_auth and not self.basic_auth_password:
            raise ValueError("enable_basic_auth requires basic_auth_password")


class _Peer:
    __slots__ = ("uid", "ws", "addr", "status", "meta")

    def __init__(self, uid: str, ws: web.WebSocketResponse, addr: Any, meta: Any):
        self.uid = uid
        self.ws = ws
        self.addr = addr
        self.status: str | None = None  # None | 'session' | room_id
        self.meta = meta


def _is_ws_path(path: str) -> bool:
    return path in ("/ws", "/ws/") or path.rstrip("/").endswith("/signalling")


class SignallingServer:
    """Combined HTTP + WebSocket signalling server."""

    def __init__(self, options: SignallingOptions):
        self.options = options
        # extra WebSocket endpoints (e.g. the /media transport) registered by
        # the orchestrator: path-prefix -> async handler(request) -> response
        self.ws_routes: dict[str, Any] = {}
        # multi-host admission (selkies_tpu/cluster): when wired, every
        # client HELLO that carries meta (browsers always do — backend
        # planes never do) is routed — serve locally, or answer with a
        # REDIRECT record the client's reconnect loop follows
        self.cluster_router = None
        self.peers: dict[str, _Peer] = {}
        self.sessions: dict[str, str] = {}
        self.rooms: dict[str, set[str]] = {}
        self._http_cache: dict[str, tuple[bytes, float]] = {}
        self._runner: web.AppRunner | None = None
        self._stopped: asyncio.Future | None = None
        self._cert_mtime: float = -1.0
        self.rtc_config: str = options.rtc_config
        if options.rtc_config_file and os.path.exists(options.rtc_config_file):
            logger.info("loading rtc_config_file: %s", options.rtc_config_file)
            with open(options.rtc_config_file) as f:
                self.rtc_config = f.read()

    # ------------------------------------------------------------------
    # HTTP plane

    def set_rtc_config(self, rtc_config: str) -> None:
        self.rtc_config = rtc_config

    def _cors_headers(self, request: web.Request | None) -> dict[str, str]:
        origin = request.headers.get("Origin") if request is not None else None
        headers = {
            "Access-Control-Allow-Methods": "GET, POST, PUT, DELETE, OPTIONS",
            "Access-Control-Max-Age": "86400",
        }
        if origin:
            headers["Access-Control-Allow-Origin"] = origin
            headers["Access-Control-Allow-Credentials"] = "true"
        else:
            headers["Access-Control-Allow-Origin"] = "*"
        headers["Access-Control-Allow-Headers"] = ", ".join(
            ["Content-Type", "Authorization", self.options.turn_auth_header_name]
        )
        return headers

    def _check_basic_auth(self, request: web.Request) -> bool:
        auth = request.headers.get("Authorization", "")
        if not auth.lower().startswith("basic "):
            return False
        try:
            decoded = base64.b64decode(auth.split(None, 1)[1]).decode()
            user, _, password = decoded.partition(":")
        except Exception:
            return False
        return user == self.options.basic_auth_user and password == self.options.basic_auth_password

    async def _cached_read(self, full_path: str) -> bytes:
        entry = self._http_cache.get(full_path)
        now = time.time()
        if entry is not None and now - entry[1] < self.options.cache_ttl:
            return entry[0]
        data = await asyncio.to_thread(lambda: open(full_path, "rb").read())
        self._http_cache[full_path] = (data, now)
        return data

    async def _handle_http(self, request: web.Request) -> web.StreamResponse:
        opts = self.options
        path = request.path
        cors = self._cors_headers(request)

        if request.method == "OPTIONS":
            return web.Response(status=200, headers=cors)

        for prefix, handler in self.ws_routes.items():
            if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                return await handler(request)

        if _is_ws_path(path):
            return await self._handle_ws(request)

        # basic auth gates everything except the TURN credential endpoint
        # and the k8s liveness probe (probes cannot carry credentials)
        if opts.enable_basic_auth and path.rstrip("/") not in ("/turn", "/healthz"):
            if not self._check_basic_auth(request):
                hdrs = dict(cors)
                hdrs["WWW-Authenticate"] = 'Basic realm="restricted, charset="UTF-8"'
                return web.Response(status=401, text="Unauthorized", headers=hdrs)

        if path.rstrip("/") == opts.health_path or path == opts.health_path + "/":
            return web.Response(status=200, text="OK\n", headers=cors)

        if path.rstrip("/") == "/turn":
            return self._serve_turn(request, cors)

        if path.rstrip("/") == "/trace":
            return self._serve_trace(request, cors)

        if path.rstrip("/") == "/statz":
            return self._serve_statz(request, cors)

        if path.rstrip("/") == "/healthz":
            return self._serve_healthz(request, cors)

        return await self._serve_static(request, cors)

    def _serve_trace(self, request: web.Request, cors: dict[str, str]) -> web.Response:
        """First-party pipeline tracer dump (monitoring/tracing.py):
        default is the per-stage summary; ?format=chrome returns a
        chrome://tracing / Perfetto-loadable trace-event document;
        ?reset=1 clears the ring after the dump. Requires tracing to be
        enabled (SELKIES_TRACING=1), else 404s like any unknown path."""
        from selkies_tpu_torch.monitoring.tracing import tracer

        headers = dict(cors)
        if not tracer.enabled:
            headers["Content-Type"] = "text/plain"
            return web.Response(
                status=404, headers=headers,
                text="tracing disabled (set SELKIES_TRACING=1)\n")
        headers["Content-Type"] = "application/json"
        if request.query.get("format") == "chrome":
            body = tracer.chrome_trace()
        else:
            body = json.dumps(tracer.summary(), indent=2)
        if request.query.get("reset") in ("1", "true"):
            tracer.reset()
        return web.Response(status=200, text=body, headers=headers)

    def _serve_statz(self, request: web.Request, cors: dict[str, str]) -> web.Response:
        """Telemetry rollup (monitoring/telemetry.py): per-stage latency
        histograms, counters (tile cache, supervisor ladder, faults),
        congestion gauges, live link bytes, and slot health as one JSON
        document — pretty-printed by tools/statz.py. 404s with a hint
        when telemetry is off (SELKIES_TELEMETRY=1), like /trace."""
        from selkies_tpu_torch.monitoring.telemetry import telemetry

        headers = dict(cors)
        if not telemetry.enabled:
            headers["Content-Type"] = "text/plain"
            return web.Response(
                status=404, headers=headers,
                text="telemetry disabled (set SELKIES_TELEMETRY=1)\n")
        headers["Content-Type"] = "application/json"
        return web.Response(status=200, text=telemetry.statz_json(),
                            headers=headers)

    def _serve_healthz(self, request: web.Request, cors: dict[str, str]) -> web.Response:
        """Supervisor rung / watchdog summary shaped for k8s probes:
        200 while every slot is healthy or degraded-but-serving, 503
        once a slot hits the RECYCLE rung — and 503 for the whole
        drain window (parallel/lifecycle.DrainController), so a load
        balancer stops routing new clients the moment the preStop path
        begins; the body's ``lifecycle`` block carries the per-slot
        drain/placement state (serving/busy/lent/queued). Works with
        telemetry metric emission off — supervisors and the drain
        controller register unconditionally.

        The path is basic-auth exempt so probes work, but an
        unauthenticated caller only gets the status word — the per-slot
        ladder internals (slot names, failure counters) stay behind
        auth with the rest of the server."""
        from selkies_tpu_torch.monitoring.telemetry import telemetry

        health = telemetry.health()
        headers = dict(cors)
        headers["Content-Type"] = "application/json"
        status = 503 if health["status"] in ("down", "draining") else 200
        if self.options.enable_basic_auth and not self._check_basic_auth(request):
            health = {"status": health["status"]}
        return web.Response(status=status, text=json.dumps(health, indent=2),
                            headers=headers)

    def _serve_turn(self, request: web.Request, cors: dict[str, str]) -> web.Response:
        opts = self.options
        if opts.turn_shared_secret:
            user = request.headers.get(opts.turn_auth_header_name) or "webrtc-user"
            body = generate_rtc_config(
                opts.turn_host, opts.turn_port, opts.turn_shared_secret, user,
                opts.turn_protocol, opts.turn_tls, opts.stun_host, opts.stun_port,
            )
        elif self.rtc_config:
            body = self.rtc_config
        else:
            web_logger.info("GET /turn - no TURN configured, STUN-only config")
            body = stun_only_rtc_config(opts.stun_host, opts.stun_port)
        headers = dict(cors)
        headers["Content-Type"] = "application/json"
        return web.Response(status=200, body=body.encode() if isinstance(body, str) else body, headers=headers)

    async def _serve_static(self, request: web.Request, cors: dict[str, str]) -> web.Response:
        root = os.path.realpath(self.options.web_root) if self.options.web_root else None
        path = request.path.split("?")[0]
        if path == "/":
            path = "/index.html"
        headers = dict(cors)
        if root is None:
            headers["Content-Type"] = "text/html"
            return web.Response(status=404, body=b"404 NOT FOUND", headers=headers)
        full_path = os.path.realpath(os.path.join(root, path.lstrip("/")))
        if (
            os.path.commonpath((root, full_path)) != root
            or not os.path.isfile(full_path)
        ):
            headers["Content-Type"] = "text/html"
            web_logger.info("GET %s 404", path)
            return web.Response(status=404, body=b"404 NOT FOUND", headers=headers)
        ext = os.path.splitext(full_path)[1]
        headers["Content-Type"] = MIME_TYPES.get(ext) or mimetypes.guess_type(full_path)[0] or "application/octet-stream"
        body = await self._cached_read(full_path)
        return web.Response(status=200, body=body, headers=headers)

    # ------------------------------------------------------------------
    # WebSocket signalling plane

    async def _handle_ws(self, request: web.Request) -> web.WebSocketResponse:
        ws = web.WebSocketResponse(heartbeat=self.options.keepalive_timeout)
        await ws.prepare(request)
        uid: str | None = None
        try:
            uid = await self._hello(ws, request)
            if uid is not None:
                await self._peer_loop(self.peers[uid])
        finally:
            if uid is not None:
                await self._remove_peer(uid)
        return ws

    async def _hello(self, ws: web.WebSocketResponse, request: web.Request) -> str | None:
        msg = await ws.receive()
        if msg.type != WSMsgType.TEXT:
            return None
        toks = msg.data.split(maxsplit=2)
        meta = None
        if len(toks) == 3 and toks[2]:
            try:
                meta = json.loads(base64.b64decode(toks[2]))
            except Exception:
                meta = None
        if len(toks) < 2 or toks[0] != "HELLO":
            await ws.close(code=1002, message=b"invalid protocol")
            return None
        uid = toks[1]
        if not uid or uid.split() != [uid]:
            await ws.close(code=1002, message=b"invalid peer uid")
            return None
        collision = uid in self.peers
        if self.cluster_router is not None and meta is not None:
            try:
                # a colliding uid is never a live local reconnect (that
                # peer is still registered and serving) — stock clients
                # all register as the same peer id, so a SECOND browser
                # knocking on an occupied host must go through capacity
                # routing (pin bypassed) instead of a bare uid error
                rd = self.cluster_router.route(
                    meta, uid="" if collision else uid)
            except Exception:
                logger.exception("cluster routing failed; serving locally")
                rd = None
            if rd is not None:
                # redirect instead of registering; a lost record (the
                # cluster:redirect fault site) still closes the socket,
                # so the client's reconnect loop retries and re-routes
                await self._send_redirect(ws, rd)
                await ws.close(code=1000, message=b"redirect")
                return None
        if collision:
            await ws.close(code=1002, message=b"invalid peer uid")
            return None
        self.peers[uid] = _Peer(uid, ws, request.remote, meta)
        logger.info("registered peer %r at %r meta=%s", uid, request.remote, meta)
        await ws.send_str("HELLO")
        return uid

    async def _send_redirect(self, ws, redirect) -> bool:
        """Ship one redirect record; the ``cluster:redirect`` fault
        site fires here (``drop`` = the record is lost in flight — the
        client must recover through its ordinary reconnect loop,
        ``delay:<ms>`` stretches delivery). True iff it was sent."""
        from selkies_tpu_torch.resilience import InjectedFault, get_injector

        fi = get_injector()
        if fi is not None:
            try:
                act = fi.check("cluster:redirect")
            except InjectedFault:
                return False
            if act is not None:
                kind, ms = act
                if kind in ("drop", "flap"):
                    logger.warning("redirect to %s LOST (injected)",
                                   redirect.host)
                    return False
                if kind == "delay":
                    await asyncio.sleep(ms / 1e3)
        await ws.send_str(redirect.to_wire())
        from selkies_tpu_torch.monitoring.telemetry import telemetry

        if telemetry.enabled:
            telemetry.count("selkies_cluster_redirects_total",
                            reason=redirect.reason or "?")
            telemetry.event("cluster", action="redirect",
                            to=redirect.host, reason=redirect.reason)
        return True

    async def redirect_peer(self, uid: str, redirect) -> bool:
        """Send a registered peer a redirect record and disconnect it
        (the migrate-off path: its session now lives on another host).
        True iff the peer existed and the record went out."""
        peer = self.peers.get(str(uid))
        if peer is None:
            return False
        try:
            sent = await self._send_redirect(peer.ws, redirect)
        except (ConnectionError, RuntimeError):
            sent = False
        await self._remove_peer(str(uid))
        return sent

    async def _peer_loop(self, peer: _Peer) -> None:
        ws = peer.ws
        async for msg in ws:
            if msg.type != WSMsgType.TEXT:
                continue
            data = msg.data
            if peer.status == "session":
                other = self.peers.get(self.sessions.get(peer.uid, ""))
                if other is not None:
                    await other.ws.send_str(data)
            elif peer.status is not None:
                await self._room_message(peer, data)
            elif data.startswith("SESSION"):
                await self._start_session(peer, data)
            elif data.startswith("ROOM"):
                await self._join_room(peer, data)
            else:
                logger.info("ignoring unknown message %r from %r", data, peer.uid)

    async def _start_session(self, peer: _Peer, data: str) -> None:
        parts = data.split(maxsplit=1)
        callee_id = parts[1] if len(parts) > 1 else ""
        callee = self.peers.get(callee_id)
        if callee is None:
            await peer.ws.send_str(f"ERROR peer {callee_id!r} not found")
            return
        if callee.status is not None:
            await peer.ws.send_str(f"ERROR peer {callee_id!r} busy")
            return
        meta64 = ""
        if callee.meta:
            meta64 = base64.b64encode(json.dumps(callee.meta).encode()).decode("ascii")
        await peer.ws.send_str(f"SESSION_OK {meta64}")
        logger.info("session %r -> %r", peer.uid, callee_id)
        peer.status = callee.status = "session"
        self.sessions[peer.uid] = callee_id
        self.sessions[callee_id] = peer.uid

    async def _join_room(self, peer: _Peer, data: str) -> None:
        parts = data.split(maxsplit=1)
        room_id = parts[1] if len(parts) > 1 else ""
        if room_id == "session" or room_id.split() != [room_id]:
            await peer.ws.send_str(f"ERROR invalid room id {room_id!r}")
            return
        members = self.rooms.setdefault(room_id, set())
        await peer.ws.send_str("ROOM_OK {}".format(" ".join(members)))
        peer.status = room_id
        members.add(peer.uid)
        for pid in members:
            if pid != peer.uid:
                await self._send_best_effort(pid, f"ROOM_PEER_JOINED {peer.uid}")

    async def _send_best_effort(self, uid: str, message: str) -> None:
        """A dead member's socket must not tear down the sender's loop."""
        peer = self.peers.get(uid)
        if peer is None:
            return
        try:
            await peer.ws.send_str(message)
        except (ConnectionError, RuntimeError):
            logger.info("dropping message to dead peer %r", uid)

    async def _room_message(self, peer: _Peer, data: str) -> None:
        room_id = peer.status
        if data.startswith("ROOM_PEER_MSG"):
            try:
                _, other_id, payload = data.split(maxsplit=2)
            except ValueError:
                await peer.ws.send_str("ERROR invalid msg, already in room")
                return
            other = self.peers.get(other_id)
            if other is None:
                await peer.ws.send_str(f"ERROR peer {other_id!r} not found")
                return
            if other.status != room_id:
                await peer.ws.send_str(f"ERROR peer {other_id!r} is not in the room")
                return
            await other.ws.send_str(f"ROOM_PEER_MSG {peer.uid} {payload}")
        else:
            await peer.ws.send_str("ERROR invalid msg, already in room")

    async def _cleanup_session(self, uid: str) -> None:
        other_id = self.sessions.pop(uid, None)
        if other_id is None:
            return
        logger.info("cleaned up %r session", uid)
        if self.sessions.pop(other_id, None) is not None:
            # Closing the partner resets its state so both sides renegotiate.
            other = self.peers.pop(other_id, None)
            if other is not None:
                logger.info("closing connection to %r", other_id)
                await other.ws.close()

    async def _cleanup_room(self, uid: str, room_id: str) -> None:
        members = self.rooms.get(room_id)
        if members is None or uid not in members:
            return
        members.discard(uid)
        for pid in list(members):
            await self._send_best_effort(pid, f"ROOM_PEER_LEFT {uid}")

    async def _remove_peer(self, uid: str) -> None:
        await self._cleanup_session(uid)
        peer = self.peers.pop(uid, None)
        if peer is not None:
            if peer.status and peer.status != "session":
                await self._cleanup_room(uid, peer.status)
            await peer.ws.close()
            logger.info("disconnected peer %r", uid)

    # ------------------------------------------------------------------
    # lifecycle

    def _ssl_context(self) -> ssl.SSLContext | None:
        opts = self.options
        if not opts.enable_https:
            return None
        ctx = ssl.create_default_context(purpose=ssl.Purpose.CLIENT_AUTH)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        ctx.load_cert_chain(opts.https_cert, keyfile=opts.https_key or None)
        return ctx

    def check_cert_changed(self) -> bool:
        opts = self.options
        try:
            mtime = max(os.stat(p).st_mtime for p in (opts.https_cert, opts.https_key) if p and os.path.isfile(p))
        except ValueError:
            return False
        if self._cert_mtime < 0:
            self._cert_mtime = mtime
            return False
        if mtime > self._cert_mtime:
            self._cert_mtime = mtime
            return True
        return False

    async def _watch_certs(self) -> None:
        while self.options.cert_restart:
            await asyncio.sleep(1.0)
            if self.check_cert_changed():
                logger.info("certificate changed, stopping server for restart")
                await self.stop()
                return

    async def start(self) -> None:
        """Bind and serve in the background (returns once listening)."""
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle_http)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.options.addr, self.options.port, ssl_context=self._ssl_context())
        await site.start()
        self._stopped = asyncio.get_running_loop().create_future()
        scheme = "https" if self.options.enable_https else "http"
        logger.info("listening on %s://%s:%s", scheme, self.options.addr, self.options.port)
        if self.options.cert_restart:
            asyncio.ensure_future(self._watch_certs())

    async def run(self) -> None:
        """Start and block until stop() (reference run loop parity)."""
        if self._runner is None:
            await self.start()
        assert self._stopped is not None
        await self._stopped

    async def stop(self) -> None:
        logger.info("stopping server...")
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        if self._stopped is not None and not self._stopped.done():
            self._stopped.set_result(True)

    @property
    def bound_port(self) -> int:
        """Actual bound port (useful when options.port == 0 in tests)."""
        assert self._runner is not None and self._runner.addresses
        return self._runner.addresses[0][1]


def entrypoint() -> None:
    """Console script: standalone signalling server (reference
    signalling_web.py:601-636 flag set)."""
    import argparse

    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--addr", default="0.0.0.0")
    parser.add_argument("--port", default=8443, type=int)
    parser.add_argument("--web_root", default=os.path.join(os.getcwd(), "web"), type=str)
    parser.add_argument("--rtc_config_file", default="/tmp/rtc.json", type=str)
    parser.add_argument("--rtc_config", default="", type=str)
    parser.add_argument("--turn_shared_secret", default="", type=str)
    parser.add_argument("--turn_host", default="", type=str)
    parser.add_argument("--turn_port", default="", type=str)
    parser.add_argument("--turn_protocol", default="udp", type=str)
    parser.add_argument("--enable_turn_tls", dest="turn_tls", action="store_true")
    parser.add_argument("--turn_auth_header_name", default="x-auth-user", type=str)
    parser.add_argument("--stun_host", default="stun.l.google.com", type=str)
    parser.add_argument("--stun_port", default="19302", type=str)
    parser.add_argument("--keepalive_timeout", default=30, type=int)
    parser.add_argument("--enable_https", action="store_true")
    parser.add_argument("--https_cert", default="/etc/ssl/certs/ssl-cert-snakeoil.pem", type=str)
    parser.add_argument("--https_key", default="/etc/ssl/private/ssl-cert-snakeoil.key", type=str)
    parser.add_argument("--health", default="/health")
    parser.add_argument("--restart_on_cert_change", dest="cert_restart", action="store_true")
    parser.add_argument("--enable_basic_auth", action="store_true")
    parser.add_argument("--basic_auth_user", default="")
    parser.add_argument("--basic_auth_password", default="")
    args = parser.parse_args()

    options = SignallingOptions(
        addr=args.addr, port=args.port, web_root=args.web_root,
        keepalive_timeout=args.keepalive_timeout, health_path=args.health,
        turn_shared_secret=args.turn_shared_secret, turn_host=args.turn_host,
        turn_port=args.turn_port, turn_protocol=args.turn_protocol,
        turn_tls=args.turn_tls, turn_auth_header_name=args.turn_auth_header_name,
        stun_host=args.stun_host, stun_port=args.stun_port,
        rtc_config=args.rtc_config, rtc_config_file=args.rtc_config_file,
        enable_basic_auth=args.enable_basic_auth, basic_auth_user=args.basic_auth_user,
        basic_auth_password=args.basic_auth_password, enable_https=args.enable_https,
        https_cert=args.https_cert, https_key=args.https_key, cert_restart=args.cert_restart,
    )
    logging.basicConfig(level=logging.INFO)
    asyncio.run(SignallingServer(options).run())


if __name__ == "__main__":
    entrypoint()
