"""WebSocket media transport.

The port's copy of ``selkies_tpu/transport/websocket.py``, on the port's
telemetry bus and tracer. It imports ``aiohttp`` at module top, as JAX's
does; ``parallel/fleet.py`` imports it only when a slot is built without a
WebSocket plane.

The reference's byte plane is webrtcbin (ICE+DTLS+SRTP+SCTP).  This
transport is the framework's always-available fallback and test plane: one
WebSocket carries both the media stream (binary messages) and the data
channel (text messages), multiplexed by message type.  The browser client
plays the video messages with WebCodecs (H.264 Annex-B) and treats text
messages exactly like RTCDataChannel payloads, so every protocol above
this layer (input vocabulary, stats, clipboard, cursor, system actions) is
identical to the WebRTC path.

Binary frame layout (network order):
    u8  kind      1=video 2=audio
    u8  flags     bit0 = keyframe (IDR)
    u16 seq       video: per-frame sequence (congestion-control feedback
                  key: the client echoes `_ack,<seq>,<recv_ms>`); audio: 0
    u32 timestamp video: 90 kHz clock; audio: 48 kHz sample clock
    ... payload   video: Annex-B access unit; audio: Opus packet
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Any, Awaitable, Callable

from aiohttp import WSMsgType, web

from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.monitoring.tracing import tracer

logger = logging.getLogger("transport.ws")

HEADER = struct.Struct("!BBHI")
KIND_VIDEO = 1
KIND_AUDIO = 2
FLAG_KEYFRAME = 1


def pack_media_frame(kind: int, flags: int, timestamp: int, payload: bytes, seq: int = 0) -> bytes:
    return HEADER.pack(kind, flags, seq & 0xFFFF, timestamp & 0xFFFFFFFF) + payload


def parse_media_frame(data: bytes) -> tuple[int, int, int, bytes]:
    kind, flags, _, ts = HEADER.unpack_from(data)
    return kind, flags, ts, data[HEADER.size :]


def parse_media_frame_seq(data: bytes) -> int:
    return HEADER.unpack_from(data)[2]


class WebSocketTransport:
    """Server side of the WS media plane; implements the app Transport
    protocol (pipeline/app.py) and registers under /media on the web
    server."""

    def __init__(self) -> None:
        self._ws: web.WebSocketResponse | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self.on_data_message: Callable[[str], Awaitable[None] | None] = lambda m: None
        self.on_connect: Callable[[], Any] = lambda: None
        self.on_disconnect: Callable[[], Any] = lambda: None
        # congestion control taps (GccController.on_frame_sent wiring)
        self.on_video_sent: Callable[[int, float, int], None] = lambda seq, ms, size: None
        self.frames_sent = 0
        self.bytes_sent = 0
        self._video_seq = 0
        # telemetry session label (fleet sets its slot index; solo = "0")
        self.session = "0"

    # -- Transport protocol -------------------------------------------

    @property
    def data_channel_ready(self) -> bool:
        return self._ws is not None and not self._ws.closed

    async def close(self) -> None:
        """Server-initiated disconnect (admission refused, drain): close
        the live socket; the connection handler's finally runs the
        normal on_disconnect path."""
        ws = self._ws
        if ws is not None and not ws.closed:
            await ws.close()

    def send_data_channel(self, message: str) -> None:
        """Callable from the event loop or worker threads (reference
        bridges with run_coroutine_threadsafe, gstwebrtc_app.py:1792)."""
        ws, loop = self._ws, self._loop
        if ws is None or ws.closed or loop is None:
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        coro = self._safe_send_str(ws, message)
        if running is loop:
            loop.create_task(coro)
        else:
            asyncio.run_coroutine_threadsafe(coro, loop)

    @staticmethod
    async def _safe_send_str(ws: web.WebSocketResponse, message: str) -> None:
        try:
            await ws.send_str(message)
        except (ConnectionError, RuntimeError):
            pass

    async def send_video(self, ef) -> bool:
        """EncodedFrame (pipeline/elements.py) → binary WS message.
        Returns False when the client is gone / the socket failed so the
        fleet's per-slot send accounting sees it (parallel/fleet.py)."""
        flags = FLAG_KEYFRAME if ef.idr else 0
        seq = self._video_seq = (self._video_seq + 1) & 0xFFFF
        # sample the send clock BEFORE the await: under TCP backpressure
        # send_bytes blocks until the socket drains, and enqueue-time deltas
        # are what let the trendline see the queue growing (congestion would
        # otherwise inflate Δsend to match Δrecv and hide itself)
        send_ms = time.monotonic() * 1000.0
        # register with the estimator BEFORE the await: under backpressure
        # the client's ack can arrive while send_bytes is still draining,
        # and an ack for an unregistered seq would be dropped. A frame that
        # fails to send leaves a stale entry, which simply ages out.
        self.on_video_sent(seq, send_ms, len(ef.au) + HEADER.size)
        tele = telemetry.enabled
        if tele:
            # seq -> frame-id so the client's ack correlates back to the
            # frame's capture/encode events (congestion.on_frame_ack)
            telemetry.map_seq(self.session, seq, getattr(ef, "frame_id", 0))
            t0 = time.perf_counter()
        with tracer.span("ws-send"):
            ok = await self._send_binary(
                pack_media_frame(KIND_VIDEO, flags, ef.timestamp_90k, ef.au, seq))
        if tele:
            telemetry.stage_ms("ws-send", (time.perf_counter() - t0) * 1e3,
                               session=self.session,
                               frame=getattr(ef, "frame_id", 0),
                               seq=seq, bytes=len(ef.au), ok=ok)
        return ok

    async def send_audio(self, ea) -> None:
        """EncodedAudio (audio/pipeline.py) → binary WS message."""
        await self._send_binary(pack_media_frame(KIND_AUDIO, 0, ea.timestamp_48k, ea.packet))

    async def _send_binary(self, data: bytes) -> bool:
        ws = self._ws
        if ws is None or ws.closed:
            return False
        try:
            await ws.send_bytes(data)
            self.frames_sent += 1
            self.bytes_sent += len(data)
            return True
        except (ConnectionError, RuntimeError):
            logger.info("media send failed; client gone")
            return False

    # -- aiohttp endpoint ---------------------------------------------

    async def handle_connection(self, request: web.Request) -> web.WebSocketResponse:
        """Register under the web server's ws_routes as the /media path."""
        ws = web.WebSocketResponse(heartbeat=20.0, max_msg_size=32 * 1024 * 1024)
        await ws.prepare(request)
        if self._ws is not None and not self._ws.closed:
            logger.info("replacing existing media client")
            await self._ws.close()
        self._ws = ws
        self._loop = asyncio.get_running_loop()
        logger.info("media client connected from %s", request.remote)
        try:
            result = self.on_connect()
            if asyncio.iscoroutine(result):
                await result
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    result = self.on_data_message(msg.data)
                    if asyncio.iscoroutine(result):
                        await result
                # binary upstream messages are not part of the protocol
        finally:
            if self._ws is ws:
                self._ws = None
                result = self.on_disconnect()
                if asyncio.iscoroutine(result):
                    await result
            logger.info("media client disconnected")
        return ws
