"""The app-facing transport of a session: ``TransportMux`` over its
WebSocket and WebRTC planes, and ``AbsentPeerPlane``, the WebRTC plane
while the port has no WebRTC stack.

``TransportMux`` is the port's copy of JAX's (``selkies_tpu/orchestrator.py``
lines 109-176); ``orchestrator.py`` re-exports both names. They live here
so that ``parallel/fleet.py`` imports them without the server stack
(aiohttp, prometheus_client, psutil) that ``orchestrator.py`` imports.
"""

from __future__ import annotations

import asyncio
import logging

from selkies_tpu_torch.resilience import get_injector

logger = logging.getLogger("orchestrator")

__all__ = ["AbsentPeerPlane", "TransportMux"]


class AbsentPeerPlane:
    """The WebRTC plane while the port has no WebRTC stack (ROADMAP queue
    1, item 3.3): never connected, no data channel, nothing sent. With it
    ``TransportMux`` routes media and control to the WebSocket plane, as
    JAX's mux does while no peer is connected, so the bytes that plane
    carries are the same.

    Every member the solo orchestrator and a fleet slot touch is here and
    inert: ``set_codec`` records the codec and profile,
    ``set_fec_percentage`` and ``set_ice_servers`` record their arguments,
    ``start_session`` logs that no peer plane exists and makes no offer,
    ``stop_session`` does nothing, and the callbacks (``on_connect``,
    ``on_disconnect``, ``on_data_message``, ``on_force_keyframe``,
    ``on_video_sent``, ``on_video_acked``, ``on_loss``, ``on_nack``,
    ``on_unrecoverable``, ``on_sdp``, ``on_ice``) are stored and never
    called. ``set_remote_sdp`` / ``add_remote_ice`` raise."""

    connected = False
    data_channel_ready = False
    frames_sent = 0
    bytes_sent = 0

    def __init__(self) -> None:
        self.codec = "h264"
        self.h264_profile = "baseline"
        self.fec_percentage: int | None = None
        self.ice_servers: dict = {}
        self.on_connect = self.on_disconnect = self.on_data_message = None
        self.on_force_keyframe = self.on_video_sent = self.on_video_acked = None
        self.on_loss = self.on_nack = self.on_unrecoverable = None
        self.on_sdp = self.on_ice = None

    def set_codec(self, codec: str, h264_profile: str = "baseline") -> None:
        self.codec, self.h264_profile = codec, h264_profile

    def set_fec_percentage(self, pct: int) -> None:
        self.fec_percentage = int(pct)

    def set_ice_servers(self, **kw) -> None:
        self.ice_servers = kw

    async def start_session(self) -> None:
        logger.info("no WebRTC peer plane in the port (ROADMAP queue 1, item 3.3); "
                    "no offer made, media stays on the /media WebSocket")

    async def stop_session(self) -> None:
        pass

    def set_remote_sdp(self, sdp_type: str, sdp: str) -> None:
        raise NotImplementedError(
            "no WebRTC plane in the port yet (ROADMAP queue 1, item 3.3)")

    def add_remote_ice(self, mlineindex: int, candidate: str) -> None:
        raise NotImplementedError(
            "no WebRTC plane in the port yet (ROADMAP queue 1, item 3.3)")


class TransportMux:
    """One app-facing Transport fronting both byte planes: WebRTC when a
    peer connection is up, the WebSocket fallback otherwise.

    ``fault_site`` names this mux's send injection point for the
    resilience harness (resilience/faultinject.py): solo mode uses
    "send", fleet slots use "send:<k>" so a schedule can target one
    session. With ``SELKIES_FAULTS`` unset the check is one None test."""

    def __init__(self, ws, rtc, fault_site: str = "send"):
        self.ws = ws
        self.rtc = rtc
        self.fault_site = fault_site

    @property
    def active(self):
        return self.rtc if self.rtc.connected else self.ws

    @property
    def _control(self):
        # media switches on DTLS-SRTP readiness, but control messages
        # need the DCEP channel — keep WS control until the browser has
        # actually opened 'input' over the peer connection
        return self.rtc if self.rtc.data_channel_ready else self.ws

    @property
    def data_channel_ready(self) -> bool:
        return self._control.data_channel_ready

    def send_data_channel(self, message: str) -> None:
        self._control.send_data_channel(message)

    async def send_video(self, ef) -> bool:
        """Returns False when the frame did not reach the client (socket
        gone, injected drop) so callers can count per-slot send failures;
        transports that can't tell report None → success."""
        fi = get_injector()
        if fi is not None:
            act = fi.check(self.fault_site)  # raises on a scheduled raise
            if act is not None:
                action, delay_ms = act
                if action == "drop":
                    return False
                if action == "delay":
                    await asyncio.sleep(delay_ms / 1000.0)
        ok = await self.active.send_video(ef)
        return ok is not False

    async def send_audio(self, ea) -> None:
        await self.active.send_audio(ea)

    # app.set_sdp/set_ice delegate here (pipeline/app.py:161-167)
    def set_remote_sdp(self, sdp_type: str, sdp: str) -> None:
        self.rtc.set_remote_sdp(sdp_type, sdp)

    def add_remote_ice(self, mlineindex: int, candidate: str) -> None:
        self.rtc.add_remote_ice(mlineindex, candidate)

    @property
    def frames_sent(self) -> int:
        return self.ws.frames_sent + self.rtc.frames_sent

    @property
    def bytes_sent(self) -> int:
        return self.ws.bytes_sent + self.rtc.bytes_sent
