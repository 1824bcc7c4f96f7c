"""Orchestrator of the port — for now only the pieces a fleet slot uses.

Counterpart of ``selkies_tpu/orchestrator.py``. This slice copies
``TransportMux`` (``orchestrator.py:109-176``), the app-facing transport
that fronts a slot's WebSocket and WebRTC planes, and ``_loss_counters``
(``:286-310``), the loss extraction from a client's RTCStats upload. It adds
``AbsentPeerPlane``, the peer plane a slot holds until the port has a WebRTC
stack. The solo ``Orchestrator`` (config → TURN chain → signalling server →
app), its helpers and ``__main__.py`` are a later slice: they build a
``WebRTCTransport``, the signalling server and the input host, none of which
the port has yet.
"""

from __future__ import annotations

import asyncio
import json
import logging

from selkies_tpu_torch.resilience import get_injector

logger = logging.getLogger("orchestrator")

__all__ = ["AbsentPeerPlane", "TransportMux"]


class AbsentPeerPlane:
    """The WebRTC plane of a slot while the port has no WebRTC stack
    (ROADMAP queue 1, item 3.3): never connected, no data channel, nothing
    sent. With it ``TransportMux`` routes media and control to the
    WebSocket plane, as JAX's mux does while no peer is connected, so the
    bytes that plane carries are the same. ``set_codec`` records the codec;
    the offer/answer calls raise."""

    connected = False
    data_channel_ready = False
    frames_sent = 0
    bytes_sent = 0

    def __init__(self) -> None:
        self.codec = "h264"

    def set_codec(self, codec: str) -> None:
        self.codec = codec

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
