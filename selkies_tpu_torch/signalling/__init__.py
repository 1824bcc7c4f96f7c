"""WebRTC signalling of the port: server (HTTP+WS+/turn), in-process
client, TURN credentials and their monitors, and per-client codec
negotiation (``negotiate.py``).

Counterpart of ``selkies_tpu/signalling/``, with JAX's re-exports.

Protocol parity with the reference: HELLO/SESSION/SESSION_OK/ROOM plus JSON
sdp/ice relay (signalling_web.py:374-473, webrtc_signalling.py:155-210).
"""

from selkies_tpu_torch.signalling.client import (
    SignallingClient,
    SignallingError,
    SignallingErrorNoPeer,
)
from selkies_tpu_torch.signalling.server import SignallingOptions, SignallingServer
from selkies_tpu_torch.signalling.turn import (
    generate_rtc_config,
    hmac_credential,
    parse_rtc_config,
    stun_only_rtc_config,
)

__all__ = [
    "SignallingClient",
    "SignallingError",
    "SignallingErrorNoPeer",
    "SignallingOptions",
    "SignallingServer",
    "generate_rtc_config",
    "hmac_credential",
    "parse_rtc_config",
    "stun_only_rtc_config",
]
