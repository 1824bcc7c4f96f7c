"""Media transport of the port: the WebSocket media plane
(``websocket.py``), GCC congestion control (``congestion.py``), the
loss-recovery ladder (``recovery.py``) and a session's app-facing mux
with the absent WebRTC plane (``mux.py``).

Counterpart of ``selkies_tpu/transport/``; the RTP payloaders and the
WebRTC stack are not ported yet. The byte plane is host-side; only encode
runs on the card.
"""
