"""WebRTC signalling of the port: per-client codec negotiation
(``negotiate.py``).

Counterpart of ``selkies_tpu/signalling/``. The signalling server, the
in-process client and the TURN helpers are not ported yet, so this
package exports nothing of its own.
"""
