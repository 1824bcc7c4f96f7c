"""The redirect record of the cluster's signalling admission.

The port's copy of ``Redirect``, ``parse_redirect`` and ``ws_url_of`` from
``selkies_tpu/cluster/router.py`` (lines 55-100), unchanged: the signalling
client follows a ``REDIRECT`` record through its reconnect loop
(``signalling/client.py``). ``ClusterRouter`` waits for ROADMAP queue 1,
item 3.4, with the rest of the cluster plane.
"""

from __future__ import annotations

import base64
import json
import logging
from dataclasses import asdict, dataclass

logger = logging.getLogger("cluster.router")

__all__ = ["Redirect", "parse_redirect", "ws_url_of"]


@dataclass(frozen=True)
class Redirect:
    """One server-initiated redirect record, as shipped on the wire.

    ``session`` is set on migrate-off redirects when the session landed
    on a DIFFERENT slot index than it held on the source: the client
    must re-register under the landing slot's peer id or it would pair
    with the wrong slot's signalling loop on the target."""

    host: str              # the target's advertised base URL
    reason: str = ""       # draining | capacity | codec | migrated
    retry_after_s: float = 0.5
    session: int | None = None  # landing slot index on the target

    def to_wire(self) -> str:
        blob = json.dumps(asdict(self), sort_keys=True).encode()
        return "REDIRECT " + base64.b64encode(blob).decode("ascii")


def parse_redirect(message: str) -> Redirect | None:
    """Inverse of :meth:`Redirect.to_wire`; None on anything malformed
    (a garbled record must never crash the client's dispatch loop)."""
    try:
        _, b64 = message.split(None, 1)
        data = json.loads(base64.b64decode(b64))
        session = data.get("session")
        return Redirect(host=str(data["host"]).rstrip("/"),
                        reason=str(data.get("reason", "")),
                        retry_after_s=float(data.get("retry_after_s", 0.5)),
                        session=int(session) if session is not None else None)
    except Exception:
        logger.warning("ignoring malformed redirect record %r", message[:80])
        return None


def ws_url_of(host: str) -> str:
    """A redirect target's signalling WebSocket URL from its advertised
    base URL (http(s) base -> ws(s)://…/ws; ws URLs pass through)."""
    host = host.rstrip("/")
    if host.startswith(("ws://", "wss://")):
        base, rest = host.split("://", 1)
        return host if "/" in rest else host + "/ws"
    if host.startswith("https://"):
        return "wss://" + host[len("https://"):] + "/ws"
    if host.startswith("http://"):
        return "ws://" + host[len("http://"):] + "/ws"
    return "ws://" + host + "/ws"
