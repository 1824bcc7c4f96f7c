"""In-process signalling client.

The port's copy of ``selkies_tpu/signalling/client.py``: its redirect
helpers come from the port's ``cluster`` package.

Counterpart of the reference ``WebRTCSignalling`` (webrtc_signalling.py:59):
connects to the local signalling server, registers with ``HELLO <id>``,
calls a peer with ``SESSION <peer_id>``, then relays SDP/ICE JSON both ways
via callbacks.  Two instances run per host process — one for the video+data
connection and one for audio (reference __main__.py:568-579).

Implemented on aiohttp's WebSocket client rather than the websockets
package; retry/disconnect semantics match the reference (retry connect
every 2 s, on_disconnect on closed socket).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import ssl
from typing import Any, Awaitable, Callable

import aiohttp

from selkies_tpu_torch.resilience import get_injector
from selkies_tpu_torch.utils.aio import maybe_await as _maybe_await

logger = logging.getLogger("signalling.client")


def reconnect_backoff():
    """The ONE signalling reconnect policy (capped exponential + jitter),
    shared by the solo orchestrator loop, every fleet slot loop, and the
    client's own connect() retries — fix it here, it is fixed everywhere."""
    import random

    from selkies_tpu_torch.resilience import Backoff

    return Backoff(base=0.5, cap=30.0, jitter=0.5, rand=random.random)


async def run_reconnect_loop(client: "SignallingClient",
                             log_prefix: str = "signalling") -> None:
    """Connect/serve/reconnect forever with the shared backoff policy —
    the single reconnect loop behind Orchestrator._signalling_loop and
    every FleetOrchestrator slot loop. A connection that lived >= 30 s
    was healthy and resets the backoff; errors out of the message loop
    are logged, never fatal. A server-initiated redirect (the cluster
    plane's REDIRECT record) re-targets ``client.server`` and rides
    this same loop: the next iteration connects to the NEW host after
    the record's retry-after beat (not a penalty backoff — the move
    was server-directed, so the backoff resets with it)."""
    import time

    backoff = reconnect_backoff()
    while True:
        await client.connect()
        connected_at = time.monotonic()
        try:
            await client.start()  # returns on disconnect
        except Exception:
            logger.exception("%s client error", log_prefix)
        if time.monotonic() - connected_at > 30.0:
            backoff.reset()
        retry_after = client.consume_retry_after()
        if retry_after is not None:
            backoff.reset()
            delay = retry_after
            logger.info("%s client redirected to %s; following in %.1fs",
                        log_prefix, client.server, delay)
        else:
            delay = backoff.next_delay()
            logger.info("%s client disconnected; retrying in %.1fs",
                        log_prefix, delay)
        await asyncio.sleep(delay)


class SignallingError(Exception):
    pass


class SignallingErrorNoPeer(SignallingError):
    pass


class SignallingClient:
    # server-initiated redirect chain bounds: at most this many hops
    # inside the window, and never back to a host already in the chain
    # (the two-host ping-pong loop)
    MAX_REDIRECT_HOPS = 4
    REDIRECT_WINDOW_S = 60.0

    def __init__(
        self,
        server: str,
        id: int | str,
        peer_id: int | str,
        enable_https: bool = False,
        enable_basic_auth: bool = False,
        basic_auth_user: str | None = None,
        basic_auth_password: str | None = None,
        retry_interval: float = 2.0,
        retry_backoff=None,
        meta: dict | None = None,
    ):
        self.server = server
        self.id = id
        self.peer_id = peer_id
        self.enable_https = enable_https
        self.enable_basic_auth = enable_basic_auth
        self.basic_auth_user = basic_auth_user
        self.basic_auth_password = basic_auth_password
        self.retry_interval = retry_interval
        # optional resilience.Backoff: when set, connect() retries decay
        # (capped exponential + jitter) instead of a fixed beat — a dead
        # signalling server isn't hammered every retry_interval forever
        self.retry_backoff = retry_backoff
        # HELLO meta (the browser's third token: codec preferences etc.).
        # Carrying meta also marks this client cluster-routable — the
        # server only ever redirects HELLOs that have it.
        self.meta = meta

        self._session: aiohttp.ClientSession | None = None
        self._ws: aiohttp.ClientWebSocketResponse | None = None
        # redirect-following state (cluster/router.py records)
        self._redirect_path: list[tuple[str, float]] = []
        self._retry_after: float | None = None

        # callbacks (any may be sync or async)
        self.on_connect: Callable[[], Any] = lambda: logger.warning("unhandled on_connect")
        self.on_session: Callable[[Any, dict], Any] = lambda peer_id, meta: logger.warning("unhandled on_session")
        self.on_disconnect: Callable[[], Any] = lambda: logger.warning("unhandled on_disconnect")
        self.on_error: Callable[[Exception], Any] = lambda e: logger.warning("unhandled on_error: %s", e)
        self.on_sdp: Callable[[str, str], Any] = lambda t, s: logger.warning("unhandled on_sdp")
        self.on_ice: Callable[[int, str], Any] = lambda m, c: logger.warning("unhandled on_ice")

    async def connect(self) -> None:
        """Connect (retrying forever) and send HELLO."""
        sslctx: ssl.SSLContext | bool = False
        if self.enable_https or self.server.startswith("wss:"):
            sslctx = ssl.create_default_context(purpose=ssl.Purpose.SERVER_AUTH)
            sslctx.check_hostname = False
            sslctx.verify_mode = ssl.CERT_NONE
        headers = None
        if self.enable_basic_auth:
            auth64 = base64.b64encode(
                f"{self.basic_auth_user}:{self.basic_auth_password}".encode("ascii")
            ).decode("ascii")
            headers = {"Authorization": f"Basic {auth64}"}
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        while True:
            try:
                self._ws = await self._session.ws_connect(self.server, headers=headers, ssl=sslctx, heartbeat=None)
                break
            except (aiohttp.ClientError, OSError) as exc:
                # ClientError (not just ClientConnectionError): a proxy
                # answering the WS upgrade with 502 during a restart
                # raises WSServerHandshakeError — that must retry too,
                # not kill the reconnect loop for good
                delay = (self.retry_backoff.next_delay()
                         if self.retry_backoff is not None
                         else self.retry_interval)
                logger.info("connecting to signalling server (%s; retry "
                            "in %.1fs)...", type(exc).__name__, delay)
                await asyncio.sleep(delay)
        if self.retry_backoff is not None:
            self.retry_backoff.reset()
        hello = f"HELLO {self.id}"
        if self.meta:
            meta64 = base64.b64encode(
                json.dumps(self.meta).encode()).decode("ascii")
            hello = f"{hello} {meta64}"
        await self._ws.send_str(hello)

    async def setup_call(self) -> None:
        """Request a session with the configured peer (after server HELLO)."""
        assert self._ws is not None
        await self._ws.send_str(f"SESSION {self.peer_id}")

    async def send_sdp(self, sdp_type: str, sdp: str) -> None:
        assert self._ws is not None
        logger.info("sending sdp type: %s", sdp_type)
        await self._ws.send_str(json.dumps({"sdp": {"type": sdp_type, "sdp": sdp}}))

    async def send_ice(self, mlineindex: int, candidate: str) -> None:
        assert self._ws is not None
        await self._ws.send_str(json.dumps({"ice": {"candidate": candidate, "sdpMLineIndex": mlineindex}}))

    async def stop(self) -> None:
        if self._ws is not None:
            await self._ws.close()
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def start(self) -> None:
        """Message loop: dispatches HELLO / SESSION_OK / ERROR / sdp / ice.

        Fault site ``signalling`` (resilience/faultinject.py): a scheduled
        ``flap`` closes the socket mid-session — the reconnect/backoff
        path in the orchestrators is exercised deterministically — and
        ``drop`` discards one inbound message."""
        assert self._ws is not None
        async for msg in self._ws:
            if msg.type != aiohttp.WSMsgType.TEXT:
                continue
            fi = get_injector()
            if fi is not None:
                act = fi.check("signalling")
                if act is not None:
                    action, delay_ms = act
                    if action == "flap":
                        await self._ws.close()
                        break
                    if action == "drop":
                        continue
                    if action == "delay":
                        await asyncio.sleep(delay_ms / 1000.0)
            await self._dispatch(msg.data)
        await _maybe_await(self.on_disconnect())

    def consume_retry_after(self) -> float | None:
        """The pending redirect's retry-after beat, once (the reconnect
        loop reads it to pace the follow); None when no redirect is
        pending."""
        ra, self._retry_after = self._retry_after, None
        return ra

    async def _on_redirect(self, message: str) -> None:
        """Server-initiated redirect record (cluster/router.py): point
        ``self.server`` at the new host and drop the socket so the
        reconnect loop follows. Chains are capped — at most
        MAX_REDIRECT_HOPS inside REDIRECT_WINDOW_S, and never back to a
        host already in the recent chain, so two misconfigured hosts
        can never ping-pong a client forever."""
        import time

        from selkies_tpu_torch.cluster.router import parse_redirect, ws_url_of

        rd = parse_redirect(message)
        if rd is None:
            return
        target = ws_url_of(rd.host)
        now = time.monotonic()
        self._redirect_path = [
            (h, t) for h, t in self._redirect_path
            if now - t < self.REDIRECT_WINDOW_S]
        seen = {h for h, _ in self._redirect_path}
        # the path holds origin + followed hops, so hop count is len-1
        hops = max(0, len(self._redirect_path) - 1)
        if target in seen or hops >= self.MAX_REDIRECT_HOPS:
            logger.warning(
                "ignoring redirect to %s (%s): chain capped (%d recent "
                "hops%s)", target, rd.reason, hops,
                ", ping-pong" if target in seen else "")
            return
        if not self._redirect_path:
            self._redirect_path.append((self.server, now))
        self._redirect_path.append((target, now))
        logger.warning("server redirected us to %s (%s, retry in %.1fs)",
                       target, rd.reason or "?", rd.retry_after_s)
        self.server = target
        if rd.session is not None:
            # a migrated session can land on a DIFFERENT slot index on
            # the target; ids following the fleet convention (browser
            # 1+10k, server client 2+10k — parallel/fleet.py) re-target
            # so the client pairs with the slot that holds its restored
            # encoder state, not whatever its old index maps to there
            try:
                if (int(self.id) - 1) % 10 == 0:
                    self.id = 1 + 10 * int(rd.session)
                if (int(self.peer_id) - 2) % 10 == 0:
                    self.peer_id = 2 + 10 * int(rd.session)
            except (TypeError, ValueError):
                pass  # non-numeric ids: the owner wires its own mapping
        self._retry_after = max(0.0, rd.retry_after_s)
        if self._ws is not None:
            await self._ws.close()

    async def _dispatch(self, message: str) -> None:
        if message == "HELLO":
            logger.info("connected")
            await _maybe_await(self.on_connect())
        elif message.startswith("REDIRECT"):
            await self._on_redirect(message)
        elif message.startswith("SESSION_OK"):
            toks = message.split()
            meta = json.loads(base64.b64decode(toks[1])) if len(toks) > 1 else {}
            logger.info("session started with peer %s meta=%s", self.peer_id, meta)
            await _maybe_await(self.on_session(self.peer_id, meta))
        elif message.startswith("ERROR"):
            if message == f"ERROR peer {str(self.peer_id)!r} not found":
                await _maybe_await(self.on_error(SignallingErrorNoPeer(f"{self.peer_id!r} not found")))
            else:
                await _maybe_await(self.on_error(SignallingError(f"unhandled signalling message: {message}")))
        else:
            try:
                data = json.loads(message)
            except json.JSONDecodeError:
                await _maybe_await(self.on_error(SignallingError(f"error parsing message as JSON: {message}")))
                return
            if data.get("sdp"):
                await _maybe_await(self.on_sdp(data["sdp"].get("type"), data["sdp"].get("sdp")))
            elif data.get("ice"):
                await _maybe_await(self.on_ice(data["ice"].get("sdpMLineIndex"), data["ice"].get("candidate")))
            else:
                await _maybe_await(self.on_error(SignallingError(f"unhandled JSON message: {message}")))
