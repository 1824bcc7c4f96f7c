"""RTC-config sources and periodic monitors.

The port's copy of ``selkies_tpu/signalling/rtc_monitors.py``, unchanged.

Parity: the four in-process credential sources of the reference
orchestrator (__main__.py:62-160, 162-287) — HMAC shared-secret refresh,
TURN REST API refresh, an RTC JSON file watcher, Cloudflare Calls, and the
legacy long-term-credential config builder.  Monitors push refreshed
configs through ``on_rtc_config(stun_servers, turn_servers, rtc_config)``
so live sessions can rotate credentials before the 24 h HMAC expiry.

The file monitor polls mtime (the reference uses watchdog inotify, which
is not in this image); the fetchers use aiohttp instead of http.client.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any, Callable

import aiohttp

from selkies_tpu_torch.signalling.turn import generate_rtc_config, parse_rtc_config

logger = logging.getLogger("rtc_monitors")

RtcConfigCallback = Callable[[str, str, str], Any]


def make_turn_rtc_config_json_legacy(
    turn_host: str, turn_port: int | str, username: str, password: str,
    protocol: str = "udp", turn_tls: bool = False,
    stun_host: str | None = None, stun_port: int | str | None = None,
) -> str:
    """RTC config from static long-term TURN credentials."""
    from selkies_tpu_torch.signalling.turn import stun_urls

    scheme = "turns" if turn_tls else "turn"
    return json.dumps(
        {
            "lifetimeDuration": "86400s",
            "blockStatus": "NOT_BLOCKED",
            "iceTransportPolicy": "all",
            "iceServers": [
                {"urls": stun_urls(turn_host, turn_port, stun_host, stun_port)},
                {
                    "urls": [f"{scheme}:{turn_host}:{turn_port}?transport={protocol}"],
                    "username": username,
                    "credential": password,
                },
            ],
        },
        indent=2,
    )


async def fetch_turn_rest(
    uri: str,
    user: str,
    auth_header_username: str = "x-auth-user",
    protocol: str = "udp",
    header_protocol: str = "x-turn-protocol",
    turn_tls: bool = False,
    header_tls: str = "x-turn-tls",
) -> tuple[str, str, str]:
    """GET an RTC config from a TURN REST service (addons/turn-rest API)."""
    headers = {
        auth_header_username: user,
        header_protocol: protocol,
        header_tls: "true" if turn_tls else "false",
    }
    async with aiohttp.ClientSession() as session:
        async with session.get(uri, headers=headers) as resp:
            data = await resp.text()
            if resp.status >= 400:
                raise RuntimeError(f"TURN REST error {resp.status}: {data[:200]}")
    if not data:
        raise RuntimeError("TURN REST returned empty body")
    return parse_rtc_config(data)


async def fetch_cloudflare_turn(turn_token_id: str, api_token: str, ttl: int = 86400) -> dict:
    """POST to the Cloudflare Calls credential API; returns the parsed
    iceServers document (reference __main__.py:266-287)."""
    uri = f"https://rtc.live.cloudflare.com/v1/turn/keys/{turn_token_id}/credentials/generate"
    headers = {"authorization": f"Bearer {api_token}", "content-type": "application/json"}
    async with aiohttp.ClientSession() as session:
        async with session.post(uri, json={"ttl": ttl}, headers=headers) as resp:
            if resp.status >= 400:
                raise RuntimeError(f"Cloudflare TURN error {resp.status}")
            return await resp.json()


class _PeriodicMonitor:
    """Run a refresh coroutine every `period` seconds while started."""

    def __init__(self, period: float = 60.0, enabled: bool = True):
        self.period = period
        self.enabled = enabled
        self.running = False
        self.on_rtc_config: RtcConfigCallback = (
            lambda stun, turn, cfg: logger.warning("unhandled on_rtc_config")
        )

    async def _refresh(self) -> None:
        raise NotImplementedError

    async def start(self) -> None:
        if not self.enabled:
            return
        self.running = True
        next_at = time.monotonic() + self.period
        while self.running:
            if time.monotonic() >= next_at:
                next_at = time.monotonic() + self.period
                try:
                    await self._refresh()
                except Exception as exc:
                    logger.warning("%s refresh failed: %s", type(self).__name__, exc)
            await asyncio.sleep(0.5)
        logger.info("%s stopped", type(self).__name__)

    async def stop(self) -> None:
        self.running = False


class HMACRTCMonitor(_PeriodicMonitor):
    """Re-derives HMAC short-term credentials periodically."""

    def __init__(self, turn_host, turn_port, turn_shared_secret, turn_username,
                 turn_protocol="udp", turn_tls=False, stun_host=None, stun_port=None,
                 period=60.0, enabled=True):
        super().__init__(period, enabled)
        self.turn_host = turn_host
        self.turn_port = turn_port
        self.turn_shared_secret = turn_shared_secret
        self.turn_username = turn_username
        self.turn_protocol = turn_protocol
        self.turn_tls = turn_tls
        self.stun_host = stun_host
        self.stun_port = stun_port

    async def _refresh(self) -> None:
        data = generate_rtc_config(
            self.turn_host, self.turn_port, self.turn_shared_secret,
            self.turn_username, self.turn_protocol, self.turn_tls,
            self.stun_host, self.stun_port,
        )
        stun, turn, cfg = parse_rtc_config(data)
        self.on_rtc_config(stun, turn, cfg)


class RESTRTCMonitor(_PeriodicMonitor):
    """Refreshes credentials from the TURN REST API periodically."""

    def __init__(self, turn_rest_uri, turn_rest_username,
                 turn_rest_username_auth_header="x-auth-user", turn_protocol="udp",
                 turn_rest_protocol_header="x-turn-protocol", turn_tls=False,
                 turn_rest_tls_header="x-turn-tls", period=60.0, enabled=True):
        super().__init__(period, enabled)
        self.turn_rest_uri = turn_rest_uri
        self.turn_rest_username = turn_rest_username.replace(":", "-")
        self.turn_rest_username_auth_header = turn_rest_username_auth_header
        self.turn_protocol = turn_protocol
        self.turn_rest_protocol_header = turn_rest_protocol_header
        self.turn_tls = turn_tls
        self.turn_rest_tls_header = turn_rest_tls_header

    async def _refresh(self) -> None:
        stun, turn, cfg = await fetch_turn_rest(
            self.turn_rest_uri, self.turn_rest_username,
            self.turn_rest_username_auth_header, self.turn_protocol,
            self.turn_rest_protocol_header, self.turn_tls, self.turn_rest_tls_header,
        )
        self.on_rtc_config(stun, turn, cfg)


class RTCConfigFileMonitor:
    """Watches an rtc.json file by mtime polling and pushes changes."""

    def __init__(self, rtc_file: str, enabled: bool = True, poll_interval: float = 1.0):
        self.rtc_file = rtc_file
        self.enabled = enabled
        self.poll_interval = poll_interval
        self.running = False
        self._mtime: float | None = None
        self.on_rtc_config: RtcConfigCallback = (
            lambda stun, turn, cfg: logger.warning("unhandled on_rtc_config")
        )

    def _read_and_push(self) -> None:
        try:
            with open(self.rtc_file) as f:
                data = f.read()
            stun, turn, cfg = parse_rtc_config(data)
            self.on_rtc_config(stun, turn, cfg)
        except Exception as exc:
            logger.warning("could not read RTC JSON file %s: %s", self.rtc_file, exc)

    async def start(self) -> None:
        if not self.enabled:
            return
        self.running = True
        try:
            self._mtime = os.stat(self.rtc_file).st_mtime
        except OSError:
            self._mtime = None
        while self.running:
            await asyncio.sleep(self.poll_interval)
            try:
                mtime = os.stat(self.rtc_file).st_mtime
            except OSError:
                continue
            if self._mtime is None or mtime > self._mtime:
                self._mtime = mtime
                logger.info("detected RTC JSON file change: %s", self.rtc_file)
                await asyncio.to_thread(self._read_and_push)
        logger.info("RTC config file monitor stopped")

    async def stop(self) -> None:
        self.running = False
