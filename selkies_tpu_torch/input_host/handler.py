"""HostInput — the data-channel input protocol handler.

The port's copy of ``selkies_tpu/input_host/handler.py``, unchanged.

Parity target: ``WebRTCInput`` (webrtc_input.py:82-736).  Parses the full
client→server CSV vocabulary (``kd ku kr m m2 p vb ab js cr cw r s
_arg_fps _arg_resize _f _l _stats_video _stats_audio pong``) and turns
each message into a host-side effect through the pluggable injection
backend, the clipboard backend, and the per-js# gamepad servers, emitting
orchestrator callbacks for everything else.

Differences by design: injection goes through ``InputBackend`` (ctypes
XTest or fake) instead of pynput; the cursor monitor polls the XFixes
cursor serial instead of decoding X events.
"""

from __future__ import annotations

import asyncio
import base64
import io
import logging
import os
import re
import time
from typing import Any, Callable

from PIL import Image

from selkies_tpu_torch.input_host.backends import (
    FakeBackend,
    InputBackend,
    UinputMouseProxy,
    X_BTN_LEFT,
    X_BTN_MIDDLE,
    X_BTN_RIGHT,
    open_best_backend,
)
from selkies_tpu_torch.input_host.clipboard import ClipboardBackend, open_best_clipboard
from selkies_tpu_torch.input_host.gamepad import GamepadServer
from selkies_tpu_torch.input_host.x11 import CursorImage

logger = logging.getLogger("input.handler")

_RES_RE = re.compile(r"^\d+x\d+$")
_SCALE_RE = re.compile(r"^\d+(\.\d+)?$")

# Keysyms cleared by a keyboard reset (stuck-modifier recovery,
# webrtc_input.py:234-260): modifiers plus f/m (fullscreen hotkeys) and Esc.
RESET_KEYSYMS = (
    65507, 65505, 65513,  # L ctrl/shift/alt
    65508, 65506, 65027,  # R ctrl/shift, AltGr
    65511, 65512,         # meta
    102, 70, 109, 77,     # f F m M
    65307,                # Escape
)

NUM_GAMEPADS = 4


class HostInput:
    def __init__(
        self,
        backend: InputBackend | None = None,
        clipboard: ClipboardBackend | None = None,
        uinput_mouse_socket_path: str = "",
        js_socket_path: str = "/tmp",
        enable_clipboard: str = "false",
        enable_cursors: bool = True,
        cursor_size: int = 16,
        cursor_scale: float = 1.0,
        cursor_debug: bool = False,
    ):
        self.backend = backend if backend is not None else open_best_backend()
        self.clipboard = clipboard if clipboard is not None else open_best_clipboard()
        self.uinput_mouse: UinputMouseProxy | None = (
            UinputMouseProxy(uinput_mouse_socket_path) if uinput_mouse_socket_path else None
        )
        self.js_socket_paths = {
            i: os.path.join(js_socket_path, f"selkies_js{i}.sock") for i in range(NUM_GAMEPADS)
        }
        self.gamepads: dict[int, GamepadServer] = {}
        self.enable_clipboard = enable_clipboard
        self.enable_cursors = enable_cursors
        self.cursor_size = cursor_size
        self.cursor_scale = cursor_scale
        self.cursor_debug = cursor_debug
        self.cursor_cache: dict[int, dict] = {}
        self.button_mask = 0
        self.ping_start: float | None = None
        self._clipboard_running = False
        self._cursors_running = False

        # orchestrator callbacks (reference webrtc_input.py:114-139)
        warn = logger.warning
        self.on_video_encoder_bit_rate: Callable[[int], Any] = lambda b: warn("unhandled on_video_encoder_bit_rate")
        self.on_audio_encoder_bit_rate: Callable[[int], Any] = lambda b: warn("unhandled on_audio_encoder_bit_rate")
        self.on_mouse_pointer_visible: Callable[[bool], Any] = lambda v: warn("unhandled on_mouse_pointer_visible")
        self.on_clipboard_read: Callable[[str], Any] = lambda d: warn("unhandled on_clipboard_read")
        self.on_set_fps: Callable[[int], Any] = lambda f: warn("unhandled on_set_fps")
        self.on_set_enable_resize: Callable[[bool, str | None], Any] = lambda e, r: warn("unhandled on_set_enable_resize")
        self.on_client_fps: Callable[[int], Any] = lambda f: warn("unhandled on_client_fps")
        self.on_media_ack: Callable[[int, float], Any] = lambda seq, ms: None
        self.on_client_latency: Callable[[int], Any] = lambda l: warn("unhandled on_client_latency")
        self.on_resize: Callable[[str], Any] = lambda r: warn("unhandled on_resize")
        self.on_scaling_ratio: Callable[[float], Any] = lambda s: warn("unhandled on_scaling_ratio")
        self.on_ping_response: Callable[[float], Any] = lambda l: warn("unhandled on_ping_response")
        self.on_cursor_change: Callable[[dict | None], Any] = lambda m: warn("unhandled on_cursor_change")
        self.on_client_webrtc_stats: Callable[[str, str], Any] = lambda t, s: warn("unhandled on_client_webrtc_stats")

    # ------------------------------------------------------------------
    # lifecycle

    async def connect(self) -> None:
        self.reset_keyboard()

    async def disconnect(self) -> None:
        await self.stop_js_server()
        self.stop_clipboard()
        self.stop_cursor_monitor()

    # ------------------------------------------------------------------
    # keyboard / mouse injection

    def reset_keyboard(self) -> None:
        logger.info("resetting keyboard modifiers")
        for keysym in RESET_KEYSYMS:
            self.backend.key(keysym, down=False)

    def send_keypress(self, keysym: int, down: bool) -> None:
        try:
            self.backend.key(keysym, down)
        except Exception as exc:
            logger.error("failed to send keypress: %s", exc)

    def send_mouse(self, x: int, y: int, button_mask: int, scroll_magnitude: int, relative: bool) -> None:
        if relative:
            if self.uinput_mouse is not None:
                self.uinput_mouse.pointer_motion(x, y)
            else:
                self.backend.pointer_motion(x, y)
        else:
            self.backend.pointer_position(x, y)

        if button_mask != self.button_mask:
            for i in range(5):
                if not (button_mask ^ self.button_mask) & (1 << i):
                    continue
                down = bool(button_mask & (1 << i))
                if i < 3:
                    x_button = (X_BTN_LEFT, X_BTN_MIDDLE, X_BTN_RIGHT)[i]
                    # buttons/scroll ride the uinput proxy whenever it is
                    # configured (reference webrtc_input.py:294-310)
                    if self.uinput_mouse is not None:
                        self.uinput_mouse.button(x_button, down)
                    else:
                        self.backend.button(x_button, down)
                elif button_mask != 0:  # bits 3/4: wheel up/down edges
                    up = i == 3
                    # repeat per scroll magnitude for smoother trackpads
                    for _ in range(max(1, scroll_magnitude)):
                        if self.uinput_mouse is not None:
                            self.uinput_mouse.scroll(up)
                        else:
                            self.backend.scroll(up)
            self.button_mask = button_mask

        if not relative:
            self.backend.sync()

    # ------------------------------------------------------------------
    # clipboard

    def read_clipboard(self) -> str | None:
        return self.clipboard.read()

    def write_clipboard(self, data: str) -> bool:
        return self.clipboard.write(data)

    async def start_clipboard(self) -> None:
        if self.enable_clipboard not in ("true", "out"):
            logger.info("outbound clipboard disabled")
            return
        logger.info("starting clipboard monitor")
        self._clipboard_running = True
        last = ""
        while self._clipboard_running:
            data = await asyncio.to_thread(self.read_clipboard)
            if data and data != last:
                self.on_clipboard_read(data)
                last = data
            await asyncio.sleep(0.5)
        logger.info("clipboard monitor stopped")

    def stop_clipboard(self) -> None:
        self._clipboard_running = False

    # ------------------------------------------------------------------
    # cursor monitor

    async def start_cursor_monitor(self) -> None:
        if not self.enable_cursors:
            return
        getter = getattr(self.backend, "cursor_image", None)
        if getter is None:
            logger.warning("backend has no cursor support; cursor monitor off")
            return
        display = getattr(self.backend, "display", None)
        if display is not None and display.has_xfixes:
            display.select_cursor_events()
        logger.info("starting cursor monitor")
        self.cursor_cache = {}
        self._cursors_running = True
        last_serial = -1
        while self._cursors_running:
            if display is not None:
                await asyncio.to_thread(display.drain_events)
            try:
                cur = await asyncio.to_thread(getter)
            except Exception as exc:
                logger.warning("cursor fetch failed: %s", exc)
                cur = None
            if cur is not None and cur.serial != last_serial:
                last_serial = cur.serial
                if cur.serial not in self.cursor_cache:
                    self.cursor_cache[cur.serial] = self.cursor_to_msg(
                        cur, self.cursor_scale, self.cursor_size
                    )
                self.on_cursor_change(self.cursor_cache[cur.serial])
            await asyncio.sleep(0.1)
        logger.info("cursor monitor stopped")

    def stop_cursor_monitor(self) -> None:
        self._cursors_running = False

    def cursor_to_msg(self, cursor: CursorImage, scale: float = 1.0, cursor_size: int = -1) -> dict:
        if cursor_size > -1:
            w = h = cursor_size
            xhot = int(cursor_size / cursor.width * cursor.xhot) if cursor.width else 0
            yhot = int(cursor_size / cursor.height * cursor.yhot) if cursor.height else 0
        else:
            w, h = int(cursor.width * scale), int(cursor.height * scale)
            xhot, yhot = int(cursor.xhot * scale), int(cursor.yhot * scale)
        png = self.cursor_to_png(cursor, w, h)
        override = "none" if sum(cursor.argb) == 0 else None
        return {
            "curdata": base64.b64encode(png).decode(),
            "handle": cursor.serial,
            "override": override,
            "hotspot": {"x": xhot, "y": yhot},
        }

    @staticmethod
    def cursor_to_png(cursor: CursorImage, resize_w: int, resize_h: int) -> bytes:
        rgba = bytearray()
        for px in cursor.argb:
            rgba += bytes(((px >> 16) & 0xFF, (px >> 8) & 0xFF, px & 0xFF, (px >> 24) & 0xFF))
        im = Image.frombytes("RGBA", (cursor.width, cursor.height), bytes(rgba), "raw")
        if (cursor.width, cursor.height) != (resize_w, resize_h):
            im = im.resize((resize_w, resize_h))
        with io.BytesIO() as f:
            im.save(f, "PNG")
            return f.getvalue()

    # ------------------------------------------------------------------
    # gamepads

    async def _js_connect(self, js_num: int, name: str, num_btns: int, num_axes: int) -> None:
        path = self.js_socket_paths.get(js_num)
        if path is None:
            logger.error("no socket path for js%d", js_num)
            return
        logger.info("gamepad js%d connect: %r (%d btns, %d axes)", js_num, name, num_btns, num_axes)
        old = self.gamepads.pop(js_num, None)
        if old is not None:
            await old.stop()
        js = GamepadServer(path)
        await js.start()
        self.gamepads[js_num] = js

    async def _js_disconnect(self, js_num: int | None = None) -> None:
        if js_num is None:
            for js in self.gamepads.values():
                await js.stop()
            self.gamepads = {}
            return
        js = self.gamepads.pop(js_num, None)
        if js is not None:
            await js.stop()

    async def stop_js_server(self) -> None:
        await self._js_disconnect()

    # ------------------------------------------------------------------
    # ping

    def send_ping(self, when: float) -> None:
        self.ping_start = when

    # ------------------------------------------------------------------
    # the protocol

    async def on_message(self, msg: str) -> None:
        toks = msg.split(",")
        cmd = toks[0]
        try:
            if cmd == "pong":
                if self.ping_start is None:
                    logger.warning("received pong before ping")
                    return
                latency_ms = round((time.time() - self.ping_start) / 2 * 1000, 3)
                self.on_ping_response(latency_ms)
            elif cmd == "kd":
                self.send_keypress(int(toks[1]), down=True)
            elif cmd == "ku":
                self.send_keypress(int(toks[1]), down=False)
            elif cmd == "kr":
                self.reset_keyboard()
            elif cmd in ("m", "m2"):
                relative = cmd == "m2"
                try:
                    x, y, button_mask, scroll_magnitude = (int(v) for v in toks[1:])
                except (ValueError, IndexError):
                    x, y, button_mask, scroll_magnitude = 0, 0, self.button_mask, 0
                    relative = False
                try:
                    self.send_mouse(x, y, button_mask, scroll_magnitude, relative)
                except Exception as exc:
                    logger.warning("failed to send mouse event: %s", exc)
            elif cmd == "p":
                self.on_mouse_pointer_visible(bool(int(toks[1])))
            elif cmd == "vb":
                self.on_video_encoder_bit_rate(int(toks[1]))
            elif cmd == "ab":
                self.on_audio_encoder_bit_rate(int(toks[1]))
            elif cmd == "js":
                await self._on_js_message(toks)
            elif cmd == "cr":
                if self.enable_clipboard in ("true", "out"):
                    data = self.read_clipboard()
                    if data:
                        self.on_clipboard_read(data)
                else:
                    logger.warning("clipboard read rejected: outbound disabled")
            elif cmd == "cw":
                if self.enable_clipboard in ("true", "in"):
                    data = base64.b64decode(toks[1]).decode("utf-8")
                    self.write_clipboard(data)
                else:
                    logger.warning("clipboard write rejected: inbound disabled")
            elif cmd == "r":
                res = toks[1]
                if _RES_RE.match(res):
                    w, h = (int(v) + int(v) % 2 for v in res.split("x"))
                    self.on_resize(f"{w}x{h}")
                else:
                    logger.warning("invalid resolution: %s", res)
            elif cmd == "s":
                if _SCALE_RE.match(toks[1]):
                    self.on_scaling_ratio(float(toks[1]))
                else:
                    logger.warning("invalid scale: %s", toks[1])
            elif cmd == "_arg_fps":
                self.on_set_fps(int(toks[1]))
            elif cmd == "_arg_resize":
                if len(toks) != 3:
                    logger.error("_arg_resize expects <enabled>,<res>")
                    return
                enabled = toks[1].lower() == "true"
                res: str | None = None
                if _RES_RE.match(toks[2]):
                    w, h = (int(v) + int(v) % 2 for v in toks[2].split("x"))
                    res = f"{w}x{h}"
                self.on_set_enable_resize(enabled, res)
            elif cmd == "_ack":
                self.on_media_ack(int(toks[1]), float(toks[2]))
            elif cmd == "_f":
                self.on_client_fps(int(toks[1]))
            elif cmd == "_l":
                self.on_client_latency(int(toks[1]))
            elif cmd in ("_stats_video", "_stats_audio"):
                result = self.on_client_webrtc_stats(cmd, ",".join(toks[1:]))
                if asyncio.iscoroutine(result):
                    await result
            else:
                logger.info("unknown data channel message: %s", msg)
        except (ValueError, IndexError) as exc:
            logger.error("malformed input message %r: %s", msg, exc)

    async def _on_js_message(self, toks: list[str]) -> None:
        sub = toks[1]
        js_num = int(toks[2])
        if sub == "c":
            name = base64.b64decode(toks[3]).decode()[:255]
            num_axes, num_btns = int(toks[4]), int(toks[5])
            await self._js_connect(js_num, name, num_btns, num_axes)
        elif sub == "d":
            await self._js_disconnect(js_num)
        elif sub == "b":
            js = self.gamepads.get(js_num)
            if js is None:
                logger.error("js%d not connected", js_num)
                return
            js.send_btn(int(toks[3]), float(toks[4]))
        elif sub == "a":
            js = self.gamepads.get(js_num)
            if js is None:
                logger.error("js%d not connected", js_num)
                return
            js.send_axis(int(toks[3]), float(toks[4]))
        else:
            logger.warning("unhandled joystick command: %s", sub)
