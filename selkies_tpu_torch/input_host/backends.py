"""Pluggable input-injection backends.

The port's copy of ``selkies_tpu/input_host/backends.py``, unchanged; ``msgpack`` is imported at module top, as in JAX.

The reference injects via pynput/XTest directly inside WebRTCInput
(webrtc_input.py:262-399); we factor the device boundary into a Backend
protocol so the protocol handler is testable without an X server:

* ``X11Backend`` — ctypes XTest injection (production).
* ``UinputMouseProxy`` — msgpack-over-unix-dgram relative-mouse proxy,
  wire-compatible with the reference's --uinput_mouse_socket flow
  (webrtc_input.py:159-164): payload {"args": [(type, code), value],
  "kwargs": {"syn": bool}}.
* ``FakeBackend`` — records every call; used by tests and headless CI.
"""

from __future__ import annotations

import logging
import socket
from typing import Protocol

import msgpack

from selkies_tpu_torch.input_host import input_codes as codes
from selkies_tpu_torch.input_host.x11 import CursorImage, X11Display

logger = logging.getLogger("input.backends")

# X core protocol pointer buttons
X_BTN_LEFT = 1
X_BTN_MIDDLE = 2
X_BTN_RIGHT = 3
X_BTN_SCROLL_UP = 4
X_BTN_SCROLL_DOWN = 5


class InputBackend(Protocol):
    def key(self, keysym: int, down: bool) -> None: ...

    def pointer_position(self, x: int, y: int) -> None: ...

    def pointer_motion(self, dx: int, dy: int) -> None: ...

    def button(self, x_button: int, down: bool) -> None: ...

    def scroll(self, up: bool) -> None: ...

    def sync(self) -> None: ...


class X11Backend:
    """XTest injection through the ctypes display wrapper."""

    def __init__(self, display: X11Display | None = None):
        self.display = display or X11Display.open()

    def key(self, keysym: int, down: bool) -> None:
        # Generic 105-key layouts map keysym 60 ('<') to keycode 94, whose
        # shifted sym is '>'; route '<' through ',' instead (reference
        # webrtc_input.py:325-330).
        if keysym == 60 and self.display.keysym_to_keycode(60) == 94:
            keysym = 44
        self.display.fake_key(keysym, down)

    def pointer_position(self, x: int, y: int) -> None:
        self.display.fake_motion(x, y)

    def pointer_motion(self, dx: int, dy: int) -> None:
        self.display.fake_relative_motion(dx, dy)

    def button(self, x_button: int, down: bool) -> None:
        self.display.fake_button(x_button, down)

    def scroll(self, up: bool) -> None:
        b = X_BTN_SCROLL_UP if up else X_BTN_SCROLL_DOWN
        self.display.fake_button(b, True)
        self.display.fake_button(b, False)

    def sync(self) -> None:
        self.display.sync()

    # cursor monitor hooks (consumed by HostInput.start_cursor_monitor)
    def cursor_image(self) -> CursorImage | None:
        return self.display.get_cursor_image()


_UINPUT_BTN = {
    X_BTN_LEFT: (codes.EV_KEY, codes.BTN_LEFT),
    X_BTN_MIDDLE: (codes.EV_KEY, codes.BTN_MIDDLE),
    X_BTN_RIGHT: (codes.EV_KEY, codes.BTN_RIGHT),
}


class UinputMouseProxy:
    """Relative-mouse half of a backend: forwards to a uinput helper over a
    unix datagram socket (containers without XTest pointer access)."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)

    def _emit(self, etype_code: tuple[int, int], value: int, syn: bool = True) -> None:
        payload = {"args": [tuple(etype_code), value], "kwargs": {"syn": syn}}
        try:
            self._sock.sendto(msgpack.packb(payload, use_bin_type=True), self.socket_path)
        except OSError as exc:
            logger.warning("uinput proxy send failed: %s", exc)

    def pointer_motion(self, dx: int, dy: int) -> None:
        self._emit((codes.EV_REL, codes.REL_X), dx, syn=False)
        self._emit((codes.EV_REL, codes.REL_Y), dy)

    def button(self, x_button: int, down: bool) -> None:
        mapped = _UINPUT_BTN.get(x_button)
        if mapped is not None:
            self._emit(mapped, 1 if down else 0)

    def scroll(self, up: bool) -> None:
        self._emit((codes.EV_REL, codes.REL_WHEEL), 1 if up else -1)

    def close(self) -> None:
        self._sock.close()


class FakeBackend:
    """Records injected events; stands in for X in tests/headless runs."""

    def __init__(self):
        self.events: list[tuple] = []
        self.keysym_keycode_overrides: dict[int, int] = {}
        self.fake_cursor: CursorImage | None = None

    def key(self, keysym: int, down: bool) -> None:
        self.events.append(("key", keysym, down))

    def pointer_position(self, x: int, y: int) -> None:
        self.events.append(("pos", x, y))

    def pointer_motion(self, dx: int, dy: int) -> None:
        self.events.append(("move", dx, dy))

    def button(self, x_button: int, down: bool) -> None:
        self.events.append(("button", x_button, down))

    def scroll(self, up: bool) -> None:
        self.events.append(("scroll", up))

    def sync(self) -> None:
        self.events.append(("sync",))

    def cursor_image(self) -> CursorImage | None:
        return self.fake_cursor


def open_best_backend() -> InputBackend:
    """X11 when a display is reachable, otherwise the fake recorder."""
    try:
        return X11Backend()
    except Exception as exc:  # X11Unavailable or library load issues
        logger.warning("X11 backend unavailable (%s); using FakeBackend", exc)
        return FakeBackend()
