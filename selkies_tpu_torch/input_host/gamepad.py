"""Virtual gamepad socket server.

The port's copy of ``selkies_tpu/input_host/gamepad.py``, unchanged.

Serves the joystick-interposer wire protocol (reference gamepad.py +
addons/js-interposer/joystick_interposer.c): a unix STREAM socket per
``js#`` where each new client first receives a config struct
``255sHH512H64B`` (name, num_btns, num_axes, btn_map, axes_map) and then a
stream of kernel-format ``struct js_event`` packets (``IhBB``: time-ms,
value, type, number).  Browser W3C standard-gamepad events are remapped to
the Linux xpad layout (triggers → full-range axes, dpad → hat axes,
reference gamepad.py:21-100) before serialisation.

Implemented with ``asyncio.start_unix_server`` (the reference hand-rolls a
non-blocking accept loop + thread sends).
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import time

from selkies_tpu_torch.input_host import input_codes as codes

logger = logging.getLogger("gamepad")

JS_EVENT_BUTTON = 0x01
JS_EVENT_AXIS = 0x02

MAX_BTNS = 512
MAX_AXES = 64
ABS_MIN = -32767
ABS_MAX = 32767

CONFIG_STRUCT = struct.Struct(f"255sHH{MAX_BTNS}H{MAX_AXES}B")
EVENT_STRUCT = struct.Struct("IhBB")

# The Linux xpad device exposed to applications: 11 buttons, 8 axes.
XPAD_NAME = "Selkies Controller"
XPAD_BTN_MAP = [
    codes.BTN_A, codes.BTN_B, codes.BTN_X, codes.BTN_Y,
    codes.BTN_TL, codes.BTN_TR, codes.BTN_SELECT, codes.BTN_START,
    codes.BTN_MODE, codes.BTN_THUMBL, codes.BTN_THUMBR,
]
XPAD_AXES_MAP = [
    codes.ABS_X, codes.ABS_Y, codes.ABS_Z, codes.ABS_RX,
    codes.ABS_RY, codes.ABS_RZ, codes.ABS_HAT0X, codes.ABS_HAT0Y,
]

# W3C standard-gamepad button index -> xpad target.
# Buttons 6/7 (triggers) become axes 2/5; dpad 12-15 become hat axes.
W3C_BTN_TO_AXIS = {6: (2, 1), 7: (5, 1), 15: (6, 1), 14: (6, -1), 13: (7, 1), 12: (7, -1)}
W3C_BTN_REMAP = {8: 6, 9: 7, 10: 9, 11: 10, 16: 8}
W3C_AXIS_REMAP = {2: 3, 3: 4}
TRIGGER_AXES = (2, 5)


def _event_ts_ms() -> int:
    return int((time.time() * 1000) % 1_000_000_000)


def axis_value(val: float) -> int:
    """Normalise [-1, 1] stick input to the joystick ABS range."""
    return round(ABS_MIN + ((val + 1) * (ABS_MAX - ABS_MIN)) / 2)


def trigger_value(val: float) -> int:
    """Normalise [0, 1] trigger input to the full ABS range."""
    return round(val * (ABS_MAX - ABS_MIN)) + ABS_MIN


def pack_event(num: int, value: int, is_axis: bool) -> bytes:
    etype = JS_EVENT_AXIS if is_axis else JS_EVENT_BUTTON
    return EVENT_STRUCT.pack(_event_ts_ms(), value, etype, num)


def pack_config(name: str = XPAD_NAME) -> bytes:
    btn_map = XPAD_BTN_MAP + [0] * (MAX_BTNS - len(XPAD_BTN_MAP))
    axes_map = XPAD_AXES_MAP + [0] * (MAX_AXES - len(XPAD_AXES_MAP))
    return CONFIG_STRUCT.pack(name.encode()[:255], len(XPAD_BTN_MAP), len(XPAD_AXES_MAP), *btn_map, *axes_map)


def map_w3c_button(btn_num: int, btn_val: float) -> bytes | None:
    """W3C standard-gamepad button -> js_event bytes (or None if unmappable)."""
    to_axis = W3C_BTN_TO_AXIS.get(btn_num)
    if to_axis is not None:
        axis, sign = to_axis
        if axis in TRIGGER_AXES:
            value = trigger_value(btn_val)
        else:
            value = axis_value(btn_val * sign)
        return pack_event(axis, value, is_axis=True)
    mapped = W3C_BTN_REMAP.get(btn_num, btn_num)
    if mapped >= len(XPAD_BTN_MAP):
        logger.error("button %d exceeds xpad button map", mapped)
        return None
    return pack_event(mapped, int(btn_val), is_axis=False)


def map_w3c_axis(axis_num: int, axis_val: float) -> bytes | None:
    mapped = W3C_AXIS_REMAP.get(axis_num, axis_num)
    if mapped >= len(XPAD_AXES_MAP):
        logger.error("axis %d exceeds xpad axes map", mapped)
        return None
    return pack_event(mapped, axis_value(axis_val), is_axis=True)


class GamepadServer:
    """One unix-socket server per virtual joystick (``/tmp/selkies_js{N}.sock``)."""

    MAX_WRITE_BUFFER = 64 * 1024  # drop clients that stop reading events

    def __init__(self, socket_path: str, name: str = XPAD_NAME):
        self.socket_path = socket_path
        self.name = name
        self._server: asyncio.base_events.Server | None = None
        self._writers: set[asyncio.StreamWriter] = set()

    @property
    def running(self) -> bool:
        return self._server is not None

    @property
    def num_clients(self) -> int:
        return len(self._writers)

    async def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        os.makedirs(os.path.dirname(self.socket_path) or ".", exist_ok=True)
        self._server = await asyncio.start_unix_server(self._on_client, path=self.socket_path)
        logger.info("gamepad server listening on %s", self.socket_path)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for w in list(self._writers):
            w.close()
        self._writers.clear()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        logger.info("gamepad server stopped: %s", self.socket_path)

    async def _on_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        logger.info("gamepad client connected on %s", self.socket_path)
        try:
            writer.write(pack_config(self.name))
            await writer.drain()
            await asyncio.sleep(0.5)  # let the interposer finish config read
            # announce neutral state for every button/axis
            for b in range(len(XPAD_BTN_MAP)):
                writer.write(pack_event(b, 0, is_axis=False))
            for a in range(len(XPAD_AXES_MAP)):
                writer.write(pack_event(a, 0, is_axis=True))
            await writer.drain()
        except (ConnectionError, OSError):
            writer.close()
            return
        self._writers.add(writer)
        try:
            # interposer clients never send data; read detects disconnects
            while await reader.read(4096):
                pass
        except (ConnectionError, OSError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()
            logger.info("gamepad client disconnected from %s", self.socket_path)

    def _broadcast(self, event: bytes | None) -> None:
        if event is None:
            return
        for w in list(self._writers):
            try:
                if w.transport.get_write_buffer_size() > self.MAX_WRITE_BUFFER:
                    # client stopped reading; don't buffer events unboundedly
                    logger.warning("gamepad client not reading; dropping it")
                    self._writers.discard(w)
                    w.close()
                    continue
                w.write(event)
            except (ConnectionError, RuntimeError):
                self._writers.discard(w)

    def send_btn(self, btn_num: int, btn_val: float) -> None:
        self._broadcast(map_w3c_button(btn_num, btn_val))

    def send_axis(self, axis_num: int, axis_val: float) -> None:
        self._broadcast(map_w3c_axis(axis_num, axis_val))
