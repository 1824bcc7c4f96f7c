"""The port's input host against JAX's: the same client messages into each
package's ``HostInput`` over a ``FakeBackend`` and a ``MemoryClipboard``
give the same call log (backend events, every orchestrator callback with
its arguments, the clipboard's contents), on the cases of
test_input_host.py; the gamepad socket's wire bytes, the uinput proxy's
datagrams, the cursor messages and ``resize.py``'s command lines
(test_resize.py) are equal too. Exact equality throughout; the ping's
latency depends on the clock and is compared by count only."""

from __future__ import annotations

import asyncio
import base64
import socket
import subprocess
import types

import pytest

import selkies_tpu.input_host as jin
import selkies_tpu.input_host.backends as jbackends
import selkies_tpu.input_host.gamepad as jgamepad
import selkies_tpu.input_host.resize as jresize
import selkies_tpu.input_host.x11 as jx11
import selkies_tpu_torch.input_host as tin
import selkies_tpu_torch.input_host.backends as tbackends
import selkies_tpu_torch.input_host.gamepad as tgamepad
import selkies_tpu_torch.input_host.resize as tresize
import selkies_tpu_torch.input_host.x11 as tx11

PKGS = {
    "jax": types.SimpleNamespace(inp=jin, backends=jbackends, gamepad=jgamepad, resize=jresize,
                                 x11=jx11),
    "torch": types.SimpleNamespace(inp=tin, backends=tbackends, gamepad=tgamepad,
                                   resize=tresize, x11=tx11),
}

CALLBACKS = ("on_video_encoder_bit_rate", "on_audio_encoder_bit_rate",
             "on_mouse_pointer_visible", "on_clipboard_read", "on_set_fps",
             "on_set_enable_resize", "on_client_fps", "on_media_ack", "on_client_latency",
             "on_resize", "on_scaling_ratio", "on_cursor_change", "on_client_webrtc_stats")

SCRIPTS = {
    "keyboard": ["kd,65", "ku,65", "kd,65505", "kd,97", "ku,97", "ku,65505", "kr"],
    "keyboard_reset": ["kr"],
    "mouse_buttons": ["m,100,200,1,0", "m,100,200,0,0", "m,5,6,4,0", "m,5,6,2,0",
                      "m,5,6,0,0"],
    "mouse_scroll": ["m,100,200,8,3", "m,100,200,0,0", "m,1,2,16,2", "m,1,2,0,0",
                     "m,1,2,8,0"],
    "mouse_relative": ["m2,-5,7,0,0", "m2,3,-1,1,0", "m2,0,0,0,0"],
    "malformed": ["m,xx,yy", "kd,zz", "vb", "_arg_fps,abc", "js,b,x,1,1", "nonsense,1",
                  "m2,1"],
    "settings": ["vb,4000", "ab,128000", "p,1", "p,0", "r,1921x1079", "r,bad", "s,1.25",
                 "_arg_fps,30", "_arg_resize,true,800x601", "_arg_resize,false",
                 "_f,59", "_l,12", '_stats_video,{"a":1},extra', '_stats_audio,[]',
                 "_ack,7,123.5"],
    "clipboard": ["cr", "cw," + base64.b64encode("world".encode()).decode(), "cr",
                  "cw," + base64.b64encode("ünïcode".encode()).decode(), "cr"],
}


def _loop():
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    return loop


def _run_script(pkg, script, enable_clipboard="true", js_path="/tmp"):
    """-> (backend events, callback log, clipboard text)."""
    backend, clip = pkg.inp.FakeBackend(), pkg.inp.MemoryClipboard("hello")
    hi = pkg.inp.HostInput(backend=backend, clipboard=clip, enable_clipboard=enable_clipboard,
                           js_socket_path=js_path)
    log = []
    for name in CALLBACKS:
        setattr(hi, name, lambda *a, _n=name: log.append((_n, a)))
    loop = _loop()
    try:
        for msg in script:
            loop.run_until_complete(hi.on_message(msg))
        loop.run_until_complete(hi.stop_js_server())
    finally:
        loop.close()
    return backend.events, log, clip.read()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_message_scripts_give_jax_call_logs(name):
    got = {k: _run_script(pkg, SCRIPTS[name]) for k, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["jax"][0] or got["jax"][1] or name == "clipboard"


@pytest.mark.parametrize("enabled", ["true", "false", "in", "out"])
def test_clipboard_gating_matches_jax(enabled):
    got = {k: _run_script(pkg, SCRIPTS["clipboard"], enable_clipboard=enabled)
           for k, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]


def test_ping_pong_matches_jax():
    import time

    counts = {}
    for k, pkg in PKGS.items():
        hi = pkg.inp.HostInput(backend=pkg.inp.FakeBackend(), clipboard=pkg.inp.MemoryClipboard())
        got = []
        hi.on_ping_response = got.append
        loop = _loop()
        try:
            loop.run_until_complete(hi.on_message("pong,1"))  # no ping out yet
            hi.send_ping(time.time() - 0.1)
            loop.run_until_complete(hi.on_message("pong,123"))
        finally:
            loop.close()
        counts[k] = [40 < ms < 500 for ms in got]
    assert counts["torch"] == counts["jax"] == [True]


# -- gamepads ------------------------------------------------------------------

def test_w3c_mapping_matches_jax():
    def event(packed):  # (value, type, number): the timestamp is the clock's
        return None if packed is None else jgamepad.EVENT_STRUCT.unpack(packed)[1:]

    for button in range(18):
        for value in (0.0, 0.25, 0.5, 1.0):
            assert (event(tgamepad.map_w3c_button(button, value))
                    == event(jgamepad.map_w3c_button(button, value))), (button, value)
    for axis in range(6):
        for value in (-1.0, -0.5, 0.0, 0.3, 1.0):
            assert (event(tgamepad.map_w3c_axis(axis, value))
                    == event(jgamepad.map_w3c_axis(axis, value))), (axis, value)
    for name in ("ABS_MAX", "ABS_MIN", "JS_EVENT_AXIS", "JS_EVENT_BUTTON", "XPAD_AXES_MAP",
                 "XPAD_BTN_MAP"):
        assert getattr(tgamepad, name) == getattr(jgamepad, name), name
    assert tgamepad.CONFIG_STRUCT.format == jgamepad.CONFIG_STRUCT.format
    assert tgamepad.EVENT_STRUCT.format == jgamepad.EVENT_STRUCT.format


async def _gamepad_wire(pkg, path):
    """Connect js0 through the input protocol, read the config and the
    neutral burst, send buttons and axes, and return what the socket
    carried (each event without its timestamp)."""
    hi = pkg.inp.HostInput(backend=pkg.inp.FakeBackend(), clipboard=pkg.inp.MemoryClipboard(),
                           js_socket_path=path)
    g = pkg.gamepad
    name = base64.b64encode(b"Xbox 360 Controller").decode()
    await hi.on_message(f"js,c,0,{name},6,17")
    reader, writer = await asyncio.open_unix_connection(hi.js_socket_paths[0])
    out = [await asyncio.wait_for(reader.readexactly(g.CONFIG_STRUCT.size), 5)]
    for msg in ("js,b,0,0,1", "js,b,0,0,0", "js,b,0,6,0.5", "js,b,0,14,1", "js,a,0,2,1.0",
                "js,a,0,1,-0.25", "js,b,1,0,1"):  # js1 is not connected
        await hi.on_message(msg)
    await asyncio.sleep(0.1)
    while True:  # the neutral burst, then the script's events
        try:
            ev = await asyncio.wait_for(reader.readexactly(g.EVENT_STRUCT.size), 0.5)
        except asyncio.TimeoutError:
            break
        out.append(g.EVENT_STRUCT.unpack(ev)[1:])
    writer.close()
    await writer.wait_closed()
    await asyncio.sleep(0.05)  # the server's client task sees the close
    await hi.on_message("js,d,0")
    await hi.stop_js_server()
    import os

    out.append(os.path.exists(hi.js_socket_paths[0]))
    return out


def test_gamepad_socket_wire_matches_jax(tmp_path):
    got = {}
    for k, pkg in PKGS.items():
        d = tmp_path / k
        d.mkdir()
        loop = _loop()
        try:
            got[k] = loop.run_until_complete(_gamepad_wire(pkg, str(d)))
        finally:
            loop.close()
    assert got["torch"] == got["jax"]
    assert len(got["jax"]) > 8 and got["jax"][-1] is False


def test_uinput_mouse_proxy_datagrams_match_jax(tmp_path):
    import msgpack

    got = {}
    for k, pkg in PKGS.items():
        path = str(tmp_path / f"{k}.sock")
        rx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        rx.bind(path)
        rx.settimeout(2)
        proxy = pkg.backends.UinputMouseProxy(path)
        try:
            proxy.pointer_motion(-5, 7)
            for b in (1, 2, 3):
                proxy.button(b, True)
                proxy.button(b, False)
            proxy.scroll(up=False)
            proxy.scroll(up=True)
            got[k] = [msgpack.unpackb(rx.recv(4096), raw=False) for _ in range(10)]
        finally:
            proxy.close()
            rx.close()
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("size", [-1, 4, 16, 32])
def test_cursor_messages_match_jax(size):
    got = {}
    for k, pkg in PKGS.items():
        hi = pkg.inp.HostInput(backend=pkg.inp.FakeBackend(), clipboard=pkg.inp.MemoryClipboard())
        argb = [(0xFF << 24) | (i * 0x010203 & 0xFFFFFF) for i in range(64)]
        cur = pkg.x11.CursorImage(width=8, height=8, xhot=2, yhot=3, serial=42, argb=argb)
        blank = pkg.x11.CursorImage(width=4, height=4, xhot=0, yhot=0, serial=7, argb=[0] * 16)
        got[k] = [hi.cursor_to_msg(cur, cursor_size=size), hi.cursor_to_msg(blank, cursor_size=size),
                  hi.cursor_to_msg(cur, scale=1.5, cursor_size=size)]
    assert got["torch"] == got["jax"]


def test_backend_fallback_matches_jax(monkeypatch):
    """Without a display both packages open the FakeBackend and the
    memory clipboard."""
    monkeypatch.delenv("DISPLAY", raising=False)
    for pkg in PKGS.values():
        assert type(pkg.backends.open_best_backend()).__name__ == "FakeBackend"
    assert (type(tin.open_best_clipboard()).__name__ == type(jin.open_best_clipboard()).__name__)


# -- resize.py (test_resize.py) ---------------------------------------------------

XRANDR_OUT = """\
Screen 0: minimum 320 x 200, current 1920 x 1080, maximum 16384 x 16384
eDP-1 connected primary 1920x1080+0+0 (normal left inverted) 344mm x 194mm
   1920x1080     60.02*+  59.97
   1680x1050     59.95
   1280x720      60.00
"""

XRANDR_DVI = XRANDR_OUT.replace("eDP-1", "DVI-D-0")

CVT_OUT = """\
# 2560x1440 59.95 Hz (CVT 3.69M9-R) hsync: 88.79 kHz; pclk: 241.50 MHz
Modeline "2560x1440R"  241.50  2560 2608 2640 2720  1440 1443 1448 1481 +hsync -vsync
"""


class FakeRunner:
    def __init__(self, xrandr=XRANDR_OUT, fail: str = ""):
        self.calls: list[list[str]] = []
        self.xrandr, self.fail = xrandr, fail

    def __call__(self, cmd):
        self.calls.append(cmd)
        out = ""
        if cmd[0] == "xrandr" and len(cmd) == 1:
            out = self.xrandr
        elif cmd[0] == "cvt":
            out = CVT_OUT
        rc = 1 if self.fail and self.fail in cmd else 0
        return subprocess.CompletedProcess(cmd, rc, stdout=out, stderr="")


RESIZES = [("2560x1440", XRANDR_OUT, ""), ("1920x1080", XRANDR_OUT, ""),
           ("1280x720", XRANDR_OUT, ""), ("9000x5000", XRANDR_OUT, ""),
           ("2561x1601", XRANDR_DVI, ""), ("2560x1440", XRANDR_OUT, "--newmode"),
           ("1280x720", XRANDR_OUT, "--output"), ("nonsense", XRANDR_OUT, ""),
           ("640x480", "no outputs here\n", "")]


@pytest.mark.parametrize("res,xrandr,fail", RESIZES)
def test_resize_command_lines_match_jax(res, xrandr, fail):
    got = {}
    for k, pkg in PKGS.items():
        runner = FakeRunner(xrandr, fail)
        try:
            result = pkg.resize.resize_display(res, runner)
        except Exception as exc:  # the same exception type in both
            result = type(exc).__name__
        got[k] = (result, runner.calls)
    assert got["torch"] == got["jax"]


def test_resize_helpers_match_jax():
    for args in ((1920, 1080, 7680, 4320), (8000, 4500, 7680, 4320), (2561, 1601, 2560, 1600),
                 (3, 3, 2, 2)):
        assert tresize.fit_res(*args) == jresize.fit_res(*args)
    for out in (XRANDR_OUT, XRANDR_DVI, "", "garbage\n"):
        assert tresize.parse_xrandr(out) == jresize.parse_xrandr(out)
    for res in ("9000x5000", "1920x1080", "2560x1440"):
        assert (tresize.get_new_res(res, FakeRunner())
                == jresize.get_new_res(res, FakeRunner()))
    assert (tresize.generate_modeline("2560x1440", FakeRunner())
            == jresize.generate_modeline("2560x1440", FakeRunner()))
    assert tresize.MAX_RES_DVI == jresize.MAX_RES_DVI
