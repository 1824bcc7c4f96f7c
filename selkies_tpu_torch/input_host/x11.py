"""Direct ctypes bindings to libX11 / libXtst / libXfixes.

The port's copy of ``selkies_tpu/input_host/x11.py``, unchanged.

The reference reaches X through python-xlib + pynput (webrtc_input.py:22-35);
neither is in this image, so we bind the three shared libraries directly.
Capabilities: XTest key/button/motion injection (abs + relative), keysym →
keycode resolution with on-the-fly spare-keycode mapping for keysyms absent
from the current keymap (what pynput does internally), and the XFixes
cursor-image API used by the cursor monitor (webrtc_input.py:437-553).

Everything degrades gracefully: if the libraries or the DISPLAY are absent,
``X11Display.open()`` raises ``X11Unavailable`` and callers fall back to the
fake backend (tests) or disable the feature (headless hosts).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import os
from dataclasses import dataclass

logger = logging.getLogger("input.x11")

# X protocol constants
_KEY_PRESS = 2
_CURRENT_TIME = 0
_NO_SYMBOL = 0
XFIXES_DISPLAY_CURSOR_NOTIFY_MASK = 1 << 0


class X11Unavailable(RuntimeError):
    pass


class _XFixesCursorImage(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_short),
        ("y", ctypes.c_short),
        ("width", ctypes.c_ushort),
        ("height", ctypes.c_ushort),
        ("xhot", ctypes.c_ushort),
        ("yhot", ctypes.c_ushort),
        ("cursor_serial", ctypes.c_ulong),
        ("pixels", ctypes.POINTER(ctypes.c_ulong)),
        ("atom", ctypes.c_ulong),
        ("name", ctypes.c_char_p),
    ]


@dataclass
class CursorImage:
    """Snapshot of the current cursor: ARGB pixels row-major."""

    width: int
    height: int
    xhot: int
    yhot: int
    serial: int
    argb: list[int]


def _load(*names: str) -> ctypes.CDLL | None:
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


class X11Display:
    """One X connection with the small API surface the input host needs."""

    def __init__(self, xlib, xtst, xfixes, display_ptr):
        self._x = xlib
        self._xtst = xtst
        self._xfixes = xfixes
        self._dpy = display_ptr
        self._spare_mappings: dict[int, int] = {}  # keysym -> borrowed keycode
        self._min_kc = ctypes.c_int(0)
        self._max_kc = ctypes.c_int(0)
        self._x.XDisplayKeycodes(self._dpy, ctypes.byref(self._min_kc), ctypes.byref(self._max_kc))
        self._cursor_events_selected = False

    # -- lifecycle ------------------------------------------------------

    @classmethod
    def open(cls, display_name: str | None = None) -> "X11Display":
        xlib = _load("libX11.so.6", "libX11.so")
        xtst = _load("libXtst.so.6", "libXtst.so")
        xfixes = _load("libXfixes.so.3", "libXfixes.so")
        if xlib is None or xtst is None:
            raise X11Unavailable("libX11/libXtst not found")
        xlib.XOpenDisplay.restype = ctypes.c_void_p
        xlib.XOpenDisplay.argtypes = [ctypes.c_char_p]
        name = display_name if display_name is not None else os.environ.get("DISPLAY")
        if not name:
            raise X11Unavailable("DISPLAY is not set")
        dpy = xlib.XOpenDisplay(name.encode())
        if not dpy:
            raise X11Unavailable(f"cannot open display {name!r}")
        cls._declare(xlib, xtst, xfixes)
        return cls(xlib, xtst, xfixes, dpy)

    @staticmethod
    def _declare(x, xtst, xfixes) -> None:
        vp, ul, i, ui = ctypes.c_void_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_uint
        x.XDefaultRootWindow.restype = ul
        x.XDefaultRootWindow.argtypes = [vp]
        x.XKeysymToKeycode.restype = ctypes.c_ubyte
        x.XKeysymToKeycode.argtypes = [vp, ul]
        x.XGetKeyboardMapping.restype = ctypes.POINTER(ul)
        x.XGetKeyboardMapping.argtypes = [vp, ctypes.c_ubyte, i, ctypes.POINTER(i)]
        x.XChangeKeyboardMapping.argtypes = [vp, i, i, ctypes.POINTER(ul), i]
        x.XDisplayKeycodes.argtypes = [vp, ctypes.POINTER(i), ctypes.POINTER(i)]
        x.XFlush.argtypes = [vp]
        x.XSync.argtypes = [vp, i]
        x.XPending.restype = i
        x.XPending.argtypes = [vp]
        x.XNextEvent.argtypes = [vp, ctypes.c_char_p]
        x.XFree.argtypes = [vp]
        x.XCloseDisplay.argtypes = [vp]
        xtst.XTestFakeKeyEvent.argtypes = [vp, ui, i, ul]
        xtst.XTestFakeButtonEvent.argtypes = [vp, ui, i, ul]
        xtst.XTestFakeMotionEvent.argtypes = [vp, i, i, i, ul]
        xtst.XTestFakeRelativeMotionEvent.argtypes = [vp, i, i, ul]
        if xfixes is not None:
            xfixes.XFixesQueryExtension.restype = i
            xfixes.XFixesQueryExtension.argtypes = [vp, ctypes.POINTER(i), ctypes.POINTER(i)]
            xfixes.XFixesSelectCursorInput.argtypes = [vp, ul, ul]
            xfixes.XFixesGetCursorImage.restype = ctypes.POINTER(_XFixesCursorImage)
            xfixes.XFixesGetCursorImage.argtypes = [vp]

    def close(self) -> None:
        if self._dpy:
            self._x.XCloseDisplay(self._dpy)
            self._dpy = None

    def flush(self) -> None:
        self._x.XFlush(self._dpy)

    def sync(self) -> None:
        self._x.XSync(self._dpy, 0)

    # -- keyboard -------------------------------------------------------

    def keysym_to_keycode(self, keysym: int) -> int:
        return int(self._x.XKeysymToKeycode(self._dpy, ctypes.c_ulong(keysym)))

    def _find_spare_keycode(self) -> int | None:
        count = self._max_kc.value - self._min_kc.value + 1
        per = ctypes.c_int(0)
        mapping = self._x.XGetKeyboardMapping(
            self._dpy, ctypes.c_ubyte(self._min_kc.value), count, ctypes.byref(per)
        )
        if not mapping:
            return None
        try:
            for kc_off in range(count - 1, -1, -1):
                if all(
                    mapping[kc_off * per.value + s] == _NO_SYMBOL
                    for s in range(per.value)
                ):
                    return self._min_kc.value + kc_off
        finally:
            self._x.XFree(mapping)
        return None

    def _map_spare(self, keysym: int) -> int:
        """Borrow an unused keycode for a keysym missing from the keymap."""
        if keysym in self._spare_mappings:
            return self._spare_mappings[keysym]
        kc = self._find_spare_keycode()
        if kc is None:
            return 0
        syms = (ctypes.c_ulong * 2)(keysym, keysym)
        self._x.XChangeKeyboardMapping(self._dpy, kc, 2, syms, 1)
        self.sync()
        self._spare_mappings[keysym] = kc
        return kc

    def fake_key(self, keysym: int, down: bool) -> None:
        keycode = self.keysym_to_keycode(keysym)
        if keycode == 0:
            keycode = self._map_spare(keysym)
            if keycode == 0:
                logger.warning("no keycode for keysym %d", keysym)
                return
        self._xtst.XTestFakeKeyEvent(self._dpy, keycode, 1 if down else 0, _CURRENT_TIME)
        self.flush()

    # -- pointer --------------------------------------------------------

    def fake_motion(self, x: int, y: int) -> None:
        self._xtst.XTestFakeMotionEvent(self._dpy, -1, int(x), int(y), _CURRENT_TIME)
        self.flush()

    def fake_relative_motion(self, dx: int, dy: int) -> None:
        self._xtst.XTestFakeRelativeMotionEvent(self._dpy, int(dx), int(dy), _CURRENT_TIME)
        self.flush()

    def fake_button(self, button: int, down: bool) -> None:
        self._xtst.XTestFakeButtonEvent(self._dpy, button, 1 if down else 0, _CURRENT_TIME)
        self.flush()

    # -- cursor (XFixes) ------------------------------------------------

    @property
    def has_xfixes(self) -> bool:
        if self._xfixes is None:
            return False
        eb, er = ctypes.c_int(0), ctypes.c_int(0)
        return bool(self._xfixes.XFixesQueryExtension(self._dpy, ctypes.byref(eb), ctypes.byref(er)))

    def select_cursor_events(self) -> None:
        root = self._x.XDefaultRootWindow(self._dpy)
        self._xfixes.XFixesSelectCursorInput(self._dpy, root, XFIXES_DISPLAY_CURSOR_NOTIFY_MASK)
        self.flush()
        self._cursor_events_selected = True

    def drain_events(self) -> int:
        """Discard queued events (cursor changes are detected by serial)."""
        n = 0
        buf = ctypes.create_string_buffer(192)  # sizeof(XEvent) on LP64
        while self._x.XPending(self._dpy) > 0:
            self._x.XNextEvent(self._dpy, buf)
            n += 1
        return n

    def get_cursor_image(self) -> CursorImage | None:
        if self._xfixes is None:
            return None
        ptr = self._xfixes.XFixesGetCursorImage(self._dpy)
        if not ptr:
            return None
        try:
            c = ptr.contents
            n = c.width * c.height
            # pixels are unsigned long on LP64 with ARGB in the low 32 bits
            argb = [c.pixels[i] & 0xFFFFFFFF for i in range(n)]
            return CursorImage(
                width=c.width, height=c.height, xhot=c.xhot, yhot=c.yhot,
                serial=int(c.cursor_serial), argb=argb,
            )
        finally:
            self._x.XFree(ptr)
