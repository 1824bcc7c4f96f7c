"""Host input injection: keyboard/mouse/gamepad/clipboard/resize into X11.

The port's copy of ``selkies_tpu/input_host/__init__.py``, unchanged.

Parity with the reference's webrtc_input.py/gamepad.py/resize.py via ctypes
bindings against libX11/libXtst/libXfixes/libXrandr (no python-xlib dep).
"""

from selkies_tpu_torch.input_host.backends import (
    FakeBackend,
    InputBackend,
    UinputMouseProxy,
    X11Backend,
    open_best_backend,
)
from selkies_tpu_torch.input_host.clipboard import (
    ClipboardBackend,
    MemoryClipboard,
    XselClipboard,
    open_best_clipboard,
)
from selkies_tpu_torch.input_host.gamepad import GamepadServer
from selkies_tpu_torch.input_host.handler import HostInput
from selkies_tpu_torch.input_host.x11 import CursorImage, X11Display, X11Unavailable

__all__ = [
    "ClipboardBackend",
    "CursorImage",
    "FakeBackend",
    "GamepadServer",
    "HostInput",
    "InputBackend",
    "MemoryClipboard",
    "UinputMouseProxy",
    "X11Backend",
    "X11Display",
    "X11Unavailable",
    "XselClipboard",
    "open_best_backend",
    "open_best_clipboard",
]
