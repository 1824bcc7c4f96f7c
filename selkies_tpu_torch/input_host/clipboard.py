"""Clipboard backends.

The port's copy of ``selkies_tpu/input_host/clipboard.py``, unchanged.

The reference shells out to ``xsel`` (webrtc_input.py:401-414).  We keep
that as the production backend (gated on the binary being present) and add
an in-memory backend for tests and headless hosts.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from typing import Protocol

logger = logging.getLogger("input.clipboard")


class ClipboardBackend(Protocol):
    def read(self) -> str | None: ...

    def write(self, data: str) -> bool: ...


class XselClipboard:
    """xsel --clipboard subprocess backend."""

    @staticmethod
    def available() -> bool:
        return shutil.which("xsel") is not None

    def read(self) -> str | None:
        try:
            result = subprocess.run(
                ("xsel", "--clipboard", "--output"),
                check=True, text=True, capture_output=True, timeout=3,
            )
            return result.stdout
        except (subprocess.SubprocessError, OSError) as exc:
            logger.warning("clipboard read failed: %s", exc)
            return None

    def write(self, data: str) -> bool:
        try:
            subprocess.run(
                ("xsel", "--clipboard", "--input"),
                input=data.encode(), check=True, timeout=3,
            )
            return True
        except (subprocess.SubprocessError, OSError) as exc:
            logger.warning("clipboard write failed: %s", exc)
            return False


class MemoryClipboard:
    """In-process clipboard for tests / no-X hosts."""

    def __init__(self, initial: str = ""):
        self.data = initial

    def read(self) -> str | None:
        return self.data

    def write(self, data: str) -> bool:
        self.data = data
        return True


def open_best_clipboard() -> ClipboardBackend:
    if XselClipboard.available():
        return XselClipboard()
    logger.info("xsel not found; using in-memory clipboard")
    return MemoryClipboard()
