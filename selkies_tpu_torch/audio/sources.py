"""Audio frame sources: native libpulse-simple capture, ``parec``
subprocess capture, and a synthetic tone.

The port's copy of ``selkies_tpu/audio/sources.py``, unchanged.

Parity: the reference captures with ``pulsesrc`` (buffer-time 100 ms,
latency-time 1 ms, gstwebrtc_app.py:1009-1028). The native source binds
``pa_simple`` over ctypes — same protocol client pulsesrc ultimately is —
with the fragment size set to one 10 ms Opus frame so read latency
matches the reference's latency-time tuning. ``parec`` remains as a
fallback for hosts with the CLI but no loadable libpulse, and the
synthetic source keeps the pipeline exercised end-to-end on headless
rigs. Device selection (``--audio_device`` / SELKIES_AUDIO_DEVICE)
reaches every backend.
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import glob
import logging
import math
import os
import shutil
import struct
from typing import Protocol

from selkies_tpu_torch.audio.opus import CHANNELS, FRAME_SAMPLES, SAMPLE_RATE

logger = logging.getLogger("audio.sources")

FRAME_BYTES = FRAME_SAMPLES * CHANNELS * 2


class AudioSource(Protocol):
    async def start(self) -> None: ...

    async def read_frame(self) -> bytes:
        """Return one 10 ms s16le stereo frame (FRAME_BYTES bytes)."""
        ...

    async def stop(self) -> None: ...


class SyntheticAudioSource:
    """440 Hz sine (quiet) — deterministic signal for tests and demos."""

    def __init__(self, freq: float = 440.0, amplitude: float = 0.1):
        self.freq = freq
        self.amplitude = amplitude
        self._phase = 0

    async def start(self) -> None:
        return None

    async def read_frame(self) -> bytes:
        out = bytearray()
        amp = int(self.amplitude * 32767)
        for i in range(FRAME_SAMPLES):
            s = int(amp * math.sin(2 * math.pi * self.freq * (self._phase + i) / SAMPLE_RATE))
            out += struct.pack("<hh", s, s)
        self._phase += FRAME_SAMPLES
        return bytes(out)

    async def stop(self) -> None:
        return None


# -- native libpulse-simple capture -----------------------------------

_PA_STREAM_RECORD = 2
_PA_SAMPLE_S16LE = 3


class _PaSampleSpec(ctypes.Structure):
    _fields_ = [("format", ctypes.c_int), ("rate", ctypes.c_uint32),
                ("channels", ctypes.c_uint8)]


class _PaBufferAttr(ctypes.Structure):
    _fields_ = [("maxlength", ctypes.c_uint32), ("tlength", ctypes.c_uint32),
                ("prebuf", ctypes.c_uint32), ("minreq", ctypes.c_uint32),
                ("fragsize", ctypes.c_uint32)]


_pa_lib = None
_pa_tried = False


def _load_pa_simple() -> ctypes.CDLL | None:
    """libpulse-simple from the system, or any vendored copy on the
    python path (this image ships one inside pygame.libs)."""
    global _pa_lib, _pa_tried
    if _pa_tried:
        return _pa_lib
    _pa_tried = True
    names = ["libpulse-simple.so.0", "libpulse-simple.so"]
    found = ctypes.util.find_library("pulse-simple")
    if found:
        names.insert(0, found)
    import sys

    for sp in sys.path:
        names.extend(glob.glob(os.path.join(sp, "pygame.libs",
                                            "libpulse-simple*.so*")))
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            lib.pa_simple_new.restype = ctypes.c_void_p
            lib.pa_simple_new.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(_PaSampleSpec), ctypes.c_void_p,
                ctypes.POINTER(_PaBufferAttr),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.pa_simple_read.restype = ctypes.c_int
            lib.pa_simple_read.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.pa_simple_free.restype = None
            lib.pa_simple_free.argtypes = [ctypes.c_void_p]
            lib.pa_strerror.restype = ctypes.c_char_p
            lib.pa_strerror.argtypes = [ctypes.c_int]
            _pa_lib = lib
            logger.info("libpulse-simple loaded: %s", name)
            return lib
        except (OSError, AttributeError):
            continue
    logger.info("libpulse-simple not loadable")
    return None


class NativePulseSource:
    """ctypes ``pa_simple`` capture — no subprocess, 10 ms fragments.

    The reference's pulsesrc tuning (buffer-time=100000 latency-time=1000,
    gstwebrtc_app.py:1009-1028) maps to maxlength = 100 ms of s16le and
    fragsize = one frame: the server wakes once per Opus frame.
    """

    def __init__(self, device: str | None = None):
        self.device = device
        self._s: ctypes.c_void_p | None = None
        # serializes pa_simple_read against pa_simple_free: cancelling
        # the asyncio read resolves while the worker THREAD is still
        # blocked inside pa_simple_read, and freeing the handle under it
        # would be a native use-after-free
        import threading

        self._io_lock = threading.Lock()

    @staticmethod
    def available() -> bool:
        return _load_pa_simple() is not None

    def _open_sync(self) -> ctypes.c_void_p:
        lib = _load_pa_simple()
        if lib is None:
            raise RuntimeError("libpulse-simple unavailable")
        spec = _PaSampleSpec(_PA_SAMPLE_S16LE, SAMPLE_RATE, CHANNELS)
        attr = _PaBufferAttr(
            maxlength=FRAME_BYTES * 10,  # ~100 ms cap (pulsesrc parity)
            tlength=0xFFFFFFFF, prebuf=0xFFFFFFFF, minreq=0xFFFFFFFF,
            fragsize=FRAME_BYTES,
        )
        err = ctypes.c_int(0)
        dev = self.device.encode() if self.device else None
        s = lib.pa_simple_new(
            None, b"selkies-tpu", _PA_STREAM_RECORD, dev,
            b"audio-capture", ctypes.byref(spec), None,
            ctypes.byref(attr), ctypes.byref(err))
        if not s:
            raise RuntimeError(
                f"pa_simple_new failed: {lib.pa_strerror(err).decode()}")
        return ctypes.c_void_p(s)

    async def start(self) -> None:
        self._s = await asyncio.to_thread(self._open_sync)
        logger.info("native pulse capture started (device=%s)",
                    self.device or "default")

    async def read_frame(self) -> bytes:
        assert self._s is not None
        lib = _load_pa_simple()
        buf = (ctypes.c_uint8 * FRAME_BYTES)()

        def _read():
            with self._io_lock:
                s = self._s
                if s is None:
                    raise RuntimeError("capture stopped")
                err = ctypes.c_int(0)
                if lib.pa_simple_read(s, buf, FRAME_BYTES,
                                      ctypes.byref(err)) < 0:
                    raise RuntimeError(
                        f"pa_simple_read: {lib.pa_strerror(err).decode()}")
            return bytes(buf)

        return await asyncio.to_thread(_read)

    async def stop(self) -> None:
        if self._s is not None:
            def _free():
                # wait out any read still blocked in the native call —
                # but bounded: a suspended/corked source can park
                # pa_simple_read forever, and shutdown must not hang on
                # it. On timeout the handle is deliberately leaked (one
                # small native object) instead of freed under the read
                # (use-after-free) or waited on (hung shutdown).
                if not self._io_lock.acquire(timeout=2.0):
                    logger.warning(
                        "pulse read stalled >2s; leaking pa_simple handle")
                    self._s = None
                    return
                try:
                    s, self._s = self._s, None
                    if s is not None:
                        _load_pa_simple().pa_simple_free(s)
                finally:
                    self._io_lock.release()

            await asyncio.to_thread(_free)


class PulseAudioSource:
    """``parec`` subprocess capture from the default monitor device."""

    def __init__(self, device: str | None = None):
        self.device = device
        self._proc: asyncio.subprocess.Process | None = None

    @staticmethod
    def available() -> bool:
        return shutil.which("parec") is not None

    async def start(self) -> None:
        cmd = [
            "parec", "--format=s16le", f"--rate={SAMPLE_RATE}", f"--channels={CHANNELS}",
            f"--latency-msec=1",
        ]
        if self.device:
            cmd += ["-d", self.device]
        self._proc = await asyncio.create_subprocess_exec(
            *cmd, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL
        )
        logger.info("parec capture started (device=%s)", self.device or "default")

    async def read_frame(self) -> bytes:
        assert self._proc is not None and self._proc.stdout is not None
        return await self._proc.stdout.readexactly(FRAME_BYTES)

    async def stop(self) -> None:
        if self._proc is not None:
            try:
                self._proc.terminate()
                await self._proc.wait()
            except ProcessLookupError:
                pass
            self._proc = None


def open_best_audio_source(device: str | None = None) -> AudioSource:
    """Native pa_simple when loadable + a daemon answers, then parec,
    then the synthetic tone. The native probe actually opens a stream —
    a loadable library without a running daemon must not win and then
    fail at start()."""
    if NativePulseSource.available():
        probe = NativePulseSource(device)
        try:
            s = probe._open_sync()
            _load_pa_simple().pa_simple_free(s)
            return probe  # probe never kept a handle; it IS the source
        except Exception as exc:
            logger.info("native pulse probe failed (%s); trying parec", exc)
    if PulseAudioSource.available():
        return PulseAudioSource(device)
    logger.info("no PulseAudio capture available; synthetic audio source")
    return SyntheticAudioSource()
