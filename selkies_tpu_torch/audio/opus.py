"""Opus codec via ctypes against the system libopus.

The port's copy of ``selkies_tpu/audio/opus.py``, unchanged.

Replaces the reference's ``opusenc`` element configured for interactive
streaming: restricted-lowdelay application, 10 ms frames, in-band FEC,
bitrate retunable live (gstwebrtc_app.py:1043-1105, set_audio_bitrate
:1414).  A decoder binding is included for round-trip tests.
"""

from __future__ import annotations

import ctypes
import logging

logger = logging.getLogger("audio.opus")

SAMPLE_RATE = 48000
CHANNELS = 2
FRAME_MS = 10
FRAME_SAMPLES = SAMPLE_RATE * FRAME_MS // 1000  # 480
MAX_PACKET = 4000

# opus_defines.h
OPUS_OK = 0
OPUS_APPLICATION_RESTRICTED_LOWDELAY = 2051
OPUS_SET_BITRATE = 4002
OPUS_SET_INBAND_FEC = 4012
OPUS_SET_PACKET_LOSS_PERC = 4014
OPUS_SET_DTX = 4016

_lib = None
_lib_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    for name in ("libopus.so.0", "libopus.so"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        logger.warning("libopus not found; audio encoding disabled")
        return None
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encoder_create.argtypes = [
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    lib.opus_encode.restype = ctypes.c_int32
    lib.opus_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int32,
    ]
    lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_decoder_create.restype = ctypes.c_void_p
    lib.opus_decoder_create.argtypes = [ctypes.c_int32, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.opus_decode.restype = ctypes.c_int
    lib.opus_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
    ]
    lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def opus_available() -> bool:
    return _load() is not None


class OpusEncoder:
    """Stateful stereo encoder; one 10 ms s16le frame in, one packet out."""

    def __init__(self, bitrate_bps: int = 128000, fec: bool = True, loss_pct: int = 5):
        lib = _load()
        if lib is None:
            raise RuntimeError("libopus unavailable")
        self._lib = lib
        err = ctypes.c_int(0)
        self._enc = lib.opus_encoder_create(
            SAMPLE_RATE, CHANNELS, OPUS_APPLICATION_RESTRICTED_LOWDELAY, ctypes.byref(err)
        )
        if err.value != OPUS_OK or not self._enc:
            raise RuntimeError(f"opus_encoder_create failed: {err.value}")
        self._ctl = lib.opus_encoder_ctl
        self.set_bitrate(bitrate_bps)
        if fec:
            self._ctl(ctypes.c_void_p(self._enc), OPUS_SET_INBAND_FEC, 1)
            self._ctl(ctypes.c_void_p(self._enc), OPUS_SET_PACKET_LOSS_PERC, loss_pct)
        self._out = ctypes.create_string_buffer(MAX_PACKET)

    def set_bitrate(self, bitrate_bps: int) -> None:
        self._ctl(ctypes.c_void_p(self._enc), OPUS_SET_BITRATE, int(bitrate_bps))

    def encode(self, pcm_s16le: bytes) -> bytes:
        """Encode one frame: FRAME_SAMPLES * CHANNELS int16 samples."""
        expected = FRAME_SAMPLES * CHANNELS * 2
        if len(pcm_s16le) != expected:
            raise ValueError(f"expected {expected} bytes of s16le, got {len(pcm_s16le)}")
        pcm = (ctypes.c_int16 * (FRAME_SAMPLES * CHANNELS)).from_buffer_copy(pcm_s16le)
        n = self._lib.opus_encode(self._enc, pcm, FRAME_SAMPLES, self._out, MAX_PACKET)
        if n < 0:
            raise RuntimeError(f"opus_encode error {n}")
        return self._out.raw[:n]

    def close(self) -> None:
        if self._enc:
            self._lib.opus_encoder_destroy(self._enc)
            self._enc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class OpusDecoder:
    """Decoder for round-trip tests / loopback clients."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("libopus unavailable")
        self._lib = lib
        err = ctypes.c_int(0)
        self._dec = lib.opus_decoder_create(SAMPLE_RATE, CHANNELS, ctypes.byref(err))
        if err.value != OPUS_OK or not self._dec:
            raise RuntimeError(f"opus_decoder_create failed: {err.value}")
        self._pcm = (ctypes.c_int16 * (FRAME_SAMPLES * CHANNELS * 6))()

    def decode(self, packet: bytes) -> bytes:
        n = self._lib.opus_decode(
            self._dec, packet, len(packet), self._pcm, FRAME_SAMPLES * 6, 0
        )
        if n < 0:
            raise RuntimeError(f"opus_decode error {n}")
        return bytes(memoryview(self._pcm)[: n * CHANNELS].cast("B"))

    def close(self) -> None:
        if self._dec:
            self._lib.opus_decoder_destroy(self._dec)
            self._dec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
