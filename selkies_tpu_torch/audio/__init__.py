"""Audio plane: Opus encode (ctypes libopus), capture sources, pipeline.

The port's copy of ``selkies_tpu/audio/__init__.py``, unchanged.

Parity with the reference audio path (gstwebrtc_app.py:1004-1105):
pulsesrc → opusenc restricted-lowdelay 10 ms inband-FEC → rtpopuspay.
"""

from selkies_tpu_torch.audio.opus import (
    CHANNELS,
    FRAME_MS,
    FRAME_SAMPLES,
    OpusDecoder,
    OpusEncoder,
    SAMPLE_RATE,
    opus_available,
)
from selkies_tpu_torch.audio.pipeline import AudioPipeline, EncodedAudio
from selkies_tpu_torch.audio.sources import (
    AudioSource,
    PulseAudioSource,
    SyntheticAudioSource,
    open_best_audio_source,
)

__all__ = [
    "AudioPipeline",
    "AudioSource",
    "CHANNELS",
    "EncodedAudio",
    "FRAME_MS",
    "FRAME_SAMPLES",
    "OpusDecoder",
    "OpusEncoder",
    "PulseAudioSource",
    "SAMPLE_RATE",
    "SyntheticAudioSource",
    "open_best_audio_source",
    "opus_available",
]
