"""Audio pipeline: source → Opus → RTP, with live bitrate retune.

The port's copy of ``selkies_tpu/audio/pipeline.py``, on the port's tracer.

Parity: the reference audio chain pulsesrc → opusenc[restricted-lowdelay,
10 ms, inband FEC] → rtpopuspay → leaky queue → webrtcbin
(gstwebrtc_app.py:1004-1105).  The ticker pulls one 10 ms frame per
period; a slow sink drops frames (leaky-queue semantics) via the same
latest-wins handoff the video pipeline uses.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Awaitable, Callable

from selkies_tpu_torch.audio.opus import FRAME_MS, OpusEncoder, SAMPLE_RATE
from selkies_tpu_torch.audio.sources import AudioSource, SyntheticAudioSource
from selkies_tpu_torch.monitoring.tracing import tracer

logger = logging.getLogger("audio.pipeline")


@dataclass
class EncodedAudio:
    packet: bytes
    timestamp_48k: int
    wall_time: float


AudioSink = Callable[[EncodedAudio], Awaitable[None]]


class AudioPipeline:
    def __init__(
        self,
        source: AudioSource | None = None,
        sink: AudioSink | None = None,
        bitrate_bps: int = 128000,
    ):
        self.source = source or SyntheticAudioSource()
        self.sink = sink
        self.encoder = OpusEncoder(bitrate_bps=bitrate_bps)
        self._task: asyncio.Task | None = None
        self.frames = 0
        self.dropped_frames = 0
        self._latest: EncodedAudio | None = None
        self._ready = asyncio.Event()
        self._sender: asyncio.Task | None = None

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    def set_bitrate(self, bitrate_bps: int) -> None:
        self.encoder.set_bitrate(bitrate_bps)

    async def start(self) -> None:
        if self.running:
            return
        await self.source.start()
        self._task = asyncio.create_task(self._run(), name="audio-pipeline")
        self._sender = asyncio.create_task(self._send_loop(), name="audio-sender")

    async def stop(self) -> None:
        for attr in ("_task", "_sender"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)
        await self.source.stop()

    async def _run(self) -> None:
        t0 = time.monotonic()
        period = FRAME_MS / 1000.0
        next_tick = t0
        samples = 0
        while True:
            now = time.monotonic()
            if now < next_tick:
                await asyncio.sleep(next_tick - now)
            next_tick = max(next_tick + period, time.monotonic() - period)
            try:
                pcm = await self.source.read_frame()
                with tracer.span("audio-encode"):
                    packet = await asyncio.to_thread(self.encoder.encode, pcm)
                ea = EncodedAudio(packet=packet, timestamp_48k=samples, wall_time=time.time())
                samples += SAMPLE_RATE * FRAME_MS // 1000
                self.frames += 1
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("audio frame error")
                continue
            if self._latest is not None:
                self.dropped_frames += 1
            self._latest = ea
            self._ready.set()

    async def _send_loop(self) -> None:
        while True:
            await self._ready.wait()
            self._ready.clear()
            ea, self._latest = self._latest, None
            if ea is None or self.sink is None:
                continue
            try:
                with tracer.span("audio-send"):
                    await self.sink(ea)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("audio sink error")
