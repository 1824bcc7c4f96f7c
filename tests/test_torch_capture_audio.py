"""The port's capture, audio and host monitors against JAX's.

* ``make_frame_source`` without a display gives frames (and damage rects)
  equal to JAX's; the ctypes layouts and ``pad_frame_to_even`` match; the
  live X11 cases (test_capture.py) run where a display exists, as JAX's
  do, and skip otherwise.
* Opus (where libopus loads, as test_audio.py): the same PCM through each
  package's ``OpusEncoder`` gives equal packets, at every bitrate and
  across a retune; each ``AudioPipeline`` over the synthetic source codes
  the same packets at the same timestamps.
* ``Metrics`` (the exporter, the stats CSVs) and ``SystemMonitor`` behave
  as JAX's: the same scrape text from the same emissions, the same CSV
  rows (the wall-clock column apart).

Exact equality throughout."""

from __future__ import annotations

import asyncio
import csv
import ctypes
import json
import os

import numpy as np
import pytest

import selkies_tpu.audio as jaudio
import selkies_tpu.audio.sources as jsources
import selkies_tpu.pipeline.capture as jcapture
import selkies_tpu_torch.audio as taudio
import selkies_tpu_torch.audio.sources as tsources
import selkies_tpu_torch.pipeline.capture as tcapture
from selkies_tpu.input_host.x11 import X11Unavailable as JX11Unavailable
from selkies_tpu.monitoring.metrics import Metrics as JMetrics
from selkies_tpu.monitoring.metrics import _CsvLog as JCsvLog
from selkies_tpu.monitoring.system_monitor import SystemMonitor as JSystemMonitor
from selkies_tpu.monitoring.telemetry import telemetry as jtelemetry
from selkies_tpu_torch.input_host.x11 import X11Unavailable as TX11Unavailable
from selkies_tpu_torch.monitoring.metrics import Metrics as TMetrics
from selkies_tpu_torch.monitoring.metrics import _CsvLog as TCsvLog
from selkies_tpu_torch.monitoring.system_monitor import SystemMonitor as TSystemMonitor
from selkies_tpu_torch.monitoring.telemetry import telemetry as ttelemetry


# -- capture ----------------------------------------------------------------------

@pytest.mark.parametrize("struct", ["_XImage", "_XShmSegmentInfo", "_XRectangle",
                                    "_XDamageNotifyEvent", "_XImageFuncs"])
def test_ctypes_layouts_match_jax(struct):
    t, j = getattr(tcapture, struct), getattr(jcapture, struct)
    assert ctypes.sizeof(t) == ctypes.sizeof(j)
    assert ([(n, getattr(t, n).offset, getattr(t, n).size) for n, *_ in t._fields_]
            == [(n, getattr(j, n).offset, getattr(j, n).size) for n, *_ in j._fields_])


def test_pad_frame_to_even_matches_jax():
    rng = np.random.default_rng(4)
    for h, w in [(48, 64), (48, 63), (47, 64), (47, 63), (2161, 4096), (1, 1)]:
        frame = rng.integers(0, 256, (h, w, 4), np.uint8)
        t, j = tcapture.pad_frame_to_even(frame), jcapture.pad_frame_to_even(frame)
        np.testing.assert_array_equal(t, j)
        assert t.flags["C_CONTIGUOUS"] and (t is frame) == (j is frame)


@pytest.mark.parametrize("w,h", [(192, 128), (320, 240), (1920, 1080)])
def test_frame_source_without_display_matches_jax(monkeypatch, w, h):
    monkeypatch.delenv("DISPLAY", raising=False)
    t, j = tcapture.make_frame_source(w, h), jcapture.make_frame_source(w, h)
    assert type(t).__name__ == type(j).__name__ == "SyntheticSource"
    assert (t.width, t.height) == (j.width, j.height) == (w, h)
    for _ in range(4 if w > 1000 else 12):
        np.testing.assert_array_equal(t.capture(), j.capture())
        assert t.last_damage == j.last_damage


def test_open_without_display_raises_as_jax(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    with pytest.raises(JX11Unavailable):
        jcapture.X11CaptureSource()
    with pytest.raises(TX11Unavailable):
        tcapture.X11CaptureSource()


def _need_display():
    if not os.environ.get("DISPLAY"):
        pytest.skip("needs a live X server (as test_capture.py's live cases)")


@pytest.mark.parametrize("use_shm", [True, False])
def test_live_grab_matches_jax(use_shm):
    _need_display()
    t, j = tcapture.X11CaptureSource(use_shm=use_shm), jcapture.X11CaptureSource(use_shm=use_shm)
    try:
        assert (t.width, t.height, t.using_shm) == (j.width, j.height, j.using_shm)
        a, b = t.capture(), j.capture()
        assert a.shape == b.shape == (t.height, t.width, 4) and a.dtype == b.dtype == np.uint8
    finally:
        t.close()
        j.close()


def test_live_selection_matches_jax():
    _need_display()
    t, j = tcapture.make_frame_source(320, 240), jcapture.make_frame_source(320, 240)
    try:
        assert type(t).__name__ == type(j).__name__ == "X11CaptureSource"
    finally:
        t.close()
        j.close()


# -- audio ------------------------------------------------------------------------

def _need_opus():
    if not (taudio.opus_available() and jaudio.opus_available()):
        pytest.skip("libopus not present (as test_audio.py)")


def _pcm_frames(n, freq=440.0, amplitude=0.5):
    src = jaudio.SyntheticAudioSource(freq=freq, amplitude=amplitude)
    return [asyncio.run(src.read_frame()) for _ in range(n)]


def test_synthetic_audio_matches_jax():
    for freq, amp in ((440.0, 0.1), (1000.0, 0.9)):
        t = taudio.SyntheticAudioSource(freq=freq, amplitude=amp)
        j = jaudio.SyntheticAudioSource(freq=freq, amplitude=amp)
        for _ in range(5):
            assert asyncio.run(t.read_frame()) == asyncio.run(j.read_frame())
    for name in ("FRAME_SAMPLES", "CHANNELS", "SAMPLE_RATE", "FRAME_MS"):
        assert getattr(taudio, name) == getattr(jaudio, name)


@pytest.mark.parametrize("bitrates", [(128000,), (32000,), (256000, 32000, 96000)])
def test_opus_packets_match_jax(bitrates):
    _need_opus()
    frames = _pcm_frames(30, freq=1000.0, amplitude=0.9)
    te, je = taudio.OpusEncoder(bitrate_bps=bitrates[0]), jaudio.OpusEncoder(bitrate_bps=bitrates[0])
    td, jd = taudio.OpusDecoder(), jaudio.OpusDecoder()
    for i, pcm in enumerate(frames):
        if i % 10 == 0 and i // 10 < len(bitrates):
            te.set_bitrate(bitrates[i // 10])
            je.set_bitrate(bitrates[i // 10])
        pt, pj = te.encode(pcm), je.encode(pcm)
        assert pt == pj, i
        assert td.decode(pt) == jd.decode(pj), i


def test_opus_rejects_wrong_frame_size_as_jax():
    _need_opus()
    for pkg in (taudio, jaudio):
        with pytest.raises(ValueError):
            pkg.OpusEncoder().encode(b"\x00" * 100)


async def _pipeline_packets(pkg, seconds=0.4):
    """Every packet the pipeline's encoder coded and every one the sink
    got (by timestamp)."""
    coded, sent = [], {}

    async def sink(ea):
        sent[ea.timestamp_48k] = ea.packet

    p = pkg.AudioPipeline(source=pkg.SyntheticAudioSource(), sink=sink, bitrate_bps=64000)
    encode = p.encoder.encode

    def recording(pcm):
        coded.append(encode(pcm))
        return coded[-1]
    p.encoder.encode = recording
    await p.start()
    await asyncio.sleep(seconds)
    await p.stop()
    return coded, sent


def test_audio_pipelines_code_the_same_packets():
    _need_opus()
    t_coded, t_sent = asyncio.run(_pipeline_packets(taudio))
    j_coded, j_sent = asyncio.run(_pipeline_packets(jaudio))
    n = min(len(t_coded), len(j_coded))
    assert n >= 10 and t_coded[:n] == j_coded[:n]
    frame = jaudio.FRAME_SAMPLES
    for sent, coded in ((t_sent, t_coded), (j_sent, j_coded)):
        assert sent and all(ts % frame == 0 and sent[ts] == coded[ts // frame] for ts in sent)


@pytest.mark.parametrize("struct", ["_PaSampleSpec", "_PaBufferAttr"])
def test_pulse_structs_match_jax(struct):
    t, j = getattr(tsources, struct), getattr(jsources, struct)
    assert ctypes.sizeof(t) == ctypes.sizeof(j)
    assert [(n, getattr(t, n).offset) for n, *_ in t._fields_] == \
        [(n, getattr(j, n).offset) for n, *_ in j._fields_]


def test_audio_source_fallback_matches_jax(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(tsources.NativePulseSource, "available", staticmethod(lambda: False))
    monkeypatch.setattr(jsources.NativePulseSource, "available", staticmethod(lambda: False))
    t, j = tsources.open_best_audio_source(None), jsources.open_best_audio_source(None)
    assert type(t).__name__ == type(j).__name__


# -- Metrics and SystemMonitor ------------------------------------------------------

def _stats(n_extra: int = 0, **over):
    report = {"type": "inbound-rtp", "id": "RTCInbound1", "kind": "video",
              "bytesReceived": 1000, "packetsReceived": 10, "packetsLost": 0,
              "jitter": 0.001, "framesDecoded": 60, "framesPerSecond": 60,
              "frameWidth": 1920, "frameHeight": 1080, "firCount": 0, "pliCount": 0,
              "nackCount": 0}
    report.update(over)
    for i in range(n_extra):
        report[f"extra{i}"] = i
    return [report]


def _rows(path):
    """The CSV's rows without the wall-clock column."""
    with open(path) as f:
        return [r[1:] for r in csv.reader(f)]


def test_stats_flattening_matches_jax():
    reports = [{"type": "transport", "id": "T1", "bytesSent": 5},
               {"type": "transport", "id": "T2", "bytesSent": 7}, *_stats(2)]
    assert TMetrics.sanitize_json_stats(reports) == JMetrics.sanitize_json_stats(reports)


def test_stats_csv_matches_jax(tmp_path):
    rows = {}
    for name, log_cls, metrics in (("jax", JCsvLog, JMetrics), ("torch", TCsvLog, TMetrics)):
        path = str(tmp_path / f"{name}.csv")
        log = log_cls(path, cache_rows=5)
        for i in range(8):
            log.append(metrics.sanitize_json_stats(_stats(framesDecoded=i)))
        log.append(metrics.sanitize_json_stats([{"type": "x", "id": "1"}]))  # truncated
        log.append(metrics.sanitize_json_stats(_stats(n_extra=2, framesDecoded=8)))
        rows[name] = (_rows(path), len(log.rows))
    assert rows["torch"] == rows["jax"]


def test_webrtc_stats_roundtrip_matches_jax(tmp_path):
    rows = {}
    for name, metrics in (("jax", JMetrics), ("torch", TMetrics)):
        m = metrics(using_webrtc_csv=True)
        d = tmp_path / name
        d.mkdir()
        m.initialize_webrtc_csv_file(str(d))
        for kind in ("_stats_video", "_stats_audio"):
            asyncio.run(m.set_webrtc_stats(kind, json.dumps(_stats(kind=kind))))
        rows[name] = (_rows(m.stats_video_file_path), _rows(m.stats_audio_file_path))
    assert rows["torch"] == rows["jax"] and len(rows["jax"][0]) == 2


@pytest.mark.parametrize("telemetry_on", [False, True])
def test_scrape_text_matches_jax(tmp_path, telemetry_on):
    """The parity gauges, and with telemetry on the bus's families folded
    into the same registry by the Prometheus collector."""
    from prometheus_client import generate_latest

    texts = {}
    for name, metrics, tele in (("jax", JMetrics, jtelemetry), ("torch", TMetrics, ttelemetry)):
        tele.reset()
        tele.enabled = telemetry_on
        try:
            m = metrics()
            m.set_fps(60)
            m.set_fps(31)
            m.set_tpu_utilization(42.5)
            m.set_latency(12)
            set_fps, set_lat = m.session_setters(3)
            set_fps(59)
            set_lat(7)
            tele.stage_ms("capture", 2.0, frame=1)
            tele.count("selkies_tile_cache_tiles_total", 4, result="hit")
            tele.gauge("selkies_supervisor_rung", 0, slot="session")
            tele.register_provider("link_bytes", lambda: {"up_delta": 1000, "down_pb": 2000})
            # a histogram's *_created sample is the wall clock at its build
            texts[name] = [line for line in generate_latest(m.registry).decode().splitlines()
                           if "_created" not in line.split(" ")[0]]
        finally:
            tele.enabled = False
            tele.reset()
    assert texts["torch"] == texts["jax"]
    assert any("selkies_stage_ms_bucket" in line for line in texts["jax"]) == telemetry_on


def test_system_monitors_tick_as_jax():
    async def ticks(cls):
        mon = cls(period=0.05)
        got = []
        mon.on_timer = got.append
        task = asyncio.ensure_future(mon.start())
        await asyncio.sleep(0.3)
        mon.stop()
        await task
        return len(got) >= 2, mon.mem_total > 0, mon.cpu_percent >= 0

    assert asyncio.run(ticks(TSystemMonitor)) == asyncio.run(ticks(JSystemMonitor)) == \
        (True, True, True)
