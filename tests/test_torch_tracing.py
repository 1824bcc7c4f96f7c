"""The port's own tracing: ``Tracer.record``, the device track's placement
of a step on the host clock, the solo row's ``group_wait_ms`` stamp, and
the device monitor's NVML load (``selkies_tpu_torch/monitoring/``).

No JAX here: the spans these cover have no counterpart in the JAX
package (``tests/test_torch_observability.py`` holds the shared names to
JAX's). The card's side of the device track is in ``test_torch_gpu.py``.
"""

from __future__ import annotations

import ctypes
import json
import logging

import numpy as np
import pytest
import torch

from selkies_tpu_torch.models.h264.encoder import TorchH264Encoder
from selkies_tpu_torch.monitoring import device_monitor
from selkies_tpu_torch.monitoring.tracing import GpuMark, Tracer, _Anchor, tracer

W, H = 320, 192


@pytest.fixture(autouse=True)
def _tracer_off():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


def test_record_takes_the_callers_stamps():
    t = Tracer()
    t.record("device-step", 1.0, 1.25)
    assert t.summary() == {}
    t.enable()
    t.record("device-step", 1.0, 1.25)
    t.record("convert", 2.0)  # to now
    s = t.summary()
    assert s["device-step"]["count"] == 1 and s["device-step"]["mean_ms"] == 250.0
    assert s["convert"]["count"] == 1
    name, rel, dur, _ = t._ring[0]
    assert (name, rel + t._epoch, dur) == ("device-step", 1.0, 0.25)


class _Event:
    """A stand-in for a timing CUDA event: the card's clock in ms."""

    def __init__(self, ms: float, done: bool = True):
        self.ms, self.done = ms, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end: "_Event") -> float:
        return end.ms - self.ms


def test_device_span_is_placed_by_its_anchor():
    """The anchor ran at host time 50.0 s and card time 1000 ms; a step
    whose first op ran at 1012.5 ms and whose step-done ran at 1020 ms
    is [50.0125, 50.020] s on the host clock, on card 3's track."""
    t = Tracer()
    t.enable()
    mark = GpuMark(_Event(1012.5), _Anchor(_Event(1000.0), 50.0, 3))
    t0, t1 = t.gpu_span(mark, _Event(1020.0))
    assert t0 == pytest.approx(50.0125) and t1 == pytest.approx(50.020)
    assert t.device_spans() == [("gpu-step", pytest.approx(50.0125), pytest.approx(50.020), 3)]
    assert len(t._ring) == 0  # the host ring holds host spans only
    assert t.summary()["gpu-step"]["mean_ms"] == pytest.approx(7.5)
    # an anchor that has not run places nothing
    late = GpuMark(_Event(1012.5), _Anchor(_Event(1000.0, done=False), 50.0, 3))
    assert t.gpu_span(late, _Event(1020.0)) is None and len(t.device_spans()) == 1
    # a step before the anchor (a negative elapsed time) still places
    early = GpuMark(_Event(990.0), _Anchor(_Event(1000.0), 50.0, 3))
    assert t.gpu_span(early, _Event(995.0)) == (pytest.approx(49.99), pytest.approx(49.995))


def test_device_spans_have_their_own_track():
    t = Tracer()
    t.enable()
    with t.span("device-step"):
        pass
    assert all(e["pid"] == 1 for e in json.loads(t.chrome_trace())["traceEvents"])
    t.gpu_span(GpuMark(_Event(2.0), _Anchor(_Event(0.0), t._epoch, 0)), _Event(4.0))
    events = json.loads(t.chrome_trace())["traceEvents"]
    host = [e for e in events if e["ph"] == "X" and e["pid"] == 1]
    card = [e for e in events if e["ph"] == "X" and e["pid"] == 2]
    names = {e["pid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert [e["name"] for e in host] == ["device-step"]
    assert [(e["name"], e["tid"], e["ts"], e["dur"]) for e in card] == [
        ("gpu-step", 0, 2000.0, 2000.0)]
    assert names == {1: "host", 2: "card"}
    t.reset()
    assert t.device_spans() == [] and json.loads(t.chrome_trace())["traceEvents"] == []


def test_no_device_mark_off_or_off_the_card():
    t = Tracer()
    assert t.gpu_mark(torch.device("cuda", 0)) is None  # off: no event, no CUDA call
    t.enable()
    assert t.gpu_mark(torch.device("cpu")) is None


def _typing_frames():
    """An IDR, a typed line (a group candidate), an unchanged capture
    (which flushes the pending group), a full-frame change (dispatched on
    its own) and two more lines then a flush."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (H, W, 4), np.uint8)
    frames = [a]
    for k in range(2):
        f = frames[-1].copy()
        f[32 + 16 * k:44 + 16 * k, 40:200, :3] = rng.integers(0, 256, (12, 160, 3), np.uint8)
        frames.append(f)
        frames.append(f.copy())
    frames.append(rng.integers(0, 256, (H, W, 4), np.uint8))
    f = frames[-1].copy()
    f[96:108, 40:200, :3] = 0
    frames.append(f)
    return frames


def _run(frames):
    enc = TorchH264Encoder(W, H, frame_batch=4, pipeline_depth=2, device="cpu")
    outs = []
    for f in frames:
        outs += enc.submit(f)
    outs += enc.flush()
    enc.close()
    return [au for au, _, _ in outs], [st for _, st, _ in outs]


def test_group_wait_is_stamped_hooks_on_or_off():
    """group_wait_ms is the wait of a delta frame in the pending group: 0
    for every frame dispatched on its own, positive for a line flushed by
    the next (unchanged) capture. Off, the hooks change no byte and record
    nothing; the stamp is there either way."""
    frames = _typing_frames()
    aus_off, stats_off = _run(frames)
    assert tracer.summary() == {}
    tracer.enable()
    aus_on, stats_on = _run(frames)
    assert aus_on == aus_off
    assert tracer.summary()["device-step"]["count"] > 0
    for stats in (stats_off, stats_on):
        kinds = [st.upload_kind for st in stats]
        assert kinds == ["full", "delta", "static", "delta", "static", "full", "delta"]
        waits = [st.group_wait_ms for st in stats]
        assert waits[1] > 0 and waits[3] > 0 and waits[6] > 0
        assert waits[0] == waits[2] == waits[4] == waits[5] == 0.0


# -- the device monitor's load ---------------------------------------------------

class _Nvml:
    """A stand-in for libnvidia-ml: every call returns ``rc``."""

    def __init__(self, gpu: int, rc: int = 0):
        self.gpu, self.rc, self.asked = gpu, rc, []

    def nvmlInit_v2(self):
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, handle):
        self.asked.append(uuid)
        return 999  # NVML_ERROR_NOT_FOUND's kind: the index is asked next

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        self.asked.append(index.value)
        handle.contents.value = 0x1234
        return 0

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        assert handle.value == 0x1234
        util.contents.gpu = self.gpu
        return self.rc


def test_nvml_load_is_the_kernel_active_share():
    lib = _Nvml(37)
    load = device_monitor.NvmlLoad(2, uuid="GPU-x", lib=lib)
    assert load.load() == pytest.approx(0.37) and load.load() == pytest.approx(0.37)
    assert lib.asked == [b"GPU-x", 2]  # the handle is taken once


def test_nvml_absent_reads_zero_and_logs_once(monkeypatch, caplog):
    def missing(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", missing)
    load = device_monitor.NvmlLoad(0)
    with caplog.at_level(logging.WARNING, logger="device_monitor"):
        assert [load.load() for _ in range(3)] == [0.0, 0.0, 0.0]
    assert len(caplog.records) == 1 and "NVML" in caplog.records[0].getMessage()
    failing = device_monitor.NvmlLoad(0, lib=_Nvml(50, rc=3))
    assert failing.load() == 0.0


def test_device_monitor_has_no_host_clock_tap():
    assert not hasattr(device_monitor.DeviceMonitor, "observe_encode")
