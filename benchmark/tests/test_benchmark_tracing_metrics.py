"""The readers of the per-layer metrics that read the program's tracer
(``device-step``, ``complete_wait``, ``step-i`` spans, the
``group_wait_ms`` stamp, ``last_timing["device_tail_ms"]``) on a stub run,
and on a stub of a program without them, where each reads None."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _reader(metric: str):
    from yardstick.spec import Spec

    return Spec(ROOT).reader(metric)


def _tracer(spans):
    from selkies_tpu_torch.monitoring.tracing import Tracer

    t = Tracer()
    t.enable()
    for name, ms in spans:
        t.record(name, 10.0, 10.0 + ms / 1e3)
    return t


def _run(spans=(), frames=(), ticks=(), handed=4):
    tracer = _tracer(spans)
    entry = SimpleNamespace(tracer=lambda: tracer, frames=list(frames), ticks=list(ticks))
    return SimpleNamespace(entry=entry, handed=[(0, i, 0.0) for i in range(handed)])


def _stats(kind, wait=None):
    st = SimpleNamespace(upload_kind=kind)
    if wait is not None:
        st.group_wait_ms = wait
    return st


def test_solo_readers():
    run = _run(spans=[("device-step", 2.0), ("device-step", 4.0), ("complete_wait", 1.0),
                      ("complete_wait", 5.0), ("classify", 9.0)],
               frames=[_stats("delta", 12.0), _stats("static", 0.0), _stats("delta", 4.0),
                       _stats("full", 0.0)])
    assert _reader("dispatch_ms.solo").read(run) == pytest.approx(3.0)
    assert _reader("complete_wait_ms.solo").read(run) == pytest.approx(6.0 / 4)
    assert _reader("group_wait_ms.solo").read(run) == pytest.approx(8.0)


def test_sessions_readers():
    ticks = [{"idr": False, "device_tail_ms": 0.5}, {"idr": True, "device_tail_ms": 40.0},
             {"idr": False, "device_tail_ms": 1.5}]
    run = _run(spans=[("step-i", 900.0), ("step-i", 1100.0), ("step-p", 9.0)], ticks=ticks)
    assert _reader("step_i_ms.sessions8").read(run) == pytest.approx(1000.0)
    assert _reader("device_tail_ms.sessions8").read(run) == pytest.approx(1.0)


@pytest.mark.parametrize("metric", ["dispatch_ms.solo", "complete_wait_ms.solo",
                                    "group_wait_ms.solo", "step_i_ms.sessions8",
                                    "device_tail_ms.sessions8"])
def test_a_program_without_the_source_reads_none(metric):
    """A program with only the older spans and stamps (the step's
    ``step_ms``, the tick's ``dispatch_ms``): nothing to read, no raise."""
    run = _run(spans=[("classify", 1.0), ("device-step", 3.0)] if "solo" not in metric
               else [("classify", 1.0), ("step", 3.0)],
               frames=[_stats("delta"), _stats("static")],
               ticks=[{"idr": False, "dispatch_ms": 19.0}])
    assert _reader(metric).read(run) is None
