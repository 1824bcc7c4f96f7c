"""Black-box flight recorder: post-mortem evidence that survives the crash.

The port's copy of ``selkies_tpu/monitoring/flightrecorder.py``, unchanged
but for its imports (the tracer is ``selkies_tpu_torch.monitoring.tracing``).
The JAX package's triggers (its supervisor and SLO plane) are not in the
port yet: here a bundle is written by ``telemetry.escalation`` or
``telemetry.outlier_dump`` when a caller asks.

When a session dies, the interesting data is the few seconds *before*
the supervisor escalated — and that is exactly what a live dashboard
cannot show after the fact. This recorder keeps a bounded ring of the
telemetry bus's structured events per slot (last ``window_s`` seconds,
hard-capped at ``max_events``) and, on demand, atomically writes a
timestamped bundle:

    <SELKIES_BLACKBOX_DIR>/blackbox-<slot>-<stamp>/
        meta.json       escalating slot, reason, wall time, event count
        events.jsonl    EVERY slot's event window merged by time (each
                        line annotated with its session) — a slot rarely
                        dies alone, and the supervisor's ladder events
                        live in a different ring than the frame timeline
        trace.json      tracer.chrome_trace() — load in Perfetto /
                        chrome://tracing (empty trace when tracing is off)
        metrics.json    full telemetry rollup() snapshot at dump time

The bundle directory appears atomically (written under a dot-tmp name,
then ``os.replace``d into place) so a collector sidecar never ships a
half-written bundle. Dumps are rate-limited per slot
(``min_dump_interval_s``) — a crash-looping slot produces one bundle per
window, not one per failure. Triggering is wired in
resilience/supervisor.py: every escalation past WARN calls
``telemetry.escalation()``, which lands here.

Beyond supervisor escalations, the SLO plane (monitoring/slo.py) feeds
every frame's latency through an :class:`OutlierTrigger` — a rolling-
quantile detector that dumps a bundle for a p99-outlier frame, tagged
with that frame's correlation id (``meta.json`` ``frame_id``), even
when no escalation ever happens. Outlier dumps rate-limit under their
own per-session bucket (``<session>-outlier``) so tail-latency evidence
never suppresses a real escalation bundle or vice versa.

``SELKIES_BLACKBOX_DIR`` overrides the output directory (default
``./blackbox``, gitignored). Everything is injectable (clock, dir,
window) so tests drive it deterministically.
"""

from __future__ import annotations

import bisect
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable

logger = logging.getLogger("flightrecorder")

__all__ = ["FlightRecorder", "OutlierTrigger", "DEFAULT_DIR", "ENV_DIR"]

ENV_DIR = "SELKIES_BLACKBOX_DIR"
DEFAULT_DIR = "blackbox"


def _slug(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-" for c in str(s)) or "slot"


class OutlierTrigger:
    """Rolling-quantile latency-outlier detector (the black-box trigger
    for frames that are dramatically worse than the session's own recent
    tail, monitoring/slo.py).

    Keeps the last ``window`` observations in arrival order plus a
    sorted mirror (bisect insert/remove — the window is small enough
    that the O(n) memmove is nanoseconds), and judges each NEW sample
    against the quantile of what came *before* it: an outlier is a
    sample at or above ``max(quantile * factor, floor_ms)``. The sample
    then joins the window either way, so a sustained latency shift
    re-baselines within one window instead of dumping forever — the
    sustained case is the burn-rate windows' job, this trigger exists
    for the lone catastrophic frame. No judgment happens before
    ``warmup`` samples (a cold session's first compile-priced frames
    are not outliers, they are startup).

    Single-threaded by contract, like the SessionSLO that owns it.
    """

    def __init__(self, *, window: int = 512, warmup: int = 120,
                 quantile: float = 0.99, factor: float = 1.5,
                 floor_ms: float = 50.0):
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        self.window = int(window)
        self.warmup = max(1, int(warmup))
        self.quantile = float(quantile)
        self.factor = float(factor)
        self.floor_ms = float(floor_ms)
        self._ring: deque[float] = deque()
        self._sorted: list[float] = []
        self.observed = 0
        self.outliers = 0

    def reset(self) -> None:
        """Drop the window (a new client's traffic must not be judged
        against the previous one's baseline); lifetime counters stay."""
        self._ring.clear()
        self._sorted.clear()

    def quantile_ms(self) -> float:
        """The configured quantile of the current window (0.0 empty)."""
        s = self._sorted
        if not s:
            return 0.0
        return s[min(len(s) - 1, int(self.quantile * (len(s) - 1) + 0.5))]

    def observe(self, latency_ms: float) -> bool:
        """Judge one sample against the window-so-far; True = outlier.
        Rate limiting is the dump path's job, not this trigger's — the
        caller counts every detection, suppressed or not."""
        latency_ms = float(latency_ms)
        self.observed += 1
        is_outlier = False
        if len(self._ring) >= self.warmup:
            threshold = max(self.quantile_ms() * self.factor, self.floor_ms)
            is_outlier = latency_ms >= threshold
        if len(self._ring) >= self.window:
            oldest = self._ring.popleft()
            i = bisect.bisect_left(self._sorted, oldest)
            del self._sorted[i]
        self._ring.append(latency_ms)
        bisect.insort(self._sorted, latency_ms)
        if is_outlier:
            self.outliers += 1
        return is_outlier


class FlightRecorder:
    def __init__(self, *, window_s: float = 10.0, max_events: int = 4096,
                 out_dir: str | None = None, min_dump_interval_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.max_events = int(max_events)
        self.out_dir = out_dir or os.environ.get(ENV_DIR) or DEFAULT_DIR
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._rings: dict[str, deque] = {}   # slot -> deque[(mono_t, event)]
        self._last_dump: dict[str, float] = {}
        self.dumps = 0
        self.suppressed = 0

    # -- recording (hot-ish: every telemetry emission lands here) ------

    def record(self, slot: str, event: dict) -> None:
        now = self.clock()
        with self._lock:
            ring = self._rings.get(slot)
            if ring is None:
                ring = self._rings[slot] = deque(maxlen=self.max_events)
            ring.append((now, event))
            cutoff = now - self.window_s
            while ring and ring[0][0] < cutoff:
                ring.popleft()

    def events(self, slot: str) -> list[dict]:
        with self._lock:
            return [dict(ev, t=round(t, 4))
                    for t, ev in self._rings.get(slot, ())]

    # -- dumping -------------------------------------------------------

    def dump(self, slot: str, reason: str, *,
             snapshot: dict | None = None,
             extra_meta: dict | None = None) -> str | None:
        """Write a bundle for ``slot``'s escalation; None when
        rate-limited (per slot). The bundle carries EVERY ring's window,
        merged by time and annotated with the owning session — the
        escalating slot's ladder events and the frame timeline live in
        different rings, and cross-slot context is exactly what a
        post-mortem needs. ``extra_meta`` lands in ``meta.json`` (the
        outlier path tags the breaching frame's correlation id there).
        The write happens outside the lock (a slow disk must not stall
        emitters)."""
        now = self.clock()
        with self._lock:
            last = self._last_dump.get(slot)
            if last is not None and now - last < self.min_dump_interval_s:
                self.suppressed += 1
                return None
            self._last_dump[slot] = now
            events = sorted(
                (dict(ev, t=round(t, 4), session=s)
                 for s, ring in self._rings.items() for t, ev in ring),
                key=lambda e: e["t"])
        try:
            return self._write_bundle(slot, reason, events, snapshot,
                                      extra_meta)
        except Exception:
            # the black box must never take down the loop it observes
            logger.exception("black-box dump for slot %r failed", slot)
            return None

    def _write_bundle(self, slot: str, reason: str, events: list[dict],
                      snapshot: dict | None,
                      extra_meta: dict | None = None) -> str:
        from selkies_tpu_torch.monitoring.tracing import tracer

        stamp = time.strftime("%Y%m%d-%H%M%S")
        name = f"blackbox-{_slug(slot)}-{stamp}-{self.dumps:03d}"
        os.makedirs(self.out_dir, exist_ok=True)
        tmp = os.path.join(self.out_dir, f".{name}.tmp")
        final = os.path.join(self.out_dir, name)
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"slot": str(slot), "reason": reason,
                       "written_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
                       "event_count": len(events), **(extra_meta or {})},
                      f, indent=2, default=str)
        with open(os.path.join(tmp, "events.jsonl"), "w") as f:
            for ev in events:
                f.write(json.dumps(ev, default=str) + "\n")
        with open(os.path.join(tmp, "trace.json"), "w") as f:
            f.write(tracer.chrome_trace())
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump(snapshot or {}, f, indent=2, default=str)
        os.replace(tmp, final)
        self.dumps += 1
        logger.warning("black-box bundle written: %s (%s)", final, reason)
        return final
