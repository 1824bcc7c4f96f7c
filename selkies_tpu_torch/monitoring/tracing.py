"""First-party in-pipeline tracing — the GStreamer coretracers analogue
(the reference leans on GStreamer's GST_TRACERS=latency/stats; this
framework owns its pipeline, so it owns the tracer too).

The port's copy of ``selkies_tpu/monitoring/tracing.py``: the same
``SELKIES_TRACING`` switch, ``span`` / ``instant`` / ``summary`` /
``chrome_trace``, and the same span names at the same sites. A span is two
``perf_counter`` reads and never synchronises the card; ``step`` is the
wait on a frame's (or band's) step-done CUDA event. The port emits the
encoder-completion spans (``step``, ``fetch``, ``bits_fetch``, ``unpack``,
``pack``), ``classify``, ``band_gather`` / ``row_gather`` and the session
service's ``convert`` / ``device-step`` / ``fetch`` / ``pack``; the
vocabulary below also lists the JAX package's serving, fleet, transport
and audio spans, whose modules are not ported yet.

Design: a process-global span recorder with near-zero cost when
disabled (one attribute read per span). Hot-path stages (capture,
classify, upload, device step, fetch, entropy pack, payload, send) wrap
themselves in `with tracer.span("stage"):`; each completed span lands
in a fixed ring buffer and folds into per-name aggregates (count /
total / min / max / EWMA). Two export surfaces:

* `summary()` — per-stage aggregate dict (the stats-tracer view),
  served by the signalling server's `/trace` endpoint and printable
  from tools/.
* `chrome_trace()` — Chrome trace-event JSON (the latency-tracer
  view): load the dump straight into chrome://tracing / Perfetto and
  see the pipeline's stage overlap on a timeline, worker threads
  included.

Enable with SELKIES_TRACING=1 (or tracer.enable()); the ring holds the
most recent `capacity` spans (default 8192 ≈ 2-3 s of a busy 1080p60
pipeline across ~5 stages).

Span-name vocabulary (the full set emitted by the framework — keep this
list authoritative when adding instrumentation so dashboards and the
black-box bundles stay greppable):

  solo video loop (pipeline/elements.py):
    capture       FrameSource.capture on the worker thread
    classify      static/delta/full frame classification: the fused
                  band-sharded dirty scan (FramePrep.scan, damage-
                  bounded when the capture layer passes XDamage rect
                  hints) incl. the tile-cache hash/split
                  (models/h264/encoder.py). The matching
                  selkies_stage_ms stage is "classify"; its front-end
                  siblings "convert" (BGRx→I420 of the upload payload)
                  and "h2d" (host→device transfer enqueues) are emitted
                  per frame at frame_done — together they decompose
                  FrameStats.upload_ms, the host front-end cost
    submit        pipelined encoder dispatch (classify + upload + step)
    encode        synchronous encode_frame path (non-pipelined rows)
    send          sink callback (transport handoff) per access unit
    frame-drop    instant: capture tick skipped (transport backpressure)
    policy        one scenario-policy evaluation (selkies_tpu/policy):
                  signal observe + classify + any knob actuation this
                  tick applied — the fleet emits the same span around
                  its per-slot policy pass in _encode_tick, so a slow
                  actuation (the device-entropy retune recompile) is
                  attributable on the timeline
  encoder completion workers (models/h264/encoder.py, parallel/bands.py):
    step          dispatch → device outputs ready (block_until_ready on
                  the frame's — or one BAND's — downlink buffer; with
                  the band-parallel encoder one span per band, so the
                  per-chip step latency is visible per slice); the
                  matching selkies_stage_ms stage is "step". The clock
                  starts immediately BEFORE the jitted step call: a
                  dispatch call that blocks (CPU-backend contention,
                  full dispatch queue) is device-side backpressure and
                  counts here, not in upload
    fetch         device→host coefficient/word downlink
    bits_fetch    device→host transfer of a device-entropy frame's
                  FINAL slice-data bit words. Spans mark only the EXTRA
                  transfers (shortfall refetch / word spill —
                  sparse_complete.complete_sparse_slice, encoder.
                  _complete_bits); the main prefix fetch rides the
                  shared "fetch" span like every downlink. The
                  selkies_stage_ms stage "bits_fetch" is wider: one
                  observation per bits-mode frame covering its WHOLE
                  payload fetch (pipeline/elements.py frame_done), so
                  the histogram tracks the fetch that replaced the
                  coefficient downlink, not just the spill tail
    unpack        downlink bytes → packer-ready coefficients (sparse
                  wire views / dense expansion, shortfall + spill +
                  dense-header fallback fetches included)
    pack          host CAVLC entropy pack + NAL assembly (the
                  sparse-native packer when libcavlc exports it, the
                  Python dense oracle otherwise); the matching
                  selkies_stage_ms stages are "unpack" and "cavlc"
    band_gather   band-parallel encoder only (parallel/bands.py): the
                  whole per-band fan-out — N per-chip fetches +
                  unpack/pack overlapped on the pack pool — until the
                  multi-slice access unit is assembled in band order;
                  selkies_stage_ms stage "band_gather"
    row_gather    2D tile-grid encoder only (SELKIES_TILE_GRID,
                  parallel/bands.py): the tile-mode analogue of
                  band_gather — per-ROW payload fetches off the
                  (band, col) mesh (each row's C tile outputs were
                  already col-merged on device) + the per-slice host
                  completions, until the multi-slice access unit is
                  assembled in band-row order; selkies_stage_ms stage
                  "row_gather"
    col_halo      tile-grid collective probe (tools/profile_bands.py):
                  the column+row halo-slab construction a tile chip
                  performs before ME — on a real mesh this is the two
                  ppermute exchanges; the profiler emits the span
                  around its serial analogue so trace summaries bound
                  the exchange term of the dedicated-chip projection
  fleet service (parallel/serving.py):
    convert       per-session BGRx→I420 on the pack pool
    device-step   sharded batch encode dispatch
    fetch / pack  batch downlink and concurrent per-session packs
  occupancy scheduler (parallel/occupancy.py):
    sched_wait    selkies_stage_ms stage only (no tracer span — it is a
                  wait, not work): how long a session's dispatch sat
                  behind earlier sessions on the scheduler's dispatch
                  lane this tick, per session. Sub-ms while the lane
                  keeps up; a session whose front-end hogs the lane
                  shows up as ITS SUCCESSORS' sched_wait growing
  fleet lifecycle (parallel/lifecycle.py):
    admit         one admission-control decision (accept/queue/reject)
    recarve       a dynamic re-carve transition (borrow or return of
                  band chips, incl. the affected encoder rebuilds'
                  dispatch on the serving side)
    drain         the whole graceful-drain sequence (force-IDR + flush
                  + checkpoint hand-off), SIGTERM to exit-ready
    migrate       one checkpoint_session or restore_session call
  transports (transport/websocket.py):
    ws-send       one binary media frame over the WebSocket plane
  audio (audio/pipeline.py):
    audio-encode  one 10 ms Opus frame
    audio-send    audio sink callback
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from collections import deque

__all__ = ["Tracer", "tracer", "span"]


class _Span:
    """Context manager recording one stage execution."""

    __slots__ = ("t", "name", "t0")

    def __init__(self, t: "Tracer", name: str):
        self.t = t
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t._record(self.name, self.t0, time.perf_counter())
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Tracer:
    def __init__(self, capacity: int = 8192):
        self.enabled = bool(os.environ.get("SELKIES_TRACING"))
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._agg: dict[str, list] = {}  # name -> [count, total, min, max, ewma]
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    # -- control -------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._agg.clear()
            self._epoch = time.perf_counter()

    # -- recording -----------------------------------------------------

    def span(self, name: str):
        """`with tracer.span("encode"):` — no-op object when disabled."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name)

    def instant(self, name: str) -> None:
        """Zero-duration marker (frame drops, forced IDRs, reconnects)."""
        if self.enabled:
            now = time.perf_counter()
            self._record(name, now, now)

    def _record(self, name: str, t0: float, t1: float) -> None:
        dur = t1 - t0
        # lane id: the asyncio task when inside one (concurrent sessions
        # on one loop must not share a chrome-trace track — overlapping
        # sibling events render as bogus nesting), the thread otherwise.
        # Async spans measure await-INCLUSIVE wall time by design.
        try:
            task = asyncio.current_task()
        except RuntimeError:
            task = None
        tid = id(task) if task is not None else threading.get_ident()
        with self._lock:
            self._ring.append((name, t0 - self._epoch, dur, tid))
            a = self._agg.get(name)
            if a is None:
                self._agg[name] = [1, dur, dur, dur, dur]
            else:
                a[0] += 1
                a[1] += dur
                if dur < a[2]:
                    a[2] = dur
                if dur > a[3]:
                    a[3] = dur
                a[4] += 0.05 * (dur - a[4])  # EWMA, ~20-sample horizon

    # -- export --------------------------------------------------------

    def summary(self) -> dict:
        """Per-stage aggregates in milliseconds (stats-tracer view)."""
        with self._lock:
            return {
                name: {
                    "count": a[0],
                    "mean_ms": round(a[1] / a[0] * 1e3, 3),
                    "min_ms": round(a[2] * 1e3, 3),
                    "max_ms": round(a[3] * 1e3, 3),
                    "ewma_ms": round(a[4] * 1e3, 3),
                }
                for name, a in self._agg.items()
            }

    def chrome_trace(self) -> str:
        """Trace-event JSON for chrome://tracing / Perfetto (latency-
        tracer view: stage overlap across threads on a timeline)."""
        with self._lock:
            events = [
                {
                    "name": name,
                    "ph": "X",
                    "ts": round(rel * 1e6, 1),   # microseconds
                    "dur": round(dur * 1e6, 1),
                    "pid": 1,
                    "tid": tid % 100000,
                }
                for name, rel, dur, tid in self._ring
            ]
        return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})


# the process-global tracer every stage uses
tracer = Tracer()


def span(name: str):
    """Module-level convenience: `with tracing.span("pack"):`."""
    return tracer.span(name)
