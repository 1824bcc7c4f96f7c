"""First-party in-pipeline tracing — the GStreamer coretracers analogue
(the reference leans on GStreamer's GST_TRACERS=latency/stats; this
framework owns its pipeline, so it owns the tracer too).

The port's copy of ``selkies_tpu/monitoring/tracing.py``: the same
``SELKIES_TRACING`` switch, ``span`` / ``instant`` / ``summary`` /
``chrome_trace``, and the same span names at the same sites, plus the
port's own spans (marked *port* below), ``record`` and a device track. A
span is two ``perf_counter`` reads and never synchronises the card.

Design: a process-global span recorder with near-zero cost when
disabled (one attribute read per span). Hot-path stages (capture,
classify, upload, device step, fetch, entropy pack, payload, send) wrap
themselves in `with tracer.span("stage"):`; each completed span lands
in a fixed ring buffer and folds into per-name aggregates (count /
total / min / max / EWMA). A site that already stamps ``perf_counter``
emits its span with ``tracer.record(name, t0, t1)`` instead of reading
the clock again (``t1`` defaults to now). Two export surfaces:

* `summary()` — per-stage aggregate dict (the stats-tracer view),
  served by the signalling server's `/trace` endpoint and printable
  from tools/.
* `chrome_trace()` — Chrome trace-event JSON (the latency-tracer
  view): load the dump straight into chrome://tracing / Perfetto and
  see the pipeline's stage overlap on a timeline, worker threads
  included. Host spans are process 1; device spans, when there are any,
  are process 2 ("card"), one track per card, on the same clock.

**The device track.** With tracing on, each device-step site takes
``gpu_mark(device)`` just before its first op: a timing CUDA event on the
step's stream. The step's step-done event (``device.Fetch``) is then
created with timing too, and the worker that has waited on it hands both
to ``gpu_span``, which puts them on the ``perf_counter`` clock through an
anchor: a timing event recorded at a known host time on the step's
stream at a moment that stream has nothing left to run
(``Stream.query()``, which does not synchronise), so the card runs it as
it is recorded; it is kept only if ``Event.query()`` sees it done within
``ANCHOR_WAIT_S`` of the record, its host time the middle of that. The
anchor is renewed at the first such moment after it
is ``ANCHOR_S`` old, looked for at each step's start (``gpu_mark``) and
after each downlink (``gpu_anchor``, from the worker that waited on it);
a step before a card's first anchor is not placed.
(An event on a side stream would not do: a side stream may share the
card's hardware queue with the default stream and wait behind its work.)
The result is one ``gpu-step`` span from the step's first op to its
step-done, as the card ran them. Device spans have a ring of their own
(``_dev_ring``): the host ring (``_ring``), which the benchmark reads to
name idle gaps, holds host spans only. Off, ``gpu_mark`` returns None
after one attribute read and no event is made.

Enable with SELKIES_TRACING=1 (or tracer.enable()); the ring holds the
most recent `capacity` spans (default 8192 ≈ 2-3 s of a busy 1080p60
pipeline across ~5 stages).

Span-name vocabulary (the full set emitted by the framework — keep this
list authoritative when adding instrumentation so dashboards and the
black-box bundles stay greppable). A benchmark metric that reads a name
(``benchmark/metrics/<metric>.py``) is given after "read by":

  solo video loop (pipeline/elements.py):
    capture       FrameSource.capture on the worker thread
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
  the solo encoder's submit thread (models/h264/encoder.py):
    classify      static/delta/full frame classification: the fused
                  band-sharded dirty scan (FramePrep.scan, damage-
                  bounded when the capture layer passes XDamage rect
                  hints) incl. the tile-cache hash/split. The matching
                  selkies_stage_ms stage is "classify"; its front-end
                  siblings "convert" and "h2d" are emitted per frame at
                  frame_done — together they decompose
                  FrameStats.upload_ms, the host front-end cost
    convert       *port*: BGRx→I420 of the upload payload, the dirty
                  tiles (_delta_tiles) or the full planes
                  (_upload_planes)
    h2d           *port*: one upload: the upload pack (_pack_uploads)
                  and its host→device enqueues (_put_timed)
    device-step   *port*: the Python issue of one device step, single
                  frame or group, from the FrameStats.step_ms stamp to
                  the return of the step call; read by dispatch_ms.solo
    allskip       *port*: the host's all-skip P slice of an unchanged
                  capture (_allskip_slice), no device work
    complete_wait *port*: _emit's block on a frame's completion future
                  (the submit thread waiting on a worker); read by
                  complete_wait_ms.solo
    (stamp)       FrameStats.group_wait_ms, *port*: a delta frame's wait
                  in the pending group until its group's dispatch
                  starts, 0 for a frame dispatched alone; the
                  selkies_stage_ms stage "group_wait"; read by
                  group_wait_ms.solo
  encoder completion workers (models/h264/encoder.py, parallel/bands.py):
    step          dispatch → device outputs ready (the wait on the
                  frame's — or one BAND's — step-done CUDA event; with
                  the band-parallel encoder one span per band, so the
                  per-chip step latency is visible per slice); the
                  matching selkies_stage_ms stage is "step". The clock
                  starts immediately BEFORE the step call: a dispatch
                  call that blocks (a full launch queue) is device-side
                  backpressure and counts here, not in upload
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
                  "row_gather"; read by gather_ms.bands4k
  the band- and tile-sliced encoder's dispatch (parallel/bands.py, *port*):
    classify, convert, h2d, allskip
                  as the solo row's: the dirty scan (FramePrep.scan),
                  BGRx→I420 of the whole frame, the upload of the band
                  (tile) planes (_put_band_planes), the host's all-skip
                  AU of an unchanged capture; convert read by
                  convert_ms.bands4k
    device-step   the Python issue of the carve's step: the step call,
                  from just before it (the first-op event included) to
                  its return
    step-i, step-p
                  inside device-step, the IDR or the P step; step-p read
                  by dispatch_ms.bands4k
    band-row      inside the step, one band-row's work (a tile grid: the
                  row's merged vote, its C tiles and its row pack; bands:
                  one band's body), on the stacked and the mesh steps
                  alike: R a coded frame, the carve's counter
  session service (parallel/serving.py, parallel/sessions.py):
    convert       *port*: each session's frame copied into the pinned
                  BGRx staging batch on the pack pool (the BGRx→I420
                  conversion itself runs in device-step); read by
                  convert_ms.sessions8
    h2d           *port*: put_groups, the upload of the tick's BGRx batch
    device-step   the batched step's Python issue (the conversion's
                  launch, pick, fillers and stacking of the mixed tick
                  included)
    step-i        *port*: inside device-step, one batched IDR branch
                  call of _group_step (the keying sessions of the mixed
                  tick, or every session on the first tick); read by
                  step_i_ms.sessions8
    step-p        *port*: inside device-step, one batched P branch call
    fetch / pack  batch downlink and concurrent per-session packs
    (stamp)       last_timing["device_tail_ms"], *port*, tracing on
                  only: the card's execution of the tick's step-done
                  minus the host's record of it (near 0: the card waits
                  on the Python issue; large: the card is behind); read
                  by device_tail_ms.sessions8
    (stamp)       last_timing["idr_pack_ms"], *port*: on a tick with an
                  IDR, the longest host CAVLC pack of an IDR session
                  (_pack_one, on the pool; the slice's MB-row chunks
                  and their splice included); read by
                  idr_pack_ms.sessions8
  occupancy scheduler (parallel/occupancy.py):
    unit-dispatch *port*: one unit's dispatch on the lane (one span per
                  unit and tick)
    complete_wait *port*: the lane's wait on one unit's completion
    sched_wait    selkies_stage_ms stage only (no tracer span — it is a
                  wait, not work): how long a session's dispatch sat
                  behind earlier sessions on the scheduler's dispatch
                  lane this tick, per session. Sub-ms while the lane
                  keeps up; a session whose front-end hogs the lane
                  shows up as ITS SUCCESSORS' sched_wait growing
  fleet service (parallel/serving.py):
    encode        a banded fleet tick (fetch and pack included)
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
  the device track (*port*, tracing on, cards only):
    gpu-step      a device step as the card ran it: the step's first-op
                  timing event to its step-done event (``gpu_mark`` /
                  ``gpu_span``), at every site of device-step (solo row,
                  session service, and the band- and tile-sliced encoder,
                  to band 0's step-done on its first device);
                  chrome_trace's process 2; read by gpu_step_ms.bands4k
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from collections import deque

__all__ = ["Tracer", "tracer", "span"]

# an anchor older than this is renewed at the next chance: the card's
# clock and the host's drift apart by parts per million
ANCHOR_S = 1.0
# an anchor is kept only if the card ran it within this of its record, so
# its host time is known to half of it (a thread switch or work enqueued
# by another thread in between would otherwise shift every span it places)
ANCHOR_WAIT_S = 2e-4


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


class _Anchor:
    """A timing event recorded on an idle stream of card ``track`` at host
    time ``t``: it ran as it was recorded, so it ties the card's clock to
    ``perf_counter``."""

    __slots__ = ("event", "t", "track")

    def __init__(self, event, t: float, track: int):
        self.event, self.t, self.track = event, t, track


class GpuMark:
    """A device step's first-op timing event and the anchor that places it."""

    __slots__ = ("event", "anchor")

    def __init__(self, event, anchor: _Anchor):
        self.event, self.anchor = event, anchor


class Tracer:
    def __init__(self, capacity: int = 8192):
        self.enabled = bool(os.environ.get("SELKIES_TRACING"))
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._dev_ring: deque = deque(maxlen=capacity)  # device spans, never in _ring
        self._agg: dict[str, list] = {}  # name -> [count, total, min, max, ewma]
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._anchors: dict[int, _Anchor] = {}  # card index -> newest anchor

    # -- control -------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dev_ring.clear()
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

    def record(self, name: str, t0: float, t1: float | None = None) -> None:
        """A span from ``perf_counter`` stamps the caller already took; ``t1``
        None means now (the clock is read only when tracing is on)."""
        if self.enabled:
            self._record(name, t0, time.perf_counter() if t1 is None else t1)

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
            self._fold(name, dur)

    def _fold(self, name: str, dur: float) -> None:
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

    # -- the device track ----------------------------------------------

    def gpu_mark(self, device) -> GpuMark | None:
        """At a device-step site, before the step's first op: a timing event
        on ``device``'s current stream and the anchor that will place it.
        None when tracing is off, ``device`` is not a card, or the card has
        no anchor yet (its stream has not been idle at a step's start)."""
        if not self.enabled or device.type != "cuda":
            return None
        import torch

        idx = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(idx)
        anchor = self._renew(torch, idx, stream)
        if anchor is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return GpuMark(ev, anchor)

    def gpu_anchor(self, device) -> None:
        """Renew ``device``'s anchor if it is stale and its current stream has
        nothing left to run (a worker calls this after a downlink landed)."""
        if self.enabled and device.type == "cuda":
            import torch

            idx = device.index if device.index is not None else torch.cuda.current_device()
            self._renew(torch, idx, torch.cuda.current_stream(idx))

    def _renew(self, torch, idx: int, stream) -> _Anchor | None:
        """Card ``idx``'s anchor, first renewed on ``stream`` when it is older
        than ``ANCHOR_S`` and the stream is idle; None if it has none."""
        anchor = self._anchors.get(idx)
        if (anchor is None or time.perf_counter() - anchor.t > ANCHOR_S) and stream.query():
            ev = torch.cuda.Event(enable_timing=True)
            t_a = time.perf_counter()
            ev.record(stream)
            while not ev.query():
                if time.perf_counter() - t_a > ANCHOR_WAIT_S:
                    return anchor
            t_c = time.perf_counter()
            if t_c - t_a <= ANCHOR_WAIT_S:
                anchor = self._anchors[idx] = _Anchor(ev, 0.5 * (t_a + t_c), idx)
        return anchor

    def gpu_span(self, mark: GpuMark, done) -> tuple | None:
        """Called by a worker that has waited on ``done`` (the step-done
        event, recorded with timing behind the step whose first op ``mark``
        precedes): the ``gpu-step`` span from ``mark`` to ``done`` on the
        host clock, kept in the device ring. -> (t0, t1) in ``perf_counter``
        seconds, or None when the anchor has not run yet (``elapsed_time``
        needs both of its events done, and the anchor's stream may be
        another thread's)."""
        a = mark.anchor
        if not a.event.query():
            return None
        t0 = a.t + a.event.elapsed_time(mark.event) * 1e-3
        t1 = a.t + a.event.elapsed_time(done) * 1e-3
        with self._lock:
            self._dev_ring.append(("gpu-step", t0 - self._epoch, t1 - t0, a.track))
            self._fold("gpu-step", t1 - t0)
        return t0, t1

    def device_spans(self) -> list:
        """The device ring as (name, start, end, card) on the host clock."""
        with self._lock:
            return [(n, self._epoch + rel, self._epoch + rel + dur, track)
                    for n, rel, dur, track in self._dev_ring]

    # -- export --------------------------------------------------------

    def summary(self) -> dict:
        """Per-stage aggregates in milliseconds (stats-tracer view); device
        spans aggregate under their own names."""
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
        tracer view: stage overlap across threads on a timeline). Device
        spans, if any, form process 2, a track per card, below the host's
        process 1."""
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
            if self._dev_ring:
                events += [{"name": "process_name", "ph": "M", "pid": pid,
                            "args": {"name": label}}
                           for pid, label in ((1, "host"), (2, "card"))]
                events += [
                    {"name": name, "ph": "X", "ts": round(rel * 1e6, 1),
                     "dur": round(dur * 1e6, 1), "pid": 2, "tid": track}
                    for name, rel, dur, track in self._dev_ring
                ]
        return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})


# the process-global tracer every stage uses
tracer = Tracer()


def span(name: str):
    """Module-level convenience: `with tracing.span("pack"):`."""
    return tracer.span(name)
