"""Frame-correlated telemetry bus — the serving stack's structured metrics.

The port's copy of ``selkies_tpu/monitoring/telemetry.py``: the same
family specs, ``Telemetry`` with ``count`` / ``gauge`` / ``observe`` /
``stage_ms`` / ``event`` / ``frame_done``, the providers, ``rollup``,
``statz_json`` and ``health``, and the same ``SELKIES_TELEMETRY`` switch;
``frame_done`` also takes the port's ``group_wait_ms``.
The Prometheus collector (``register_into`` / ``registry``, which
``metrics.py`` calls; ``prometheus_client`` is imported only when they
run), ``_supported_codecs`` (the codec rows the port's negotiation
probes) and ``capacity_digest`` (over the port's ``cluster.membership.
build_digest``, the ``capacity`` block of ``health()``) are copied too.

Where monitoring/tracing.py answers "how long did each stage take?"
(anonymous spans on a timeline), this bus answers "what happened to
frame N, and how often does each thing happen?": every emission carries
a **frame correlation id** assigned at capture and threaded through
tile-cache classification, device encode, entropy pack, transport send,
and the client's congestion-control ack — so one frame's life can be
reconstructed across threads and stages. Three consumers:

* **labeled metric families** (``METRIC_FAMILIES``): per-session
  stage-latency and frame-byte histograms, tile-cache / supervisor /
  congestion / fault counters, and the encoder's ``LinkByteCounter``
  exported live through a registered provider.
* **/statz** — ``rollup()`` is the JSON operations view served by the
  signalling server (signalling/server.py).
* **flight recorder** — every emission also lands in the attached
  :class:`~selkies_tpu_torch.monitoring.flightrecorder.FlightRecorder`'s
  bounded per-slot ring; a supervisor escalation past ``warn`` dumps
  the ring as a post-mortem bundle (``escalation()``).

Cost discipline matches tracing.py: off by default (enable with
``SELKIES_TELEMETRY=1`` or ``telemetry.enable()``), and every mutator
early-returns on one attribute read, mutating **nothing** while
disabled — encoded bytes are identical with telemetry on or off because
no data-plane code ever branches on it.

Frame-id propagation uses a ``contextvars.ContextVar``:
``telemetry.span("submit", fid)`` sets the current frame id, and
``asyncio.to_thread`` copies the context, so events emitted deep inside
the encoder (tile-cache hit/miss counters) correlate without the
encoder API carrying the id.
"""

from __future__ import annotations

import asyncio
import contextvars
import itertools
import json
import logging
import threading
import time
import os
import weakref

logger = logging.getLogger("telemetry")

__all__ = [
    "Telemetry",
    "telemetry",
    "METRIC_FAMILIES",
    "STAGE_BUCKETS_MS",
    "STAGE_BUCKETS_SUBMS",
    "STAGE_BUCKET_LADDERS",
    "FRAME_BYTE_BUCKETS",
    "COMPILE_BUCKETS_MS",
]

ENV_VAR = "SELKIES_TELEMETRY"

# histogram bucket edges: stage latencies span sub-ms host packs to
# multi-hundred-ms cold device round trips; frame bytes span all-skip
# P slices (~tens of bytes) to 4K IDRs
STAGE_BUCKETS_MS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 33.0, 66.0, 133.0, 500.0)
FRAME_BYTE_BUCKETS = (1024, 4096, 16384, 65536, 262144, 1048576)
# executable builds (monitoring/jitprof.py): the port's first-use
# nvcc / g++ builds, from about a second to minutes
COMPILE_BUCKETS_MS = (1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0,
                      16384.0, 65536.0)

# Per-STAGE bucket ladders for selkies_stage_ms: the uplink front-end
# stages can take well under a millisecond, so on the default ladder
# every observation would land in the lowest (0.5 ms) bucket and a 10x
# regression would stay invisible until it crossed into milliseconds.
# Stages listed here histogram on a sub-ms ladder; each series carries its
# own edges. unpack and bits_fetch ride along.
STAGE_BUCKETS_SUBMS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 33.0)
STAGE_BUCKET_LADDERS: dict[str, tuple[float, ...]] = {
    "classify": STAGE_BUCKETS_SUBMS,
    "convert": STAGE_BUCKETS_SUBMS,
    "h2d": STAGE_BUCKETS_SUBMS,
    "unpack": STAGE_BUCKETS_SUBMS,
    "bits_fetch": STAGE_BUCKETS_SUBMS,
    # occupancy dispatch-lane wait (parallel/occupancy.py): how long a
    # session's dispatch sat behind earlier sessions this tick — sub-ms
    # when the lane keeps up, milliseconds when a front-end hogs it
    "sched_wait": STAGE_BUCKETS_SUBMS,
}

# Every family this bus can emit, name -> help string. The names are the
# observability contract: tools/check_metric_docs.py asserts each one is
# documented in docs/observability.md (run from tier-1 tests).
METRIC_FAMILIES: dict[str, str] = {
    "selkies_stage_ms":
        "Per-stage latency histogram in milliseconds, labeled by pipeline "
        "stage and session",
    "selkies_frame_bytes":
        "Encoded access-unit size histogram in bytes, labeled by session",
    "selkies_frames_total":
        "Encoded frames, labeled by session and kind (idr/p)",
    "selkies_tile_cache_tiles_total":
        "Tile-cache per-tile outcomes (hit/miss/evict), labeled by session",
    "selkies_tile_cache_frames_total":
        "Frame upload classification (static/delta/remap_only/full), "
        "labeled by session",
    "selkies_link_bytes_total":
        "Host<->device link bytes, labeled by direction (up/down) and stage",
    "selkies_downlink_mode_total":
        "P-frame downlink payload mode per encoded frame (coeff = sparse "
        "coefficient rows, bits = device-entropy slice bits, dense = "
        "dense-fallback fetch), labeled by session and mode",
    "selkies_congestion_target_kbps":
        "GCC congestion-controller target bitrate, labeled by session",
    "selkies_congestion_loss_ratio":
        "Last reported fraction of packets lost, labeled by session",
    "selkies_congestion_rtt_ms":
        "Client round-trip latency from the ping channel, labeled by session",
    "selkies_congestion_events_total":
        "Congestion-controller events (increase/decrease/loss_report), "
        "labeled by session",
    "selkies_supervisor_rung":
        "Current recovery-ladder rung (0=healthy .. 5=recycle), labeled "
        "by slot",
    "selkies_supervisor_events_total":
        "Recovery-ladder events (warn/force_idr/restart/degrade/undegrade/"
        "recycle/deadline_miss/recovered), labeled by slot",
    "selkies_rtx_packets_total":
        "NACK-driven retransmissions at the peer's send boundary, labeled "
        "by result (sent/budget_drop — budget_drop counts retransmits the "
        "abuse token bucket refused)",
    "selkies_fec_recovered_total":
        "Packets rebuilt from ULP FEC parity by the recovering receiver, "
        "labeled by session",
    "selkies_frames_frozen_total":
        "Frames abandoned because a gap outlived every recovery rung "
        "(the receiver's freeze deadline expired), labeled by session",
    "selkies_recovery_rung":
        "Transport recovery-ladder rung (0=clean 1=rtx 2=fec 3=refresh "
        "4=degrade), labeled by session",
    "selkies_faults_injected_total":
        "Deterministic injected faults (resilience/faultinject.py), "
        "labeled by site and action",
    "selkies_blackbox_dumps_total":
        "Black-box flight-recorder bundles written, labeled by slot",
    "selkies_admission_total":
        "Session admission-control decisions (parallel/lifecycle.py), "
        "labeled by decision (accept/queue/reject) and reason",
    "selkies_lifecycle_events_total":
        "Fleet lifecycle transitions (drain_begin/drain_done/drain_timeout/"
        "recarve_borrow/recarve_return/checkpoint/restore/release/"
        "quarantine/readmit), labeled by event",
    "selkies_placement_chips":
        "Chips by placement state in the SessionPlacer carve "
        "(free/assigned/borrowed/quarantined)",
    "selkies_drain_state":
        "Process drain state (0=serving, 1=draining, 2=drained)",
    "selkies_codec_sessions":
        "Sessions currently negotiated per codec (h264/av1/vp9/...), "
        "labeled by codec — per-client negotiation is "
        "signalling/negotiate.py",
    "selkies_policy_scenario":
        "Scenario the policy engine currently classifies a session as "
        "(selkies_tpu/policy): 1 for the active scenario, 0 otherwise, "
        "labeled by session and scenario (idle/typing/scroll/drag/video/"
        "game/unknown, plus the 'congested' link overlay)",
    "selkies_policy_transitions_total":
        "Policy scenario transitions, labeled by session and the "
        "scenario transitioned INTO ('congested' and 'disarmed' count "
        "the overlay and the wedged-engine fallback)",
    "selkies_policy_actuations_total":
        "Encoder knob retunes the policy engine applied, labeled by "
        "session and knob (tile_cache/batch_cap/device_entropy/"
        "keyframe_interval)",
    "selkies_slo_burn_rate":
        "SLO burn rate (observed badness / allowed badness) per session "
        "and objective (latency_p50/latency_p95/fps/downlink/quality) "
        "over the fast (1-min) and slow (30-min) windows "
        "(monitoring/slo.py)",
    "selkies_slo_breached":
        "SLO breach state per session and objective: 0 ok, 1 chronic "
        "(slow window over threshold), 2 acute (fast window over "
        "threshold — hooks fired)",
    "selkies_slo_breaches_total":
        "SLO burn-threshold crossings, labeled by session, objective and "
        "the window that crossed (fast/slow)",
    "selkies_slo_outliers_total":
        "p99 latency-outlier frames the rolling-quantile trigger "
        "detected (each dumps a rate-limited black-box bundle tagged "
        "with the frame's correlation id), labeled by session",
    "selkies_compile_total":
        "Executable builds observed by the recompile sentinel (the "
        "port's first-use nvcc / g++ kernel builds) "
        "(monitoring/jitprof.py), labeled by attributed trigger "
        "(actuation/recarve/codec_switch/resize/restart/startup/"
        "unattributed)",
    "selkies_compile_ms":
        "Executable build wall-time histogram in milliseconds, labeled by "
        "attributed trigger",
    "selkies_compile_storms_total":
        "Recompile storms flagged (N compiles inside the dwell window — "
        "an executable-reuse discipline is broken), labeled by the "
        "window's dominant trigger",
    "selkies_device_health":
        "Per-chip device health in the DevicePool "
        "(resilience/devhealth.py): 0 healthy, 1 quarantined "
        "(probation until sustained healthy probes readmit it), "
        "labeled by chip",
    "selkies_device_quarantines_total":
        "Chip quarantine transitions (attributed step-failure streak or "
        "failed liveness probe crossing SELKIES_DEVICE_FAIL_THRESHOLD), "
        "labeled by chip and reason",
    "selkies_cluster_peers":
        "Cluster membership view (selkies_tpu/cluster): peers counted "
        "by lease state (alive/dead)",
    "selkies_cluster_heartbeats_total":
        "Cluster heartbeat traffic, labeled by peer and result "
        "(ok/fail on the send side, received/rejected on the receive "
        "side — rejected means a bad HMAC signature)",
    "selkies_cluster_redirects_total":
        "Server-initiated signalling redirects actually sent, labeled "
        "by reason (draining/capacity/codec/migrated)",
    "selkies_cluster_migrations_total":
        "Cross-host live migrations, labeled by direction (out/in) and "
        "result (ok/fail) — an `out` failure leaves the session serving "
        "on the source",
    "selkies_occupancy_overlap_ratio":
        "Fraction of the tick's serialized per-session stage time hidden "
        "by the occupancy scheduler's overlap (parallel/occupancy.py): "
        "0 = fully serial, approaching 1-1/N when N equal sessions "
        "overlap perfectly; 1 - wall / sum(stage time) per tick",
    "selkies_quality_psnr_db":
        "Sampled decode-and-compare luma PSNR in dB "
        "(monitoring/quality.py, SELKIES_QUALITY=1), labeled by session "
        "and scenario; capped at 99 dB (= visually lossless)",
    "selkies_quality_ssim":
        "Sampled decode-and-compare luma SSIM (monitoring/quality.py), "
        "labeled by session and scenario",
    "selkies_quality_vmaf":
        "Sampled VMAF-axis score 0-100 (monitoring/quality.py): the "
        "real vmaf CLI when present, otherwise the documented "
        "PSNR+SSIM proxy composite — the quality_sample ring event's "
        "vmaf_kind says which; labeled by session and scenario",
    "selkies_rc_qp":
        "Per-frame quantizer the encoder actually used (the CBR "
        "controller's output — models/h264/ratecontrol.py), labeled by "
        "session; the RC state the quality axis correlates with",
    "selkies_rc_fullness":
        "CBR leaky-bucket VBV fullness per encoded frame, normalized to "
        "the VBV size (0 = midpoint-neutral, 1 = one full VBV of debt, "
        "clamps at -1 and 4 — ratecontrol.py), labeled by session",
}

# canonical label names per family (order fixed for the Prometheus
# exposition); emissions fill missing labels with "0" (the solo session)
_FAMILY_LABELS: dict[str, tuple[str, ...]] = {
    "selkies_stage_ms": ("stage", "session"),
    "selkies_frame_bytes": ("session",),
    "selkies_frames_total": ("session", "kind"),
    "selkies_tile_cache_tiles_total": ("session", "result"),
    "selkies_tile_cache_frames_total": ("session", "kind"),
    "selkies_link_bytes_total": ("direction", "stage"),
    "selkies_downlink_mode_total": ("session", "mode"),
    "selkies_congestion_target_kbps": ("session",),
    "selkies_congestion_loss_ratio": ("session",),
    "selkies_congestion_rtt_ms": ("session",),
    "selkies_congestion_events_total": ("session", "event"),
    "selkies_supervisor_rung": ("slot",),
    "selkies_supervisor_events_total": ("slot", "event"),
    "selkies_faults_injected_total": ("site", "action"),
    "selkies_blackbox_dumps_total": ("slot",),
    "selkies_admission_total": ("decision", "reason"),
    "selkies_lifecycle_events_total": ("event",),
    "selkies_placement_chips": ("state",),
    "selkies_drain_state": (),
    "selkies_codec_sessions": ("codec",),
    "selkies_policy_scenario": ("session", "scenario"),
    "selkies_policy_transitions_total": ("session", "scenario"),
    "selkies_policy_actuations_total": ("session", "knob"),
    "selkies_slo_burn_rate": ("session", "objective", "window"),
    "selkies_slo_breached": ("session", "objective"),
    "selkies_slo_breaches_total": ("session", "objective", "window"),
    "selkies_slo_outliers_total": ("session",),
    "selkies_compile_total": ("trigger",),
    "selkies_compile_ms": ("trigger",),
    "selkies_compile_storms_total": ("trigger",),
    "selkies_device_health": ("chip",),
    "selkies_device_quarantines_total": ("chip", "reason"),
    "selkies_cluster_peers": ("state",),
    "selkies_cluster_heartbeats_total": ("peer", "result"),
    "selkies_cluster_redirects_total": ("reason",),
    "selkies_cluster_migrations_total": ("direction", "result"),
    "selkies_occupancy_overlap_ratio": (),
    "selkies_quality_psnr_db": ("session", "scenario"),
    "selkies_quality_ssim": ("session", "scenario"),
    "selkies_quality_vmaf": ("session", "scenario"),
    "selkies_rc_qp": ("session",),
    "selkies_rc_fullness": ("session",),
}

_HIST_BUCKETS: dict[str, tuple[float, ...]] = {
    "selkies_stage_ms": STAGE_BUCKETS_MS,
    "selkies_frame_bytes": FRAME_BYTE_BUCKETS,
    "selkies_compile_ms": COMPILE_BUCKETS_MS,
    # quality axes (monitoring/quality.py): PSNR edges straddle the
    # 30-40 dB band where streaming encodes actually live; SSIM edges
    # compress toward 1.0 the same way the scores do
    "selkies_quality_psnr_db": (20.0, 24.0, 28.0, 30.0, 32.0, 34.0, 36.0,
                                38.0, 40.0, 44.0, 50.0, 99.0),
    "selkies_quality_ssim": (0.5, 0.7, 0.8, 0.85, 0.9, 0.93, 0.95, 0.97,
                             0.98, 0.99, 0.995, 1.0),
    "selkies_quality_vmaf": (10.0, 20.0, 30.0, 40.0, 50.0, 60.0, 70.0,
                             80.0, 90.0, 95.0, 99.0),
    # RC state: the H.264 QP range and the controller's clamped
    # normalized VBV fullness [-1, 4] (models/h264/ratecontrol.py)
    "selkies_rc_qp": (10.0, 14.0, 18.0, 22.0, 26.0, 30.0, 34.0, 38.0,
                      42.0, 46.0, 51.0),
    "selkies_rc_fullness": (-1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 1.0, 2.0,
                            3.0, 4.0),
}


def _buckets_for(family: str, labelvals: tuple[str, ...]) -> tuple[float, ...]:
    """Bucket edges for one histogram series: selkies_stage_ms resolves
    a per-stage ladder (the stage is the first label), everything else
    uses the family's single ladder."""
    if family == "selkies_stage_ms" and labelvals:
        return STAGE_BUCKET_LADDERS.get(labelvals[0], STAGE_BUCKETS_MS)
    return _HIST_BUCKETS[family]

# current frame correlation id; 0 = none. asyncio.to_thread copies the
# context, so a span set on the event loop is visible on the worker.
_frame_ctx: contextvars.ContextVar[int] = contextvars.ContextVar(
    "selkies_frame_id", default=0)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _TeleSpan:
    """Times one stage for one frame; observes the stage histogram and
    records a timeline event on exit. Sets the frame ContextVar so
    nested emissions (encoder internals) correlate."""

    __slots__ = ("t", "stage", "session", "frame", "fields", "t0", "_tok")

    def __init__(self, t: "Telemetry", stage: str, session: str,
                 frame: int, fields: dict):
        self.t = t
        self.stage = stage
        self.session = session
        self.frame = frame
        self.fields = fields
        self._tok = None

    def __enter__(self):
        if self.frame:
            self._tok = _frame_ctx.set(self.frame)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self.t0) * 1e3
        if self._tok is not None:
            _frame_ctx.reset(self._tok)
        self.t.stage_ms(self.stage, ms, session=self.session,
                        frame=self.frame, **self.fields)
        return False


class Telemetry:
    """The bus. One process-global instance (``telemetry``) below."""

    def __init__(self, enabled: bool | None = None):
        self.enabled = (bool(os.environ.get(ENV_VAR))
                        if enabled is None else bool(enabled))
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}   # (family, labelvals) -> n
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, list] = {}       # -> [bucket_counts, sum]
        self._providers: dict[str, object] = {}   # name -> () -> dict
        self._slots: dict[str, object] = {}       # slot name -> SlotSupervisor
        self._lifecycle = None                    # weakref to DrainController
        self._slo = None                          # weakref to health_view fn
        self._devhealth = None                    # weakref to DevicePool view
        self._seq_map: dict[tuple[str, int], int] = {}  # (session, seq) -> fid
        self._frame_ids = itertools.count(1)
        self._epoch = time.time()
        self._registry = None
        self.recorder = None
        if self.enabled:
            self._ensure_recorder()

    # -- control -------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True
        self._ensure_recorder()

    def disable(self) -> None:
        self.enabled = False
        # detach the recorder too: with emission off the rings freeze,
        # and a later escalation must not dump stale pre-disable events
        # as if they were evidence for the current failure
        self.recorder = None

    def _ensure_recorder(self):
        if self.recorder is None:
            from selkies_tpu_torch.monitoring.flightrecorder import FlightRecorder

            self.recorder = FlightRecorder()
        return self.recorder

    def reset(self) -> None:
        """Tests: drop all accumulated state (keeps registrations out —
        providers/slots re-register on construction of their owners)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._seq_map.clear()
            self._providers.clear()
            self._slots.clear()
            self._lifecycle = None
            self._slo = None
            self._devhealth = None
        self.recorder = None
        self._epoch = time.time()

    # -- frame correlation ---------------------------------------------

    def next_frame_id(self) -> int:
        return next(self._frame_ids)

    @staticmethod
    def current_frame() -> int:
        return _frame_ctx.get()

    def span(self, stage: str, frame: int = 0, *, session: str = "0",
             **fields):
        """``with telemetry.span("capture", fid):`` — no-op when disabled
        (same one-attribute-read discipline as tracing.Tracer.span)."""
        if not self.enabled:
            return _NOOP
        return _TeleSpan(self, stage, session, frame, fields)

    def map_seq(self, session: str, seq: int, frame: int) -> None:
        """Transport send: remember which frame a wire sequence number
        carried so the client's ack can be correlated back."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._seq_map) > 8192:  # acks lost: bound memory
                self._seq_map.clear()
            self._seq_map[(session, seq)] = frame

    def ack(self, session: str, seq: int, recv_ms: float) -> None:
        """Client feedback (``_ack,<seq>,<recv_ms>`` / RTCP): closes the
        frame's timeline."""
        if not self.enabled:
            return
        with self._lock:
            fid = self._seq_map.pop((session, seq), 0)
        self._record(session, {"ev": "ack", "fid": fid, "seq": seq,
                               "recv_ms": round(recv_ms, 3)})

    # -- emission ------------------------------------------------------

    def _labels_of(self, family: str, labels: dict) -> tuple[str, ...]:
        names = _FAMILY_LABELS.get(family)
        if names is None:  # unregistered family: fail soft, keep serving
            names = tuple(sorted(labels))
            _FAMILY_LABELS[family] = names
        return tuple(str(labels.get(n, "0")) for n in names)

    def count(self, family: str, n: float = 1, **labels) -> None:
        if not self.enabled:
            return
        key = (family, self._labels_of(family, labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n
        self._record(labels.get("session") or labels.get("slot") or "0",
                     {"ev": family, "n": n, **labels})

    def gauge(self, family: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        key = (family, self._labels_of(family, labels))
        with self._lock:
            self._gauges[key] = float(value)
        self._record(labels.get("session") or labels.get("slot") or "0",
                     {"ev": family, "value": value, **labels})

    def observe(self, family: str, value: float, **labels) -> None:
        """Public histogram observation for emitters outside this module
        (the compile sentinel's selkies_compile_ms)."""
        if not self.enabled:
            return
        self._observe(family, value, labels)

    def _observe(self, family: str, value: float, labels: dict) -> None:
        vals = self._labels_of(family, labels)
        buckets = _buckets_for(family, vals)
        key = (family, vals)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [[0] * (len(buckets) + 1), 0.0]
            i = 0
            while i < len(buckets) and value > buckets[i]:
                i += 1
            h[0][i] += 1
            h[1] += value

    def stage_ms(self, stage: str, ms: float, *, session: str = "0",
                 frame: int = 0, **fields) -> None:
        """One stage execution for one frame: histogram + timeline."""
        if not self.enabled:
            return
        self._observe("selkies_stage_ms", ms, {"stage": stage,
                                               "session": session})
        self._record(session, {"ev": stage, "fid": frame or _frame_ctx.get(),
                               "ms": round(ms, 3), **fields})

    def frame_done(self, frame: int, nbytes: int, *, idr: bool,
                   session: str = "0", device_ms: float = 0.0,
                   pack_ms: float = 0.0, unpack_ms: float = 0.0,
                   cavlc_ms: float = 0.0, downlink_mode: str = "",
                   bits_fetch_ms: float = 0.0, classify_ms: float = 0.0,
                   convert_ms: float = 0.0, h2d_ms: float = 0.0,
                   qp: int = 0, rc_fullness: float | None = None,
                   entropy_coder: str = "", group_wait_ms: float = 0.0) -> None:
        """An encoded access unit left the encoder: fold its size, kind,
        and on-device / entropy-pack milliseconds. unpack/cavlc are the
        completion sub-stages of pack_ms (coefficient prep vs the CAVLC
        bit pack itself); rows that don't attribute them pass 0.
        downlink_mode ("coeff"/"bits"/"cabac"/"dense", "" = no downlink;
        "bits" = device CAVLC bit words, "cabac" = device token IR)
        counts into selkies_downlink_mode_total; bits_fetch_ms is the
        d2h transfer of a device-entropy frame's bit/token words (the
        "bits_fetch" stage), so bits-mode fetch latency stays separable
        from the coefficient fetch it replaces. entropy_coder
        ("cavlc"/"cabac", "" = unattributed) stamps the stream's active
        entropy backend onto the frame event so a recorder ring shows
        which coder produced each AU across a retune. classify/convert/h2d are the
        uplink front-end sub-stages of the frame's upload cost (fused
        dirty scan + hash/split, BGRx->I420 of the upload payload, h2d
        transfer enqueues): without this split a regression
        in the host front-end hides inside the device stage again.
        group_wait_ms (the port's) is a delta frame's wait in the solo
        encoder's pending group before its group dispatched (stage
        "group_wait"; 0, not observed, for a frame dispatched alone).
        qp (>0) and rc_fullness (None = unattributed; 0.0 is a real
        reading) export the rate-control state the quality axis
        correlates with — the frame's actual quantizer and the CBR
        VBV fullness normalized to the buffer size."""
        if not self.enabled:
            return
        self._observe("selkies_frame_bytes", nbytes, {"session": session})
        key = ("selkies_frames_total", (session, "idr" if idr else "p"))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + 1
        if downlink_mode:
            mkey = ("selkies_downlink_mode_total", (session, downlink_mode))
            with self._lock:
                self._counters[mkey] = self._counters.get(mkey, 0) + 1
        if device_ms:
            self._observe("selkies_stage_ms", device_ms,
                          {"stage": "device", "session": session})
        if pack_ms:
            self._observe("selkies_stage_ms", pack_ms,
                          {"stage": "pack", "session": session})
        if unpack_ms:
            self._observe("selkies_stage_ms", unpack_ms,
                          {"stage": "unpack", "session": session})
        if cavlc_ms:
            self._observe("selkies_stage_ms", cavlc_ms,
                          {"stage": "cavlc", "session": session})
        if bits_fetch_ms:
            self._observe("selkies_stage_ms", bits_fetch_ms,
                          {"stage": "bits_fetch", "session": session})
        if classify_ms:
            self._observe("selkies_stage_ms", classify_ms,
                          {"stage": "classify", "session": session})
        if convert_ms:
            self._observe("selkies_stage_ms", convert_ms,
                          {"stage": "convert", "session": session})
        if h2d_ms:
            self._observe("selkies_stage_ms", h2d_ms,
                          {"stage": "h2d", "session": session})
        if group_wait_ms:
            self._observe("selkies_stage_ms", group_wait_ms,
                          {"stage": "group_wait", "session": session})
        if qp > 0:
            self._observe("selkies_rc_qp", qp, {"session": session})
        if rc_fullness is not None:
            self._observe("selkies_rc_fullness", rc_fullness,
                          {"session": session})
        self._record(session, {"ev": "frame", "fid": frame, "bytes": nbytes,
                               "idr": idr, "device_ms": round(device_ms, 3),
                               "pack_ms": round(pack_ms, 3),
                               "unpack_ms": round(unpack_ms, 3),
                               "cavlc_ms": round(cavlc_ms, 3),
                               "mode": downlink_mode, "qp": qp,
                               **({"coder": entropy_coder}
                                  if entropy_coder else {}),
                               **({"vbv": round(rc_fullness, 3)}
                                  if rc_fullness is not None else {})})

    def event(self, kind: str, *, session: str = "0", **fields) -> None:
        """A first-class timeline event for the flight-recorder rings —
        no metric, just post-mortem context. The post-PR-3 subsystems
        emit these so their state changes appear in dumped bundles next
        to the frame timeline: policy transitions/actuations, codec
        negotiations, lifecycle admit/recarve/migrate/drain, SLO
        breaches/recoveries, recompile storms."""
        if not self.enabled:
            return
        self._record(str(session), {"ev": kind, **fields})

    def _record(self, session: str, ev: dict) -> None:
        rec = self.recorder
        if rec is not None:
            if "fid" not in ev:
                # nested emissions (the encoder's tile-cache counters on
                # the encode worker) inherit the frame id from the span's
                # ContextVar — this read IS the advertised correlation
                fid = _frame_ctx.get()
                if fid:
                    ev["fid"] = fid
            rec.record(session, ev)

    # -- registrations -------------------------------------------------

    def register_provider(self, name: str, fn) -> None:
        """A live read-side source folded into ``rollup()`` and the
        Prometheus collector (e.g. the encoder's LinkByteCounter
        snapshot). ``fn`` must be cheap and thread-safe. Bound methods
        are held via WeakMethod so this process-global registry never
        keeps a torn-down app/fleet (and its encoder) alive; names are
        last-writer-wins — the newest owner of a name is the live one."""
        if hasattr(fn, "__self__"):
            self._providers[name] = weakref.WeakMethod(fn)
        else:
            self._providers[name] = lambda: fn

    def register_lifecycle(self, controller) -> None:
        """Called by lifecycle.DrainController.__init__: makes the drain
        state visible to ``health()`` / ``/healthz`` (503 while
        draining) regardless of metric emission. Weakly referenced and
        last-writer-wins, like slot registration — one live drain
        controller per process is the product shape."""
        self._lifecycle = weakref.ref(controller)

    def register_slo(self, fn) -> None:
        """Called by the SLO plane's owner (app / fleet): ``fn`` returns
        the per-session breach summary folded into ``health()`` →
        ``/healthz`` as the ``slo`` block. Weakly referenced and
        last-writer-wins, like the lifecycle registration."""
        self._slo = weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
            else weakref.ref(fn)

    def register_devices(self, fn) -> None:
        """Called by the DevicePool (resilience/devhealth.py): ``fn``
        returns the chip-health capacity detail folded into ``health()``
        → ``/healthz`` as the ``devices`` block — the degraded-capacity
        signal the chronic-burn autoscaler reads. A pure chip quarantine
        never flips the probe status; sessions carry their own impact
        through the supervisor rungs. Weakly referenced and last-writer-
        wins like the lifecycle/slo registrations."""
        self._devhealth = weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
            else weakref.ref(fn)

    def register_slot(self, name: str, supervisor) -> None:
        """Called by SlotSupervisor.__init__: makes the slot visible to
        ``health()`` / ``/healthz`` regardless of whether metric
        emission is enabled. Weakly referenced (a recycled app's
        supervisor must not be pinned forever) and last-writer-wins per
        name, matching the one-supervisor-per-slot-name product shape."""
        self._slots[name] = weakref.ref(supervisor)

    def _provider_values(self) -> dict[str, dict]:
        out = {}
        for name, ref in list(self._providers.items()):
            fn = ref()
            if fn is None:  # owner got collected
                self._providers.pop(name, None)
                continue
            try:
                out[name] = fn() or {}
            except Exception:
                logger.exception("telemetry provider %r failed", name)
                out[name] = {}
        return out

    # -- read side -----------------------------------------------------

    def capacity_digest(self) -> dict:
        """The ONE machine-readable capacity/drain summary of this
        process — shared verbatim by ``/healthz`` (the ``capacity``
        block), ``/statz`` (inside ``health``) and the cluster
        heartbeat (cluster/membership.py, which owns the
        actual derivation in ``build_digest``). Folds the registered
        lifecycle (drain state + placer carve), device-health
        (degraded chip capacity) and SLO (chronic-burn sessions) views
        plus the probed codec rows into stable fields so no surface
        re-derives them."""
        from selkies_tpu_torch.cluster.membership import build_digest

        lc = self._lifecycle() if self._lifecycle is not None else None
        dev = self._devhealth() if self._devhealth is not None else None
        slo = self._slo() if self._slo is not None else None
        dev_view = slo_views = None
        if dev is not None:
            try:
                dev_view = dev()
            except Exception:
                dev_view = None
        if slo is not None:
            try:
                slo_views = slo()
            except Exception:
                slo_views = None
        return build_digest(drain=lc, devices_view=dev_view,
                            slo_views=slo_views,
                            codecs=_supported_codecs())

    def health(self) -> dict:
        """Rung/watchdog summary for k8s-style probes. Works with
        telemetry disabled — supervisors register unconditionally.
        ``status``: ok (all slots at/below WARN), degraded (a slot is
        shedding load or restarting), down (a slot hit RECYCLE),
        draining (the process is in its preStop drain — probes should
        stop routing new clients here)."""
        slots = {}
        worst = 0
        for name, ref in list(self._slots.items()):
            sup = ref()
            if sup is None:  # supervisor got collected
                self._slots.pop(name, None)
                continue
            try:
                slots[name] = sup.stats()
                worst = max(worst, int(sup.rung))
            except Exception:
                slots[name] = {"error": "unreadable"}
        status = "ok" if worst <= 1 else ("down" if worst >= 5 else "degraded")
        out = {"status": status, "worst_rung": worst, "slots": slots}
        lc = self._lifecycle() if self._lifecycle is not None else None
        if lc is not None:
            try:
                view = lc.health_view()
            except Exception:
                view = {"state": "unreadable"}
            out["lifecycle"] = view
            # drain outranks everything except a hard-down slot: the
            # balancer must stop routing here even while slots are healthy
            if view.get("state") in ("draining", "drained") and status != "down":
                out["status"] = "draining"
        dev = self._devhealth() if self._devhealth is not None else None
        if dev is not None:
            # chip-health capacity detail (resilience/devhealth.py):
            # quarantined chips shrink the serveable carve without any
            # slot being unhealthy — the autoscaling plane reads this
            try:
                out["devices"] = dev()
            except Exception:
                out["devices"] = {"error": "unreadable"}
        slo = self._slo() if self._slo is not None else None
        if slo is not None:
            # SLO detail (monitoring/slo.py): which sessions are burning
            # which objectives — probes keep getting 200 on a pure SLO
            # breach (the supervisor's sticky WARN rung carries it), but
            # the detail is what an autoscaler reads
            try:
                out["slo"] = slo()
            except Exception:
                out["slo"] = {"error": "unreadable"}
        # the machine-readable capacity digest: the same fields the
        # cluster heartbeat ships, so an external balancer/autoscaler
        # reads ONE schema whether it scrapes /healthz or the gossip
        try:
            out["capacity"] = self.capacity_digest()
        except Exception:
            out["capacity"] = {"error": "unreadable"}
        return out

    def rollup(self) -> dict:
        """The /statz JSON: histograms, counters, gauges, providers,
        health, and the tracer's per-stage summary."""
        from selkies_tpu_torch.monitoring.tracing import tracer

        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (list(v[0]), v[1]) for k, v in self._hists.items()}

        def label_str(family: str, vals: tuple) -> str:
            names = _FAMILY_LABELS.get(family, ())
            return ",".join(f"{n}={v}" for n, v in zip(names, vals))

        def fold(d: dict) -> dict:
            out: dict[str, dict] = {}
            for (family, vals), v in sorted(d.items()):
                out.setdefault(family, {})[label_str(family, vals)] = v
            return out

        stages: dict[str, dict] = {}
        for (family, vals), (counts, total) in sorted(hists.items()):
            n = sum(counts)
            stages.setdefault(family, {})[label_str(family, vals)] = {
                "count": n,
                "mean": round(total / n, 3) if n else 0.0,
                "buckets": dict(zip(
                    [str(b) for b in _buckets_for(family, vals)] + ["+Inf"],
                    itertools.accumulate(counts))),
            }
        return {
            "enabled": self.enabled,
            "uptime_s": round(time.time() - self._epoch, 1),
            "histograms": stages,
            "counters": fold(counters),
            "gauges": fold(gauges),
            "providers": self._provider_values(),
            "health": self.health(),
            "trace": tracer.summary() if tracer.enabled else {},
        }

    def statz_json(self) -> str:
        return json.dumps(self.rollup(), indent=2)

    # -- prometheus fold -----------------------------------------------

    def register_into(self, registry) -> None:
        """Fold this bus into an existing prometheus CollectorRegistry
        (Metrics does this so one scrape port serves both)."""
        registry.register(_TelemetryCollector(self))

    @property
    def registry(self):
        """A standalone registry exporting only this bus."""
        if self._registry is None:
            from prometheus_client import CollectorRegistry

            self._registry = CollectorRegistry()
            self.register_into(self._registry)
        return self._registry

    # -- black box -----------------------------------------------------

    def escalation(self, session: str, reason: str):
        """Supervisor escalation past WARN: dump the black box for this
        slot (rate-limited inside the recorder). When called on a
        running event loop — supervisors escalate from inside the
        serving loops — the disk write is handed to the default
        executor so a slow disk can't stall every session at the exact
        moment a slot is failing; the synchronous path (tests, worker
        threads) returns the bundle path."""
        rec = self.recorder
        if rec is None:
            if not self.enabled:
                return None
            rec = self._ensure_recorder()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            loop.run_in_executor(None, self._dump_sync, rec, session, reason)
            return None
        return self._dump_sync(rec, session, reason)

    def outlier_dump(self, session: str, reason: str, *,
                     extra_meta: dict | None = None):
        """Latency-outlier black-box capture (monitoring/slo.py): dump
        the rings for a p99-outlier frame even though no supervisor
        escalation happened. Rate-limits under its own per-session
        bucket (``<session>-outlier``) so tail-latency bundles never
        starve — or get starved by — escalation bundles; ``extra_meta``
        tags the breaching frame's correlation id into ``meta.json``.
        Same executor discipline as :meth:`escalation`."""
        rec = self.recorder
        if rec is None:
            if not self.enabled:
                return None
            rec = self._ensure_recorder()
        slot = f"{session}-outlier"
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            loop.run_in_executor(None, self._dump_sync, rec, slot, reason,
                                 extra_meta)
            return None
        return self._dump_sync(rec, slot, reason, extra_meta)

    def _dump_sync(self, rec, session: str, reason: str,
                   extra_meta: dict | None = None):
        path = rec.dump(session, reason, snapshot=self.rollup(),
                        extra_meta=extra_meta)
        if path is not None:
            key = ("selkies_blackbox_dumps_total", (str(session),))
            with self._lock:
                self._counters[key] = self._counters.get(key, 0) + 1
        return path


# the process-global bus every emission site uses
telemetry = Telemetry()


class _TelemetryCollector:
    """prometheus_client custom collector: converts the bus state (and
    the link-bytes provider) into metric families at scrape time — no
    per-event prometheus objects on the hot path."""

    def __init__(self, t: Telemetry):
        self._t = t

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
            HistogramMetricFamily,
        )

        t = self._t
        if not t.enabled:
            return  # off means off: no families, not even provider reads
        with t._lock:
            counters = dict(t._counters)
            gauges = dict(t._gauges)
            hists = {k: (list(v[0]), v[1]) for k, v in t._hists.items()}
        # live link bytes: the provider snapshot IS the counter value
        # ("up_delta" -> direction=up, stage=delta)
        link = t._provider_values().get("link_bytes", {})
        for stage_key, nbytes in link.items():
            direction, _, stage = str(stage_key).partition("_")
            key = ("selkies_link_bytes_total", (direction, stage or "?"))
            counters[key] = counters.get(key, 0) + nbytes

        def group(d: dict) -> dict:
            by_fam: dict[str, list] = {}
            for (family, vals), v in sorted(d.items()):
                by_fam.setdefault(family, []).append((vals, v))
            return by_fam

        for family, rows in group(counters).items():
            f = CounterMetricFamily(
                family, METRIC_FAMILIES.get(family, family),
                labels=_FAMILY_LABELS.get(family, ()))
            for vals, v in rows:
                f.add_metric(list(vals), v)
            yield f
        for family, rows in group(gauges).items():
            f = GaugeMetricFamily(
                family, METRIC_FAMILIES.get(family, family),
                labels=_FAMILY_LABELS.get(family, ()))
            for vals, v in rows:
                f.add_metric(list(vals), v)
            yield f
        for family, rows in group(hists).items():
            f = HistogramMetricFamily(
                family, METRIC_FAMILIES.get(family, family),
                labels=_FAMILY_LABELS.get(family, ()))
            for vals, (bucket_counts, total) in rows:
                # edges resolve per SERIES: selkies_stage_ms stages carry
                # per-stage ladders (sub-ms front-end stages)
                edges = [str(b) for b in _buckets_for(family, vals)] + ["+Inf"]
                cum = list(itertools.accumulate(bucket_counts))
                f.add_metric(list(vals), list(zip(edges, cum)),
                             sum_value=total)
            yield f


_codec_cache: list[str] | None = None


def _supported_codecs() -> list[str]:
    """Codec rows this image can actually serve (negotiate.py probes,
    cached — library availability cannot change mid-process). Part of
    the capacity digest so a router never lands an AV1 client on an
    h264-only host."""
    global _codec_cache
    if _codec_cache is None:
        try:
            from selkies_tpu_torch.signalling.negotiate import (
                CODEC_ROWS, codec_available)

            _codec_cache = sorted(c for c in CODEC_ROWS if codec_available(c))
        except Exception:
            logger.exception("codec availability probe failed; digesting "
                             "h264 only")
            _codec_cache = ["h264"]
    return list(_codec_cache)


# the process-global bus every emission site uses
telemetry = Telemetry()
