"""Prometheus metrics + WebRTC client-stats CSV recorder.

The port's copy of ``selkies_tpu/monitoring/metrics.py``, on the port's
telemetry bus.

Parity target: reference metrics.py — gauges ``fps`` / ``gpu_utilization``
/ ``latency``, histogram ``fps_hist`` (buckets 0/20/40/60), Info
``webrtc_statistics``, an HTTP exporter, and per-connection CSV dumps of
the client's RTCStats uploads (``_stats_video`` / ``_stats_audio``).

The CSV writer handles the same dynamic-schema problem (browsers add stat
fields mid-session) with a simpler mechanism than the reference's in-place
column splicing: each file keeps an in-memory column union + a BOUNDED row
cache and is rewritten from that cache when the schema grows, so columns
never misalign.

When telemetry is enabled (SELKIES_TELEMETRY=1), the frame-correlated
telemetry bus (telemetry.py) folds its metric families into this scrape
registry, so the one metrics HTTP port serves both the parity gauges and
the expanded production families (docs/observability.md).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from collections import OrderedDict, deque
from datetime import datetime

from prometheus_client import CollectorRegistry, Gauge, Histogram, Info, start_http_server

from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("metrics")

FPS_HIST_BUCKETS = (0, 20, 40, 60)
MIN_STAT_FIELDS = 14  # discard truncated reconnect bursts (reference :119)

# rows kept in memory per CSV for schema-growth rewrites; at the client's
# 100 ms stats cadence this is ~1 minute of history. A browser adds stat
# fields in the first seconds of a connection, so rewrites past the cap
# (which keep only the cached tail) are a non-event in practice — the
# old behaviour cached EVERY row forever and rewrote the whole file,
# unbounded memory on a long-lived session.
CSV_CACHE_ROWS = 512


class _CsvLog:
    """One stats CSV with a growable column set and a bounded row cache."""

    def __init__(self, path: str, cache_rows: int = CSV_CACHE_ROWS):
        self.path = path
        self.columns: list[str] = ["timestamp"]
        self.rows: deque[dict[str, str]] = deque(maxlen=cache_rows)

    def append(self, stats: "OrderedDict[str, str]") -> None:
        if len(stats) < MIN_STAT_FIELDS:
            return
        row = {"timestamp": datetime.now().strftime("%d/%B/%Y:%H:%M:%S")}
        row.update(stats)
        new_cols = [k for k in row if k not in self.columns]
        self.rows.append(row)
        if new_cols:
            self.columns.extend(new_cols)
            self._rewrite()
        else:
            self._append_row(row)

    def _fmt(self, row: dict[str, str]) -> str:
        import csv
        import io

        buf = io.StringIO()
        csv.writer(buf, quotechar='"').writerow(
            [row.get(c, "NaN") for c in self.columns]
        )
        return buf.getvalue()

    def _append_row(self, row: dict[str, str]) -> None:
        new_file = not os.path.exists(self.path)
        with open(self.path, "a") as f:
            if new_file:
                import csv

                csv.writer(f).writerow(self.columns)
            f.write(self._fmt(row))

    def _rewrite(self) -> None:
        """Schema grew: rewrite header + the cached row tail. Rows older
        than the cache are dropped from the file — bounded memory beats
        perfect backfill for a diagnostics CSV."""
        import csv

        with open(self.path, "w") as f:
            w = csv.writer(f, quotechar='"')
            w.writerow(self.columns)
            for row in self.rows:
                w.writerow([row.get(c, "NaN") for c in self.columns])


class Metrics:
    def __init__(self, port: int = 8000, using_webrtc_csv: bool = False,
                 registry: CollectorRegistry | None = None):
        self.port = port
        # per-instance registry: multiple Metrics (tests, multi-session
        # hosts) must not collide in the process-global default registry
        self.registry = registry or CollectorRegistry()
        # expanded families (stage histograms, tile-cache/supervisor/
        # congestion counters, live link bytes) fold into the same scrape
        # endpoint as the parity gauges. Registered unconditionally: the
        # collector emits nothing while telemetry is disabled, and this
        # keeps a runtime telemetry.enable() exporting without caring
        # whether Metrics was built first
        telemetry.register_into(self.registry)
        self.fps = Gauge("fps", "Frames per second observed by client", registry=self.registry)
        self.fps_hist = Histogram(
            "fps_hist", "Histogram of FPS observed by client",
            buckets=FPS_HIST_BUCKETS, registry=self.registry,
        )
        self.gpu_utilization = Gauge(
            "gpu_utilization", "Utilization percentage reported by the accelerator",
            registry=self.registry,
        )
        self.latency = Gauge("latency", "Latency observed by client", registry=self.registry)
        self.webrtc_statistics = Info(
            "webrtc_statistics", "WebRTC Statistics from the client", registry=self.registry
        )
        self.using_webrtc_csv = using_webrtc_csv
        self._video_log: _CsvLog | None = None
        self._audio_log: _CsvLog | None = None
        self._session_fps: Gauge | None = None
        self._session_latency: Gauge | None = None

    def session_setters(self, session: int):
        """(set_fps, set_latency) for one fleet session, exported as
        ``session_fps{session=k}`` / ``session_latency{session=k}`` —
        scalar last-writer-wins gauges would lose the per-session signal
        on a multi-session host. The aggregate fps histogram still
        observes every sample."""
        if self._session_fps is None:
            self._session_fps = Gauge(
                "session_fps", "Client-observed fps per fleet session",
                ["session"], registry=self.registry)
            self._session_latency = Gauge(
                "session_latency", "Client latency (ms) per fleet session",
                ["session"], registry=self.registry)
        fps_g = self._session_fps.labels(session=str(session))
        lat_g = self._session_latency.labels(session=str(session))

        def set_fps(fps: float) -> None:
            fps_g.set(fps)
            self.fps_hist.observe(fps)

        return set_fps, lat_g.set

    # -- setters -------------------------------------------------------

    def set_fps(self, fps: float) -> None:
        self.fps.set(fps)
        self.fps_hist.observe(fps)

    def set_gpu_utilization(self, utilization: float) -> None:
        self.gpu_utilization.set(utilization)

    # TPU twin: same gauge, the client/dashboards read one utilization series
    set_tpu_utilization = set_gpu_utilization

    def set_latency(self, latency_ms: float) -> None:
        self.latency.set(latency_ms)

    # -- http exporter -------------------------------------------------

    async def start_http(self) -> None:
        await asyncio.to_thread(start_http_server, self.port, registry=self.registry)

    # -- webrtc stats --------------------------------------------------

    def initialize_webrtc_csv_file(self, webrtc_stats_dir: str = "/tmp") -> None:
        ts = datetime.now().strftime("%Y-%m-%d:%H:%M:%S")
        self._video_log = _CsvLog(os.path.join(webrtc_stats_dir, f"selkies-stats-video-{ts}.csv"))
        self._audio_log = _CsvLog(os.path.join(webrtc_stats_dir, f"selkies-stats-audio-{ts}.csv"))

    @property
    def stats_video_file_path(self) -> str | None:
        return self._video_log.path if self._video_log else None

    @property
    def stats_audio_file_path(self) -> str | None:
        return self._audio_log.path if self._audio_log else None

    @staticmethod
    def sanitize_json_stats(obj_list: list[dict]) -> "OrderedDict[str, str]":
        """Flatten a getStats() report list into reportType.field keys,
        suffixing duplicate report types with their id."""
        seen: set[str] = set()
        flat: OrderedDict[str, str] = OrderedDict()
        for report in obj_list:
            rtype = report.get("type")
            key = rtype
            if rtype in seen:
                key = f"{rtype}-{report.get('id')}"
            seen.add(rtype)
            for field, value in report.items():
                flat[f"{key}.{field}"] = value if isinstance(value, str) else str(value)
        return flat

    async def set_webrtc_stats(self, webrtc_stat_type: str, webrtc_stats: str) -> None:
        obj_list = await asyncio.to_thread(json.loads, webrtc_stats)
        flat = self.sanitize_json_stats(obj_list)
        if self.using_webrtc_csv:
            log = self._audio_log if webrtc_stat_type == "_stats_audio" else self._video_log
            if log is not None:
                await asyncio.to_thread(log.append, flat)
        await asyncio.to_thread(self.webrtc_statistics.info, flat)
