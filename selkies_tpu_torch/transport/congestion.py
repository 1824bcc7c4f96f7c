"""Google-Congestion-Control-style bandwidth estimation.

The port's copy of ``selkies_tpu/transport/congestion.py``, on the port's
telemetry bus.

The reference attaches `rtpgccbwe` (gst-plugins-rs) as webrtcbin's aux
sender and drives `set_video_bitrate(estimate, cc=True)` from its
notify::estimated-bitrate signal (gstwebrtc_app.py:1638-1655). This module
is that estimator rebuilt for the framework's transports:

* delay-based control (draft-ietf-rmcat-gcc-02): per-frame one-way delay
  gradients, smoothed, fed to a trendline slope estimator over a sliding
  window; an adaptive-threshold overuse detector drives an AIMD rate
  controller (multiplicative 0.85x decrease to measured throughput on
  overuse; multiplicative-then-additive increase near convergence).
* loss-based control: the classic >10% / <2% rules, fed from client RTC
  stats when the transport reports loss (WS/TCP transports never do —
  their congestion shows up purely as delay, which the trendline sees).

Feedback arrives as `_ack,<seq>,<recv_ms>` data-channel messages (one per
video frame, the frame-granularity analogue of transport-wide-CC
feedback); send times and frame sizes are recorded server-side at send
time, so the client only echoes the sequence number and its local receive
clock (deltas cancel the clock offset).

Everything takes explicit timestamps — no wall-clock reads — so tests
drive synthetic timelines deterministically.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass
from typing import Callable

from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("transport.gcc")

# trendline / detector constants (draft-ietf-rmcat-gcc-02 §5)
_WINDOW = 20              # delay-gradient samples in the regression window
_SMOOTHING = 0.9          # EWMA on accumulated delay
_THRESHOLD_GAIN = 4.0     # slope -> modified trend multiplier
_K_UP = 0.0087            # adaptive threshold gain (overshoot direction)
_K_DOWN = 0.039           # adaptive threshold gain (recovery direction)
_INIT_THRESHOLD_MS = 12.5
_OVERUSE_TIME_MS = 10.0   # sustained overuse before signalling
_BETA = 0.85              # multiplicative decrease factor


@dataclass
class _Sent:
    send_ms: float
    size: int


class TrendlineEstimator:
    """Delay-gradient slope detector: normal / overuse / underuse."""

    def __init__(self) -> None:
        self._samples: deque[tuple[float, float]] = deque(maxlen=_WINDOW)
        self._acc = 0.0
        self._smoothed = 0.0
        self._prev_send: float | None = None
        self._prev_recv: float | None = None
        self._first_recv: float | None = None
        self._threshold = _INIT_THRESHOLD_MS
        self._overuse_start: float | None = None
        self._last_update: float | None = None
        self.state = "normal"

    def add(self, send_ms: float, recv_ms: float) -> str:
        if self._prev_send is not None:
            d = (recv_ms - self._prev_recv) - (send_ms - self._prev_send)
            self._acc += d
            self._smoothed = _SMOOTHING * self._smoothed + (1 - _SMOOTHING) * self._acc
            if self._first_recv is None:
                self._first_recv = recv_ms
            self._samples.append((recv_ms - self._first_recv, self._smoothed))
            self._update_state(recv_ms)
        self._prev_send = send_ms
        self._prev_recv = recv_ms
        return self.state

    def _slope(self) -> float | None:
        if len(self._samples) < _WINDOW // 2:
            return None
        n = len(self._samples)
        mx = sum(t for t, _ in self._samples) / n
        my = sum(y for _, y in self._samples) / n
        num = sum((t - mx) * (y - my) for t, y in self._samples)
        den = sum((t - mx) ** 2 for t, _ in self._samples)
        return num / den if den else None

    def _update_state(self, now_ms: float) -> None:
        slope = self._slope()
        if slope is None:
            return
        # modified trend: scale by window size like the reference impl
        trend = slope * min(len(self._samples), _WINDOW) * _THRESHOLD_GAIN
        if trend > self._threshold:
            if self._overuse_start is None:
                self._overuse_start = now_ms
            elif now_ms - self._overuse_start >= _OVERUSE_TIME_MS:
                self.state = "overuse"
        elif trend < -self._threshold:
            self._overuse_start = None
            self.state = "underuse"
        else:
            self._overuse_start = None
            self.state = "normal"
        # adaptive threshold (§5.5): track |trend| so persistent queues
        # don't starve us, recover fast when the network clears
        if abs(trend) < self._threshold + 15.0:  # ignore wild outliers
            # k is positive both ways (§5.5): (|trend| - threshold) sets the
            # direction, k only sets how fast each direction adapts
            k = _K_UP if abs(trend) > self._threshold else _K_DOWN
            dt = 0.0 if self._last_update is None else min(now_ms - self._last_update, 100.0)
            self._threshold += k * (abs(trend) - self._threshold) * dt / 25.0
            self._threshold = max(6.0, min(self._threshold, 600.0))
        self._last_update = now_ms


class GccController:
    """Full estimator: feedback in, bitrate-estimate callback out.

    on_estimate(kbps) fires whenever the target changes by >=5% (or on
    every decrease) — the consumer wires it to
    TPUWebRTCApp.set_video_bitrate(kbps, cc=True).
    """

    def __init__(
        self,
        start_kbps: int = 2000,
        min_kbps: int = 100,
        max_kbps: int = 20000,
        on_estimate: Callable[[int], None] | None = None,
        session: str = "0",
    ) -> None:
        # telemetry label: bitrate flaps must be attributable to the
        # session whose link caused them (fleet passes its slot index)
        self.session = str(session)
        self.max_kbps = max_kbps
        self.min_kbps = min(min_kbps, max_kbps)
        self._floor = self.min_kbps  # audio-headroom floor; survives retargets
        self.estimate_kbps = float(start_kbps)
        self.on_estimate = on_estimate or (lambda kbps: None)
        self._trend = TrendlineEstimator()
        self._sent: dict[int, _Sent] = {}
        # (recv_ms, bytes); maxlen backstops the time-window prune below —
        # hostile TWCC whose receive clock never advances would otherwise
        # grow this forever (one entry per acked packet). 4096 >> the ~300
        # entries a real 1 s window holds at 300 pps.
        self._recv_window: deque[tuple[float, int]] = deque(maxlen=4096)
        self._last_decrease_throughput: float | None = None
        self._last_increase_ms: float | None = None
        self._last_reported = float(start_kbps)
        self.last_loss = 0.0  # policy-engine congestion signal

    def reset(self) -> None:
        """New client connection: the receive clock epoch changed
        (performance.now() restarts on reload), so all delay state and the
        in-flight ledger are garbage. Keeps the current estimate — the
        network likely didn't change, only the client did."""
        self._trend = TrendlineEstimator()
        self._sent.clear()
        self._recv_window.clear()
        self._last_decrease_throughput = None
        self._last_increase_ms = None

    def set_target(self, kbps: int) -> None:
        """User-chosen bitrate (UI 'vb' message): retarget the cap and
        restart the probe from it — GCC will cut back within a few frames
        if the link can't actually carry it. The audio-headroom floor set
        at construction is preserved whenever the cap allows it."""
        self.max_kbps = int(kbps)
        self.min_kbps = min(self._floor, self.max_kbps)
        self.estimate_kbps = float(kbps)
        self._last_reported = float(kbps)
        if telemetry.enabled:
            telemetry.gauge("selkies_congestion_target_kbps", float(kbps),
                            session=self.session)
            telemetry.count("selkies_congestion_events_total",
                            session=self.session, event="retarget")

    # -- send side -----------------------------------------------------

    def on_frame_sent(self, seq: int, send_ms: float, size: int) -> None:
        self._sent[seq] = _Sent(send_ms, size)
        if len(self._sent) > 4096:  # acks lost / client gone: bound memory
            # evict by send time, not seq: seq is a 16-bit wrapping counter,
            # so numeric order would evict the newest entries after wrap
            stale = sorted(self._sent, key=lambda k: self._sent[k].send_ms)
            for k in stale[: len(self._sent) - 2048]:
                del self._sent[k]

    # -- feedback ------------------------------------------------------

    def on_frame_ack(self, seq: int, recv_ms: float) -> None:
        sent = self._sent.pop(seq, None)
        if sent is None:
            return
        if telemetry.enabled:
            # closes the frame's timeline (fid resolved from the seq the
            # transport registered at send time)
            telemetry.ack(self.session, seq, recv_ms)
        self._recv_window.append((recv_ms, sent.size))
        while self._recv_window and recv_ms - self._recv_window[0][0] > 1000.0:
            self._recv_window.popleft()
        state = self._trend.add(sent.send_ms, recv_ms)
        self._apply_state(state, recv_ms)

    def on_loss_report(self, fraction_lost: float) -> None:
        """Loss-based bound (only meaningful on lossy transports)."""
        # last-reported loss fraction: the scenario policy engine reads
        # it to tell a link bottleneck from an encoder one
        self.last_loss = float(fraction_lost)
        if telemetry.enabled:
            telemetry.gauge("selkies_congestion_loss_ratio", fraction_lost,
                            session=self.session)
            telemetry.count("selkies_congestion_events_total",
                            session=self.session, event="loss_report")
        if fraction_lost > 0.10:
            self._set(self.estimate_kbps * (1.0 - 0.5 * fraction_lost))
        elif fraction_lost < 0.02:
            self._set(self.estimate_kbps * 1.02)

    # -- rate control --------------------------------------------------

    def _measured_kbps(self) -> float | None:
        if len(self._recv_window) < 2:
            return None
        span = self._recv_window[-1][0] - self._recv_window[0][0]
        if span <= 0:
            return None
        total = sum(b for _, b in self._recv_window)
        return total * 8.0 / span  # bytes / ms -> kbps

    def _apply_state(self, state: str, now_ms: float) -> None:
        measured = self._measured_kbps()
        if state == "overuse":
            target = measured * _BETA if measured is not None else self.estimate_kbps * _BETA
            if target < self.estimate_kbps:
                self._last_decrease_throughput = measured
                self._set(target)
            self._last_increase_ms = now_ms
        elif state == "normal":
            dt = 0.0 if self._last_increase_ms is None else now_ms - self._last_increase_ms
            self._last_increase_ms = now_ms
            if dt <= 0 or dt > 1000.0:
                return
            near = (
                self._last_decrease_throughput is not None
                and abs(self.estimate_kbps - self._last_decrease_throughput)
                < 0.5 * self._last_decrease_throughput
            )
            if near:
                # additive: ~ one mtu per rtt (assume 100 ms rtt bound)
                self._set(self.estimate_kbps + 9.6 * dt / 100.0)
            else:
                self._set(self.estimate_kbps * (1.0 + 0.08 * dt / 1000.0))
        # underuse: hold (the queues are draining; wait for normal)

    def _set(self, kbps: float) -> None:
        kbps = max(float(self.min_kbps), min(float(kbps), float(self.max_kbps)))
        decreased = kbps < self.estimate_kbps
        self.estimate_kbps = kbps
        if decreased or abs(kbps - self._last_reported) >= 0.05 * self._last_reported:
            self._last_reported = kbps
            if telemetry.enabled:
                telemetry.gauge("selkies_congestion_target_kbps", kbps,
                                session=self.session)
                telemetry.count("selkies_congestion_events_total",
                                session=self.session,
                                event="decrease" if decreased else "increase")
            self.on_estimate(int(round(kbps)))
