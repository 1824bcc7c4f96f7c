"""CBR rate control: bitrate target (kbps) → per-frame QP.

The port's copy of ``selkies_tpu/models/h264/ratecontrol.py``, unchanged.

Parity target: the reference's encoder-side rate control properties — CBR
mode, VBV buffer ≈ 1.5 frame-times, zero-latency tuning (gstwebrtc_app.py
:100-105 vbv computation, :1296-1412 set_video_bitrate) — re-implemented
as an explicit controller because the device encoder exposes QP, not a rate
knob. The GCC congestion-control estimate feeds set_bitrate() exactly like
rtpgccbwe's notify::estimated-bitrate drives set_video_bitrate(cc=True)
(gstwebrtc_app.py:1638-1655).

Model: leaky-bucket VBV. Each frame drains target_bits/fps; the encoded
frame fills its actual size. QP steps to keep fullness near the midpoint,
with a proportional term on the error and a fast-attack clamp when a frame
overshoots the whole buffer (scene change with intra-only streams).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CbrRateController:
    bitrate_kbps: int
    fps: float
    vbv_frames: float = 1.5
    min_qp: int = 10
    max_qp: int = 51
    qp: int = 30
    # a keyframe (IDR or scene-cut P) legitimately spends several frame
    # budgets; the allowance forgives overshoot up to this many frames —
    # and ONLY overshoot, so a cheap keyframe is accounted like any
    # other frame instead of wiping accumulated VBV debt
    keyframe_budget_frames: float = 8.0
    _fullness: float = field(default=0.0, init=False)

    @property
    def frame_budget_bits(self) -> float:
        return self.bitrate_kbps * 1000.0 / self.fps

    @property
    def vbv_size_bits(self) -> float:
        return self.frame_budget_bits * self.vbv_frames

    @property
    def fullness(self) -> float:
        """VBV fullness normalized to the buffer size — the exported RC
        state (telemetry's selkies_rc_fullness): 0 is neutral, 1.0 one
        full VBV of accumulated debt, clamped to [-1, 4] by update()."""
        return self._fullness / max(self.vbv_size_bits, 1.0)

    def set_bitrate(self, bitrate_kbps: int) -> None:
        """Live retune (UI 'vb' message or GCC estimate)."""
        if bitrate_kbps <= 0:
            raise ValueError("bitrate must be positive")
        self.bitrate_kbps = int(bitrate_kbps)

    def set_framerate(self, fps: float) -> None:
        if fps <= 0:
            raise ValueError("fps must be positive")
        self.fps = float(fps)

    def frame_qp(self) -> int:
        """QP to use for the next frame."""
        return self.qp

    def update(self, frame_bytes: int, idr: bool = False) -> int:
        """Account an encoded frame; returns the QP for the next frame.
        `idr` covers any keyframe-sized event: IDRs and scene-cut P
        frames both receive the overshoot allowance."""
        bits = frame_bytes * 8.0
        budget = self.frame_budget_bits
        if idr:
            # forgive overshoot up to the keyframe allowance; never
            # reward a cheap keyframe (min against actual bits)
            budget = max(budget, min(bits, self.keyframe_budget_frames * budget))
        self._fullness += bits - budget
        self._fullness = max(-self.vbv_size_bits, min(self._fullness, 4 * self.vbv_size_bits))

        ratio = bits / max(budget, 1.0)
        # proportional step on the instantaneous error
        if ratio > 4.0:
            step = 4
        elif ratio > 2.0:
            step = 2
        elif ratio > 1.15:
            step = 1
        elif ratio < 0.25:
            step = -3
        elif ratio < 0.5:
            step = -2
        elif ratio < 0.85:
            step = -1
        else:
            step = 0
        # integral correction from buffer fullness
        if self._fullness > self.vbv_size_bits:
            step = max(step, 1) + 1
        elif self._fullness > 0.5 * self.vbv_size_bits:
            step = max(step, 1)
        elif self._fullness < -0.5 * self.vbv_size_bits and step >= 0:
            step -= 1
        self.qp = max(self.min_qp, min(self.max_qp, self.qp + step))
        return self.qp
