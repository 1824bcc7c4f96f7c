"""Named presets: scenario -> knob plan matrices.

The port's copy of ``selkies_tpu/policy/presets.py``.

A :class:`KnobPlan` is an ABSOLUTE target, not a delta: a field left
``None`` means "the encoder's constructed default", and the actuator
merges the plan over the defaults it captured at attach time — so any
transition sequence lands in the same state as jumping straight to the
final scenario (no knob can leak from a previous scenario).

The matrices follow the measured trade-offs of the earlier PRs
(docs/policy.md has the full table with the why per cell):

* interactive scenarios (idle/typing) cap grouped dispatch at 1 —
  grouping trades up to ``frame_batch - 1`` capture intervals of
  latency for fewer link round trips (PERF.md), exactly the wrong
  trade while someone is typing;
* scroll/drag keep the tile cache hot (its 4x / 384x uplink cuts)
  and run a half group — enough batching to amortize round trips
  without a full group's latency;
* full-motion scenarios (video/game) turn the tile cache OFF (content
  never repeats, so the hash probe is pure cost), run full groups and a
  periodic-IDR GOP posture for mid-stream join/recovery; video
  additionally LOWERS the device-entropy bits threshold so moderate
  delta frames ship final slice bits where the backend's AUTO default
  has the device coder enabled (the on-device decision still
  requires the bits to fit the payload cap, so this can never force
  the dense-fallback path). The entropy MODE itself stays at the
  backend AUTO default — the scenario bench measured that forcing it
  on a CPU backend regresses both fps and downlink bytes (the "device"
  coder shares the host's cores and a busy full-P's fixed bits prefix
  can exceed the hint-sized coefficient fetch). The entropy CODER
  (cavlc/cabac) follows the same negative-result discipline:
  no preset pins it — it stays at the backend AUTO resolution
  (device_cavlc.entropy_coder_default: cavlc on this port),
  because forcing the CABAC token pass onto a CPU backend is exactly
  the "device work on host cores" regression measured above, and the
  coder is PPS-scoped so a mid-stream scenario flip could not retune
  it without an IDR anyway.

``latency`` forces batch cap 1 everywhere; ``throughput`` forces full
groups everywhere; ``balanced`` is the per-scenario matrix above.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from selkies_tpu_torch.monitoring.slo import SLOTargets
from selkies_tpu_torch.policy.classifier import Scenario

__all__ = ["KnobPlan", "PRESETS", "SLO_TARGETS", "plan_for"]

# batch_cap vocabulary: only ALREADY-COMPILED scan sizes are reachable
# (1 / frame_batch//2 / frame_batch — encoder.set_batch_cap snaps), so a
# plan can never trigger a new group-scan compile
BATCH_MIN = "min"
BATCH_HALF = "half"
BATCH_MAX = "max"

# full-motion GOP posture: one IDR every N frames (~10 s at 60 fps) so a
# recovering or late-joining decoder has a bounded wait; interactive
# scenarios keep the infinite GOP (IDRs only on PLI / restart)
FULL_MOTION_GOP = 600


@dataclass(frozen=True)
class KnobPlan:
    """Absolute knob targets for one scenario. None = constructed
    default (the actuator merges over its captured defaults)."""

    scenario: str
    tile_cache: bool | None = None
    batch_cap: str | None = None          # BATCH_MIN | BATCH_HALF | BATCH_MAX
    device_entropy: bool | None = None
    bits_min_mbs: int | None = None
    keyframe_interval: int | None = None

    def merged_over(self, defaults: "KnobPlan") -> "KnobPlan":
        """Fill this plan's None fields from the captured defaults."""
        return KnobPlan(
            scenario=self.scenario,
            tile_cache=(self.tile_cache if self.tile_cache is not None
                        else defaults.tile_cache),
            batch_cap=(self.batch_cap if self.batch_cap is not None
                       else defaults.batch_cap),
            device_entropy=(self.device_entropy
                            if self.device_entropy is not None
                            else defaults.device_entropy),
            bits_min_mbs=(self.bits_min_mbs if self.bits_min_mbs is not None
                          else defaults.bits_min_mbs),
            keyframe_interval=(self.keyframe_interval
                               if self.keyframe_interval is not None
                               else defaults.keyframe_interval),
        )


_BALANCED: dict[Scenario, KnobPlan] = {
    Scenario.UNKNOWN: KnobPlan("unknown"),
    Scenario.IDLE: KnobPlan("idle", tile_cache=True, batch_cap=BATCH_MIN),
    Scenario.TYPING: KnobPlan("typing", tile_cache=True, batch_cap=BATCH_MIN),
    Scenario.SCROLL: KnobPlan("scroll", tile_cache=True,
                              batch_cap=BATCH_HALF),
    Scenario.DRAG: KnobPlan("drag", tile_cache=True, batch_cap=BATCH_HALF),
    Scenario.VIDEO: KnobPlan("video", tile_cache=False, batch_cap=BATCH_MAX,
                             bits_min_mbs=256,
                             keyframe_interval=FULL_MOTION_GOP),
    Scenario.GAME: KnobPlan("game", tile_cache=False, batch_cap=BATCH_MAX,
                            keyframe_interval=FULL_MOTION_GOP),
}


def _with_batch(matrix: dict, cap: str) -> dict:
    return {s: replace(p, batch_cap=(cap if p.scenario != "unknown" else None))
            for s, p in matrix.items()}


PRESETS: dict[str, dict[Scenario, KnobPlan]] = {
    "balanced": _BALANCED,
    # latency: never wait for a group — every scenario dispatches singles
    "latency": _with_batch(_BALANCED, BATCH_MIN),
    # throughput: always fill full groups (relay-priced links where round
    # trips dominate and added frames of latency are acceptable)
    "throughput": _with_batch(_BALANCED, BATCH_MAX),
}


def plan_for(preset: str, scenario: Scenario) -> KnobPlan:
    matrix = PRESETS.get(preset) or PRESETS["balanced"]
    return matrix.get(scenario) or matrix[Scenario.UNKNOWN]


# -- serving SLO objectives per scenario class (monitoring/slo.py) ----------
#
# The objectives live HERE, next to the knob matrices, because they are
# the same kind of product statement: what this scenario's session
# promises its user. The latency ceilings follow the scenario bench's
# measured interaction classes (docs/slo.md has
# the full table with the why per row):
#
# * interactive rows (idle/typing) promise keystroke-class p50 — a
#   typed character must render within ~2 capture ticks at 60 fps;
# * scroll/drag tolerate a longer pipeline (content momentum hides
#   ~100 ms) but promise a 20 fps floor — below that a drag visibly
#   stutters;
# * full-motion rows (video/game) judge by throughput + sustained
#   latency, with the downlink budget doing the real work: a video
#   session stuck on coefficient rows (device-entropy misconfigured)
#   blows a 25 Mbit/s budget long before any latency ceiling trips;
# * unknown (no classification yet, or policy off) is deliberately
#   loose: objectives tighten only once the workload is known, so an
#   unclassified session never pages on a scenario it isn't in.
#
# The quality floors (psnr_floor_db, docs/quality.md) come from the
# committed rate/quality record BENCH_quality_r02.json (tpuh264enc at
# 512x288 through the QP 24-36 ladder, cv2 decode oracle): each floor
# sits ~2-3 dB under the scenario's measured QP-36 rung — the worst
# quality the encoder ships on purpose — so the objective burns on
# genuine degradation (RC pinned at max QP under a starved budget),
# not on the ladder's normal bottom. Measured qp24->qp36 spans:
# typing 45.5->33.0 dB, scroll 32.6->26.3, drag 31.4->24.8, video
# 35.1->28.9, game 27.8->22.5; idle is near-static (48-90 dB, skips
# dominate) so its floor is far below anything the probe ever scores.
# unknown keeps floor 0 = objective unarmed until classified.
SLO_TARGETS: dict[Scenario, SLOTargets] = {
    Scenario.UNKNOWN: SLOTargets(p50_ms=250.0, p95_ms=600.0,
                                 fps_floor=5.0, down_kbps=0.0),
    Scenario.IDLE: SLOTargets(p50_ms=50.0, p95_ms=150.0,
                              fps_floor=10.0, down_kbps=2_000.0,
                              psnr_floor_db=40.0),
    Scenario.TYPING: SLOTargets(p50_ms=35.0, p95_ms=100.0,
                                fps_floor=20.0, down_kbps=3_000.0,
                                psnr_floor_db=30.0),
    Scenario.SCROLL: SLOTargets(p50_ms=100.0, p95_ms=250.0,
                                fps_floor=20.0, down_kbps=15_000.0,
                                psnr_floor_db=24.0),
    Scenario.DRAG: SLOTargets(p50_ms=100.0, p95_ms=250.0,
                              fps_floor=20.0, down_kbps=10_000.0,
                              psnr_floor_db=22.0),
    Scenario.VIDEO: SLOTargets(p50_ms=150.0, p95_ms=400.0,
                               fps_floor=24.0, down_kbps=25_000.0,
                               psnr_floor_db=26.0),
    Scenario.GAME: SLOTargets(p50_ms=150.0, p95_ms=400.0,
                              fps_floor=24.0, down_kbps=30_000.0,
                              psnr_floor_db=20.0),
}
