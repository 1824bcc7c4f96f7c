"""Workload classification: per-frame signals -> scenario class.

The port's copy of ``selkies_tpu/policy/classifier.py``, unchanged.

Two layers, both deterministic and cheap enough to run on every frame:

* :func:`categorize_frame` maps ONE frame's signals to a category —
  ``static`` (byte-identical capture), ``tiny`` (a few dirty tiles:
  keystrokes, cursor), ``remap`` (a dirty region mostly served by
  tile-cache remaps: scroll / window drag), ``busy`` (a large dirty
  region of genuinely new pixels), ``full`` (full-frame upload).
* :func:`classify_window` folds a rolling window of categories into a
  :class:`Scenario` using the threshold table documented in
  docs/policy.md. A window that matches nothing (or is still filling)
  returns ``UNKNOWN`` — the engine then keeps the current scenario
  rather than guessing.

The thresholds are fixed constants on purpose: the engine's hysteresis
(confirmation streak) and dwell do the anti-flap work, so the
classifier itself can stay a pure, unit-testable function of the
window (tests/test_policy.py replays recorded signal traces per
scenario against it).
"""

from __future__ import annotations

import enum
from collections import deque

__all__ = ["Scenario", "SignalWindow", "categorize_frame", "classify_window"]


class Scenario(str, enum.Enum):
    """Workload classes the engine can steer for. Values are the
    telemetry label vocabulary (selkies_policy_scenario)."""

    UNKNOWN = "unknown"
    IDLE = "idle"
    TYPING = "typing"
    SCROLL = "scroll"
    DRAG = "drag"
    VIDEO = "video"
    GAME = "game"


_CATEGORIES = ("static", "tiny", "remap", "busy", "full", "other")

# per-frame category thresholds
TINY_DIRTY_FRAC = 0.02     # <=2% of tiles dirty: keystroke/cursor scale
REMAP_FRAC = 0.5           # >=half the dirty tiles served as remaps
# skip-fraction fallback for encoder rows without upload attribution
# (banded/fleet/software): derive the category from how much of the
# frame the encoder skipped
SKIP_STATIC = 0.995
SKIP_TINY = 0.97
SKIP_FULL = 0.40

# window-level scenario thresholds (docs/policy.md)
MIN_FRAMES = 16            # window must be at least this full to classify
GAME_FULL_FRAC = 0.85      # nearly every frame a full-frame change
GAME_STATIC_MAX = 0.05
VIDEO_ACTIVE_FRAC = 0.40   # sustained full/busy frames (30in60 playback)
REMAP_WINDOW_FRAC = 0.35   # scroll/drag: remap-dominated deltas
SCROLL_DIRTY_FRAC = 0.08   # scroll moves a big region; drag a window edge
TYPING_DELTA_FRAC = 0.08   # some small deltas...
TYPING_DELTA_MAX = 0.45    # ...but mostly static (video alternates 50/50)
TYPING_FULL_MAX = 0.02
TYPING_DIRTY_MAX = 0.10    # a text line is small even on a small screen
IDLE_STATIC_FRAC = 0.90


def categorize_frame(upload_kind: str = "", dirty_frac: float = 0.0,
                     remap_frac: float = 0.0,
                     skip_frac: float | None = None) -> str:
    """One frame's signals -> category. ``upload_kind`` is the encoder's
    own classification (models/stats.FrameStats.upload_kind); rows that
    don't attribute uploads fall back to the skip fraction."""
    if upload_kind == "static":
        return "static"
    if upload_kind == "full":
        return "full"
    if upload_kind == "delta":
        if remap_frac >= REMAP_FRAC:
            return "remap"
        if dirty_frac <= TINY_DIRTY_FRAC:
            return "tiny"
        return "busy"
    if skip_frac is None:
        return "other"
    if skip_frac >= SKIP_STATIC:
        return "static"
    if skip_frac >= SKIP_TINY:
        return "tiny"
    if skip_frac <= SKIP_FULL:
        return "full"
    return "busy"


class SignalWindow:
    """Rolling per-frame category window with O(1) fraction reads.

    Also tracks the mean dirty fraction of the remap-category frames
    (the scroll-vs-drag discriminator) and capture-interval jitter."""

    def __init__(self, size: int = 48):
        self.size = int(size)
        self._frames: deque = deque(maxlen=self.size)
        self._counts = dict.fromkeys(_CATEGORIES, 0)
        self._dirty_sum = dict.fromkeys(_CATEGORIES, 0.0)
        self._intervals: deque = deque(maxlen=self.size)

    def push(self, category: str, dirty_frac: float = 0.0,
             interval_ms: float = 0.0) -> None:
        if category not in self._counts:
            category = "other"
        if len(self._frames) == self.size:
            old_cat, old_dirty = self._frames[0]
            self._counts[old_cat] -= 1
            self._dirty_sum[old_cat] -= old_dirty
        self._frames.append((category, float(dirty_frac)))
        self._counts[category] += 1
        self._dirty_sum[category] += float(dirty_frac)
        if interval_ms > 0:
            self._intervals.append(float(interval_ms))

    def clear(self) -> None:
        self._frames.clear()
        self._intervals.clear()
        self._counts = dict.fromkeys(_CATEGORIES, 0)
        self._dirty_sum = dict.fromkeys(_CATEGORIES, 0.0)

    @property
    def n(self) -> int:
        return len(self._frames)

    def fraction(self, *categories: str) -> float:
        if not self._frames:
            return 0.0
        return sum(self._counts[c] for c in categories) / len(self._frames)

    def mean_dirty(self, *categories: str) -> float:
        n = sum(self._counts[c] for c in categories)
        if not n:
            return 0.0
        return sum(self._dirty_sum[c] for c in categories) / n

    def jitter_ms(self) -> float:
        """Mean absolute deviation of the capture interval — a spiky
        interval during a nominally idle window is a scheduling signal,
        not a content one, so it rides along for /statz rather than
        driving the classifier."""
        iv = self._intervals
        if len(iv) < 2:
            return 0.0
        mean = sum(iv) / len(iv)
        return sum(abs(x - mean) for x in iv) / len(iv)

    def stats(self) -> dict:
        return {
            "n": self.n,
            "fractions": {c: round(self.fraction(c), 3)
                          for c in _CATEGORIES if self._counts[c]},
            "mean_dirty": round(self.mean_dirty("tiny", "remap", "busy"), 4),
            "jitter_ms": round(self.jitter_ms(), 2),
        }


def classify_window(win: SignalWindow,
                    min_frames: int = MIN_FRAMES) -> Scenario:
    """Window -> scenario, per the threshold table in docs/policy.md.
    Rules are ordered most- to least-specific; the first match wins."""
    if win.n < min_frames:
        return Scenario.UNKNOWN
    static = win.fraction("static")
    full = win.fraction("full")
    active = full + win.fraction("busy")
    remap = win.fraction("remap")
    tiny = win.fraction("tiny")
    if full >= GAME_FULL_FRAC and static <= GAME_STATIC_MAX:
        return Scenario.GAME
    if active >= VIDEO_ACTIVE_FRAC:
        return Scenario.VIDEO
    if remap >= REMAP_WINDOW_FRAC:
        return (Scenario.SCROLL
                if win.mean_dirty("remap") >= SCROLL_DIRTY_FRAC
                else Scenario.DRAG)
    # typing: intermittent SMALL deltas on an otherwise static screen.
    # "small" is judged by the mean dirty fraction, not the tiny/busy
    # category split — one text line is 7% of a small screen but still
    # typing; video playback fails the delta-fraction ceiling (its
    # updates alternate at ~50%) and the dirty bound (a playback region
    # dirties far more than a text line)
    deltas = tiny + win.fraction("busy")
    if (deltas >= TYPING_DELTA_FRAC and deltas <= TYPING_DELTA_MAX
            and full <= TYPING_FULL_MAX
            and win.mean_dirty("tiny", "busy") <= TYPING_DIRTY_MAX):
        return Scenario.TYPING
    if static >= IDLE_STATIC_FRAC:
        return Scenario.IDLE
    return Scenario.UNKNOWN
