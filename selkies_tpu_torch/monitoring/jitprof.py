"""Recompile sentinel: count, time, and attribute executable builds.

The port's copy of ``selkies_tpu/monitoring/jitprof.py``. ``CompileSentinel``,
``mark``, ``scope``, ``stats``, the storm rule and the telemetry families
(``selkies_compile_total`` / ``selkies_compile_ms`` /
``selkies_compile_storms_total``) are JAX's. What feeds it differs: JAX
listens to ``jax.monitoring``'s backend-compile events, one per XLA
executable built. The port compiles nothing per geometry or per knob; its
only executable builds are the first-use ``nvcc`` / ``g++`` builds of
``selkies_tpu_torch/utils/build.py``, which report each build's duration
(:data:`COMPILE_EVENT`) and each reuse of a library already built
(:data:`CACHE_HIT_EVENT`) through :func:`report_duration` /
:func:`report_event` to the active sentinel.

So a rebuild site marks as in JAX (``TorchH264Encoder.retune_entropy``
marks ``actuation`` / ``entropy-coder-switch`` on a coder change and
``actuation`` / ``entropy-retune`` when the delta steps' entropy consts
change), but the retune builds nothing: the mark attributes no compile.
A build observed within ``mark_ttl_s`` of a mark belongs to it; builds in
the first ``startup_grace_s`` are ``startup``; anything else is
``unattributed``. :meth:`CompileSentinel.scope` attributes the builds of
one thread exactly (``prewarm``). ``storm_n`` builds inside
``storm_window_s`` flag a storm: an error log, a
``selkies_compile_storms_total`` count and a ``compile_storm`` ring event.

Nothing is observed until :func:`install` makes a sentinel active;
``mark()`` on an uninstalled sentinel is a cheap bookkeeping write.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable

from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("jitprof")

__all__ = ["CompileSentinel", "sentinel", "install", "uninstall",
           "mark", "scope", "stats", "report_duration", "report_event",
           "COMPILE_EVENT", "CACHE_HIT_EVENT"]

# the one duration event that means "an executable was built": a library
# compiled by utils/build.py (a miss of its source-hashed build cache)
COMPILE_EVENT = "/selkies_tpu_torch/build/compile_duration"
# a library found already built under its source hash: no build
CACHE_HIT_EVENT = "/selkies_tpu_torch/build/cache_hits"

TRIGGERS = ("actuation", "recarve", "codec_switch", "resize", "restart",
            "startup", "unattributed")


class CompileSentinel:
    """Counts/times/attributes executable builds; flags recompile storms.

    All state mutations take ``_lock`` — builds report from whatever
    thread first used the library (the submit thread, completion
    workers, pack pools)."""

    def __init__(self, *, storm_n: int = 8, storm_window_s: float = 30.0,
                 mark_ttl_s: float = 30.0, startup_grace_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic):
        self.storm_n = max(2, int(storm_n))
        self.storm_window_s = float(storm_window_s)
        self.mark_ttl_s = float(mark_ttl_s)
        self.startup_grace_s = float(startup_grace_s)
        self.clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._mark: tuple[str, str, float] | None = None  # trigger, detail, t
        self.compiles = 0
        self.cache_hits = 0
        self.compile_ms_total = 0.0
        self.storms = 0
        self.by_trigger: dict[str, int] = {}
        self.by_site: dict[str, int] = {}       # "trigger:detail" -> n
        self._recent: deque = deque()           # (t, trigger) inside window
        self._last_storm_at = -1e18
        self.last: dict | None = None           # last compile, for stats()

    # -- attribution ---------------------------------------------------

    def mark(self, trigger: str, detail: str = "") -> None:
        """Declare that executables were just invalidated by ``trigger``
        — compiles observed within ``mark_ttl_s`` attribute to it.
        Newest mark wins (the rebuild that happened last is the one the
        next lazy compile pays for)."""
        with self._lock:
            self._mark = (str(trigger), str(detail), self.clock())

    @contextmanager
    def scope(self, trigger: str, detail: str = ""):
        """Exact attribution for eager compile sites (``prewarm``):
        compiles on THIS thread inside the block belong to ``trigger``,
        overriding any process-global mark."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append((str(trigger), str(detail)))
        try:
            yield self
        finally:
            stack.pop()

    def _attribute(self, now: float) -> tuple[str, str]:
        stack = getattr(self._tls, "stack", None)
        if stack:
            return stack[-1]
        m = self._mark
        if m is not None and now - m[2] <= self.mark_ttl_s:
            return m[0], m[1]
        if now - self._t0 <= self.startup_grace_s:
            return "startup", ""
        return "unattributed", ""

    # -- the build listener ---------------------------------------------

    def on_duration(self, event: str, secs: float) -> None:
        if event != COMPILE_EVENT:
            return
        now = self.clock()
        ms = secs * 1e3
        with self._lock:
            trigger, detail = self._attribute(now)
            self.compiles += 1
            self.compile_ms_total += ms
            self.by_trigger[trigger] = self.by_trigger.get(trigger, 0) + 1
            site = f"{trigger}:{detail}" if detail else trigger
            self.by_site[site] = self.by_site.get(site, 0) + 1
            self.last = {"trigger": trigger, "detail": detail,
                         "ms": round(ms, 1), "t": round(now - self._t0, 1)}
            self._recent.append((now, trigger))
            cutoff = now - self.storm_window_s
            while self._recent and self._recent[0][0] < cutoff:
                self._recent.popleft()
            storm = (len(self._recent) >= self.storm_n
                     and now - self._last_storm_at >= self.storm_window_s)
            if storm:
                self._last_storm_at = now
                self.storms += 1
                dominant = max(set(t for _, t in self._recent),
                               key=[t for _, t in self._recent].count)
                n_window = len(self._recent)
        if telemetry.enabled:
            telemetry.count("selkies_compile_total", trigger=trigger)
            telemetry.observe("selkies_compile_ms", ms, trigger=trigger)
        if storm:
            logger.error(
                "recompile storm: %d executable builds inside %.0fs (dominant "
                "trigger %r, last %s/%s %.0f ms) — an executable-reuse "
                "discipline is broken", n_window, self.storm_window_s,
                dominant, trigger, detail or "-", ms)
            if telemetry.enabled:
                telemetry.count("selkies_compile_storms_total",
                                trigger=dominant)
                telemetry.event("compile_storm", trigger=dominant,
                                compiles=n_window,
                                window_s=self.storm_window_s)

    def on_event(self, event: str) -> None:
        if event == CACHE_HIT_EVENT:
            with self._lock:
                self.cache_hits += 1

    # -- read side -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "compiles": self.compiles,
                "cache_hits": self.cache_hits,
                "compile_ms_total": round(self.compile_ms_total, 1),
                "storms": self.storms,
                "by_trigger": dict(self.by_trigger),
                "by_site": dict(self.by_site),
                "in_window": len(self._recent),
                "last": dict(self.last) if self.last else None,
            }


# -- process-global dispatch ------------------------------------------------
#
# utils/build.py reports every build and every cache hit here; the reports
# go to whichever sentinel install() made active, and nowhere before that.

sentinel = CompileSentinel()
_active: CompileSentinel | None = None
_reg_lock = threading.Lock()


def report_duration(event: str, duration: float, **_kw) -> None:
    """A build took ``duration`` seconds (``event`` is
    :data:`COMPILE_EVENT`): forward to the active sentinel, if any."""
    s = _active
    if s is not None:
        try:
            s.on_duration(event, duration)
        except Exception:  # the sentinel must never break a build
            logger.exception("compile sentinel listener failed")


def report_event(event: str, **_kw) -> None:
    """A build event without a duration (:data:`CACHE_HIT_EVENT`)."""
    s = _active
    if s is not None:
        try:
            s.on_event(event)
        except Exception:
            logger.exception("compile sentinel listener failed")


def install(s: CompileSentinel | None = None) -> CompileSentinel:
    """Make ``s`` (default: the module sentinel) the active build
    listener. Idempotent. Returns the active sentinel."""
    global _active
    with _reg_lock:
        _active = s or sentinel
        return _active


def uninstall() -> None:
    """Stop observing: later reports go nowhere."""
    global _active
    with _reg_lock:
        _active = None


def mark(trigger: str, detail: str = "") -> None:
    """Module-level convenience: mark on the *active* sentinel when one
    is installed, else on the default (so marks placed before install
    still attribute the startup builds that follow)."""
    (_active or sentinel).mark(trigger, detail)


def scope(trigger: str, detail: str = ""):
    return (_active or sentinel).scope(trigger, detail)


def stats() -> dict:
    """The active sentinel's stats (the /statz ``compile`` provider)."""
    return (_active or sentinel).stats()
