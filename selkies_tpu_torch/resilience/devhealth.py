"""Device health plane: chip enumeration, quarantine, probation, readmit.

The port's copy of ``selkies_tpu/resilience/devhealth.py`` over CUDA
devices. What differs from JAX's:

* **enumeration** — ``DevicePool()`` takes ``torch.device("cuda", i)``
  for each ``i < torch.cuda.device_count()`` and raises when there is no
  card; a caller that wants the CPU passes ``devices`` itself (the tests
  pass ``[torch.device("cpu")]``). A quarantined card is never replaced
  by the CPU;
* **``chip_key``** is the CUDA index as a string; the CPU gives ``"0"``,
  the id of JAX's first CPU device, so one ``device:0`` rule hits both
  packages;
* **the probe** sends one int32 scalar to the device and back and
  compares it; a probe that raises counts as failed;
* **``looks_device_error``** recognises torch's CUDA failure shapes
  (``torch.AcceleratorError``, ``torch.cuda.OutOfMemoryError``, and a
  ``RuntimeError`` whose text carries ``CUDA error``, ``CUBLAS_STATUS``,
  ``cuDNN error`` or ``device-side assert``).

``DeviceFault``, ``check_device_faults``, ``note_tick_failure``,
``fault_chip``, the quarantine → probation → readmit machine and the
process-wide pool functions are JAX's. The pool and the injector it reads
are this package's own. In the port, ``check_device_faults`` is called by
``TorchBandedH264Encoder.dispatch_frame`` and
``TorchMultiSessionH264Service.dispatch_tick``; the banded encoder and the
session encoder take their card from the pool when ``device=None``. The
fleet, placer and supervisor named below are JAX modules not ported yet.

Every layer that places work on chips used to enumerate the devices
independently (band/tile mesh builders, the session mesh, the fleet
placer) and assumed each chip stays healthy forever — a chip failing
mid-stream made the supervisor rebuild the encoder onto the *same dead
device* until the session fell all the way to the software row, while
healthy idle chips sat unused. This module is the single source of chip
truth the rest of the stack routes through:

* **enumeration** — :func:`get_device_pool` owns the process-wide
  :class:`DevicePool`; ``healthy_devices()`` is what the mesh builders
  and the placer consume, so placement, mesh build, and admission can
  never disagree about the chip set.
* **health tracking** — serving loops classify failed ticks
  (:meth:`DevicePool.attribute`: a :class:`DeviceFault` in the exception
  chain names the chip directly; CUDA-shaped errors fall back to
  cheap liveness probes over the session's row) and feed
  :meth:`DevicePool.note_failure`. ``SELKIES_DEVICE_FAIL_THRESHOLD``
  consecutive attributed failures quarantine the chip.
* **quarantine → probation → readmit** — a quarantined chip sits out for
  ``SELKIES_DEVICE_PROBATION_S`` seconds (doubling per re-quarantine,
  capped at 8x — the supervisor's capped-backoff discipline), then
  :meth:`DevicePool.tick` runs cheap liveness probes; ``readmit_after``
  consecutive healthy probes re-admit it. The fleet wires readmits back
  into the JAX fleet's ``SessionPlacer``
  (quarantine is a first-class placement location there) and re-carves
  the affected session; solo sessions pick the chip up on their next
  encoder rebuild.
* **deterministic chaos** — the ``device:<chip>`` fault site
  (:func:`check_device_faults`, consulted by the banded/tiled encoders
  once per chip per frame) lets a seeded ``SELKIES_FAULTS`` schedule
  kill (``raise``/``drop`` → :class:`DeviceFault`), wedge (``delay:<ms>``
  stalls the step) or flap (``flap`` → a health-plane blip the failure
  threshold must absorb) a specific chip mid-stream.

Telemetry: ``selkies_device_health`` (0 healthy / 1 quarantined per
chip), ``selkies_device_quarantines_total``, ``device`` ring events, a
``devices`` /statz provider block, and a degraded-capacity detail folded
into ``/healthz`` (the chronic-burn autoscaling signal reads it).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field

import torch

from selkies_tpu_torch.monitoring.telemetry import telemetry
from selkies_tpu_torch.resilience.faultinject import InjectedFault, get_injector

logger = logging.getLogger("resilience.devhealth")

__all__ = [
    "DeviceFault",
    "DevicePool",
    "check_device_faults",
    "chip_key",
    "fault_chip",
    "get_device_pool",
    "looks_device_error",
    "note_tick_failure",
    "peek_device_pool",
    "reset_device_pool",
    "set_device_pool",
]

ENV_PROBATION = "SELKIES_DEVICE_PROBATION_S"
ENV_FAIL_THRESHOLD = "SELKIES_DEVICE_FAIL_THRESHOLD"

# probation doubles per re-quarantine up to this multiple of the base —
# the same capped-backoff discipline as the supervisor's restart gate
PROBATION_CAP_FACTOR = 8


def probation_from_env() -> float:
    env = os.environ.get(ENV_PROBATION, "")
    if not env:
        return 30.0
    try:
        return max(0.1, float(env))
    except ValueError:
        logger.warning("%s=%r is not a number; using 30", ENV_PROBATION, env)
        return 30.0


def fail_threshold_from_env() -> int:
    env = os.environ.get(ENV_FAIL_THRESHOLD, "")
    if not env:
        return 3
    try:
        return max(1, int(env))
    except ValueError:
        logger.warning("%s=%r is not an integer; using 3",
                       ENV_FAIL_THRESHOLD, env)
        return 3


def chip_key(device) -> str:
    """Stable identity for a chip across the pool, fault sites and
    telemetry labels: a CUDA device's index (the CPU, like JAX's first CPU
    device, is ``"0"``); test doubles use their own string form — the same
    form /statz prints."""
    if isinstance(device, torch.device):
        return str(device.index or 0)
    return str(getattr(device, "id", device))


class DeviceFault(RuntimeError):
    """A step failure attributed to one chip. Raised by the
    ``device:<chip>`` fault site; serving loops find it in a failed
    tick's exception chain (:meth:`DevicePool.attribute`)."""

    def __init__(self, chip: str, msg: str = ""):
        self.chip = str(chip)
        super().__init__(msg or f"device fault on chip {self.chip}")


def _default_probe(device) -> bool:
    """Cheap liveness probe: round-trip one int32 scalar through the
    device. Objects that aren't torch devices (test doubles) probe
    healthy — the injectable ``probe`` hook and the fault site carry
    those tests."""
    if not isinstance(device, torch.device):
        return True
    try:
        x = torch.tensor(1, dtype=torch.int32).to(device)
        return int(x.cpu()) == 1
    except Exception:
        logger.exception("liveness probe of %s failed", device)
        return False


@dataclass
class _ChipHealth:
    state: str = "healthy"  # healthy | quarantined
    fail_streak: int = 0
    failures_total: int = 0
    quarantines: int = 0
    last_failure_at: float = 0.0
    quarantined_at: float = 0.0
    probation_s: float = 0.0
    probation_until: float = 0.0
    probe_ok_streak: int = 0
    reason: str = ""
    extras: dict = field(default_factory=dict)


class DevicePool:
    """Process-wide chip health state (see module docstring).

    Thread-safe: failures are noted from encode worker threads while
    probes/readmits tick on the event loops' watchdogs.
    """

    def __init__(self, devices=None, *, fail_threshold: int | None = None,
                 probation_s: float | None = None, readmit_after: int = 3,
                 clock=time.monotonic, probe=None):
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError(
                    "CUDA is not available: the device pool enumerates CUDA "
                    "devices; pass devices= (e.g. [torch.device('cpu')]) to "
                    "build it over others")
            devices = [torch.device("cuda", i) for i in range(n)]
        self._devices = list(devices)
        self._by_key = {chip_key(d): d for d in self._devices}
        self.fail_threshold = (fail_threshold_from_env()
                               if fail_threshold is None
                               else max(1, int(fail_threshold)))
        self.probation_s = (probation_from_env() if probation_s is None
                            else max(0.1, float(probation_s)))
        self.readmit_after = max(1, int(readmit_after))
        self._clock = clock
        self._probe_fn = probe or _default_probe
        self._lock = threading.RLock()
        self._health: dict[str, _ChipHealth] = {
            chip_key(d): _ChipHealth() for d in self._devices}
        # /statz + /healthz surfacing: the pool is process-global, so the
        # registrations live exactly as long as the process
        telemetry.register_provider("devices", self.stats)
        telemetry.register_devices(self.health_view)
        if telemetry.enabled:
            for key in self._by_key:
                telemetry.gauge("selkies_device_health", 0, chip=key)

    # -- enumeration ----------------------------------------------------

    def all_devices(self) -> list:
        return list(self._devices)

    def healthy_devices(self) -> list:
        with self._lock:
            return [d for d in self._devices
                    if self._health[chip_key(d)].state == "healthy"]

    def quarantined_keys(self) -> list[str]:
        with self._lock:
            return [k for k, h in self._health.items()
                    if h.state == "quarantined"]

    def has_quarantined(self) -> bool:
        with self._lock:
            return any(h.state == "quarantined"
                       for h in self._health.values())

    def is_quarantined(self, chip) -> bool:
        key = chip if isinstance(chip, str) else chip_key(chip)
        with self._lock:
            h = self._health.get(key)
            return h is not None and h.state == "quarantined"

    def _entry(self, key: str) -> _ChipHealth:
        """Health record for ``key`` (lock held). Unknown chips — a
        DeviceFault naming a chip this pool wasn't built over (tests,
        explicit device lists) — are tracked lazily so the health plane
        never loses an attributed failure."""
        h = self._health.get(key)
        if h is None:
            h = self._health[key] = _ChipHealth()
        return h

    # -- health intake --------------------------------------------------

    def note_ok(self, chip) -> None:
        key = chip if isinstance(chip, str) else chip_key(chip)
        with self._lock:
            self._entry(key).fail_streak = 0

    def note_failure(self, chip, reason: str = "step") -> bool:
        """One attributed failure for ``chip``; True when this crossed
        the threshold and the chip is NEWLY quarantined. A stale streak
        (older than one probation window) restarts at 1 — isolated blips
        spread over hours must not accumulate into a quarantine."""
        key = chip if isinstance(chip, str) else chip_key(chip)
        now = self._clock()
        with self._lock:
            h = self._entry(key)
            if h.state == "quarantined":
                h.failures_total += 1
                return False
            if h.last_failure_at and now - h.last_failure_at > self.probation_s:
                h.fail_streak = 0
            h.fail_streak += 1
            h.failures_total += 1
            h.last_failure_at = now
            h.reason = reason
            crossed = h.fail_streak >= self.fail_threshold
        if telemetry.enabled:
            telemetry.event("device", chip=key, action="failure",
                            reason=reason)
        if crossed:
            return self.quarantine(key, reason=reason)
        return False

    def quarantine(self, chip, reason: str = "manual") -> bool:
        """Pull ``chip`` out of the healthy set; True when the state
        actually changed. Probation doubles per re-quarantine (capped)."""
        key = chip if isinstance(chip, str) else chip_key(chip)
        now = self._clock()
        with self._lock:
            h = self._entry(key)
            if h.state == "quarantined":
                return False
            h.state = "quarantined"
            h.quarantines += 1
            h.fail_streak = 0
            h.probe_ok_streak = 0
            h.quarantined_at = now
            h.probation_s = min(
                self.probation_s * (2 ** min(h.quarantines - 1, 16)),
                self.probation_s * PROBATION_CAP_FACTOR)
            h.probation_until = now + h.probation_s
            h.reason = reason
            probation = h.probation_s
        logger.error("chip %s QUARANTINED (%s): probation %.1fs",
                     key, reason, probation)
        if telemetry.enabled:
            telemetry.count("selkies_device_quarantines_total",
                            chip=key, reason=reason)
            telemetry.gauge("selkies_device_health", 1, chip=key)
            telemetry.event("device", chip=key, action="quarantine",
                            reason=reason, probation_s=round(probation, 1))
        return True

    def readmit(self, chip) -> bool:
        key = chip if isinstance(chip, str) else chip_key(chip)
        with self._lock:
            h = self._health.get(key)
            if h is None or h.state != "quarantined":
                return False
            h.state = "healthy"
            h.fail_streak = 0
            h.probe_ok_streak = 0
        logger.warning("chip %s readmitted after probation", key)
        if telemetry.enabled:
            telemetry.gauge("selkies_device_health", 0, chip=key)
            telemetry.event("device", chip=key, action="readmit")
        return True

    # -- probation / probes ---------------------------------------------

    def probe(self, chip) -> bool:
        """One liveness probe. The ``device:<chip>`` fault site is
        consulted first so seeded chaos keeps a chip dead for exactly
        the scheduled window — ``raise``/``drop``/``flap`` fail the
        probe, ``delay`` stalls it (a wedged chip)."""
        key = chip if isinstance(chip, str) else chip_key(chip)
        fi = get_injector()
        if fi is not None:
            try:
                act = fi.check(f"device:{key}")
            except InjectedFault:
                return False
            if act is not None:
                kind, ms = act
                if kind == "delay":
                    time.sleep(min(ms, 1000.0) / 1e3)
                else:  # drop / flap: the chip is not answering
                    return False
        dev = self._by_key.get(key)
        if dev is None:
            return True  # untracked chip: nothing to probe against
        return bool(self._probe_fn(dev))

    def tick(self) -> list[str]:
        """Periodic health work (serving-loop watchdogs, ~1/s): probe
        quarantined chips whose probation expired; ``readmit_after``
        consecutive healthy probes readmit. A failed probe re-arms one
        full (doubled, capped) probation window. Returns the chips
        readmitted this call."""
        now = self._clock()
        with self._lock:
            due = [k for k, h in self._health.items()
                   if h.state == "quarantined" and now >= h.probation_until]
        if not due:
            return []
        readmitted: list[str] = []
        for key in due:
            ok = self.probe(key)
            with self._lock:
                h = self._health.get(key)
                if h is None or h.state != "quarantined":
                    continue
                if ok:
                    h.probe_ok_streak += 1
                    ready = h.probe_ok_streak >= self.readmit_after
                else:
                    h.probe_ok_streak = 0
                    h.probation_s = min(
                        h.probation_s * 2,
                        self.probation_s * PROBATION_CAP_FACTOR)
                    h.probation_until = now + h.probation_s
                    ready = False
            if not ok and telemetry.enabled:
                telemetry.event("device", chip=key, action="probe_fail")
            if ready and self.readmit(key):
                readmitted.append(key)
        return readmitted

    # -- failure attribution --------------------------------------------

    def attribute(self, exc: BaseException, devices=None) -> str | None:
        """Map a failed tick to a chip, or None (not a device error).
        A :class:`DeviceFault` anywhere in the exception chain names the
        chip directly (the deterministic chaos plane and any site that
        raises one). Otherwise, for CUDA-shaped errors only, probe
        the session's row and blame the first chip that fails — the
        "failing mesh coordinate to chip" mapping for organic faults."""
        key = fault_chip(exc)
        if key is not None:
            return key
        if devices and _looks_device_error(exc):
            for d in devices:
                key = chip_key(d)
                if self.is_quarantined(key):
                    continue
                if not self.probe(key):
                    return key
        return None

    # -- read side ------------------------------------------------------

    def stats(self) -> dict:
        """/statz ``devices`` provider block."""
        now = self._clock()
        with self._lock:
            quarantined = {
                k: {
                    "age_s": round(now - h.quarantined_at, 1),
                    "probation_s": round(h.probation_s, 1),
                    "probe_ok": h.probe_ok_streak,
                    "failures": h.failures_total,
                    "quarantines": h.quarantines,
                    "reason": h.reason,
                }
                for k, h in sorted(self._health.items())
                if h.state == "quarantined"
            }
            failures = {k: h.failures_total
                        for k, h in sorted(self._health.items())
                        if h.failures_total}
            healthy = sum(1 for h in self._health.values()
                          if h.state == "healthy")
        return {
            "chips": len(self._devices),
            "healthy": healthy,
            "fail_threshold": self.fail_threshold,
            "probation_s": self.probation_s,
            "quarantined": quarantined,
            "failures": failures,
        }

    def health_view(self) -> dict:
        """Degraded-capacity detail folded into ``/healthz`` (a pure
        chip quarantine keeps 200 — the placer/ladder carry the session
        impact; an autoscaler reads the capacity fraction)."""
        with self._lock:
            total = len(self._devices)
            healthy = sum(1 for d in self._devices
                          if self._health[chip_key(d)].state == "healthy")
            quarantined = sorted(
                k for k, h in self._health.items()
                if h.state == "quarantined")
        return {
            "chips": total,
            "healthy": healthy,
            "quarantined": quarantined,
            "capacity": round(healthy / total, 3) if total else 0.0,
        }


# ---------------------------------------------------------------------------
# deterministic device chaos (the `device:<chip>` SELKIES_FAULTS site)
# ---------------------------------------------------------------------------


def check_device_faults(devices) -> None:
    """Injection site consulted by the banded/tiled encoders once per
    chip per frame, before anything touches the device. Actions:
    ``raise``/``drop`` kill the step with a :class:`DeviceFault` naming
    the chip, ``delay:<ms>`` wedges it (the tick-deadline watchdog's
    territory), ``flap`` notes a health-plane failure without failing
    the frame (noise the ``SELKIES_DEVICE_FAIL_THRESHOLD`` streak must
    absorb). Costs one injector read when ``SELKIES_FAULTS`` is unset."""
    fi = get_injector()
    if fi is None or not devices:
        return
    # a carve may list one card more than once: it is consulted once
    for key in dict.fromkeys(chip_key(d) for d in devices):
        try:
            act = fi.check(f"device:{key}")
        except InjectedFault as exc:
            raise DeviceFault(key) from exc
        if act is None:
            continue
        kind, ms = act
        if kind == "delay":
            time.sleep(ms / 1e3)
        elif kind == "flap":
            get_device_pool().note_failure(key, reason="flap")
        elif kind == "drop":
            raise DeviceFault(key, f"injected drop on chip {key}")


def note_tick_failure(exc: BaseException, devices=None) -> str | None:
    """The serving loops' shared classification sequence: map a failed
    tick to a chip (a :class:`DeviceFault` in the chain, else probe
    ``devices`` for CUDA-shaped errors), feed the pool, and return
    the chip key iff this failure NEWLY quarantined it (the only case
    callers act on — the fleet re-carves, the solo app rebuilds).
    Host-shaped failures return None without ever touching (or
    creating) the pool."""
    key = fault_chip(exc)
    if key is None and not (devices and _looks_device_error(exc)):
        return None
    pool = get_device_pool()
    if key is None:
        key = pool.attribute(exc, devices)
    if key is None:
        return None
    return key if pool.note_failure(key, reason="step") else None


def fault_chip(exc: BaseException) -> str | None:
    """The chip a :class:`DeviceFault` anywhere in ``exc``'s cause/
    context chain names, or None. Pool-free — serving loops call this
    on every failed tick, and an ordinary host exception must not cost
    a device-pool construction."""
    seen: set[int] = set()
    e: BaseException | None = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, DeviceFault):
            return e.chip
        e = e.__cause__ or e.__context__
    return None


def looks_device_error(exc: BaseException) -> bool:
    """Public alias of the probe-attribution gate (serving loops use it
    to skip pool work for host-shaped failures)."""
    return _looks_device_error(exc)


# the texts torch's CUDA failures carry in a plain RuntimeError
_CUDA_ERROR_MARKS = ("CUDA error", "CUBLAS_STATUS", "cuDNN error",
                     "device-side assert")


def _looks_device_error(exc: BaseException) -> bool:
    """Heuristic gate before probe-based attribution: only CUDA-shaped
    failures warrant probing a row (a KeyError in host code must not cost
    N device round-trips per failed tick)."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return (isinstance(exc, RuntimeError)
            and any(m in str(exc) for m in _CUDA_ERROR_MARKS))


# ---------------------------------------------------------------------------
# the process-wide pool
# ---------------------------------------------------------------------------

_pool: DevicePool | None = None
_pool_lock = threading.Lock()


def get_device_pool() -> DevicePool:
    """The process-wide pool, created over the CUDA devices on first use
    (raises without a card: install one with :func:`set_device_pool`)."""
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = DevicePool()
    return _pool


def peek_device_pool() -> DevicePool | None:
    """The pool if one exists — watchdog ticks use this so an idle
    session never enumerates devices just to probe nothing."""
    return _pool


def set_device_pool(pool: DevicePool) -> DevicePool:
    """Install a pool explicitly (tests, custom device sets)."""
    global _pool
    with _pool_lock:
        _pool = pool
    return pool


def reset_device_pool() -> None:
    global _pool
    with _pool_lock:
        _pool = None
