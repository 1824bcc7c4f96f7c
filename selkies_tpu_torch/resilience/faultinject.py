"""Deterministic, seeded fault injection for the serving path.

The port's copy of ``selkies_tpu/resilience/faultinject.py``: the same
grammar, the same ``SELKIES_FAULTS`` variable (one spec string drives both
packages), ``configure_faults`` / ``reset_faults`` and the per-site tick
counters. The injector is this package's own: configuring or resetting one
package's leaves the other's alone. The port wires the ``capture`` and
``encoder`` sites (``VideoPipeline._run``, ``pipeline/elements.py``, once
per tick of the solo app), the ``frontend`` site
(``TorchH264Encoder.submit``), the ``policy`` site (``PolicyEngine``,
``policy/engine.py``), the ``device:<chip>`` site (the banded encoder per
frame, the session service per tick, and every probation probe,
``resilience/devhealth.py``), the fleet lifecycle's ``admission`` /
``recarve`` / ``migrate`` / ``drain`` sites (``parallel/lifecycle.py``) and
the occupancy scheduler's ``sched:<k>`` (``parallel/occupancy.py``), the
fleet tick's ``capture:<k>`` and ``encoder`` (``parallel/fleet.py``), the
mux's ``send`` / ``send:<k>`` (``transport/mux.py``), ``signalling``
(``signalling/client.py``), ``cluster:redirect`` (``signalling/server.py``),
``cluster:heartbeat`` and ``cluster:partition`` (``cluster/membership.py``,
per heartbeat send and receive), ``cluster:ship`` (``cluster/migrate.py``,
per checkpoint ship) and the ``net:*`` family (``transport/impair.py``,
read by each ``PeerConnection`` built while a ``net`` rule is configured).

Configured with the ``SELKIES_FAULTS`` environment variable (or
programmatically via :func:`configure_faults`); when unset the hot paths
pay one ``None`` check and nothing else, and the encoded streams are
byte-identical to an injection-free build.

Grammar (semicolon-separated rules)::

    SELKIES_FAULTS = rule (";" rule)*
    rule   = site "@" sched ":" action
    site   = capture | encoder | send | signalling      (serving path)
           | frontend                                   (uplink front-end)
           | admission | recarve | migrate | drain      (fleet lifecycle)
           | policy                                     (scenario policy)
           | device                                     (chip health plane)
           | cluster                                    (multi-host plane)
           | sched                                      (occupancy scheduler)
           | net                                        (packet impairment)
           (wired sites; names are free-form)
    sched  = tick list / ranges  "5,9,13" or "20-22" or "5,9,20-22"
           | "every:N"           every Nth call (1-based)
           | "p:0.01[,seed:N]"   seeded Bernoulli per call (deterministic)
    action = raise | drop | delay:<ms> | flap

Fleet-scale sites (parallel/lifecycle.py): ``admission`` fires inside
the SessionPlacer's admit (``drop``/``raise`` both reject the client);
``recarve`` fires before a borrow moves any chips (a ``raise`` is a
re-carve-during-encode that must leave the carve untouched);
``migrate`` fires in checkpoint_session/restore_session (``raise`` is
a kill-slot-mid-migration; the qualified form ``migrate:<k>`` targets
one session); ``drain`` fires at drain start (``delay:<ms>`` stretches
the preStop window toward its deadline, ``raise`` marks the drain
failed while it still completes). ``policy`` fires inside the scenario
policy engine's per-tick decide (selkies_tpu/policy; fleet slots are
``policy:<k>``): ``flap`` forces a misclassification the hysteresis
must absorb, ``drop`` skips the evaluation, and repeated ``raise``
wedges the engine — which must DISARM back to static knobs instead of
stalling the serving loop (tests/test_chaos.py). ``frontend`` fires at
the top of the pipelined encoder's submit — inside the uplink
classify/hash/convert stage — so a ``raise`` exercises the
double-buffered front-end's failure contract: frames already in flight
stay deliverable in order, and the next submit self-heals as a
full-upload IDR (tests/test_frontend_parallel.py). ``device:<chip>``
fires per chip in the banded/tiled encoders and the lockstep session
service, once per encode per chip (resilience/devhealth.py
check_device_faults, plus every probation probe of a quarantined chip):
``raise``/``drop`` kill the step with a DeviceFault naming the chip —
the supervisor's classification quarantines it and re-carves the
session onto the surviving chips — ``delay:<ms>`` wedges the chip (the
tick-deadline watchdog's territory), and ``flap`` records a health-plane
blip without failing the frame, which the
``SELKIES_DEVICE_FAIL_THRESHOLD`` streak must absorb
(tests/test_device_faults.py). The multi-host plane
(selkies_tpu/cluster) wires four qualified ``cluster`` sites:
``cluster:heartbeat`` fires per heartbeat send (``drop`` = a lost beat
the receiver's lease must age out, ``raise`` = a send failure driving
the capped-backoff re-join, ``delay:<ms>`` stretches the beat);
``cluster:partition`` fires per heartbeat receive (``drop`` = a
one-way partition); ``cluster:ship`` fires in the cross-host
checkpoint ship of a live migration (``delay:<ms>`` = a slow ship
eating the drain deadline, ``raise``/``drop`` = mid-migration peer
death — the source keeps serving the session); ``cluster:redirect``
fires where the signalling server SENDS a redirect record (``drop`` =
redirect lost in flight — the client's reconnect loop retries and the
next HELLO re-routes) (tests/test_cluster.py). ``sched:<k>`` fires in
the occupancy scheduler (parallel/occupancy.py) per session per tick,
at the scheduling decision before session ``k``'s stage dispatches:
``drop`` skips that session's dispatch for the tick (the frame is never
encoded; later frames still deliver in order), ``delay:<ms>`` wedges
that session's own completion lane while every other session's pipeline
keeps flowing, and ``raise`` fails the session — the scheduler finishes
the other sessions' stages before re-raising, preserving the serial
tick's failure semantics (tests/test_occupancy.py). The ``net`` family
fires per outgoing datagram at the peer's send boundary
(transport/impair.py NetImpairment, armed by webrtc/peer.py when any
``net`` rule is configured — each site's tick counter counts
datagrams): ``net:loss`` with ``drop`` discards the datagram (the
NACK/FEC recovery ladder's job is to survive exactly this);
``net:jitter`` with ``delay:<ms>`` defers its delivery; ``net:reorder``
(any action) holds the datagram and releases it behind the next one;
``net:dup`` (any action) delivers it twice; ``net:bandwidth:<kbps>``
(any action) rate-shapes matching datagrams through a serialization
queue at the kbps named in the site qualifier
(tests/test_recovery.py).

Examples::

    SELKIES_FAULTS='encoder@5,9,13:raise'            three encoder-tick crashes
    SELKIES_FAULTS='send@20-24:drop'                 five dropped video sends
    SELKIES_FAULTS='signalling@2:flap'               one signalling flap
    SELKIES_FAULTS='capture@p:0.01,seed:7:raise'     1% seeded capture faults
    SELKIES_FAULTS='net:loss@p:0.05,seed:3:drop'     5% seeded packet loss

Each call site bumps a per-site tick counter, so schedules are exact and
reproducible: the same spec against the same workload injects at the same
ticks every run. Sites are matched by exact name or by prefix before a
``:`` qualifier (a rule for ``send`` also matches ``send:3``, with a
separate counter per qualified site — one schedule, per-slot clocks).
"""

from __future__ import annotations

import logging
import os
import random
import re
import threading

from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("resilience.faultinject")

__all__ = ["InjectedFault", "FaultInjector", "get_injector",
           "configure_faults", "reset_faults"]

ENV_VAR = "SELKIES_FAULTS"

_ACTIONS = ("raise", "drop", "delay", "flap")


class InjectedFault(RuntimeError):
    """Raised by an injection site on a scheduled ``raise`` action."""


class _Rule:
    __slots__ = ("site", "action", "delay_ms", "ticks", "ranges", "every",
                 "prob", "_rng")

    def __init__(self, site: str, sched: str, action: str):
        self.site = site
        self.ticks: set[int] = set()
        self.ranges: list[tuple[int, int]] = []
        self.every = 0
        self.prob = 0.0
        self._rng: random.Random | None = None
        self.delay_ms = 0.0

        act, _, arg = action.partition(":")
        if act not in _ACTIONS:
            raise ValueError(f"unknown fault action {act!r} (one of {_ACTIONS})")
        if act == "delay":
            if not arg:
                raise ValueError("delay action needs a millisecond arg: delay:<ms>")
            self.delay_ms = float(arg)
        elif arg:
            raise ValueError(f"action {act!r} takes no argument, got {arg!r}")
        self.action = act

        if sched.startswith("every:"):
            self.every = int(sched[len("every:"):])
            if self.every < 1:
                raise ValueError(f"every:N needs N >= 1, got {self.every}")
        elif sched.startswith("p:"):
            seed = 0
            body = sched[len("p:"):]
            m = re.fullmatch(r"([0-9.eE+-]+)(?:,seed:(\d+))?", body)
            if not m:
                raise ValueError(f"bad probability schedule {sched!r}")
            self.prob = float(m.group(1))
            if not 0.0 <= self.prob <= 1.0:
                raise ValueError(f"probability {self.prob} out of [0, 1]")
            if m.group(2) is not None:
                seed = int(m.group(2))
            self._rng = random.Random(seed)
        else:
            for part in sched.split(","):
                part = part.strip()
                if not part:
                    continue
                lo, dash, hi = part.partition("-")
                if dash:
                    lo_i, hi_i = int(lo), int(hi)
                    if hi_i < lo_i:
                        raise ValueError(f"bad tick range {part!r}")
                    self.ranges.append((lo_i, hi_i))
                else:
                    self.ticks.add(int(part))
            if not self.ticks and not self.ranges:
                raise ValueError(f"empty tick schedule {sched!r}")

    def matches_site(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site + ":")

    def fires(self, tick: int) -> bool:
        if self.every:
            return tick % self.every == 0
        if self._rng is not None:
            return self._rng.random() < self.prob
        return (tick in self.ticks
                or any(lo <= tick <= hi for lo, hi in self.ranges))


def parse_faults(spec: str) -> list[_Rule]:
    rules = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        # the schedule may itself contain ':' (every:N, p:…,seed:N), so the
        # action is matched as an anchored suffix alternation; sites may
        # carry a ':<qualifier>' (per-slot, e.g. capture:1)
        m = re.fullmatch(
            r"([a-zA-Z_][\w.:-]*)@(.+?):(raise|drop|flap|delay:[0-9.eE+-]+)",
            raw)
        if not m:
            raise ValueError(
                f"bad fault rule {raw!r} (want site@sched:action, action one "
                f"of {_ACTIONS} with delay:<ms>)")
        rules.append(_Rule(m.group(1), m.group(2).strip(), m.group(3).strip()))
    return rules


class FaultInjector:
    """Evaluates ``check(site)`` against the parsed schedule.

    Per-site tick counters start at 1 on the first check. Thread-safe:
    injection sites run on worker threads (encode) and the event loop
    (send/signalling) concurrently.
    """

    def __init__(self, spec: str):
        self.spec = spec
        self.rules = parse_faults(spec)
        self._counters: dict[str, int] = {}
        self._lock = threading.Lock()
        # (site, tick, action) log — chaos tests assert against this
        self.injected: list[tuple[str, int, str]] = []

    def check(self, site: str) -> tuple[str, float] | None:
        """Advance ``site``'s tick; raise InjectedFault on a scheduled
        ``raise``, else return (action, delay_ms) for the caller to apply
        (``drop`` / ``delay`` / ``flap``), or None."""
        with self._lock:
            tick = self._counters.get(site, 0) + 1
            self._counters[site] = tick
            hit: _Rule | None = None
            for rule in self.rules:
                if rule.matches_site(site) and rule.fires(tick):
                    hit = rule
                    break
            if hit is None:
                return None
            self.injected.append((site, tick, hit.action))
        logger.warning("injected %s at %s tick %d (%s)",
                       hit.action, site, tick, self.spec)
        if telemetry.enabled:
            # a scheduled fault firing is exactly the kind of event a
            # post-mortem bundle must contain (chaos-run attribution)
            telemetry.count("selkies_faults_injected_total",
                            site=site, action=hit.action)
        if hit.action == "raise":
            raise InjectedFault(f"injected fault at {site} tick {tick}")
        return hit.action, hit.delay_ms

    def tick_of(self, site: str) -> int:
        with self._lock:
            return self._counters.get(site, 0)


_injector: FaultInjector | None = None
_loaded = False


def get_injector() -> FaultInjector | None:
    """The process-wide injector from ``SELKIES_FAULTS`` (cached), or the
    one installed by :func:`configure_faults`. None when injection is off —
    call sites guard with ``if fi is not None`` so the disabled path costs
    one attribute load."""
    global _injector, _loaded
    if not _loaded:
        _loaded = True
        spec = os.environ.get(ENV_VAR, "").strip()
        if spec:
            try:
                _injector = FaultInjector(spec)
                logger.warning("fault injection ACTIVE: %s=%s", ENV_VAR, spec)
            except ValueError:
                logger.exception("ignoring malformed %s=%r", ENV_VAR, spec)
    return _injector


def configure_faults(spec: str) -> FaultInjector:
    """Install an injector programmatically (tests). Overrides the env."""
    global _injector, _loaded
    _injector = FaultInjector(spec)
    _loaded = True
    return _injector


def reset_faults() -> None:
    """Drop any cached injector; the next get_injector() re-reads the env."""
    global _injector, _loaded
    _injector = None
    _loaded = False
