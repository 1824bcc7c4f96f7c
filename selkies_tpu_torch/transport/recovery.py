"""Adaptive recovery ladder: loss telemetry -> protection level.

The port's copy of ``selkies_tpu/transport/recovery.py``, on the port's
telemetry bus.

The transport has had the recovery *primitives* from the start — a NACK
retransmit ring with abuse bounds (webrtc/peer.py), RED/ULP FEC build +
recover (webrtc/fec.py), RR/NACK/TWCC parsing (webrtc/rtcp.py), GCC
loss reports (congestion.py) — but no policy connecting them: FEC ran
at a fixed 20 % whether the link was loss-free fibre or a hotel WLAN,
and the only response to loss the transport could not repair was the
supervisor's failure ladder, whose first move (downscale / fps-halve)
is exactly the user-visible degradation recovery exists to avoid.

:class:`RecoveryController` closes the loop. The ladder, cheapest rung
first:

====  ========  ======================================================
rung  name      meaning
====  ========  ======================================================
0     clean     no measured loss; FEC at 0 % (NACK/RTX stays armed —
                it costs nothing until a NACK arrives)
1     rtx       loss seen recently and NACK/RTX is recovering it;
                smoothed loss still below the FEC threshold
2     fec       smoothed loss crossed ``fec_loss``: FEC percentage
                tracks the smoothed loss fraction up to
                ``SELKIES_FEC_MAX_PCT`` (raises immediately, lowers
                only after ``recover_after`` consecutive calmer
                reports — the supervisor ladder's hysteresis shape)
3     refresh   an unrecoverable gap (a NACKed seq aged out of the RTX
                ring, or a FEC span that could not be rebuilt) forced
                an IDR through the existing keyframe path; at most one
                per ``idr_floor_s`` so a gap *burst* costs one refresh
4     degrade   sustained unrecoverable loss with FEC already at its
                cap: only now do the degradation rungs fire
                (``on_degrade`` -> the link-pressure downscale path);
                reversed after ``undegrade_after`` consecutive clean
                loss reports
====  ========  ======================================================

Off switch: ``SELKIES_RECOVERY=0`` leaves the controller inert — no
``on_set_fec`` call is ever made, so the peer keeps its static
constructor-time FEC percentage and the wire bytes are identical to a
build without this module (tests/test_recovery.py pins the sha256).

Wiring (orchestrator.py solo, parallel/fleet.py per slot)::

    rc = RecoveryController(session="0")
    rc.on_set_fec    = webrtc.set_fec_percentage
    rc.on_force_idr  = app.force_keyframe        # unthrottled internal path
    rc.on_degrade    = app._policy_link_degrade  # downscale before fps
    rc.on_undegrade  = app._policy_link_undegrade
    webrtc.on_loss          = chain(gcc.on_loss_report, rc.on_loss_report)
    webrtc.on_nack          = rc.on_nack
    webrtc.on_unrecoverable = rc.on_unrecoverable
"""

from __future__ import annotations

import logging
import math
import os
import time

from selkies_tpu_torch.monitoring.telemetry import telemetry

logger = logging.getLogger("transport.recovery")

__all__ = ["RecoveryController", "recovery_enabled", "max_fec_pct"]

ENV_VAR = "SELKIES_RECOVERY"
ENV_MAX_FEC = "SELKIES_FEC_MAX_PCT"

RUNG_NAMES = ("clean", "rtx", "fec", "refresh", "degrade")


def recovery_enabled() -> bool:
    """Adaptive recovery is ON by default; ``SELKIES_RECOVERY=0`` keeps
    the pre-ladder static behavior (fixed constructor FEC percentage,
    no forced IDRs, no escalation) byte-identical."""
    return os.environ.get("SELKIES_RECOVERY", "1") != "0"


def max_fec_pct() -> int:
    """``SELKIES_FEC_MAX_PCT`` cap on the adaptive FEC percentage
    (default 50 -> one parity packet per two media packets under the
    worst burst loss; 1..100)."""
    try:
        pct = int(os.environ.get("SELKIES_FEC_MAX_PCT", "50"))
    except ValueError:
        return 50
    return max(1, min(100, pct))


class RecoveryController:
    """One session's recovery-ladder policy. Event-driven and clock-
    injectable (tests and the impairment bench run it on a simulated
    clock); every input is a no-op when the controller is disabled."""

    def __init__(self, *, session: str = "0", enabled: bool | None = None,
                 fec_max: int | None = None, alpha: float = 0.3,
                 clean_loss: float = 0.005, fec_loss: float = 0.02,
                 recover_after: int = 6, undegrade_after: int = 10,
                 degrade_after: int = 3, window_s: float = 10.0,
                 idr_floor_s: float = 1.0, nack_window_s: float = 3.0,
                 clock=time.monotonic):
        self.session = str(session)
        self.enabled = recovery_enabled() if enabled is None else bool(enabled)
        self.fec_max = max_fec_pct() if fec_max is None else int(fec_max)
        self.alpha = float(alpha)
        self.clean_loss = float(clean_loss)
        self.fec_loss = float(fec_loss)
        self.recover_after = int(recover_after)
        self.undegrade_after = int(undegrade_after)
        self.degrade_after = int(degrade_after)
        self.window_s = float(window_s)
        self.idr_floor_s = float(idr_floor_s)
        self.nack_window_s = float(nack_window_s)
        self._clock = clock
        # outputs (wired by the orchestrator / fleet)
        self.on_set_fec = lambda pct: None
        self.on_force_idr = lambda: None
        self.on_degrade = lambda: None
        self.on_undegrade = lambda: None
        # state
        self.fec_pct = 0
        self.rung = 0
        self.smoothed_loss = 0.0
        self._calm_reports = 0      # reports with target pct below current
        self._healthy_reports = 0   # reports at/below clean_loss
        self._last_nack = float("-inf")
        self._last_idr = float("-inf")
        self._unrec_times: list[float] = []
        self._degraded = False
        # counters (stats() / the /statz recovery block)
        self.nacks_total = 0
        self.unrecoverable_total = 0
        self.idr_forced_total = 0
        self.degrades_total = 0
        self.undegrades_total = 0

    # -- session lifecycle --------------------------------------------

    def attach(self) -> None:
        """Apply the current protection level to a (re)started session's
        fresh peer: a clean-link session starts at 0 % FEC instead of
        the static constructor default."""
        if self.enabled:
            self.on_set_fec(self.fec_pct)

    # -- inputs -------------------------------------------------------

    def on_loss_report(self, fraction: float) -> None:
        """RTCP RR loss fraction (the same tap GCC consumes)."""
        if not self.enabled:
            return
        f = max(0.0, min(1.0, float(fraction)))
        self.smoothed_loss = self.alpha * f + (1 - self.alpha) * self.smoothed_loss
        target = self._target_pct(self.smoothed_loss)
        if target > self.fec_pct:
            # more loss: protect immediately
            self._calm_reports = 0
            self._set_fec(target)
        elif target < self.fec_pct:
            # less loss: lower only after a sustained calm window — the
            # supervisor ladder's hysteresis shape (one flap must not
            # thrash the group size)
            self._calm_reports += 1
            if self._calm_reports >= self.recover_after:
                self._calm_reports = 0
                self._set_fec(target)
        else:
            self._calm_reports = 0
        if f <= self.clean_loss:
            self._healthy_reports += 1
            if self._degraded and self._healthy_reports >= self.undegrade_after:
                self._degraded = False
                self._healthy_reports = 0
                self._unrec_times.clear()
                self.undegrades_total += 1
                logger.info("recovery: link healthy — reversing degradation "
                            "(session %s)", self.session)
                self.on_undegrade()
                self._transition("undegrade")
        else:
            self._healthy_reports = 0
        self._update_rung()

    def on_nack(self, n_seqs: int) -> None:
        """NACKs arrived and the RTX ring is answering them (first rung)."""
        if not self.enabled:
            return
        self.nacks_total += int(n_seqs)
        self._last_nack = self._clock()
        self._update_rung()

    def on_unrecoverable(self, seq: int) -> None:
        """A gap neither RTX nor FEC can close (NACKed seq aged out of
        the ring / past the FEC span): force ONE IDR through the
        existing keyframe path, and only escalate to the degradation
        rungs when this keeps happening with FEC already at its cap."""
        if not self.enabled:
            return
        now = self._clock()
        self.unrecoverable_total += 1
        self._unrec_times = [t for t in self._unrec_times
                             if now - t <= self.window_s]
        self._unrec_times.append(now)
        if now - self._last_idr >= self.idr_floor_s:
            self._last_idr = now
            self.idr_forced_total += 1
            logger.warning("recovery: unrecoverable gap at seq %d — forcing "
                           "IDR (session %s)", seq, self.session)
            self.on_force_idr()
            self._transition("force_idr", seq=int(seq))
        if (not self._degraded and self.fec_pct >= self.fec_max
                and len(self._unrec_times) >= self.degrade_after):
            self._degraded = True
            self._healthy_reports = 0
            self.degrades_total += 1
            logger.warning("recovery: sustained unrecoverable loss with FEC "
                           "at cap — degrading (session %s)", self.session)
            self.on_degrade()
            self._transition("degrade")
        self._update_rung()

    # -- internals ----------------------------------------------------

    def _target_pct(self, loss: float) -> int:
        """FEC adaptation curve: 0 below ``fec_loss``, then ~2x the
        smoothed loss fraction quantized to 5 % steps (5 % loss -> 10 %
        FEC -> one parity per 10 packets), capped at ``fec_max``."""
        if loss < self.fec_loss:
            return 0
        pct = int(math.ceil(loss * 200.0 / 5.0)) * 5
        return max(5, min(self.fec_max, pct))

    def _set_fec(self, pct: int) -> None:
        if pct == self.fec_pct:
            return
        self.fec_pct = pct
        self.on_set_fec(pct)
        self._transition("set_fec", pct=pct,
                         loss=round(self.smoothed_loss, 4))

    def _update_rung(self) -> None:
        now = self._clock()
        if self._degraded:
            rung = 4
        elif any(now - t <= self.window_s for t in self._unrec_times):
            rung = 3
        elif self.fec_pct > 0:
            rung = 2
        elif now - self._last_nack <= self.nack_window_s:
            rung = 1
        else:
            rung = 0
        if rung != self.rung:
            self.rung = rung
            if telemetry.enabled:
                telemetry.gauge("selkies_recovery_rung", rung,
                                session=self.session)
            self._transition("rung", rung=rung, name=RUNG_NAMES[rung])

    def _transition(self, action: str, **fields) -> None:
        if telemetry.enabled:
            telemetry.event("recovery", session=self.session,
                            action=action, **fields)

    # -- observability ------------------------------------------------

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "rung": self.rung,
            "rung_name": RUNG_NAMES[self.rung],
            "fec_pct": self.fec_pct,
            "fec_max": self.fec_max,
            "smoothed_loss": round(self.smoothed_loss, 4),
            "degraded": self._degraded,
            "nacks": self.nacks_total,
            "unrecoverable": self.unrecoverable_total,
            "idr_forced": self.idr_forced_total,
            "degrades": self.degrades_total,
            "undegrades": self.undegrades_total,
        }
