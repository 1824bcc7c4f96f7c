"""Knob actuation: apply a KnobPlan to a live encoder, safely.

The port's copy of ``selkies_tpu/policy/actuation.py``; it drives the port
encoder's ``set_tile_cache``, ``set_batch_cap``, ``retune_entropy`` and
``keyframe_interval``.

The actuator is the ONLY thing in the policy package that touches an
encoder, and it only calls the small runtime-retune surface the encoder
rows explicitly export (capability-discovered with ``hasattr`` so the
same actuator fronts the solo TorchH264Encoder, the banded encoder, or a
software row that supports none of it):

* ``set_tile_cache(bool)`` — uplink-only; remapped tiles reproduce the
  exact bytes an upload would, so toggling is byte-safe at any frame
  boundary (the tile cache's bit-exactness contract).
* ``set_batch_cap(n)`` — grouped-vs-single delta dispatch is
  byte-identical (tests/test_sparse_native_pack.py), and the cap snaps
  to already-compiled scan sizes, so no flap can trigger a compile.
* ``retune_entropy(...)`` — device-entropy bits vs coefficient rows is
  byte-identical (tests/test_device_entropy_sparse.py) but rebuilds
  jitted partials, so the actuator DRAINS the pipeline first (the
  host-provided ``drain`` callback completes and delivers every
  in-flight frame) — this is the expensive transition the engine's
  dwell exists to protect.
* ``keyframe_interval`` — a GOP posture is inherently IDR-boundary:
  the encoder reads it per frame and only ever acts on it by opening a
  new IDR, which is the byte-safety contract for stream-altering knobs
  (docs/policy.md).

``refresh()`` re-captures defaults whenever the encoder IDENTITY
changes (supervisor restart, resize rebuild, codec swap) so the merged
plans always describe the live object, and the caller can re-apply the
current scenario to the fresh encoder.
"""

from __future__ import annotations

import logging

from selkies_tpu_torch.policy.presets import (
    BATCH_HALF,
    BATCH_MAX,
    BATCH_MIN,
    KnobPlan,
)

logger = logging.getLogger("policy.actuation")

__all__ = ["EncoderActuator"]


class EncoderActuator:
    """Applies knob plans to whatever encoder ``get_encoder()`` returns.

    ``drain`` (optional) must complete and DELIVER every in-flight frame
    of the encoder — required before retune_entropy (which rebuilds the
    jitted delta steps and the downlink sizing those frames' completion
    reads). Hosts without pipelining pass None.
    """

    def __init__(self, get_encoder, drain=None):
        self._get = get_encoder
        self._drain = drain
        self._enc = None
        self._defaults: KnobPlan | None = None

    # -- encoder identity ---------------------------------------------

    def refresh(self) -> bool:
        """Re-resolve the encoder; True when it changed (caller should
        re-apply the current scenario plan to the new instance)."""
        enc = self._get()
        if enc is self._enc:
            return False
        self._enc = enc
        self._defaults = self._capture(enc) if enc is not None else None
        return enc is not None

    def defaults(self) -> KnobPlan | None:
        if self._enc is None:
            self.refresh()
        return self._defaults

    @staticmethod
    def _capture(enc) -> KnobPlan:
        """The encoder's constructed knob state — what 'None' in a plan
        and a policy disarm both mean."""
        return KnobPlan(
            scenario="defaults",
            tile_cache=getattr(enc, "_tcache", None) is not None,
            batch_cap=BATCH_MAX,
            device_entropy=getattr(enc, "device_entropy", None),
            bits_min_mbs=getattr(enc, "bits_min_mbs", None),
            keyframe_interval=getattr(enc, "keyframe_interval", None),
        )

    # -- application ---------------------------------------------------

    def _resolve_batch(self, enc, cap: str) -> int:
        fb = max(1, int(getattr(enc, "frame_batch", 1)))
        if cap == BATCH_MIN:
            return 1
        if cap == BATCH_HALF:
            return max(1, fb // 2)
        return fb

    def apply(self, plan: KnobPlan) -> list[str]:
        """Apply one merged plan; returns the knob names that actually
        changed encoder state. Each knob is individually guarded — a
        failing actuation is logged and skipped so one broken knob
        cannot leave the plan half-applied (the remaining knobs still
        land); only the guard bookkeeping itself can raise out to the
        PolicyRuntime, which disarms after repeats."""
        if self._enc is None and not self.refresh():
            return []
        enc = self._enc
        if self._defaults is not None:
            plan = plan.merged_over(self._defaults)
        applied: list[str] = []

        def _knob(name, fn):
            try:
                if fn():
                    applied.append(name)
            except Exception:
                logger.exception("policy actuation %s failed on [%s]; "
                                 "skipped", name, plan.scenario)

        if plan.tile_cache is not None and hasattr(enc, "set_tile_cache"):
            _knob("tile_cache", lambda: enc.set_tile_cache(plan.tile_cache))
        if plan.batch_cap is not None and hasattr(enc, "set_batch_cap"):
            _knob("batch_cap", lambda: enc.set_batch_cap(
                self._resolve_batch(enc, plan.batch_cap)))
        if (plan.device_entropy is not None
                and hasattr(enc, "retune_entropy")
                and (bool(getattr(enc, "device_entropy", False))
                     != bool(plan.device_entropy)
                     or (plan.bits_min_mbs is not None
                         and plan.bits_min_mbs
                         != getattr(enc, "bits_min_mbs", None)))):
            # expensive rung: rebuilds jitted partials; in-flight frames'
            # completion reads the sizing being replaced, so drain first
            # — EXCEPT the threshold-only case with the device coder
            # disabled, which the encoder handles as pure bookkeeping
            # (no consts rebuild, nothing in flight reads it)
            def _retune():
                mode_flip = (bool(getattr(enc, "device_entropy", False))
                             != bool(plan.device_entropy))
                if self._drain is not None and (
                        mode_flip or getattr(enc, "device_entropy", False)):
                    self._drain()
                return enc.retune_entropy(
                    device_entropy=plan.device_entropy,
                    bits_min_mbs=plan.bits_min_mbs)

            _knob("device_entropy", _retune)
        if (plan.keyframe_interval is not None
                and hasattr(enc, "keyframe_interval")
                and int(getattr(enc, "keyframe_interval"))
                != int(plan.keyframe_interval)):
            def _gop():
                enc.keyframe_interval = int(plan.keyframe_interval)
                return True

            _knob("keyframe_interval", _gop)
        if applied:
            logger.info("policy actuation [%s]: %s", plan.scenario,
                        ", ".join(applied))
        return applied

    def restore_defaults(self) -> list[str]:
        """Back to the constructed static knobs (policy disarm: a wedged
        engine must leave the session exactly as a SELKIES_POLICY=0 run
        would have it)."""
        d = self.defaults()
        return self.apply(d) if d is not None else []
