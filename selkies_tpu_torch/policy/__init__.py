"""Scenario-adaptive encode policy — close the static-knob loop.

The port's copy of ``selkies_tpu/policy/``, with the same
``SELKIES_POLICY*`` switches, on the port's telemetry bus and fault
injector (the ``policy`` site).

Every encoder mode the previous PRs built (tile-cache remaps, grouped
dispatch, delta bands, device entropy, LTR restore, degradation rungs)
is picked by a static env knob at startup (tools/check_env_knobs.py
counts them), so a session tuned for desktop typing burns chips during
video playback and a session tuned for video pays latency while typing.
This package classifies the live workload from signals the serving path
already produces (frame upload class, dirty/remap tile fractions, skip
ratio, downlink mode, congestion RTT/loss/estimate) into scenario
classes — idle, typing, scroll, window drag, video, game — and retunes
the runtime-safe knobs through a small actuation interface, with
hysteresis + dwell so classification flaps never thrash recompiles.

Off by default: ``SELKIES_POLICY=1`` enables it, and with the knob unset
(or ``0``) no policy object is ever constructed — the encoded bytes are
identical to a build without this package. ``SELKIES_POLICY_PRESET``
picks the knob matrix (``latency`` / ``balanced`` / ``throughput``).

See docs/policy.md for the signal table, classifier thresholds,
per-scenario knob matrix, and the byte-safety contract every actuated
knob must satisfy.
"""

from __future__ import annotations

import os

from selkies_tpu_torch.policy.actuation import EncoderActuator
from selkies_tpu_torch.policy.classifier import (
    Scenario,
    SignalWindow,
    categorize_frame,
    classify_window,
)
from selkies_tpu_torch.policy.engine import PolicyEngine, PolicyRuntime
from selkies_tpu_torch.policy.presets import PRESETS, KnobPlan, plan_for

__all__ = [
    "EncoderActuator",
    "KnobPlan",
    "PolicyEngine",
    "PolicyRuntime",
    "PRESETS",
    "Scenario",
    "SignalWindow",
    "categorize_frame",
    "classify_window",
    "plan_for",
    "policy_enabled",
    "preset_from_env",
]

ENV_VAR = "SELKIES_POLICY"
PRESET_ENV_VAR = "SELKIES_POLICY_PRESET"


def policy_enabled() -> bool:
    """``SELKIES_POLICY=1`` opts in; unset/0 means the serving paths
    never construct a policy object (byte-identical to pre-policy
    builds by construction, not by discipline)."""
    return os.environ.get(ENV_VAR, "0").strip().lower() in (
        "1", "true", "on", "yes")


def preset_from_env(default: str = "balanced") -> str:
    """``SELKIES_POLICY_PRESET`` -> a registered preset name; malformed
    values fall back rather than failing session start."""
    name = os.environ.get(PRESET_ENV_VAR, "").strip().lower() or default
    if name not in PRESETS:
        import logging

        logging.getLogger("policy").warning(
            "%s=%r is not one of %s; using %r", PRESET_ENV_VAR, name,
            sorted(PRESETS), default)
        return default
    return name
