"""Resilience of the port: deterministic fault injection
(``faultinject.py``, the ``SELKIES_FAULTS`` grammar) and the device health
plane (``devhealth.py``: the CUDA device pool, quarantine, probation and
readmission).

Counterpart of ``selkies_tpu/resilience/`` less its supervisor, which is
not ported yet; the injector and the pool are this package's own.
"""

from selkies_tpu_torch.resilience.devhealth import (
    DeviceFault,
    DevicePool,
    check_device_faults,
    chip_key,
    get_device_pool,
    note_tick_failure,
    peek_device_pool,
    reset_device_pool,
    set_device_pool,
)
from selkies_tpu_torch.resilience.faultinject import (
    FaultInjector,
    InjectedFault,
    configure_faults,
    get_injector,
    reset_faults,
)

__all__ = [
    "DeviceFault",
    "DevicePool",
    "FaultInjector",
    "InjectedFault",
    "check_device_faults",
    "chip_key",
    "configure_faults",
    "get_device_pool",
    "get_injector",
    "note_tick_failure",
    "peek_device_pool",
    "reset_device_pool",
    "reset_faults",
    "set_device_pool",
]
