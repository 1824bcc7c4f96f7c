"""Resilience of the port: the per-slot supervisor and its recovery ladder
(``supervisor.py``), deterministic fault injection (``faultinject.py``, the
``SELKIES_FAULTS`` grammar) and the device health plane (``devhealth.py``:
the CUDA device pool, quarantine, probation and readmission).

Counterpart of ``selkies_tpu/resilience/``; the injector and the pool are
this package's own.
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
from selkies_tpu_torch.resilience.supervisor import (
    Backoff,
    RecoveryActions,
    Rung,
    SlotSupervisor,
)

__all__ = [
    "Backoff",
    "DeviceFault",
    "DevicePool",
    "FaultInjector",
    "InjectedFault",
    "RecoveryActions",
    "Rung",
    "SlotSupervisor",
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
