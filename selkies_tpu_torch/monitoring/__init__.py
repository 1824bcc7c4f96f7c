"""Observability of the port: the tracer (``tracing.py``), the
frame-correlated telemetry bus (``telemetry.py``), the black-box flight
recorder (``flightrecorder.py``), the recompile sentinel (``jitprof.py``)
and the card's monitor (``device_monitor.py``).

Counterpart of ``selkies_tpu/monitoring/``; the tracer, bus and sentinel
are this package's own process-wide singletons, separate from JAX's.
"""

from selkies_tpu_torch.monitoring.device_monitor import DeviceMonitor
from selkies_tpu_torch.monitoring.flightrecorder import FlightRecorder, OutlierTrigger
from selkies_tpu_torch.monitoring.telemetry import Telemetry, telemetry
from selkies_tpu_torch.monitoring.tracing import Tracer, tracer

__all__ = ["DeviceMonitor", "FlightRecorder", "OutlierTrigger", "Telemetry", "Tracer",
           "telemetry", "tracer"]
