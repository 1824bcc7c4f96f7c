"""Observability of the port: the tracer (``tracing.py``), the
frame-correlated telemetry bus (``telemetry.py``), the black-box flight
recorder (``flightrecorder.py``), the recompile sentinel (``jitprof.py``),
the card's monitor (``device_monitor.py``), the Prometheus exporter
(``metrics.py``) and the host's monitor (``system_monitor.py``).

Counterpart of ``selkies_tpu/monitoring/``; the tracer, bus and sentinel
are this package's own process-wide singletons, separate from JAX's.
"""

from selkies_tpu_torch.monitoring.device_monitor import DeviceMonitor
from selkies_tpu_torch.monitoring.flightrecorder import FlightRecorder, OutlierTrigger
from selkies_tpu_torch.monitoring.metrics import Metrics
from selkies_tpu_torch.monitoring.system_monitor import SystemMonitor
from selkies_tpu_torch.monitoring.telemetry import Telemetry, telemetry
from selkies_tpu_torch.monitoring.tracing import Tracer, tracer

__all__ = ["DeviceMonitor", "FlightRecorder", "Metrics", "OutlierTrigger", "SystemMonitor",
           "Telemetry", "Tracer", "telemetry", "tracer"]
