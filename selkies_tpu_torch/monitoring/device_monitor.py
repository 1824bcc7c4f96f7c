"""CUDA device monitor — the port's counterpart of
``selkies_tpu/monitoring/tpu_monitor.py`` (``TPUMonitor``).

Where the reference polls GPUtil for load / memoryTotal / memoryUsed and
feeds the ``gpu_stats`` data channel, this samples the card: its memory
from ``torch.cuda.mem_get_info(device)`` (total, and used = total - free,
for every process on the card, as GPUtil reports it) and a load proxy
derived from the encode pipeline's duty cycle (device_ms per frame
interval), pushed in by the pipeline via ``observe_encode``. Stats arrive
at the same ``on_stats(load, memory_total_mb, memory_used_mb)`` callback
shape as JAX's monitor, in the same MB of 1e6 bytes.
"""

from __future__ import annotations

import asyncio
import logging
import time

import torch

from selkies_tpu_torch.device import resolve_device

logger = logging.getLogger("device_monitor")

__all__ = ["DeviceMonitor"]


class DeviceMonitor:
    """``device=None`` means ``cuda`` and raises without a card."""

    def __init__(self, period: float = 1.0, enabled: bool = True, device=None):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceMonitor reads a CUDA card's memory, not {self.device}")
        self.period = period
        self.enabled = enabled
        self.running = False
        self._busy_ms = 0.0  # encode device-time accumulated this period
        self._window_start = time.monotonic()
        self.on_stats = lambda load, memory_total, memory_used: logger.warning(
            "unhandled on_stats"
        )

    # pipeline hook: called per encoded frame with device milliseconds
    def observe_encode(self, device_ms: float) -> None:
        self._busy_ms += device_ms

    def _load(self) -> float:
        now = time.monotonic()
        elapsed_ms = (now - self._window_start) * 1e3
        self._window_start = now
        busy, self._busy_ms = self._busy_ms, 0.0
        if elapsed_ms <= 0:
            return 0.0
        return min(1.0, busy / elapsed_ms)

    def _memory_mb(self) -> tuple[float, float]:
        """(total MB, used MB) of the card."""
        free, total = torch.cuda.mem_get_info(self.device)
        return total / 1e6, (total - free) / 1e6

    async def start(self) -> None:
        self.running = True
        while self.running:
            if self.enabled:
                total_mb, used_mb = await asyncio.to_thread(self._memory_mb)
                try:
                    self.on_stats(self._load(), total_mb, used_mb)
                except Exception:
                    logger.exception("on_stats callback failed")
            await asyncio.sleep(self.period)
        logger.info("device monitor stopped")

    def stop(self) -> None:
        self.running = False
