"""Host system monitor + the session ping timer.

The port's copy of ``selkies_tpu/monitoring/system_monitor.py``, unchanged.

Parity: reference system_monitor.py — 1 s psutil CPU/memory sampling; the
``on_timer`` callback doubles as the latency-ping trigger (the orchestrator
wires it to ``send_ping``, reference __main__.py:866-869).
"""

from __future__ import annotations

import asyncio
import logging
import time

import psutil

logger = logging.getLogger("system_monitor")


class SystemMonitor:
    def __init__(self, period: float = 1.0, enabled: bool = True):
        self.period = period
        self.enabled = enabled
        self.running = False
        self.cpu_percent = 0.0
        self.mem_total = 0
        self.mem_used = 0
        self.on_timer = lambda ts: logger.warning("unhandled on_timer")

    async def start(self) -> None:
        self.running = True
        next_sample = time.monotonic()
        while self.running:
            now = time.monotonic()
            if self.enabled and now >= next_sample:
                next_sample = now + self.period
                self.cpu_percent = await asyncio.to_thread(psutil.cpu_percent)
                mem = psutil.virtual_memory()
                self.mem_total = mem.total
                self.mem_used = mem.used
                try:
                    self.on_timer(time.time())
                except Exception:
                    logger.exception("on_timer callback failed")
            await asyncio.sleep(min(0.5, self.period / 2))
        logger.info("system monitor stopped")

    def stop(self) -> None:
        self.running = False
