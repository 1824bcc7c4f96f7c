"""CUDA device monitor — the port's counterpart of
``selkies_tpu/monitoring/tpu_monitor.py`` (``TPUMonitor``).

Where the reference polls GPUtil for load / memoryTotal / memoryUsed and
feeds the ``gpu_stats`` data channel, this samples the card: its memory
from ``torch.cuda.mem_get_info(device)`` (total, and used = total - free,
for every process on the card, as GPUtil reports it) and its load from
NVML's kernel-active utilisation (``nvmlDeviceGetUtilizationRates``'s
``gpu``: the share of the driver's last sample period in which a kernel
ran on the card, GPUtil's own source), read through ``ctypes`` from the
driver's ``libnvidia-ml.so.1``. Where that library does not load, the
monitor logs once and reports a load of 0. Stats arrive at the same
``on_stats(load, memory_total_mb, memory_used_mb)`` callback shape as
JAX's monitor, in the same MB of 1e6 bytes.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging

import torch

logger = logging.getLogger("device_monitor")

__all__ = ["DeviceMonitor", "NvmlLoad"]

NVML_LIB = "libnvidia-ml.so.1"


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class NvmlLoad:
    """One card's kernel-active utilisation from NVML, as a share in [0, 1].

    The card is named by ``uuid`` (``GPU-...``, as NVML prints it) when
    given and NVML knows it, else by NVML ``index``. ``lib`` stands in for
    the loaded library (tests); by default ``libnvidia-ml.so.1`` is opened
    on the first read. A library that does not load, or a call that
    fails, logs once and reads 0."""

    def __init__(self, index: int = 0, uuid: str | None = None, lib=None):
        self.index, self.uuid = int(index), uuid
        self._lib, self._handle = lib, None
        self._failed = False

    def _fail(self, why: str) -> float:
        if not self._failed:
            logger.warning("no card load from NVML (%s): the monitor reports 0", why)
            self._failed = True
        return 0.0

    def _open(self):
        if self._lib is None:
            self._lib = ctypes.CDLL(NVML_LIB)
        lib = self._lib
        rc = lib.nvmlInit_v2()
        if rc != 0:
            raise OSError(f"nvmlInit_v2 returned {rc}")
        handle = ctypes.c_void_p()
        rc = (lib.nvmlDeviceGetHandleByUUID(self.uuid.encode(), ctypes.pointer(handle))
              if self.uuid is not None else -1)
        if rc != 0:
            rc = lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(self.index),
                                                   ctypes.pointer(handle))
        if rc != 0:
            raise OSError(f"no NVML handle for card {self.uuid or self.index} ({rc})")
        return handle

    def load(self) -> float:
        if self._failed:
            return 0.0
        try:
            if self._handle is None:
                self._handle = self._open()
            util = _Utilization()
            rc = self._lib.nvmlDeviceGetUtilizationRates(self._handle, ctypes.pointer(util))
        except (OSError, AttributeError) as exc:
            return self._fail(str(exc))
        if rc != 0:
            return self._fail(f"nvmlDeviceGetUtilizationRates returned {rc}")
        return min(1.0, util.gpu / 100.0)


def _nvml_uuid(device: torch.device) -> str | None:
    """The card's NVML name (``GPU-<uuid>``), which survives
    ``CUDA_VISIBLE_DEVICES`` renumbering; None where torch does not say."""
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    if uuid is None:
        return None
    text = str(uuid)
    return text if text.startswith("GPU-") else "GPU-" + text


class DeviceMonitor:
    """``device=None`` means ``cuda`` and raises without a card."""

    def __init__(self, period: float = 1.0, enabled: bool = True, device=None):
        # imported here: device.py imports the tracer, and so this package
        from selkies_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceMonitor reads a CUDA card's memory, not {self.device}")
        self.period = period
        self.enabled = enabled
        self.running = False
        index = self.device.index if self.device.index is not None else 0
        self._nvml = NvmlLoad(index, uuid=_nvml_uuid(self.device))
        self.on_stats = lambda load, memory_total, memory_used: logger.warning(
            "unhandled on_stats"
        )

    def _load(self) -> float:
        """The card's kernel-active share of NVML's last sample period."""
        return self._nvml.load()

    def _memory_mb(self) -> tuple[float, float]:
        """(total MB, used MB) of the card."""
        free, total = torch.cuda.mem_get_info(self.device)
        return total / 1e6, (total - free) / 1e6

    async def start(self) -> None:
        self.running = True
        while self.running:
            if self.enabled:
                total_mb, used_mb = await asyncio.to_thread(self._memory_mb)
                load = await asyncio.to_thread(self._load)
                try:
                    self.on_stats(load, total_mb, used_mb)
                except Exception:
                    logger.exception("on_stats callback failed")
            await asyncio.sleep(self.period)
        logger.info("device monitor stopped")

    def stop(self) -> None:
        self.running = False
