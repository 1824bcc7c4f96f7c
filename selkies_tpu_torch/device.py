"""Device resolution for the port's entry points, constant tables, and the
host-device boundary that every encoder path crosses.

``None`` means ``cuda``: the port is written for the card, and a caller
that wants the CPU (the parity tests) says so with ``device="cpu"``. A
missing card raises instead of quietly running on the CPU.

The boundary is three pieces, shared by the solo row
(``models/h264/encoder.py``), the multi-session service
(``parallel/sessions.py``, ``parallel/serving.py``) and the band carve
(``parallel/bands.py``): ``to_device``, the enqueued upload; ``Fetch``,
a step's downlink copy between its step-done and fetched events, with the
tracer's ``gpu-step`` device span; and ``host``, the read that waits on
one event only.
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

from selkies_tpu_torch.monitoring.tracing import tracer


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_list(devices) -> list[torch.device]:
    """A device list as indexed ``torch.device``s, in order and with its
    repeats: ``cuda`` becomes ``cuda:<current>``. The per-device caches
    (``constant_tables``) key on the indexed device, so every device of a
    carve goes through here once."""
    return [resolve_device(d) for d in devices]


def constant_tables(tables: dict):
    """-> ``get(name, device)``: ``tables[name]`` (a numpy array) as a
    tensor on ``device``, copied there once per device. A copy from
    pageable host memory on every call would synchronise the stream, which
    the pipelined encoder's submit thread must never do."""

    @functools.lru_cache(maxsize=None)
    def get(name: str, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(tables[name])).to(device)

    return get


def host(a, after=None) -> np.ndarray:
    """One device-to-host copy of a tensor (numpy arrays pass through).
    ``after``: the CUDA event after which ``a`` is complete; the copy then
    waits for that event only (a side stream) and for nothing else."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    if after is None or a.device.type != "cuda":
        return a.cpu().numpy()
    stream = torch.cuda.Stream(a.device)  # one of PyTorch's pooled streams
    with torch.cuda.stream(stream):
        stream.wait_event(after)
        out = a.contiguous().to("cpu", non_blocking=True)
        done = torch.cuda.Event(blocking=True)
        done.record(stream)
    done.synchronize()
    return out.numpy()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy. On the card it is staged into pinned memory
    and enqueued (``non_blocking``): a blocking copy ends in a stream
    synchronise, which would wait for the steps of the frames in flight.
    PyTorch's caching host allocator keeps each pinned block until its copy
    is done, so the source buffer may be reused at once. On the CPU it is a
    copy too: the resident planes are written in place and must not alias
    host buffers."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        # on ``device``'s current stream, whatever the thread's current card
        with torch.cuda.device(device):
            return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


class Fetch:
    """One downlink buffer's device-to-host copy.

    On the card the copy is enqueued at dispatch, right behind the step
    that wrote the buffer, into pinned memory (``non_blocking``), between
    two events: ``step_done`` (the step finished) and ``fetched`` (the
    copy landed). The completion worker waits on those two events only,
    never on the device as a whole, so it does not wait for the steps of
    later frames. On the CPU the copy is made when the worker asks.

    Both events and the copy go on the current stream of the card that
    holds ``t``, whatever the thread's current card is: a mesh's band on
    ``cuda:1`` is fetched from ``cuda:1``.

    ``mark`` is the step's first-op event from ``tracer.gpu_mark`` (tracing
    on, a card): ``step_done`` is then a timing event, ``t_rec`` the host's
    time of its record, and the wait puts the step on the tracer's device
    track and sets ``tail_ms``, the card's execution of ``step_done`` minus
    ``t_rec``."""

    def __init__(self, t: torch.Tensor, mark=None):
        self.src = t
        self.step_done = self.fetched = self.host = None
        self.mark, self.tail_ms = mark, None
        if t.device.type == "cuda":
            stream = torch.cuda.current_stream(t.device)
            with torch.cuda.device(t.device):
                # blocking-sync events: a waiting worker sleeps instead of
                # spinning on a core the submit thread needs
                self.step_done = torch.cuda.Event(blocking=True, enable_timing=mark is not None)
                self.step_done.record(stream)
                if mark is not None:
                    self.t_rec = time.perf_counter()
                self.host = t.contiguous().to("cpu", non_blocking=True)
                self.fetched = torch.cuda.Event(blocking=True)
                self.fetched.record(stream)

    def wait(self, t_disp: float, *, step_span: bool = True,
             fetch_span: bool = False) -> tuple[np.ndarray, float, float]:
        """-> (host array, step ms since ``t_disp``, fetch ms). The wait on
        ``step_done`` is the tracer's ``step`` span unless ``step_span`` is
        False (a caller that waited already, under its own span); the copy
        is a ``fetch`` span where the JAX encoder opens one."""
        with tracer.span("step") if step_span else contextlib.nullcontext():
            if self.step_done is not None:
                self.step_done.synchronize()
        t_ready = time.perf_counter()
        if self.mark is not None:
            placed = tracer.gpu_span(self.mark, self.step_done)
            if placed is not None:
                self.tail_ms = (placed[1] - self.t_rec) * 1e3
        with tracer.span("fetch") if fetch_span else contextlib.nullcontext():
            if self.step_done is None:
                arr = np.ascontiguousarray(host(self.src))
            else:
                self.fetched.synchronize()
                arr = self.host.numpy()
        if tracer.enabled:
            # the downlink landed: the card may be idle, a moment to anchor
            tracer.gpu_anchor(self.src.device)
        return arr, (t_ready - t_disp) * 1e3, (time.perf_counter() - t_ready) * 1e3
