"""Device resolution for the port's entry points, and constant tables.

``None`` means ``cuda``: the port is written for the card, and a caller
that wants the CPU (the parity tests) says so with ``device="cpu"``. A
missing card raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def constant_tables(tables: dict):
    """-> ``get(name, device)``: ``tables[name]`` (a numpy array) as a
    tensor on ``device``, copied there once per device. A copy from
    pageable host memory on every call would synchronise the stream, which
    the pipelined encoder's submit thread must never do."""

    @functools.lru_cache(maxsize=None)
    def get(name: str, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(tables[name])).to(device)

    return get
