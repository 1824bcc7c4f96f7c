"""Tiny asyncio helpers shared across the signalling and transport layers.

The port's copy of ``selkies_tpu/utils/aio.py``, unchanged.
"""

from __future__ import annotations

import asyncio
from typing import Any


async def maybe_await(result: Any) -> None:
    """Await `result` if the callback returned a coroutine (callbacks across
    the codebase may be sync or async)."""
    if asyncio.iscoroutine(result):
        await result
