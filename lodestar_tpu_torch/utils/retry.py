"""sleep / retry / timeout helpers.

Reference: packages/utils/src/{sleep,retry,timeout}.ts.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Optional, TypeVar

T = TypeVar("T")


class TimeoutError_(Exception):
    """Named to avoid shadowing the builtin in `from retry import *` use."""


async def sleep(seconds: float) -> None:
    await asyncio.sleep(seconds)


async def with_timeout(aw: Awaitable[T], seconds: float) -> T:
    try:
        return await asyncio.wait_for(aw, timeout=seconds)
    except asyncio.TimeoutError:
        raise TimeoutError_(f"operation timed out after {seconds}s") from None


async def retry(
    fn: Callable[[int], Awaitable[T]],
    *,
    retries: int = 3,
    retry_delay: float = 0.0,
    should_retry: Optional[Callable[[BaseException], bool]] = None,
) -> T:
    """Call fn(attempt) up to `retries` times (reference retry.ts semantics:
    fn receives the 1-based attempt number; last error re-raised)."""
    last: Optional[BaseException] = None
    for attempt in range(1, retries + 1):
        try:
            return await fn(attempt)
        except Exception as e:  # noqa: BLE001
            last = e
            if should_retry is not None and not should_retry(e):
                raise
            if attempt < retries and retry_delay:
                await asyncio.sleep(retry_delay)
    assert last is not None
    raise last
