"""ChainHeaderTracker: follow the node's head via the events SSE stream.

Reference: packages/validator/src/services/chainHeaderTracker.ts — the VC
subscribes to head events so attestation duties fire the moment the
slot's block arrives instead of blind at the 1/3-slot clock mark.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from ..api.client import ApiClient
from ..utils.logger import get_logger

logger = get_logger("header-tracker")


class ChainHeaderTracker:
    def __init__(self, api: ApiClient):
        self.api = api
        self.head_slot: int = -1
        self.head_root: Optional[str] = None
        self.events_seen = 0
        self._waiters: Dict[int, asyncio.Event] = {}
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            try:
                async for name, data in self.api.events("head"):
                    if name != "head":
                        continue
                    slot = int(data["slot"])
                    self.head_slot = max(self.head_slot, slot)
                    self.head_root = data["block"]
                    self.events_seen += 1
                    ev = self._waiters.pop(slot, None)
                    if ev is not None:
                        ev.set()
                # clean EOF also backs off: an immediately-closing server
                # must not become a tight reconnect loop
                logger.warning("events stream ended; reconnecting in 1s")
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reconnect on stream loss
                # WARNING, not debug: a node without /eth/v1/events leaves
                # the VC degraded to clock-only attesting — say so
                logger.warning("events stream unavailable (%s); retrying", e)
            await asyncio.sleep(1.0)

    async def wait_for_slot_head(self, slot: int, timeout: float) -> bool:
        """True when the head for `slot` arrived (possibly already);
        False when the deadline passed first — the caller then attests on
        the clock, exactly the reference's fallback."""
        if self.head_slot >= slot:
            return True
        ev = self._waiters.setdefault(slot, asyncio.Event())
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            self._waiters.pop(slot, None)
