"""Slot clock + typed chain event bus.

Reference: packages/beacon-node/src/chain/clock/LocalClock.ts:14.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional

from ..tracing import TRACER


class LocalClock:
    """Slot/epoch ticker.  ``now_fn`` is injectable so tests and the dev
    chain can drive time manually (the reference's sim tests tick real
    timers; manual time is both faster and deterministic)."""

    def __init__(
        self,
        genesis_time: int,
        seconds_per_slot: int,
        slots_per_epoch: int,
        now_fn: Callable[[], float] = time.time,
    ):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self.slots_per_epoch = slots_per_epoch
        self.now_fn = now_fn

    @property
    def current_slot(self) -> int:
        return max(0, int(self.now_fn() - self.genesis_time) // self.seconds_per_slot)

    @property
    def current_epoch(self) -> int:
        return self.current_slot // self.slots_per_epoch

    def slot_start_time(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        return (self.now_fn() - self.genesis_time) % self.seconds_per_slot

    def is_current_slot_given_disparity(self, slot: int, disparity_sec: float = 0.5) -> bool:
        """Gossip clock-disparity tolerance (LocalClock.ts helpers)."""
        lo = self.slot_start_time(slot) - disparity_sec
        hi = self.slot_start_time(slot + 1) + disparity_sec
        return lo <= self.now_fn() <= hi

    def annotate_slot(self, slot: int) -> None:
        """Drop a slot-boundary marker on the trace timeline so BLS spans
        can be read against slot/epoch edges."""
        if TRACER.enabled:
            TRACER.instant("clock.slot", cat="clock", slot=slot,
                           epoch=slot // self.slots_per_epoch)

    async def wait_for_slot(self, slot: int) -> None:
        delta = self.slot_start_time(slot) - self.now_fn()
        if delta > 0:
            await asyncio.sleep(delta)
        self.annotate_slot(slot)


class ManualClock(LocalClock):
    """A LocalClock whose time is advanced explicitly (dev chain / tests):
    ``set_slot(n)`` pins now() to the start of slot n."""

    def __init__(self, genesis_time: int, seconds_per_slot: int, slots_per_epoch: int):
        self._now = float(genesis_time)
        super().__init__(genesis_time, seconds_per_slot, slots_per_epoch, now_fn=lambda: self._now)

    def set_slot(self, slot: int, seconds_into: float = 0.0) -> None:
        self._now = self.genesis_time + slot * self.seconds_per_slot + seconds_into
        if seconds_into == 0.0:
            self.annotate_slot(slot)

    async def wait_for_slot(self, slot: int) -> None:
        self.set_slot(slot)
