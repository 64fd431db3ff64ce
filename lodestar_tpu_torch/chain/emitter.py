"""Typed chain event bus.

Reference: packages/beacon-node/src/chain/emitter.ts (ChainEventEmitter —
clockSlot/clockEpoch/block/checkpoint/justified/finalized/head/reorg).
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Callable, DefaultDict, List


class ChainEvent(str, enum.Enum):
    CLOCK_SLOT = "clock:slot"
    CLOCK_EPOCH = "clock:epoch"
    BLOCK = "block"
    CHECKPOINT = "checkpoint"
    JUSTIFIED = "justified"
    FINALIZED = "finalized"
    HEAD = "forkChoice:head"
    REORG = "forkChoice:reorg"
    LIGHT_CLIENT_FINALITY_UPDATE = "lightClient:finalityUpdate"
    LIGHT_CLIENT_OPTIMISTIC_UPDATE = "lightClient:optimisticUpdate"


class ChainEventEmitter:
    def __init__(self):
        self._handlers: DefaultDict[ChainEvent, List[Callable]] = defaultdict(list)

    def on(self, event: ChainEvent, handler: Callable) -> None:
        self._handlers[event].append(handler)

    def off(self, event: ChainEvent, handler: Callable) -> None:
        if handler in self._handlers[event]:
            self._handlers[event].remove(handler)

    def has_listeners(self, event: ChainEvent) -> bool:
        return bool(self._handlers.get(event))

    def emit(self, event: ChainEvent, *args) -> None:
        for handler in list(self._handlers[event]):
            handler(*args)
