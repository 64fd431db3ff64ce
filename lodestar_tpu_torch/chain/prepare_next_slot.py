"""PrepareNextSlotScheduler + ReprocessController.

Reference: packages/beacon-node/src/chain/prepareNextSlot.ts:30 (at 2/3 of
every slot, advance the head state to slot+1 so proposals/attestations at
the next slot start from a warm state) and chain/reprocess.ts:51
(attestations referencing an unknown head block wait — bounded — for that
block to arrive instead of being dropped).
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

from ..params import Preset
from ..state_transition import clone_state, process_slots
from ..utils.logger import get_logger
from .emitter import ChainEvent

logger = get_logger("prepare-next-slot")

REPROCESS_MAX_WAIT = 2.0  # seconds (reprocess.ts WAIT_TIME_BEFORE_REJECT)
REPROCESS_MAX_PENDING = 16_384


class PrepareNextSlotScheduler:
    """Precomputes (head_root, next_slot) -> advanced state; BeaconChain's
    produce_block and the gossip handlers consult the cache via
    get_prepared_state."""

    def __init__(self, preset: Preset, chain):
        self.p = preset
        self.chain = chain
        self._prepared: Optional[Tuple[bytes, int, object, object]] = None

    async def prepare(self, next_slot: int) -> None:
        import time

        head_root = self.chain.head_root
        state = clone_state(self.p, self.chain.head_state())
        if state.slot >= next_slot:
            return
        crosses_epoch = next_slot % self.p.SLOTS_PER_EPOCH == 0
        t0 = time.monotonic()
        ctx = process_slots(self.p, self.chain.cfg, state, next_slot)
        if crosses_epoch and self.chain.metrics:
            # the precomputed epoch transition — the cost the 2/3-slot tick
            # absorbs off the import path (lodestar.ts stfnEpochTransition)
            self.chain.metrics.epoch_transition_seconds.observe(
                time.monotonic() - t0
            )
        self._prepared = (head_root, next_slot, state, ctx)
        logger.debug("prepared state for slot %d on head %s", next_slot, head_root.hex()[:8])

    def get_prepared_state(self, head_root: bytes, slot: int):
        """(state, ctx) if the precomputation matches, else None."""
        if self._prepared is None:
            return None
        r, s, state, ctx = self._prepared
        if r == head_root and s == slot:
            return state, ctx
        return None


class ReprocessController:
    """awaitBlockOfAttestation: parks objects keyed by the missing block
    root; resolves them when the block is imported, rejects on timeout."""

    def __init__(self, chain):
        self.chain = chain
        self._waiting: Dict[bytes, List[asyncio.Future]] = {}
        chain.emitter.on(ChainEvent.BLOCK, self._on_block)

    def _on_block(self, signed_block, block_root: bytes) -> None:
        futs = self._waiting.pop(block_root, [])
        for f in futs:
            if not f.done():
                f.set_result(True)

    async def wait_for_block(self, root: bytes, timeout: float = REPROCESS_MAX_WAIT) -> bool:
        """True if the block arrived within the window."""
        if self.chain.fork_choice.has_block(root):
            return True
        total = sum(len(v) for v in self._waiting.values())
        if total >= REPROCESS_MAX_PENDING:
            return False
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._waiting.setdefault(root, []).append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            lst = self._waiting.get(root)
            if lst and fut in lst:
                lst.remove(fut)
                if not lst:
                    del self._waiting[root]
