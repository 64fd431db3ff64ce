"""State regeneration + state caches.

Reference: packages/beacon-node/src/chain/regen/ (QueuedStateRegenerator:27 /
StateRegenerator) and chain/stateCache/ (StateContextCache LRU max 96,
CheckpointStateCache).

Regen answers "give me the state at X" from caches first, else by replaying
blocks from the nearest cached ancestor state (regen.ts getState flow).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from ..config.chain_config import ChainConfig
from ..params import Preset
from ..state_transition import clone_state, process_slots, state_transition
from ..types import get_types


class RegenError(Exception):
    pass


class StateContextCache:
    """block-root -> post-state LRU (stateContextCache.ts, MAX_STATES=96)."""

    MAX_STATES = 96

    def __init__(self, max_states: int = MAX_STATES):
        self.max_states = max_states
        self._map: "collections.OrderedDict[bytes, object]" = collections.OrderedDict()

    def get(self, block_root: bytes):
        state = self._map.get(block_root)
        if state is not None:
            self._map.move_to_end(block_root)
        return state

    def add(self, block_root: bytes, state) -> None:
        self._map[block_root] = state
        self._map.move_to_end(block_root)
        while len(self._map) > self.max_states:
            self._map.popitem(last=False)

    def delete(self, block_root: bytes) -> None:
        self._map.pop(block_root, None)

    def __len__(self):
        return len(self._map)


class CheckpointStateCache:
    """(epoch, root) -> epoch-boundary state (stateContextCheckpointsCache.ts)."""

    MAX = 64

    def __init__(self):
        self._map: "collections.OrderedDict[Tuple[int, bytes], object]" = collections.OrderedDict()

    def get(self, epoch: int, root: bytes):
        return self._map.get((epoch, root))

    def add(self, epoch: int, root: bytes, state) -> None:
        self._map[(epoch, root)] = state
        while len(self._map) > self.MAX:
            self._map.popitem(last=False)

    def prune_finalized(self, finalized_epoch: int) -> None:
        for k in list(self._map):
            if k[0] < finalized_epoch:
                del self._map[k]


class StateRegenerator:
    """getPreState / getBlockSlotState / getState (regen.ts), replaying from
    block storage when the cache misses."""

    def __init__(self, preset: Preset, cfg: ChainConfig, block_source, state_cache: StateContextCache, metrics=None):
        self.p = preset
        self.cfg = cfg
        self.blocks = block_source  # mapping block_root -> SignedBeaconBlock
        self.cache = state_cache
        self.metrics = metrics
        self.t = get_types(preset).phase0

    def get_state_by_block_root(self, block_root: bytes, max_replay: int = 32):
        """State after applying the block at `block_root` (getState)."""
        import time

        cached = self.cache.get(block_root)
        if cached is not None:
            if self.metrics:
                self.metrics.state_cache_hits_total.inc()
            return cached
        if self.metrics:
            self.metrics.state_cache_misses_total.inc()
        t0 = time.monotonic()
        # walk back to a cached ancestor, replaying forward
        chain: List[object] = []
        root = block_root
        while True:
            block = self.blocks.get(root)
            if block is None:
                raise RegenError(f"block {root.hex()[:12]} not available for replay")
            chain.append(block)
            if len(chain) > max_replay:
                raise RegenError("replay distance exceeded")
            parent = bytes(block.message.parent_root)
            state = self.cache.get(parent)
            if state is not None:
                break
            root = parent
        if self.metrics:
            self.metrics.regen_replays_total.inc(len(chain))
        for block in reversed(chain):
            state, _ = state_transition(
                self.p, self.cfg, state, block,
                verify_proposer_signature=False,
                verify_signatures=False,
                verify_state_root=True,
            )
            broot = self.t.BeaconBlock.hash_tree_root(block.message)
            self.cache.add(broot, state)
        if self.metrics:
            self.metrics.regen_seconds.observe(time.monotonic() - t0)
        return state

    def get_pre_state(self, block) -> object:
        """Pre-state for importing `block` (getPreState): parent post-state
        advanced to the block's slot is the caller's job (STF does it)."""
        return self.get_state_by_block_root(bytes(block.message.parent_root))

    def get_block_slot_state(self, block_root: bytes, slot: int):
        state = self.get_state_by_block_root(block_root)
        if state.slot > slot:
            raise RegenError("requested slot is before the block's state")
        if state.slot == slot:
            return state
        out = clone_state(self.p, state)
        process_slots(self.p, self.cfg, out, slot)
        return out
