"""Sync: range sync + unknown-block (parent) sync.

Reference: packages/beacon-node/src/sync/ (sync.ts:16 orchestrator,
range/range.ts:76 batched range sync, unknownBlock.ts:26).
"""

from .range_sync import RangeSync, SyncState  # noqa: F401
from .unknown_block import UnknownBlockSync  # noqa: F401
