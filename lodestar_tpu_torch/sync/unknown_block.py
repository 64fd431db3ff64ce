"""Unknown-block (parent) sync: fetch missing ancestors by root.

Reference: packages/beacon-node/src/sync/unknownBlock.ts:26 — when gossip
delivers a block whose parent is unknown, fetch the ancestor chain by
root (up to a bound) from a peer and import oldest-first.
"""

from __future__ import annotations

from typing import List

from ..params import Preset
from ..utils.logger import get_logger

logger = get_logger("unknown-block-sync")

MAX_ANCESTORS = 32


class UnknownBlockSync:
    def __init__(self, preset: Preset, chain, peer_manager):
        self.p = preset
        self.chain = chain
        self.peers = peer_manager

    async def resolve(self, signed_block) -> bool:
        """Fetch the missing ancestor chain for `signed_block`, then import
        it plus the block.  True on success."""
        peer = self.peers.best_peer_for_sync()
        if peer is None:
            return False
        chain: List[object] = [signed_block]
        parent = bytes(signed_block.message.parent_root)
        for _ in range(MAX_ANCESTORS):
            if self.chain.fork_choice.has_block(parent):
                break
            got = await peer.reqresp.blocks_by_root([parent])
            if not got:
                logger.warning("peer missing ancestor %s", parent.hex()[:12])
                return False
            blk = got[0]
            chain.append(blk)
            parent = bytes(blk.message.parent_root)
        else:
            return False
        for blk in reversed(chain):
            await self.chain.process_block(blk)
        return True
