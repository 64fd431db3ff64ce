"""BackfillSync: fill history backward from a checkpoint anchor to genesis.

Reference: packages/beacon-node/src/sync/backfill/backfill.ts:106 (the
state machine: fetch batches backward, verify, persist, track
backfilledRanges) and backfill/verify.ts (hash-chain linkage back from the
trusted anchor + batched proposer-signature verification).

A checkpoint-synced node trusts one (state, block) pair.  Backfill extends
that trust backwards: each batch's last block must hash to the oldest
trusted parent root (the chain of parent_root links is the proof), and
every block's proposer signature is verified in ONE batched verifier call
— backfill is exactly the >=1000-set bulk workload the batched verifier
wants (SURVEY §2.6).
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

from ..config.chain_config import ChainConfig
from ..crypto.bls.verifier import VerificationDroppedError
from ..params import DOMAIN_BEACON_PROPOSER, Preset
from ..state_transition import compute_epoch_at_slot
from ..state_transition.domain import compute_domain, compute_signing_root
from ..state_transition.upgrade import block_types
from ..utils.logger import get_logger

logger = get_logger("backfill")

BACKFILL_BATCH_SLOTS = 64  # slots per backward batch (backfill.ts batch size class)


class BackfillSync:
    """Walks [genesis, anchor) backward via beaconBlocksByRange.

    The anchor is the checkpoint block the node booted from; `state` is
    the checkpoint state (its validator registry covers every historical
    proposer — registries are append-only)."""

    def __init__(
        self, preset: Preset, cfg: ChainConfig, db, bls_pool, anchor_state,
        anchor_block_root: bytes, peer_manager, metrics=None,
    ):
        self.p = preset
        self.metrics = metrics
        self.cfg = cfg
        self.db = db
        self.bls = bls_pool
        self.state = anchor_state
        self.peers = peer_manager
        # trust frontier: oldest verified block root + its slot
        self.oldest_root = anchor_block_root
        self.oldest_slot: Optional[int] = None  # unknown until first batch
        anchor = db.get_archived_block_by_root(anchor_block_root) or db.block.get(anchor_block_root)
        if anchor is not None:
            self.oldest_slot = anchor.message.slot
            self.oldest_root_parent = bytes(anchor.message.parent_root)
        else:
            self.oldest_root_parent = None
        self.backfilled_to: Optional[int] = None
        # pause before retrying a window whose verification the overloaded
        # BLS pool shed (tests set 0)
        self.shed_backoff_s = 1.0

    # -- verification ----------------------------------------------------------

    def _proposer_signature_sets(self, blocks: List) -> List:
        from ..crypto.bls.api import PublicKey
        from ..crypto.bls.verifier import SingleSignatureSet

        sets = []
        gvr = bytes(self.state.genesis_validators_root)
        from ..config.fork_config import ForkConfig

        fork_config = ForkConfig(self.cfg)
        for sb in blocks:
            block = sb.message
            epoch = compute_epoch_at_slot(self.p, block.slot)
            version = fork_config.get_fork_version(epoch)
            domain = compute_domain(self.p, DOMAIN_BEACON_PROPOSER, version, gvr)
            t = block_types(self.p, block)
            root = compute_signing_root(self.p, t.BeaconBlock, block, domain)
            vi = block.proposer_index
            if vi >= len(self.state.validators):
                raise ValueError(f"proposer {vi} outside registry")
            sets.append(
                SingleSignatureSet(
                    pubkey=PublicKey.from_bytes(bytes(self.state.validators[vi].pubkey)),
                    signing_root=root,
                    signature=bytes(sb.signature),
                )
            )
        return sets

    def _links(self, blocks: List) -> bool:
        """Cheap pre-check: does this batch's newest block hash into the
        trust frontier?  (Full verification happens in _verify_and_store;
        this only decides range-vs-by-root fetching.)"""
        if not blocks or self.oldest_root_parent is None:
            return False
        t = block_types(self.p, blocks[-1].message)
        return t.BeaconBlock.hash_tree_root(blocks[-1].message) == self.oldest_root_parent

    def _verify_linkage(self, blocks: List) -> None:
        """blocks ascending by slot; the newest must parent-link into the
        current trust frontier, and every adjacent pair must chain
        (verify.ts verifyBlockSequence)."""
        roots = []
        for sb in blocks:
            t = block_types(self.p, sb.message)
            roots.append(t.BeaconBlock.hash_tree_root(sb.message))
        for i in range(len(blocks) - 1):
            if bytes(blocks[i + 1].message.parent_root) != roots[i]:
                raise ValueError(f"broken parent chain at slot {blocks[i + 1].message.slot}")
        if self.oldest_root_parent is None:
            raise ValueError("anchor block unknown; cannot link backfill")
        if roots[-1] != self.oldest_root_parent:
            raise ValueError(
                "batch does not link into the trusted anchor "
                f"(want parent {self.oldest_root_parent.hex()[:12]})"
            )

    async def _verify_and_store(self, blocks: List) -> int:
        self._verify_linkage(blocks)
        sets = self._proposer_signature_sets(blocks)
        if sets and not await self.bls.verify_signature_sets(sets):
            raise ValueError("backfill batch proposer signatures invalid")
        for sb in blocks:
            t = block_types(self.p, sb.message)
            root = t.BeaconBlock.hash_tree_root(sb.message)
            self.db.archive_block(sb, root)
        first = blocks[0].message
        self.oldest_root_parent = bytes(first.parent_root)
        self.oldest_slot = first.slot
        self.backfilled_to = first.slot
        self.db.backfilled_ranges.put(
            b"backfill", {"oldest_slot": int(first.slot)}
        )
        if self.metrics:
            self.metrics.backfill_blocks_total.inc(len(blocks))
        return len(blocks)

    # -- driver ----------------------------------------------------------------

    async def run(self, max_batches: int = 10_000) -> int:
        """Backfill until genesis (slot 1) is reached or no peer can serve.
        Returns the number of blocks stored."""
        stored = 0
        batches = 0
        while batches < max_batches:
            if self.oldest_slot is not None and self.oldest_slot <= 1:
                logger.info("backfill complete: reached genesis")
                return stored
            peer = self._pick_peer()
            if peer is None:
                logger.warning("backfill stalled: no serving peer")
                return stored
            end = self.oldest_slot if self.oldest_slot is not None else None
            if end is None:
                return stored
            start = max(1, end - BACKFILL_BATCH_SLOTS)
            count = end - start
            if count <= 0:
                return stored
            batches += 1
            try:
                blocks = await peer.reqresp.blocks_by_range(start, count)
                if not blocks or not self._links(blocks):
                    # the parent may sit beyond the 64-slot window (long
                    # empty stretch): fetch it by ROOT and link through it
                    # before judging the peer (a fixed window
                    # can never cross a gap wider than itself)
                    by_root = await peer.reqresp.blocks_by_root([self.oldest_root_parent])
                    if by_root:
                        stored += await self._verify_and_store(by_root[:1])
                        continue
                    # nothing by range AND the parent unknown by root:
                    # withholding or pruned — try another peer
                    peer.penalize(5)
                    continue
                stored += await self._verify_and_store(blocks)
            except VerificationDroppedError as e:
                # the pool shed OUR job (overload admission, docs/overload.md)
                # — backfill deliberately rides the default lane so it is
                # among the first work shed under storm, but the node's own
                # admission decision must never score the serving peer.
                # Back off before retrying the window: looping straight
                # back into a full pool re-downloads 64 blocks per spin and
                # amplifies load during the exact condition shedding
                # relieves.
                logger.info("backfill batch shed by bls pool (%s); backing off", e.reason)
                await asyncio.sleep(self.shed_backoff_s)
                continue
            except Exception as e:  # noqa: BLE001
                peer.penalize(10)
                logger.warning("backfill batch failed: %s", e)
                continue
            logger.info(
                "backfill: %d blocks stored (oldest slot %s)", stored, self.oldest_slot
            )
        return stored

    def _pick_peer(self):
        best = None
        for p in self.peers.connected():
            if p.status is None:
                continue
            if p.score <= -30:
                continue
            if best is None or p.status.head_slot > best.status.head_slot:
                best = p
        return best
