"""ForkChoice: the stateful wrapper over ProtoArray.

Reference: packages/fork-choice/src/forkChoice/forkChoice.ts:46 and
interface.ts (IForkChoice), store.ts (IForkChoiceStore).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .proto_array import ProtoArray, ProtoNode, VoteTracker, compute_deltas


@dataclasses.dataclass
class Checkpoint:
    epoch: int
    root: bytes


@dataclasses.dataclass
class ForkChoiceStore:
    """Justified/finalized tracking + justified balances (store.ts)."""

    current_slot: int
    justified_checkpoint: Checkpoint
    finalized_checkpoint: Checkpoint
    justified_balances: np.ndarray
    best_justified_checkpoint: Optional[Checkpoint] = None


class ForkChoiceError(Exception):
    pass


class ForkChoice:
    """on_block / on_attestation / update_head / prune.

    Proposer boost (PROPOSER_SCORE_BOOST) is applied as a transient weight
    delta on the next score pass (forkChoice.ts proposerBoostRoot).
    """

    def __init__(
        self,
        store: ForkChoiceStore,
        anchor: ProtoNode,
        proposer_boost_pct: int = 40,
        slots_per_epoch: int = 32,
    ):
        self.store = store
        self.proto = ProtoArray(
            justified_epoch=store.justified_checkpoint.epoch,
            finalized_epoch=store.finalized_checkpoint.epoch,
        )
        self.proto.on_block(anchor)
        self.votes: List[VoteTracker] = []
        self.balances = store.justified_balances.copy()
        self.proposer_boost_root: Optional[bytes] = None
        self.proposer_boost_pct = proposer_boost_pct
        self.slots_per_epoch = slots_per_epoch
        self._applied_boost: Optional[tuple] = None  # (root, amount) in current weights
        self._head: Optional[bytes] = None

    # -- time ---------------------------------------------------------------

    def update_time(self, slot: int) -> None:
        # boost lives for one slot: clear it only when the slot ADVANCES —
        # spec on_tick resets proposer_boost_root at slot boundaries, so an
        # intra-slot tick (e.g. the 1/3-slot attestation mark) must keep it
        if slot > self.store.current_slot:
            self.proposer_boost_root = None
        self.store.current_slot = slot

    # -- block import --------------------------------------------------------

    def on_block(
        self,
        slot: int,
        block_root: bytes,
        parent_root: bytes,
        state_root: bytes,
        target_root: bytes,
        justified_checkpoint: Checkpoint,
        finalized_checkpoint: Checkpoint,
        justified_balances: Optional[np.ndarray] = None,
        is_timely_proposal: bool = False,
        execution_status: str = "pre-merge",
        execution_block_hash: bytes = b"\x00" * 32,
    ) -> None:
        if not self.proto.has_block(parent_root):
            raise ForkChoiceError("unknown parent")
        if justified_checkpoint.epoch > self.store.justified_checkpoint.epoch:
            self.store.justified_checkpoint = justified_checkpoint
            if justified_balances is not None:
                self.store.justified_balances = justified_balances
        if finalized_checkpoint.epoch > self.store.finalized_checkpoint.epoch:
            self.store.finalized_checkpoint = finalized_checkpoint
        if is_timely_proposal:
            self.proposer_boost_root = block_root
        self.proto.on_block(
            ProtoNode(
                slot=slot,
                block_root=block_root,
                parent_root=parent_root,
                state_root=state_root,
                target_root=target_root,
                justified_epoch=justified_checkpoint.epoch,
                finalized_epoch=finalized_checkpoint.epoch,
                execution_status=execution_status,
                execution_block_hash=execution_block_hash,
            )
        )

    # -- attestations --------------------------------------------------------

    def on_attestation(self, validator_indices: Sequence[int], block_root: bytes, target_epoch: int) -> None:
        """Record LMD votes (forkChoice.ts onAttestation).  Unknown blocks
        must be filtered by the caller (unknown-block sync queue)."""
        for vi in validator_indices:
            vi = int(vi)
            while len(self.votes) <= vi:
                self.votes.append(VoteTracker())
            vote = self.votes[vi]
            if target_epoch > vote.next_epoch:
                vote.next_epoch = target_epoch
                vote.next_root = block_root

    # -- head ----------------------------------------------------------------

    def update_head(self) -> bytes:
        """Score pass + find_head (forkChoice.ts updateHead)."""
        new_balances = self.store.justified_balances
        deltas = compute_deltas(self.proto.indices, self.votes, self.balances, new_balances)
        # undo the previously applied boost, apply the current one
        # (forkChoice.ts previousProposerBoostRoot handling)
        if self._applied_boost is not None:
            old_root, old_amount = self._applied_boost
            oi = self.proto.indices.get(old_root)
            if oi is not None:
                deltas[oi] -= old_amount
            self._applied_boost = None
        if self.proposer_boost_root is not None:
            bi = self.proto.indices.get(self.proposer_boost_root)
            if bi is not None:
                # average committee weight per slot (getProposerScore:
                # total active balance / SLOTS_PER_EPOCH — preset-dependent,
                # 8 on minimal, 32 on mainnet)
                committee_weight = int(new_balances.sum()) // max(1, self.slots_per_epoch)
                boost = committee_weight * self.proposer_boost_pct // 100
                deltas[bi] += boost
                self._applied_boost = (self.proposer_boost_root, boost)
        self.proto.apply_score_changes(
            deltas,
            self.store.justified_checkpoint.epoch,
            self.store.finalized_checkpoint.epoch,
        )
        self.balances = new_balances.copy()
        self._head = self.proto.find_head(self.store.justified_checkpoint.root)
        return self._head

    def get_head(self) -> bytes:
        if self._head is None:
            return self.update_head()
        return self._head

    # -- maintenance ---------------------------------------------------------

    def prune(self, finalized_root: bytes):
        return self.proto.prune(finalized_root)

    def has_block(self, root: bytes) -> bool:
        return self.proto.has_block(root)

    def get_block(self, root: bytes):
        return self.proto.get_node(root)

    def is_descendant(self, ancestor: bytes, descendant: bytes) -> bool:
        return self.proto.is_descendant(ancestor, descendant)

    def get_ancestor(self, root: bytes, slot: int) -> Optional[bytes]:
        return self.proto.get_ancestor(root, slot)

    # -- optimistic sync (forkChoice.ts validateLatestHash) ------------------

    def on_valid_execution(self, root: bytes) -> None:
        for node in self.proto.iterate_ancestors(root):
            if node.execution_status == "syncing":
                node.execution_status = "valid"

    def on_invalid_execution(self, root: bytes) -> None:
        """Mark a block and all its descendants invalid, zero their weight
        out of every ancestor, and refresh best-child/best-descendant
        pointers so the next find_head provably lands on a valid branch
        (protoArray.ts propagateInvalidation + the applyScoreChanges
        invalid-node delta override)."""
        idx = self.proto.indices.get(root)
        if idx is None:
            return
        bad = {root}
        self.proto.nodes[idx].execution_status = "invalid"
        # descendants come after the parent: ProtoArray.on_block appends and
        # prune() preserves order, so one forward sweep covers the subtree
        for i in range(idx + 1, len(self.proto.nodes)):
            node = self.proto.nodes[i]
            if node.parent_root in bad:
                node.execution_status = "invalid"
                bad.add(node.block_root)
        # zero-delta score pass: apply_score_changes forces invalid nodes'
        # weight to 0 (subtracting the subtree from ancestors) and re-runs
        # the best-pointer bubble so pointers never target invalid nodes
        self.proto.apply_score_changes(
            np.zeros(len(self.proto.nodes), dtype=np.int64),
            self.store.justified_checkpoint.epoch,
            self.store.finalized_checkpoint.epoch,
        )
        self._head = None
