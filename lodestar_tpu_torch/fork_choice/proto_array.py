"""Proto-array LMD-GHOST fork choice core.

Reference: packages/fork-choice/src/protoArray/protoArray.ts:9 and
computeDeltas.ts:14.  The proto-array idea: keep blocks in insertion order
(parents before children), store per-node weight, and maintain
best_child/best_descendant pointers so find_head is O(1) after an O(n)
backward score pass.

The score pass is array-oriented (flat numpy deltas; single reversed
sweep) which is both the reference's own design and the layout a device
offload of the weight accumulation would use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ProtoNode:
    slot: int
    block_root: bytes
    parent_root: Optional[bytes]
    state_root: bytes
    target_root: bytes
    justified_epoch: int
    finalized_epoch: int
    parent: Optional[int] = None
    weight: int = 0
    best_child: Optional[int] = None
    best_descendant: Optional[int] = None
    # execution status for optimistic sync (forkChoice.ts ExecutionStatus)
    execution_status: str = "pre-merge"  # pre-merge | syncing | valid | invalid
    # EL block hash carried for engine_forkchoiceUpdated calls
    execution_block_hash: bytes = b"\x00" * 32


@dataclasses.dataclass
class VoteTracker:
    """One attester's latest vote (computeDeltas.ts VoteTracker).

    ``next_epoch`` starts at -1, NOT 0: the spec updates a latest message
    whenever none exists yet, so a genesis-epoch attestation
    (target_epoch == 0) must pass the ``target_epoch > next_epoch``
    freshness check on a fresh tracker — with a 0 sentinel every epoch-0
    vote was silently dropped from fork choice."""

    current_root: bytes = b"\x00" * 32
    next_root: bytes = b"\x00" * 32
    next_epoch: int = -1


def compute_deltas(
    indices: Dict[bytes, int],
    votes: List[VoteTracker],
    old_balances: np.ndarray,
    new_balances: np.ndarray,
) -> np.ndarray:
    """Per-node weight deltas from vote movements (computeDeltas.ts:14)."""
    deltas = np.zeros(len(indices), dtype=np.int64)
    zero = b"\x00" * 32
    for i, vote in enumerate(votes):
        if vote.current_root == zero and vote.next_root == zero:
            continue
        old_bal = int(old_balances[i]) if i < len(old_balances) else 0
        new_bal = int(new_balances[i]) if i < len(new_balances) else 0
        if vote.current_root != vote.next_root or old_bal != new_bal:
            # the zero root is the "no vote yet" sentinel, never a block —
            # skip it explicitly so an anchor whose root happens to be low
            # can't absorb phantom deltas
            cur = indices.get(vote.current_root) if vote.current_root != zero else None
            if cur is not None:
                deltas[cur] -= old_bal
            nxt = indices.get(vote.next_root) if vote.next_root != zero else None
            if nxt is not None:
                deltas[nxt] += new_bal
            vote.current_root = vote.next_root
    return deltas


class ProtoArrayError(Exception):
    pass


class ProtoArray:
    def __init__(self, justified_epoch: int, finalized_epoch: int):
        self.prune_threshold = 256
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        self.nodes: List[ProtoNode] = []
        self.indices: Dict[bytes, int] = {}

    # -- insertion -----------------------------------------------------------

    def on_block(self, node: ProtoNode) -> None:
        if node.block_root in self.indices:
            return
        node_index = len(self.nodes)
        node.parent = self.indices.get(node.parent_root) if node.parent_root else None
        self.indices[node.block_root] = node_index
        self.nodes.append(node)
        if node.parent is not None:
            self._maybe_update_best_child_and_descendant(node.parent, node_index)

    # -- scoring -------------------------------------------------------------

    def apply_score_changes(
        self, deltas: np.ndarray, justified_epoch: int, finalized_epoch: int
    ) -> None:
        """Backward pass: add deltas, bubble child weights into parents,
        refresh best pointers (protoArray.ts applyScoreChanges)."""
        if len(deltas) != len(self.nodes):
            raise ProtoArrayError("delta length mismatch")
        if justified_epoch != self.justified_epoch or finalized_epoch != self.finalized_epoch:
            self.justified_epoch = justified_epoch
            self.finalized_epoch = finalized_epoch
        deltas = deltas.copy()
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            delta = int(deltas[i])
            if node.execution_status == "invalid":
                # EL-invalidated subtree: force weight to 0 and propagate
                # only that change upward — stray vote-removal deltas on an
                # already-zeroed node are discarded (ancestors shed the
                # subtree the moment it was invalidated)
                delta = -node.weight
            node.weight += delta
            if node.weight < 0:
                raise ProtoArrayError("negative node weight")
            if node.parent is not None:
                deltas[node.parent] += delta
                self._maybe_update_best_child_and_descendant(node.parent, i)

    # -- head ----------------------------------------------------------------

    def find_head(self, justified_root: bytes) -> bytes:
        ji = self.indices.get(justified_root)
        if ji is None:
            raise ProtoArrayError("justified root unknown to proto array")
        node = self.nodes[ji]
        best = node.best_descendant if node.best_descendant is not None else ji
        head = self.nodes[best]
        if not self._node_is_viable_for_head(head) and head.block_root != justified_root:
            raise ProtoArrayError("head is not viable")
        return head.block_root

    # -- pruning -------------------------------------------------------------

    def prune(self, finalized_root: bytes) -> List[ProtoNode]:
        """Drop everything before the finalized root (protoArray.ts
        maybePrune); returns removed nodes for the caller to clean up."""
        fi = self.indices.get(finalized_root)
        if fi is None:
            raise ProtoArrayError("finalized root unknown")
        if fi < self.prune_threshold:
            return []
        removed = self.nodes[:fi]
        self.nodes = self.nodes[fi:]
        for n in removed:
            del self.indices[n.block_root]
        for root in list(self.indices):
            self.indices[root] -= fi
        for n in self.nodes:
            if n.parent is not None:
                n.parent = n.parent - fi if n.parent >= fi else None
            if n.best_child is not None:
                n.best_child = n.best_child - fi if n.best_child >= fi else None
            if n.best_descendant is not None:
                n.best_descendant = n.best_descendant - fi if n.best_descendant >= fi else None
        return removed

    # -- queries -------------------------------------------------------------

    def get_node(self, root: bytes) -> Optional[ProtoNode]:
        i = self.indices.get(root)
        return self.nodes[i] if i is not None else None

    def has_block(self, root: bytes) -> bool:
        return root in self.indices

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        ai = self.indices.get(ancestor_root)
        if ai is None:
            return False
        i = self.indices.get(descendant_root)
        while i is not None and i >= ai:
            if i == ai:
                return True
            i = self.nodes[i].parent
        return False

    def get_ancestor(self, root: bytes, slot: int) -> Optional[bytes]:
        i = self.indices.get(root)
        while i is not None:
            node = self.nodes[i]
            if node.slot <= slot:
                return node.block_root
            i = node.parent
        return None

    def iterate_ancestors(self, root: bytes):
        i = self.indices.get(root)
        while i is not None:
            node = self.nodes[i]
            yield node
            i = node.parent

    # -- internals -----------------------------------------------------------

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        """Only vote for nodes whose justified/finalized agree with the
        store (protoArray.ts nodeIsViableForHead), and never for nodes the
        execution layer marked invalid."""
        if node.execution_status == "invalid":
            return False
        jus_ok = node.justified_epoch == self.justified_epoch or self.justified_epoch == 0
        fin_ok = node.finalized_epoch == self.finalized_epoch or self.finalized_epoch == 0
        return jus_ok and fin_ok

    def _node_leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None:
            return self._node_is_viable_for_head(self.nodes[node.best_descendant])
        return self._node_is_viable_for_head(node)

    def _maybe_update_best_child_and_descendant(self, parent_i: int, child_i: int) -> None:
        parent = self.nodes[parent_i]
        child = self.nodes[child_i]
        child_leads = self._node_leads_to_viable_head(child)

        child_best_desc = child.best_descendant if child.best_descendant is not None else child_i

        def make_child_best():
            parent.best_child = child_i
            parent.best_descendant = child_best_desc

        def make_no_best():
            parent.best_child = None
            parent.best_descendant = None

        if parent.best_child is None:
            if child_leads:
                make_child_best()
            return
        if parent.best_child == child_i:
            if not child_leads:
                make_no_best()
            else:
                parent.best_descendant = child_best_desc
            return
        best = self.nodes[parent.best_child]
        best_leads = self._node_leads_to_viable_head(best)
        if child_leads and not best_leads:
            make_child_best()
        elif child_leads and best_leads:
            # tie-break: higher weight wins; equal weights -> higher root
            if child.weight > best.weight or (
                child.weight == best.weight and child.block_root >= best.block_root
            ):
                make_child_best()
        elif not child_leads and best_leads:
            pass
        else:
            make_no_best()
