"""Eth1 deposit tracking + eth1Data vote production.

Reference: packages/beacon-node/src/eth1/eth1DepositDataTracker.ts:46 —
follow-distance snapshots of (deposit_root, deposit_count, block_hash),
deposit event accumulation into the merkle tree, and getEth1DataForBlock:
vote with the period majority, else the follow-distance snapshot.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from ..params import Preset
from ..ssz import Fields
from ..utils.logger import get_logger

logger = get_logger("eth1")

ETH1_FOLLOW_DISTANCE = 2048
DEPOSIT_CONTRACT_TREE_DEPTH = 32


class DepositTree:
    """Incremental deposit merkle tree (the deposit contract's scheme):
    a 32-entry branch array makes push and root O(depth), so replaying a
    genesis deposit list is O(n log n) total, not O(n^2)."""

    def __init__(self):
        self.leaves: List[bytes] = []  # kept for proof construction
        self._zero = [b"\x00" * 32]
        for _ in range(DEPOSIT_CONTRACT_TREE_DEPTH):
            self._zero.append(
                hashlib.sha256(self._zero[-1] + self._zero[-1]).digest()
            )
        self._branch: List[bytes] = list(self._zero[:DEPOSIT_CONTRACT_TREE_DEPTH])

    def push(self, deposit_data_root: bytes) -> None:
        self.leaves.append(deposit_data_root)
        size = len(self.leaves)
        node = deposit_data_root
        for depth in range(DEPOSIT_CONTRACT_TREE_DEPTH):
            if size % 2 == 1:
                self._branch[depth] = node
                return
            node = hashlib.sha256(self._branch[depth] + node).digest()
            size //= 2

    def root(self) -> bytes:
        # deposit-contract get_deposit_root: fold the branch array against
        # the zero-subtree frontier
        size = len(self.leaves)
        node = self._zero[0]
        for depth in range(DEPOSIT_CONTRACT_TREE_DEPTH):
            if size % 2 == 1:
                node = hashlib.sha256(self._branch[depth] + node).digest()
            else:
                node = hashlib.sha256(node + self._zero[depth]).digest()
            size //= 2
        count = len(self.leaves).to_bytes(8, "little") + b"\x00" * 24
        return hashlib.sha256(node + count).digest()


class Eth1ProviderMock:
    """Deterministic eth1 chain double (provider/eth1Provider.ts seam):
    blocks are fabricated per height; deposit logs are whatever the test
    enqueues."""

    def __init__(self, genesis_time: int = 0, block_interval: int = 14):
        self.genesis_time = genesis_time
        self.block_interval = block_interval
        self.deposit_logs: List[Tuple[int, Fields]] = []  # (block_number, DepositData)
        self.head_number = 0

    def advance_to(self, number: int) -> None:
        self.head_number = max(self.head_number, number)

    def add_deposit(self, block_number: int, deposit_data) -> None:
        self.deposit_logs.append((block_number, deposit_data))
        self.advance_to(block_number)

    def get_block_by_number(self, number: int) -> Optional[Fields]:
        if number > self.head_number:
            return None
        return Fields(
            number=number,
            hash=hashlib.sha256(b"eth1-%d" % number).digest(),
            timestamp=self.genesis_time + number * self.block_interval,
        )

    def get_deposit_logs(self, from_block: int, to_block: int):
        return [
            (n, d) for n, d in self.deposit_logs if from_block <= n <= to_block
        ]


class Eth1DepositDataTracker:
    def __init__(self, preset: Preset, provider: Eth1ProviderMock):
        self.p = preset
        self.provider = provider
        self.tree = DepositTree()
        self.deposit_count = 0
        self.processed_block = -1

    def follow(self) -> None:
        """Ingest deposit logs up to the follow-distance head
        (eth1DepositDataTracker update loop)."""
        from ..types import get_types

        t = get_types(self.p).phase0
        target = self.provider.head_number - 0  # follow distance applied at vote time
        for number, dd in self.provider.get_deposit_logs(
            self.processed_block + 1, target
        ):
            self.tree.push(t.DepositData.hash_tree_root(dd))
            self.deposit_count += 1
        self.processed_block = target

    def eth1_data_at(self, number: int) -> Fields:
        blk = self.provider.get_block_by_number(number)
        return Fields(
            deposit_root=self.tree.root(),
            deposit_count=self.deposit_count,
            block_hash=blk.hash if blk else b"\x00" * 32,
        )

    def get_eth1_vote(self, state) -> Fields:
        """getEth1DataForBlockProduction: majority vote among the voting
        period's eth1_data_votes when one can still win, else the
        follow-distance snapshot."""
        period_votes = list(state.eth1_data_votes)
        slots_per_period = self.p.EPOCHS_PER_ETH1_VOTING_PERIOD * self.p.SLOTS_PER_EPOCH
        if period_votes:
            from ..types import get_types

            t = get_types(self.p).phase0
            tally: Dict[bytes, Tuple[int, object]] = {}
            for v in period_votes:
                k = t.Eth1Data.hash_tree_root(v)
                cnt, _ = tally.get(k, (0, v))
                tally[k] = (cnt + 1, v)
            best_count, best = max(tally.values(), key=lambda cv: cv[0])
            if best_count * 2 > slots_per_period:
                return best
        follow_head = max(0, self.provider.head_number - ETH1_FOLLOW_DISTANCE)
        return self.eth1_data_at(follow_head)
