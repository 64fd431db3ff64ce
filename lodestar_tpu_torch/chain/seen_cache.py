"""Seen caches: first-seen dedup for gossip objects.

Reference: packages/beacon-node/src/chain/seenCache/ (SURVEY §2.4):
SeenAttesters / SeenAggregators (per-epoch validator sets),
SeenBlockProposers (per-slot), SeenAggregatedAttestations (superset dedup),
SeenSyncCommitteeMessages, SeenBlockAttesters (liveness tracking).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple


class SeenEpochValidators:
    """Epoch -> set of validator indices (seenAttesters.ts base).  Prunes
    epochs older than `retention` behind the latest seen."""

    def __init__(self, retention: int = 2):
        self.retention = retention
        self._by_epoch: Dict[int, Set[int]] = {}
        self._max_epoch = 0

    def is_known(self, epoch: int, index: int) -> bool:
        return index in self._by_epoch.get(epoch, ())

    def add(self, epoch: int, index: int) -> None:
        self._by_epoch.setdefault(epoch, set()).add(index)
        if epoch > self._max_epoch:
            self._max_epoch = epoch
            self.prune()

    def prune(self) -> None:
        low = self._max_epoch - self.retention
        for e in list(self._by_epoch):
            if e < low:
                del self._by_epoch[e]


SeenAttesters = SeenEpochValidators
SeenAggregators = SeenEpochValidators


class SeenBlockProposers:
    """Slot -> proposer indices that already proposed (seenBlockProposers.ts);
    equivocation guard for gossip blocks."""

    def __init__(self, retention_slots: int = 64):
        self.retention = retention_slots
        self._by_slot: Dict[int, Set[int]] = {}
        self._max_slot = 0

    def is_known(self, slot: int, proposer: int) -> bool:
        return proposer in self._by_slot.get(slot, ())

    def add(self, slot: int, proposer: int) -> None:
        self._by_slot.setdefault(slot, set()).add(proposer)
        if slot > self._max_slot:
            self._max_slot = slot
            for s in list(self._by_slot):
                if s < self._max_slot - self.retention:
                    del self._by_slot[s]


class SeenAggregatedAttestations:
    """data-root -> list of seen aggregation-bit sets; an incoming aggregate
    is redundant iff its bits are a NON-STRICT SUBSET of one already seen
    (seenAggregateAndProof.ts non-strict-superset dedup)."""

    MAX_PER_ROOT = 8

    def __init__(self, retention_epochs: int = 2):
        self._by_epoch: Dict[int, Dict[bytes, List[Tuple[bool, ...]]]] = {}
        self._max_epoch = 0
        self.retention = retention_epochs

    def is_known(self, target_epoch: int, data_root: bytes, bits) -> bool:
        seen = self._by_epoch.get(target_epoch, {}).get(data_root, [])
        bits = tuple(bits)
        for s in seen:
            if len(s) == len(bits) and all(not b or e for b, e in zip(bits, s)):
                return True
        return False

    def add(self, target_epoch: int, data_root: bytes, bits) -> None:
        lst = self._by_epoch.setdefault(target_epoch, {}).setdefault(data_root, [])
        bits = tuple(bits)
        # drop subsets of the new bits
        lst[:] = [s for s in lst if not all(not e or b for e, b in zip(s, bits))]
        lst.append(bits)
        del lst[: max(0, len(lst) - self.MAX_PER_ROOT)]
        if target_epoch > self._max_epoch:
            self._max_epoch = target_epoch
            for e in list(self._by_epoch):
                if e < self._max_epoch - self.retention:
                    del self._by_epoch[e]


class SeenSyncCommitteeMessages:
    """(slot, subnet, validator) first-seen (seenCommittee.ts)."""

    def __init__(self, retention_slots: int = 8):
        self._by_slot: Dict[int, Set[Tuple[int, int]]] = {}
        self._max_slot = 0
        self.retention = retention_slots

    def is_known(self, slot: int, subnet: int, index: int) -> bool:
        return (subnet, index) in self._by_slot.get(slot, ())

    def add(self, slot: int, subnet: int, index: int) -> None:
        self._by_slot.setdefault(slot, set()).add((subnet, index))
        if slot > self._max_slot:
            self._max_slot = slot
            for s in list(self._by_slot):
                if s < self._max_slot - self.retention:
                    del self._by_slot[s]


class SeenContributions:
    """Slot-keyed first-seen set for (slot, aggregator, subcommittee)
    contribution keys (seenContributionAndProof.ts) with the same bounded
    retention as SeenSyncCommitteeMessages — an unbounded set would leak
    one entry per contribution for the node's whole uptime."""

    def __init__(self, retention_slots: int = 8):
        self._by_slot: Dict[int, Set[tuple]] = {}
        self._max_slot = 0
        self.retention = retention_slots

    def __contains__(self, key: tuple) -> bool:
        return key in self._by_slot.get(int(key[0]), ())

    def add(self, key: tuple) -> None:
        slot = int(key[0])
        self._by_slot.setdefault(slot, set()).add(key)
        if slot > self._max_slot:
            self._max_slot = slot
            for s in list(self._by_slot):
                if s < self._max_slot - self.retention:
                    del self._by_slot[s]


class SeenBlockAttesters(SeenEpochValidators):
    """Validators whose attestations appeared in blocks — liveness data for
    the doppelganger check (seenBlockAttesters.ts)."""
