"""Operation pools: gossip-received ops buffered for block inclusion.

Reference: packages/beacon-node/src/chain/opPools/ (SURVEY §2.4):
- AttestationPool            unaggregated atts, per-slot groups, naive agg
- AggregatedAttestationPool  aggregates for block packing, scored
- OpPool                     slashings/exits (persisted across restarts)

Aggregation here happens on SERIALIZED signatures lazily: pools store
bytes; BLS point math runs only when an aggregate is actually consumed
(the reference aggregates eagerly because blst is cheap per-op; batching
the math suits the device model better).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..crypto.bls.api import Signature, aggregate_signatures
from ..params import Preset
from ..types import get_types


class OpPoolError(Exception):
    pass


@dataclasses.dataclass
class _AttGroup:
    data: object
    bits_and_sigs: List[Tuple[List[bool], bytes]]


class AttestationPool:
    """Unaggregated attestation pool (attestationPool.ts): keyed by slot ->
    data root -> list of (bits, sig); retention SLOTS_RETAINED=3."""

    SLOTS_RETAINED = 3
    MAX_PER_SLOT = 16384

    def __init__(self, preset: Preset):
        self.p = preset
        self.t = get_types(preset).phase0
        self._by_slot: Dict[int, Dict[bytes, _AttGroup]] = {}

    def add(self, attestation) -> str:
        slot = attestation.data.slot
        data_root = self.t.AttestationData.hash_tree_root(attestation.data)
        groups = self._by_slot.setdefault(slot, {})
        if sum(len(g.bits_and_sigs) for g in groups.values()) >= self.MAX_PER_SLOT:
            raise OpPoolError("attestation pool slot full")
        group = groups.get(data_root)
        if group is None:
            group = groups[data_root] = _AttGroup(data=attestation.data, bits_and_sigs=[])
        bits = list(attestation.aggregation_bits)
        for existing_bits, _ in group.bits_and_sigs:
            if all(not b or e for b, e in zip(bits, existing_bits)):
                return "already_known"
        group.bits_and_sigs.append((bits, bytes(attestation.signature)))
        return "added"

    def get_aggregate(self, slot: int, data_root: bytes):
        """Naive aggregation of all entries for (slot, data_root) — what an
        aggregator duty publishes (attestationPool.ts getAggregate)."""
        group = self._by_slot.get(slot, {}).get(data_root)
        if group is None:
            return None
        n = len(group.bits_and_sigs[0][0])
        bits = [False] * n
        sigs = []
        for b, sig in group.bits_and_sigs:
            if any(x and y for x, y in zip(bits, b)):
                continue  # overlapping: naive agg skips
            bits = [x or y for x, y in zip(bits, b)]
            sigs.append(Signature.from_bytes(sig))
        from ..ssz import Fields

        return Fields(
            aggregation_bits=bits,
            data=group.data,
            signature=aggregate_signatures(sigs).to_bytes(),
        )

    def __len__(self) -> int:
        # entries, not data-root groups — the pool-pressure number the
        # MAX_PER_SLOT bound also counts
        return sum(
            len(g.bits_and_sigs)
            for groups in self._by_slot.values()
            for g in groups.values()
        )

    def prune(self, clock_slot: int) -> None:
        for slot in list(self._by_slot):
            if slot < clock_slot - self.SLOTS_RETAINED:
                del self._by_slot[slot]


class AggregatedAttestationPool:
    """Aggregates for block packing (aggregatedAttestationPool.ts:40).

    Scoring: not-yet-seen attester count / inclusion age — the reference's
    packing heuristic (:103-174), kept; MAX_ATTESTATIONS_PER_GROUP=2.
    """

    SLOTS_RETAINED = 32
    MAX_PER_GROUP = 2

    def __init__(self, preset: Preset):
        self.p = preset
        self.t = get_types(preset).phase0
        self._by_slot: Dict[int, Dict[bytes, List[object]]] = {}

    def add(self, attestation) -> None:
        slot = attestation.data.slot
        data_root = self.t.AttestationData.hash_tree_root(attestation.data)
        group = self._by_slot.setdefault(slot, {}).setdefault(data_root, [])
        bits = list(attestation.aggregation_bits)
        for existing in group:
            if all(not b or e for b, e in zip(bits, existing.aggregation_bits)):
                return  # subset of an existing aggregate
        group.append(attestation)
        # keep the most participated aggregates
        group.sort(key=lambda a: -sum(a.aggregation_bits))
        del group[self.MAX_PER_GROUP :]

    def get_attestations_for_block(self, state, seen_attesters=None) -> List[object]:
        """Pick up to MAX_ATTESTATIONS, prev/current epoch valid, scored by
        fresh-attester count per age."""
        out: List[Tuple[float, object]] = []
        state_slot = state.slot
        min_slot = max(0, state_slot - self.p.SLOTS_PER_EPOCH)
        for slot in sorted(self._by_slot, reverse=True):
            if not (min_slot <= slot <= state_slot - self.p.MIN_ATTESTATION_INCLUSION_DELAY):
                continue
            age = state_slot - slot
            for group in self._by_slot[slot].values():
                for att in group:
                    fresh = sum(att.aggregation_bits)
                    score = fresh / (age + 1)
                    out.append((score, att))
        out.sort(key=lambda x: -x[0])
        return [att for _, att in out[: self.p.MAX_ATTESTATIONS]]

    def __len__(self) -> int:
        return sum(
            len(aggs)
            for groups in self._by_slot.values()
            for aggs in groups.values()
        )

    def prune(self, clock_slot: int) -> None:
        for slot in list(self._by_slot):
            if slot < clock_slot - self.SLOTS_RETAINED:
                del self._by_slot[slot]


class OpPool:
    """Slashings + exits awaiting inclusion (opPool.ts), persistable via
    BeaconDb repositories (chain.ts:272-280 persist-on-close)."""

    def __init__(self, preset: Preset):
        self.p = preset
        self.t = get_types(preset).phase0
        self.attester_slashings: Dict[bytes, object] = {}
        self.proposer_slashings: Dict[int, object] = {}
        self.voluntary_exits: Dict[int, object] = {}

    def add_attester_slashing(self, slashing) -> None:
        root = self.t.AttesterSlashing.hash_tree_root(slashing)
        self.attester_slashings[root] = slashing

    def add_proposer_slashing(self, slashing) -> None:
        self.proposer_slashings[slashing.signed_header_1.message.proposer_index] = slashing

    def add_voluntary_exit(self, signed_exit) -> None:
        self.voluntary_exits[signed_exit.message.validator_index] = signed_exit

    def get_slashings_and_exits(self, state) -> Tuple[List, List, List]:
        """Ops valid against `state` for a new block (opPool.ts
        getSlashingsAndExits — validity re-checked at packing)."""
        from ..params import FAR_FUTURE_EPOCH
        from ..state_transition.misc import compute_epoch_at_slot, is_active_validator

        epoch = compute_epoch_at_slot(self.p, state.slot)
        proposer = [
            s
            for i, s in self.proposer_slashings.items()
            if not state.validators[i].slashed
        ][: self.p.MAX_PROPOSER_SLASHINGS]
        attester = list(self.attester_slashings.values())[: self.p.MAX_ATTESTER_SLASHINGS]
        exits = [
            e
            for i, e in self.voluntary_exits.items()
            if is_active_validator(state.validators[i], epoch)
            and state.validators[i].exit_epoch == FAR_FUTURE_EPOCH
        ][: self.p.MAX_VOLUNTARY_EXITS]
        return proposer, attester, exits

    # -- persistence (toPersisted/fromPersisted) -----------------------------

    def to_db(self, beacon_db) -> None:
        from ..db.schema import uint_key

        for root, s in self.attester_slashings.items():
            beacon_db.attester_slashing.put(root, s)
        for i, s in self.proposer_slashings.items():
            beacon_db.proposer_slashing.put(uint_key(i), s)
        for i, e in self.voluntary_exits.items():
            beacon_db.voluntary_exit.put(uint_key(i), e)

    def from_db(self, beacon_db) -> None:
        from ..db.schema import decode_uint_key

        for root, s in beacon_db.attester_slashing.entries():
            self.attester_slashings[root] = s
        for k, s in beacon_db.proposer_slashing.entries():
            self.proposer_slashings[decode_uint_key(k)] = s
        for k, e in beacon_db.voluntary_exit.entries():
            self.voluntary_exits[decode_uint_key(k)] = e
