"""Sync-committee message + contribution pools, and the gossip validators
for both (altair).

Reference: packages/beacon-node/src/chain/opPools/syncCommitteeMessagePool.ts
(per-slot/beacon-block-root aggregation into contributions),
opPools/syncContributionAndProofPool.ts (best contribution per subcommittee
for block production), and chain/validation/syncCommittee.ts +
syncCommitteeContributionAndProof.ts (gossip IGNORE/REJECT flows).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from ..config.chain_config import ChainConfig
from ..params import DOMAIN_SYNC_COMMITTEE, Preset
from ..params.presets import SYNC_COMMITTEE_SUBNET_COUNT
from ..ssz import Fields
from ..state_transition import compute_epoch_at_slot, compute_signing_root, get_domain
from ..types import get_types
from ..crypto.bls.verifier import SignatureSetPriority
from .validation import (
    GossipAction,
    GossipValidationError,
    _ignore,
    _pool_verify,
    _reject,
    _storm_deadline,
)

G2_INFINITY_SIG = b"\xc0" + b"\x00" * 95


class SyncCommitteeMessagePool:
    """slot -> block_root -> subcommittee -> accumulated signatures.

    The reference aggregates eagerly per (subnet, block_root); here we keep
    the individual messages and aggregate on demand (host-side aggregation
    is cheap at these counts; the batched device path verifies them).
    """

    SLOTS_RETAINED = 8

    def __init__(self, preset: Preset):
        self.p = preset
        # (slot, root, subcommittee) -> {index_in_subcommittee: signature}
        self._msgs: Dict[Tuple[int, bytes, int], Dict[int, bytes]] = {}

    def __len__(self) -> int:
        return sum(len(v) for v in self._msgs.values())

    def add(self, slot: int, block_root: bytes, subcommittee: int,
            index_in_subcommittee: int, signature: bytes) -> None:
        key = (slot, bytes(block_root), subcommittee)
        self._msgs.setdefault(key, {})[index_in_subcommittee] = signature

    def get_contribution(self, slot: int, block_root: bytes, subcommittee: int):
        """Build a SyncCommitteeContribution from pooled messages."""
        from ..crypto.bls.api import Signature, aggregate_signatures

        key = (slot, bytes(block_root), subcommittee)
        msgs = self._msgs.get(key)
        if not msgs:
            return None
        sub_size = self.p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
        bits = [False] * sub_size
        sigs = []
        for idx, sig in sorted(msgs.items()):
            bits[idx] = True
            sigs.append(Signature.from_bytes(sig))
        return Fields(
            slot=slot,
            beacon_block_root=bytes(block_root),
            subcommittee_index=subcommittee,
            aggregation_bits=bits,
            signature=aggregate_signatures(sigs).to_bytes(),
        )

    def prune(self, clock_slot: int) -> None:
        for key in list(self._msgs):
            if key[0] < clock_slot - self.SLOTS_RETAINED:
                del self._msgs[key]


class SyncContributionAndProofPool:
    """Best contribution per (slot, root, subcommittee) for block packing
    (syncContributionAndProofPool.ts getSyncAggregate)."""

    SLOTS_RETAINED = 8

    def __init__(self, preset: Preset):
        self.p = preset
        self._best: Dict[Tuple[int, bytes, int], object] = {}

    def add(self, contribution) -> None:
        key = (
            contribution.slot,
            bytes(contribution.beacon_block_root),
            contribution.subcommittee_index,
        )
        cur = self._best.get(key)
        if cur is None or sum(contribution.aggregation_bits) > sum(cur.aggregation_bits):
            self._best[key] = contribution

    def get_sync_aggregate(self, slot: int, block_root: bytes):
        """Assemble the block's SyncAggregate from the best contributions
        for (slot-1's block root)."""
        from ..crypto.bls.api import Signature, aggregate_signatures

        sub_size = self.p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
        bits = [False] * self.p.SYNC_COMMITTEE_SIZE
        sigs = []
        for sub in range(SYNC_COMMITTEE_SUBNET_COUNT):
            c = self._best.get((slot, bytes(block_root), sub))
            if c is None:
                continue
            for i, b in enumerate(c.aggregation_bits):
                if b:
                    bits[sub * sub_size + i] = True
            sigs.append(Signature.from_bytes(bytes(c.signature)))
        if not sigs:
            return Fields(
                sync_committee_bits=bits, sync_committee_signature=G2_INFINITY_SIG
            )
        return Fields(
            sync_committee_bits=bits,
            sync_committee_signature=aggregate_signatures(sigs).to_bytes(),
        )

    def prune(self, clock_slot: int) -> None:
        for key in list(self._best):
            if key[0] < clock_slot - self.SLOTS_RETAINED:
                del self._best[key]


# ---------------------------------------------------------------------------
# gossip validators (chain/validation/syncCommittee.ts)
# ---------------------------------------------------------------------------


def subcommittee_assignment(p: Preset, state, validator_index: int) -> List[int]:
    """Subcommittees where `validator_index`'s pubkey sits in the CURRENT
    sync committee (duplicates possible — the committee samples with
    replacement)."""
    pk = bytes(state.validators[validator_index].pubkey)
    sub_size = p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
    out = []
    for i, cpk in enumerate(state.current_sync_committee.pubkeys):
        if bytes(cpk) == pk:
            out.append(i // sub_size)
    return out


async def validate_sync_committee_message(
    p: Preset, cfg: ChainConfig, *, message, subnet: int, clock_slot: int,
    state, ctx, seen_sync_msgs, pool,
) -> int:
    """Returns index_in_subcommittee on acceptance (syncCommittee.ts).

    IGNORE: wrong slot window, already seen.  REJECT: validator not in the
    committee / wrong subnet / bad signature.
    """
    if message.slot != clock_slot:
        _ignore("NOT_CURRENT_SLOT")
    vi = message.validator_index
    if vi >= len(state.validators):
        _reject("UNKNOWN_VALIDATOR")
    subs = subcommittee_assignment(p, state, vi)
    if subnet not in subs:
        _reject("VALIDATOR_NOT_IN_SUBNET")
    if seen_sync_msgs.is_known(message.slot, subnet, vi):
        _ignore("ALREADY_SEEN")
    # signature over the block root at DOMAIN_SYNC_COMMITTEE
    from ..crypto.bls.verifier import SingleSignatureSet
    from ..crypto.bls.api import PublicKey

    epoch = compute_epoch_at_slot(p, message.slot)
    domain = get_domain(p, state, DOMAIN_SYNC_COMMITTEE, epoch)
    sub_size = p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
    # signing root: SigningData(object_root=block_root, domain) — the
    # message signs the beacon block root directly (spec p2p)
    from ..ssz import Fields as F

    t = get_types(p).phase0
    signing_root = t.SigningData.hash_tree_root(
        F(object_root=bytes(message.beacon_block_root), domain=domain)
    )
    sig_set = SingleSignatureSet(
        pubkey=PublicKey.from_bytes(bytes(state.validators[vi].pubkey)),
        signing_root=signing_root,
        signature=bytes(message.signature),
    )
    if not await _pool_verify(
        pool, [sig_set], batchable=True,
        priority=SignatureSetPriority.SYNC_COMMITTEE,
        deadline=_storm_deadline(cfg),
    ):
        _reject("INVALID_SIGNATURE")
    if seen_sync_msgs.is_known(message.slot, subnet, vi):
        _ignore("ALREADY_SEEN")
    seen_sync_msgs.add(message.slot, subnet, vi)
    # position within the subcommittee
    pk = bytes(state.validators[vi].pubkey)
    for i, cpk in enumerate(state.current_sync_committee.pubkeys):
        if bytes(cpk) == pk and i // sub_size == subnet:
            return i % sub_size
    _reject("VALIDATOR_NOT_IN_SUBNET")


def is_sync_committee_aggregator(p: Preset, selection_proof: bytes) -> bool:
    """isSyncCommitteeAggregator (spec: modulo over sync committee size /
    subnets / TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE=16)."""
    modulo = max(
        1,
        p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT // 16,
    )
    digest = hashlib.sha256(selection_proof).digest()
    return int.from_bytes(digest[:8], "little") % modulo == 0


async def validate_sync_committee_contribution(
    p: Preset, cfg: ChainConfig, *, signed_contribution, clock_slot: int,
    state, ctx, seen_contributions, pool,
) -> None:
    """syncCommitteeContributionAndProof.ts: slot window, subcommittee
    range, aggregator selection, three signatures (selection proof,
    aggregator, aggregate)."""
    msg = signed_contribution.message
    contribution = msg.contribution
    if contribution.slot != clock_slot:
        _ignore("NOT_CURRENT_SLOT")
    if contribution.subcommittee_index >= SYNC_COMMITTEE_SUBNET_COUNT:
        _reject("BAD_SUBCOMMITTEE")
    if not any(contribution.aggregation_bits):
        _reject("EMPTY_CONTRIBUTION")
    key = (contribution.slot, msg.aggregator_index, contribution.subcommittee_index)
    if key in seen_contributions:
        _ignore("ALREADY_SEEN")
    from ..crypto.bls.api import PublicKey
    from ..crypto.bls.verifier import AggregatedSignatureSet, SingleSignatureSet
    from ..params import (
        DOMAIN_CONTRIBUTION_AND_PROOF,
        DOMAIN_SYNC_COMMITTEE,
        DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    )
    from ..ssz import Fields as F

    t_all = get_types(p)
    t0 = t_all.phase0
    t_alt = t_all.altair
    epoch = compute_epoch_at_slot(p, contribution.slot)

    # 1. selection proof: SyncAggregatorSelectionData signed by aggregator
    sel_domain = get_domain(p, state, DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch)
    sel_data = F(slot=contribution.slot, subcommittee_index=contribution.subcommittee_index)
    sel_root = compute_signing_root(p, t_alt.SyncAggregatorSelectionData, sel_data, sel_domain)
    if not is_sync_committee_aggregator(p, bytes(msg.selection_proof)):
        _reject("NOT_AGGREGATOR")
    agg_pk = PublicKey.from_bytes(bytes(state.validators[msg.aggregator_index].pubkey))
    sets = [
        SingleSignatureSet(
            pubkey=agg_pk, signing_root=sel_root, signature=bytes(msg.selection_proof)
        )
    ]
    # 2. aggregator signature over ContributionAndProof
    cap_domain = get_domain(p, state, DOMAIN_CONTRIBUTION_AND_PROOF, epoch)
    cap_root = compute_signing_root(p, t_alt.ContributionAndProof, msg, cap_domain)
    sets.append(
        SingleSignatureSet(
            pubkey=agg_pk, signing_root=cap_root,
            signature=bytes(signed_contribution.signature),
        )
    )
    # 3. the contribution aggregate itself over the block root
    sync_domain = get_domain(p, state, DOMAIN_SYNC_COMMITTEE, epoch)
    signing_root = t0.SigningData.hash_tree_root(
        F(object_root=bytes(contribution.beacon_block_root), domain=sync_domain)
    )
    sub_size = p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
    base = contribution.subcommittee_index * sub_size
    pks = [
        PublicKey.from_bytes(bytes(state.current_sync_committee.pubkeys[base + i]))
        for i, bit in enumerate(contribution.aggregation_bits)
        if bit
    ]
    sets.append(
        AggregatedSignatureSet(
            pubkeys=pks, signing_root=signing_root,
            signature=bytes(contribution.signature),
        )
    )
    # contributions ride the AGGREGATE lane, not SYNC_COMMITTEE: they are
    # the sync-committee analog of aggregate_and_proof (~1/512 of message
    # volume), and gossip intake deliberately never sheds them — admitting
    # them at intake only to make them the pool's first eviction victim
    # would be a priority inversion
    if not await _pool_verify(
        pool, sets, batchable=True,
        priority=SignatureSetPriority.AGGREGATE,
    ):
        _reject("INVALID_SIGNATURE")
    if key in seen_contributions:
        _ignore("ALREADY_SEEN")
    seen_contributions.add(key)
