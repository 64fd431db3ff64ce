"""Gossip validation: per-type spec checks -> signature sets -> batched
verification verdicts.

Reference: packages/beacon-node/src/chain/validation/ (attestation.ts:15,
aggregateAndProof.ts, voluntaryExit.ts, proposerSlashing.ts,
attesterSlashing.ts) and the gossip-block checks in
network/gossip/handlers/index.ts:90.  Typed IGNORE/REJECT outcomes mirror
GossipAction; every accepted object has flowed through
``pool.verify_signature_sets`` (chain.bls.verifySignatureSets analog,
{batchable: true} for small jobs — attestation.ts:138).

Dependencies are explicit (clock/fork_choice/seen caches/ctx/pool) so unit
tests can drive them without a full node (the reference mocks IBeaconChain
the same way, test/utils/mocks/chain.ts).
"""

from __future__ import annotations

import enum
import time
from typing import List, Optional, Sequence

from ..config.chain_config import ChainConfig
from ..params import DOMAIN_AGGREGATE_AND_PROOF, DOMAIN_SELECTION_PROOF, Preset
from ..ssz import Fields, uint64
from ..state_transition import compute_epoch_at_slot, compute_signing_root, get_domain
from ..state_transition.block import is_slashable_attestation_data, is_slashable_validator
from ..state_transition.signature_sets import (
    attester_slashing_signature_sets,
    indexed_attestation_signature_set,
    proposer_slashing_signature_sets,
    voluntary_exit_signature_set,
)
from ..crypto.bls.verifier import (
    SignatureSetPriority,
    SingleSignatureSet,
    VerificationDroppedError,
)
from ..types import get_types


class GossipAction(str, enum.Enum):
    IGNORE = "IGNORE"
    REJECT = "REJECT"


class GossipValidationError(Exception):
    def __init__(self, action: GossipAction, code: str):
        super().__init__(f"{action.value}: {code}")
        self.action = action
        self.code = code


def _reject(code: str):
    raise GossipValidationError(GossipAction.REJECT, code)


def _ignore(code: str):
    raise GossipValidationError(GossipAction.IGNORE, code)


async def _pool_verify(pool, sets, *, batchable=True, priority=None, deadline=None):
    """pool.verify_signature_sets with the QoS lane + deadline threaded
    through and the overload contract applied: a job the pool SHED
    (deadline expiry, overflow eviction — VerificationDroppedError) maps
    to IGNORE, never REJECT — the node's own admission decision must not
    downscore the relaying peer or mark the message invalid.

    Plain verifiers that predate the ``priority`` kwarg (test doubles,
    IBlsVerifier facades) are driven through the legacy signature."""
    try:
        coro = pool.verify_signature_sets(
            sets, batchable=batchable, priority=priority, deadline=deadline
        )
    except TypeError:  # pool without QoS lanes: legacy signature
        coro = pool.verify_signature_sets(sets, batchable=batchable)
    try:
        return await coro
    except VerificationDroppedError:
        _ignore("VERIFICATION_DROPPED")


def _storm_deadline(cfg: ChainConfig) -> float:
    """Deadline stamped on storm-lane gossip jobs (single attestations,
    per-subnet sync-committee messages): one slot from intake.  Their
    propagation value decays within the slot — a job still buffered a
    full slot later is stale backlog the flusher sheds instead of burning
    device time on (docs/overload.md §Deadline shedding)."""
    return time.monotonic() + cfg.SECONDS_PER_SLOT


async def validate_gossip_attestation(
    p: Preset,
    cfg: ChainConfig,
    *,
    attestation,
    subnet: Optional[int],
    clock_slot: int,
    fork_choice,
    seen_attesters,
    ctx,
    state,
    pool,
) -> List[int]:
    """Returns the attesting indices on acceptance (attestation.ts:15).

    Reference checks in order: slot window, single-bit, known block root,
    committee lookup, first-seen dedup, signature (batchable single set).
    """
    data = attestation.data
    target_epoch = data.target.epoch
    att_slot = data.slot
    if target_epoch != compute_epoch_at_slot(p, att_slot):
        _reject("BAD_TARGET_EPOCH")
    # ATTESTATION_PROPAGATION_SLOT_RANGE = 32 with clock disparity
    if not (att_slot <= clock_slot <= att_slot + 32):
        _ignore("INVALID_SLOT_TIME")
    bits = list(attestation.aggregation_bits)
    if sum(bits) != 1:
        _reject("NOT_EXACTLY_ONE_BIT_SET")
    if not fork_choice.has_block(bytes(data.beacon_block_root)):
        _ignore("UNKNOWN_BEACON_BLOCK_ROOT")
    _verify_head_block_and_target_root(p, fork_choice, data)
    if data.index >= ctx.get_committee_count_per_slot(target_epoch):
        _reject("COMMITTEE_INDEX_OUT_OF_RANGE")
    committee = ctx.get_beacon_committee(att_slot, data.index)
    if len(bits) != len(committee):
        _reject("WRONG_NUMBER_OF_AGGREGATION_BITS")
    attester = int(committee[bits.index(True)])
    if seen_attesters.is_known(target_epoch, attester):
        _ignore("ATTESTATION_ALREADY_KNOWN")

    indexed = ctx.get_indexed_attestation(attestation)
    sig_set = indexed_attestation_signature_set(p, ctx, state, indexed)
    if not await _pool_verify(
        pool, [sig_set], batchable=True,
        priority=SignatureSetPriority.UNAGGREGATED,
        deadline=_storm_deadline(cfg),
    ):
        _reject("INVALID_SIGNATURE")
    # re-check after the async hop (attestation.ts:142-153 race guard)
    if seen_attesters.is_known(target_epoch, attester):
        _ignore("ATTESTATION_ALREADY_KNOWN")
    seen_attesters.add(target_epoch, attester)
    return [attester]


def _verify_head_block_and_target_root(p: Preset, fork_choice, data) -> None:
    """verifyHeadBlockAndTargetRoot (chain/validation/attestation.ts): the
    attested head block must not be newer than the attestation slot, and the
    attestation's target root must be the epoch-boundary ancestor of the
    head block — otherwise the attestation's vote is internally inconsistent
    and must be REJECTed (not re-gossiped).  Caller has already established
    has_block(beacon_block_root).  Descent from the finalized checkpoint is
    implied: proto-array pruning keeps only finalized descendants."""
    head_root = bytes(data.beacon_block_root)
    head_block = fork_choice.get_block(head_root)
    if head_block.slot > data.slot:
        _reject("HEAD_BLOCK_AFTER_ATTESTATION_SLOT")
    target_start_slot = data.target.epoch * p.SLOTS_PER_EPOCH
    if head_block.slot >= target_start_slot:
        # target must be the head block's own chain checkpoint
        expected = fork_choice.get_ancestor(head_root, target_start_slot)
    else:
        # head is from a prior epoch: target checkpoint root IS the head
        expected = head_root
    if expected != bytes(data.target.root):
        _reject("BAD_TARGET_ROOT")


def is_aggregator(p: Preset, committee_len: int, selection_proof: bytes) -> bool:
    """isAggregatorFromCommitteeLength (state-transition util/aggregator.ts):
    sha256(proof) little-endian uint64 % (committee_len // 16 or 1) == 0."""
    import hashlib

    from ..params.presets import TARGET_AGGREGATORS_PER_COMMITTEE

    modulo = max(1, committee_len // TARGET_AGGREGATORS_PER_COMMITTEE)
    digest = hashlib.sha256(selection_proof).digest()
    return int.from_bytes(digest[:8], "little") % modulo == 0


async def validate_gossip_aggregate_and_proof(
    p: Preset,
    cfg: ChainConfig,
    *,
    signed_aggregate,
    clock_slot: int,
    fork_choice,
    seen_aggregators,
    seen_aggregates,
    ctx,
    state,
    pool,
) -> List[int]:
    """Three signature sets in one batchable job: selection proof,
    aggregator signature, aggregated attestation (aggregateAndProof.ts)."""
    t = get_types(p).phase0
    aggregate_and_proof = signed_aggregate.message
    aggregate = aggregate_and_proof.aggregate
    data = aggregate.data
    target_epoch = data.target.epoch
    if target_epoch != compute_epoch_at_slot(p, data.slot):
        _reject("BAD_TARGET_EPOCH")
    if not (data.slot <= clock_slot <= data.slot + 32):
        _ignore("INVALID_SLOT_TIME")
    aggregator = aggregate_and_proof.aggregator_index
    if seen_aggregators.is_known(target_epoch, aggregator):
        _ignore("AGGREGATOR_ALREADY_KNOWN")
    data_root = t.AttestationData.hash_tree_root(data)
    if seen_aggregates.is_known(target_epoch, data_root, aggregate.aggregation_bits):
        _ignore("AGGREGATE_ALREADY_KNOWN")
    if not fork_choice.has_block(bytes(data.beacon_block_root)):
        _ignore("UNKNOWN_BEACON_BLOCK_ROOT")
    _verify_head_block_and_target_root(p, fork_choice, data)
    committee = ctx.get_beacon_committee(data.slot, data.index)
    if aggregator not in [int(x) for x in committee]:
        _reject("AGGREGATOR_NOT_IN_COMMITTEE")
    if not is_aggregator(p, len(committee), bytes(aggregate_and_proof.selection_proof)):
        _reject("INVALID_AGGREGATOR")

    slot_domain = get_domain(p, state, DOMAIN_SELECTION_PROOF, target_epoch)
    selection_set = SingleSignatureSet(
        pubkey=ctx.index2pubkey[aggregator],
        signing_root=compute_signing_root(p, uint64, data.slot, slot_domain),
        signature=bytes(aggregate_and_proof.selection_proof),
    )
    agg_domain = get_domain(p, state, DOMAIN_AGGREGATE_AND_PROOF, target_epoch)
    aggregator_set = SingleSignatureSet(
        pubkey=ctx.index2pubkey[aggregator],
        signing_root=compute_signing_root(p, t.AggregateAndProof, aggregate_and_proof, agg_domain),
        signature=bytes(signed_aggregate.signature),
    )
    indexed = ctx.get_indexed_attestation(aggregate)
    att_set = indexed_attestation_signature_set(p, ctx, state, indexed)
    if not await _pool_verify(
        pool, [selection_set, aggregator_set, att_set], batchable=True,
        priority=SignatureSetPriority.AGGREGATE,
    ):
        _reject("INVALID_SIGNATURE")
    seen_aggregators.add(target_epoch, aggregator)
    seen_aggregates.add(target_epoch, data_root, aggregate.aggregation_bits)
    return list(indexed.attesting_indices)


async def validate_gossip_block(
    p: Preset,
    cfg: ChainConfig,
    *,
    signed_block,
    clock_slot: int,
    fork_choice,
    seen_block_proposers,
    ctx,
    state,
    pool,
    clock=None,
) -> None:
    """Gossip beacon_block checks (gossip/handlers/index.ts:90): slot not
    future (with MAXIMUM_GOSSIP_CLOCK_DISPARITY tolerance when a clock is
    supplied), not finalized-old, descends from the finalized checkpoint,
    first proposal for (slot, proposer), parent known, proposer signature
    (verified on the spot — the reference uses blsVerifyOnMainThread to
    keep gossip latency low; a non-batchable dispatch is the analog)."""
    from ..state_transition.signature_sets import block_proposer_signature_set

    block = signed_block.message
    if block.slot > clock_slot:
        # allow the standard 500 ms clock disparity for blocks broadcast
        # just before their slot starts (gossip/handlers/index.ts clock use)
        if clock is None or not clock.is_current_slot_given_disparity(block.slot):
            _ignore("FUTURE_SLOT")
    finalized = fork_choice.store.finalized_checkpoint
    finalized_slot = finalized.epoch * p.SLOTS_PER_EPOCH
    if block.slot <= finalized_slot:
        _ignore("WOULD_REVERT_FINALIZED_SLOT")
    if seen_block_proposers.is_known(block.slot, block.proposer_index):
        _ignore("REPEAT_PROPOSAL")
    if not fork_choice.has_block(bytes(block.parent_root)):
        _ignore("PARENT_UNKNOWN")
    # a known parent at a non-finalized slot can still sit on a pruned-out
    # branch: require actual descent from the finalized checkpoint root
    if fork_choice.has_block(finalized.root) and not fork_choice.is_descendant(
        finalized.root, bytes(block.parent_root)
    ):
        _reject("NOT_FINALIZED_DESCENDANT")
    expected_proposer = ctx.get_beacon_proposer(block.slot)
    if block.proposer_index != expected_proposer:
        _reject("INCORRECT_PROPOSER")
    sig_set = block_proposer_signature_set(p, ctx, state, signed_block)
    if not await _pool_verify(
        pool, [sig_set], batchable=False,
        priority=SignatureSetPriority.BLOCK_PROPOSAL,
    ):
        _reject("PROPOSAL_SIGNATURE_INVALID")
    seen_block_proposers.add(block.slot, block.proposer_index)


async def validate_gossip_voluntary_exit(
    p: Preset, cfg: ChainConfig, *, signed_exit, ctx, state, pool, op_pool
) -> None:
    exit_msg = signed_exit.message
    idx = exit_msg.validator_index
    if idx in op_pool.voluntary_exits:
        _ignore("ALREADY_EXISTS")
    # read-only validity predicate — the reference's isValidVoluntaryExit
    # with verifySignature=false never mutates state; a deepcopy dry-run
    # here would copy the whole state per gossip message (DoS vector)
    from ..params.presets import FAR_FUTURE_EPOCH
    from ..state_transition.misc import is_active_validator

    if idx >= len(state.validators):
        _reject("INVALID_EXIT")
    v = state.validators[idx]
    current_epoch = compute_epoch_at_slot(p, state.slot)
    if (
        not is_active_validator(v, current_epoch)
        or v.exit_epoch != FAR_FUTURE_EPOCH
        or current_epoch < exit_msg.epoch
        or current_epoch < v.activation_epoch + cfg.SHARD_COMMITTEE_PERIOD
    ):
        _reject("INVALID_EXIT")
    # exits (like slashings below) are rare, irreplaceable op-pool
    # messages gossip never sheds at intake: ride the AGGREGATE lane so
    # the overflow policy can't sacrifice them to storm traffic
    if not await _pool_verify(
        pool, [voluntary_exit_signature_set(p, ctx, state, signed_exit)],
        batchable=True, priority=SignatureSetPriority.AGGREGATE,
    ):
        _reject("INVALID_SIGNATURE")


async def validate_gossip_proposer_slashing(
    p: Preset, cfg: ChainConfig, *, slashing, ctx, state, pool, op_pool
) -> None:
    idx = slashing.signed_header_1.message.proposer_index
    if idx in op_pool.proposer_slashings:
        _ignore("ALREADY_EXISTS")
    h1, h2 = slashing.signed_header_1.message, slashing.signed_header_2.message
    t = get_types(p).phase0
    if h1.slot != h2.slot or h1.proposer_index != h2.proposer_index:
        _reject("HEADERS_NOT_SLASHABLE")
    if t.BeaconBlockHeader.serialize(h1) == t.BeaconBlockHeader.serialize(h2):
        _reject("HEADERS_EQUAL")
    if not is_slashable_validator(state.validators[idx], compute_epoch_at_slot(p, state.slot)):
        _reject("NOT_SLASHABLE")
    if not await _pool_verify(
        pool, proposer_slashing_signature_sets(p, ctx, state, slashing),
        batchable=True, priority=SignatureSetPriority.AGGREGATE,
    ):
        _reject("INVALID_SIGNATURE")


async def validate_gossip_attester_slashing(
    p: Preset, cfg: ChainConfig, *, slashing, ctx, state, pool, op_pool
) -> None:
    if not is_slashable_attestation_data(slashing.attestation_1.data, slashing.attestation_2.data):
        _reject("NOT_SLASHABLE")
    intersection = set(slashing.attestation_1.attesting_indices) & set(
        slashing.attestation_2.attesting_indices
    )
    epoch = compute_epoch_at_slot(p, state.slot)
    if not any(is_slashable_validator(state.validators[i], epoch) for i in intersection):
        _ignore("NO_SLASHABLE_VALIDATORS")
    if not await _pool_verify(
        pool, attester_slashing_signature_sets(p, ctx, state, slashing),
        batchable=True, priority=SignatureSetPriority.AGGREGATE,
    ):
        _reject("INVALID_SIGNATURE")
