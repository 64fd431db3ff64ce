"""Altair state transition: participation flags, sync committees,
inactivity scores (consensus spec v1.1.10, altair/beacon-chain.md).

Reference: packages/state-transition/src/block/processAttestationsAltair.ts,
block/processSyncCommittee.ts, epoch/processInactivityUpdates.ts,
epoch/processParticipationFlagUpdates.ts, epoch/processSyncCommitteeUpdates.ts,
epoch/getRewardsAndPenalties.ts, util/syncCommittee.ts, util/attesterStatus.ts.

Layout follows the phase0 modules: columnar numpy precompute for epoch
processing (the array layout a device offload consumes unchanged), scalar
spec-shaped code on the block path.
"""

from __future__ import annotations

from typing import List, Sequence

import hashlib

import numpy as np

from ..config.chain_config import ChainConfig
from ..params import (
    DOMAIN_SYNC_COMMITTEE,
    GENESIS_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    Preset,
)
from ..ssz import Bytes32, Fields
from .block import BlockProcessingError, is_valid_indexed_attestation
from .domain import compute_signing_root, get_domain
from .epoch_context import EpochContext
from .misc import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_active_validator_indices,
    get_seed,
    increase_balance,
    decrease_balance,
    integer_squareroot,
)
from .shuffle import compute_shuffled_index


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


# ---------------------------------------------------------------------------
# participation flags
# ---------------------------------------------------------------------------


def add_flag(flags: int, flag_index: int) -> int:
    return flags | (1 << flag_index)


def has_flag(flags: int, flag_index: int) -> bool:
    return bool(flags & (1 << flag_index))


def get_block_root_at_slot(p: Preset, state, slot: int) -> bytes:
    if not (slot < state.slot <= slot + p.SLOTS_PER_HISTORICAL_ROOT):
        raise BlockProcessingError(f"block root at slot {slot} out of range (state {state.slot})")
    return bytes(state.block_roots[slot % p.SLOTS_PER_HISTORICAL_ROOT])


def get_block_root(p: Preset, state, epoch: int) -> bytes:
    return get_block_root_at_slot(p, state, compute_start_slot_at_epoch(p, epoch))


def get_total_active_balance(p: Preset, state) -> int:
    epoch = compute_epoch_at_slot(p, state.slot)
    total = sum(
        state.validators[i].effective_balance
        for i in get_active_validator_indices(state, epoch)
    )
    return max(p.EFFECTIVE_BALANCE_INCREMENT, total)


def get_base_reward_per_increment(p: Preset, total_active_balance: int) -> int:
    return (
        p.EFFECTIVE_BALANCE_INCREMENT
        * p.BASE_REWARD_FACTOR
        // integer_squareroot(total_active_balance)
    )


def get_base_reward(p: Preset, state, index: int, base_reward_per_increment: int) -> int:
    increments = state.validators[index].effective_balance // p.EFFECTIVE_BALANCE_INCREMENT
    return increments * base_reward_per_increment


def get_attestation_participation_flag_indices(
    p: Preset, state, data, inclusion_delay: int
) -> List[int]:
    """Spec get_attestation_participation_flag_indices (altair)."""
    current_epoch = compute_epoch_at_slot(p, state.slot)
    if data.target.epoch == current_epoch:
        justified_checkpoint = state.current_justified_checkpoint
    else:
        justified_checkpoint = state.previous_justified_checkpoint

    is_matching_source = (
        data.source.epoch == justified_checkpoint.epoch
        and bytes(data.source.root) == bytes(justified_checkpoint.root)
    )
    if not is_matching_source:
        raise BlockProcessingError("attestation source does not match justified checkpoint")
    is_matching_target = is_matching_source and bytes(data.target.root) == get_block_root(
        p, state, data.target.epoch
    )
    is_matching_head = is_matching_target and bytes(
        data.beacon_block_root
    ) == get_block_root_at_slot(p, state, data.slot)

    flags: List[int] = []
    if is_matching_source and inclusion_delay <= integer_squareroot(p.SLOTS_PER_EPOCH):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= p.SLOTS_PER_EPOCH:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == p.MIN_ATTESTATION_INCLUSION_DELAY:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


# ---------------------------------------------------------------------------
# block path
# ---------------------------------------------------------------------------


def process_attestation_altair(
    p: Preset, cfg: ChainConfig, ctx: EpochContext, state, attestation, verify_signatures: bool
) -> None:
    """Spec process_attestation (altair variant): same validity envelope as
    phase0, participation-flag bookkeeping + immediate proposer reward
    instead of pending-attestation accumulation
    (block/processAttestationsAltair.ts)."""
    data = attestation.data
    current_epoch = compute_epoch_at_slot(p, state.slot)
    previous_epoch = max(GENESIS_EPOCH, current_epoch - 1)
    if data.target.epoch not in (previous_epoch, current_epoch):
        raise BlockProcessingError("attestation target epoch not current or previous")
    if data.target.epoch != compute_epoch_at_slot(p, data.slot):
        raise BlockProcessingError("attestation target epoch != slot epoch")
    if not (
        data.slot + p.MIN_ATTESTATION_INCLUSION_DELAY
        <= state.slot
        <= data.slot + p.SLOTS_PER_EPOCH
    ):
        raise BlockProcessingError("attestation outside inclusion window")
    if data.index >= ctx.get_committee_count_per_slot(data.target.epoch):
        raise BlockProcessingError("attestation committee index out of range")
    committee = ctx.get_beacon_committee(data.slot, data.index)
    bits = list(attestation.aggregation_bits)
    if len(bits) != len(committee):
        raise BlockProcessingError("aggregation bits length != committee size")

    inclusion_delay = state.slot - data.slot
    participation_flag_indices = get_attestation_participation_flag_indices(
        p, state, data, inclusion_delay
    )

    indexed = ctx.get_indexed_attestation(attestation)
    if not is_valid_indexed_attestation(p, ctx, state, indexed, verify_signatures):
        raise BlockProcessingError("invalid indexed attestation")

    if data.target.epoch == current_epoch:
        epoch_participation = state.current_epoch_participation
    else:
        epoch_participation = state.previous_epoch_participation

    total_active_balance = get_total_active_balance(p, state)
    brpi = get_base_reward_per_increment(p, total_active_balance)
    proposer_reward_numerator = 0
    for index in indexed.attesting_indices:
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in participation_flag_indices and not has_flag(
                epoch_participation[index], flag_index
            ):
                epoch_participation[index] = add_flag(epoch_participation[index], flag_index)
                proposer_reward_numerator += get_base_reward(p, state, index, brpi) * weight

    proposer_reward_denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT
    )
    proposer_reward = proposer_reward_numerator // proposer_reward_denominator
    increase_balance(state, ctx.get_beacon_proposer(state.slot), proposer_reward)


def eth_fast_aggregate_verify(pubkeys, signing_root: bytes, signature: bytes) -> bool:
    """eth_fast_aggregate_verify: the G2 point-at-infinity signature is valid
    for an empty participant set (altair/bls.md)."""
    from ..crypto.bls.api import Signature, fast_aggregate_verify

    G2_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 95
    if not pubkeys and bytes(signature) == G2_POINT_AT_INFINITY:
        return True
    try:
        sig = Signature.from_bytes(bytes(signature))
    except ValueError:
        return False
    return fast_aggregate_verify(pubkeys, signing_root, sig)


def sync_aggregate_signing_root(p: Preset, state) -> bytes:
    """Signing root for a block's sync aggregate: the previous slot's block
    root under DOMAIN_SYNC_COMMITTEE (block/processSyncCommittee.ts)."""
    previous_slot = max(state.slot, 1) - 1
    domain = get_domain(p, state, DOMAIN_SYNC_COMMITTEE, compute_epoch_at_slot(p, previous_slot))
    root = get_block_root_at_slot(p, state, previous_slot)
    return compute_signing_root(p, Bytes32, root, domain)


def process_sync_aggregate(
    p: Preset, cfg: ChainConfig, ctx: EpochContext, state, sync_aggregate, verify_signatures: bool
) -> None:
    """Spec process_sync_aggregate (block/processSyncCommittee.ts).  With
    verify_signatures=False the aggregate signature is collected by
    signature_sets.sync_aggregate_signature_set for the batched dispatch."""
    committee_pubkeys = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    bits = list(sync_aggregate.sync_committee_bits)
    if len(bits) != len(committee_pubkeys):
        raise BlockProcessingError("sync committee bits length mismatch")

    # structural empty-aggregate check, independent of signature deferral:
    # zero participants is only valid with the G2 infinity signature
    # (eth_fast_aggregate_verify, altair/bls.md)
    if not any(bits) and bytes(sync_aggregate.sync_committee_signature) != b"\xc0" + b"\x00" * 95:
        raise BlockProcessingError("empty sync aggregate with non-infinity signature")

    if verify_signatures:
        from ..crypto.bls.api import PublicKey

        participant_pubkeys = [
            PublicKey.from_bytes(pk) for pk, bit in zip(committee_pubkeys, bits) if bit
        ]
        root = sync_aggregate_signing_root(p, state)
        if not eth_fast_aggregate_verify(
            participant_pubkeys, root, bytes(sync_aggregate.sync_committee_signature)
        ):
            raise BlockProcessingError("invalid sync committee signature")

    # rewards (exact integer spec arithmetic)
    total_active_increments = get_total_active_balance(p, state) // p.EFFECTIVE_BALANCE_INCREMENT
    brpi = get_base_reward_per_increment(p, get_total_active_balance(p, state))
    total_base_rewards = brpi * total_active_increments
    max_participant_rewards = (
        total_base_rewards * SYNC_REWARD_WEIGHT // WEIGHT_DENOMINATOR // p.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // p.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )

    proposer_index = ctx.get_beacon_proposer(state.slot)
    committee_indices = [ctx.pubkey2index.get(pk) for pk in committee_pubkeys]
    for participant_index, bit in zip(committee_indices, bits):
        if participant_index is None:
            raise BlockProcessingError("sync committee pubkey unknown")
        if bit:
            increase_balance(state, participant_index, participant_reward)
            increase_balance(state, proposer_index, proposer_reward)
        else:
            decrease_balance(state, participant_index, participant_reward)


# ---------------------------------------------------------------------------
# sync committee selection
# ---------------------------------------------------------------------------


def get_next_sync_committee_indices(p: Preset, state) -> List[int]:
    """Spec get_next_sync_committee_indices: effective-balance-weighted
    sampling over the shuffled active set (util/syncCommittee.ts)."""
    epoch = compute_epoch_at_slot(p, state.slot) + 1
    active = get_active_validator_indices(state, epoch)
    count = len(active)
    seed = get_seed(p, state, epoch, DOMAIN_SYNC_COMMITTEE)
    indices: List[int] = []
    i = 0
    while len(indices) < p.SYNC_COMMITTEE_SIZE:
        shuffled = compute_shuffled_index(i % count, count, seed, p.SHUFFLE_ROUND_COUNT)
        candidate = active[shuffled]
        random_byte = _sha(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * 255 >= p.MAX_EFFECTIVE_BALANCE * random_byte:
            indices.append(int(candidate))
        i += 1
    return indices


def get_next_sync_committee(p: Preset, state):
    """Spec get_next_sync_committee: member pubkeys + aggregate."""
    from ..crypto.bls.api import PublicKey, aggregate_pubkeys

    indices = get_next_sync_committee_indices(p, state)
    pubkeys = [bytes(state.validators[i].pubkey) for i in indices]
    agg = aggregate_pubkeys([PublicKey.from_bytes(pk) for pk in pubkeys])
    return Fields(pubkeys=pubkeys, aggregate_pubkey=agg.to_bytes())


# ---------------------------------------------------------------------------
# epoch path
# ---------------------------------------------------------------------------


def get_unslashed_participating_mask(p: Preset, state, flag_index: int, epoch: int) -> np.ndarray:
    """Boolean mask of unslashed validators active at `epoch` with the flag."""
    current_epoch = compute_epoch_at_slot(p, state.slot)
    participation = (
        state.current_epoch_participation
        if epoch == current_epoch
        else state.previous_epoch_participation
    )
    n = len(state.validators)
    flags = np.fromiter((int(f) for f in participation), dtype=np.uint8, count=n)
    has = (flags & (1 << flag_index)) != 0
    slashed = np.fromiter((v.slashed for v in state.validators), dtype=bool, count=n)
    activation = np.fromiter(
        (v.activation_epoch for v in state.validators), dtype=np.uint64, count=n
    )
    exit_e = np.fromiter((v.exit_epoch for v in state.validators), dtype=np.uint64, count=n)
    active = (activation <= epoch) & (epoch < exit_e)
    return has & ~slashed & active


def _eligible_mask(p: Preset, state) -> np.ndarray:
    current_epoch = compute_epoch_at_slot(p, state.slot)
    previous_epoch = max(GENESIS_EPOCH, current_epoch - 1)
    n = len(state.validators)
    slashed = np.fromiter((v.slashed for v in state.validators), dtype=bool, count=n)
    activation = np.fromiter(
        (v.activation_epoch for v in state.validators), dtype=np.uint64, count=n
    )
    exit_e = np.fromiter((v.exit_epoch for v in state.validators), dtype=np.uint64, count=n)
    withdrawable = np.fromiter(
        (v.withdrawable_epoch for v in state.validators), dtype=np.uint64, count=n
    )
    active_prev = (activation <= previous_epoch) & (previous_epoch < exit_e)
    return active_prev | (slashed & (previous_epoch + 1 < withdrawable))


def process_justification_and_finalization_altair(p: Preset, state) -> None:
    """Altair justification: target balances come from participation flags
    (epoch/processJustificationAndFinalization.ts)."""
    from .epoch import weigh_justification_and_finalization, EpochFlags

    current_epoch = compute_epoch_at_slot(p, state.slot)
    if current_epoch <= GENESIS_EPOCH + 1:
        return
    previous_epoch = max(GENESIS_EPOCH, current_epoch - 1)
    n = len(state.validators)
    eb = np.fromiter(
        (v.effective_balance for v in state.validators), dtype=np.uint64, count=n
    )
    prev_mask = get_unslashed_participating_mask(
        p, state, TIMELY_TARGET_FLAG_INDEX, previous_epoch
    )
    cur_mask = get_unslashed_participating_mask(p, state, TIMELY_TARGET_FLAG_INDEX, current_epoch)
    prev_target_balance = max(p.EFFECTIVE_BALANCE_INCREMENT, int(eb[prev_mask].sum()))
    cur_target_balance = max(p.EFFECTIVE_BALANCE_INCREMENT, int(eb[cur_mask].sum()))
    flags = EpochFlags(
        current_epoch=current_epoch,
        previous_epoch=previous_epoch,
        total_active_balance=get_total_active_balance(p, state),
        active_prev=np.zeros(n, dtype=bool),
        active_cur=np.zeros(n, dtype=bool),
        eligible=np.zeros(n, dtype=bool),
        prev_source=np.zeros(n, dtype=bool),
        prev_target=np.zeros(n, dtype=bool),
        prev_head=np.zeros(n, dtype=bool),
        cur_target=np.zeros(n, dtype=bool),
        inclusion_delay=np.zeros(n, dtype=np.uint64),
        proposer_index=np.zeros(n, dtype=np.int64),
        effective_balance=eb,
    )
    weigh_justification_and_finalization(p, state, flags, prev_target_balance, cur_target_balance)


def process_inactivity_updates(p: Preset, cfg: ChainConfig, state) -> None:
    """Spec process_inactivity_updates (epoch/processInactivityUpdates.ts)."""
    current_epoch = compute_epoch_at_slot(p, state.slot)
    if current_epoch == GENESIS_EPOCH:
        return
    previous_epoch = max(GENESIS_EPOCH, current_epoch - 1)
    target_mask = get_unslashed_participating_mask(
        p, state, TIMELY_TARGET_FLAG_INDEX, previous_epoch
    )
    eligible = _eligible_mask(p, state)
    finality_delay = previous_epoch - state.finalized_checkpoint.epoch
    is_leak = finality_delay > p.MIN_EPOCHS_TO_INACTIVITY_PENALTY
    scores = np.asarray(state.inactivity_scores, dtype=np.int64)
    updated = np.where(
        target_mask,
        scores - np.minimum(1, scores),
        scores + cfg.INACTIVITY_SCORE_BIAS,
    )
    if not is_leak:
        updated = updated - np.minimum(cfg.INACTIVITY_SCORE_RECOVERY_RATE, updated)
    state.inactivity_scores = (
        np.where(eligible, updated, scores).astype(np.uint64).tolist()
    )


def get_flag_index_deltas(p: Preset, state, flag_index: int):
    """Vectorized spec get_flag_index_deltas."""
    n = len(state.validators)
    rewards = np.zeros(n, dtype=np.int64)
    penalties = np.zeros(n, dtype=np.int64)
    current_epoch = compute_epoch_at_slot(p, state.slot)
    previous_epoch = max(GENESIS_EPOCH, current_epoch - 1)
    eb = np.fromiter((v.effective_balance for v in state.validators), dtype=np.int64, count=n)
    increment = p.EFFECTIVE_BALANCE_INCREMENT

    unslashed = get_unslashed_participating_mask(p, state, flag_index, previous_epoch)
    weight = PARTICIPATION_FLAG_WEIGHTS[flag_index]
    total_active = get_total_active_balance(p, state)
    brpi = get_base_reward_per_increment(p, total_active)
    base_reward = (eb // increment) * brpi

    unslashed_balance = max(increment, int(eb[unslashed].sum()))
    unslashed_increments = unslashed_balance // increment
    active_increments = total_active // increment

    eligible = _eligible_mask(p, state)
    finality_delay = previous_epoch - state.finalized_checkpoint.epoch
    is_leak = finality_delay > p.MIN_EPOCHS_TO_INACTIVITY_PENALTY

    gain = eligible & unslashed
    if not is_leak:
        reward_numerator = base_reward * weight * unslashed_increments
        rewards[gain] += (reward_numerator // (active_increments * WEIGHT_DENOMINATOR))[gain]
    if flag_index != TIMELY_HEAD_FLAG_INDEX:
        lose = eligible & ~unslashed
        penalties[lose] += (base_reward * weight // WEIGHT_DENOMINATOR)[lose]
    return rewards, penalties


def get_inactivity_penalty_deltas(p: Preset, cfg: ChainConfig, state):
    """Spec get_inactivity_penalty_deltas (altair quotient)."""
    n = len(state.validators)
    penalties = np.zeros(n, dtype=np.int64)
    current_epoch = compute_epoch_at_slot(p, state.slot)
    previous_epoch = max(GENESIS_EPOCH, current_epoch - 1)
    target_mask = get_unslashed_participating_mask(
        p, state, TIMELY_TARGET_FLAG_INDEX, previous_epoch
    )
    eligible = _eligible_mask(p, state)
    hit = eligible & ~target_mask
    # python-int products: eb * inactivity_score can exceed int64 during
    # long leaks; keep the per-hit loop but bound it to the hit set (tiny
    # outside leaks) instead of iterating the whole registry
    for i in np.nonzero(hit)[0]:
        i = int(i)
        penalty_numerator = state.validators[i].effective_balance * state.inactivity_scores[i]
        penalties[i] += penalty_numerator // (
            cfg.INACTIVITY_SCORE_BIAS * p.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
        )
    return penalties


def process_rewards_and_penalties_altair(p: Preset, cfg: ChainConfig, state) -> None:
    current_epoch = compute_epoch_at_slot(p, state.slot)
    if current_epoch == GENESIS_EPOCH:
        return
    n = len(state.validators)
    rewards = np.zeros(n, dtype=np.int64)
    penalties = np.zeros(n, dtype=np.int64)
    for flag_index in range(len(PARTICIPATION_FLAG_WEIGHTS)):
        r, pn = get_flag_index_deltas(p, state, flag_index)
        rewards += r
        penalties += pn
    penalties += get_inactivity_penalty_deltas(p, cfg, state)
    # vectorized write-back (mirrors the phase0 path; mainnet IS altair+,
    # so this loop is the one production actually runs at 250k+ registry
    # sizes — review r4)
    bal = np.asarray(state.balances, dtype=np.int64)
    state.balances = np.maximum(0, bal + rewards - penalties).astype(np.uint64).tolist()


def process_slashings_altair(p: Preset, state) -> None:
    """Phase0 process_slashings with the altair multiplier."""
    epoch = compute_epoch_at_slot(p, state.slot)
    total = get_total_active_balance(p, state)
    total_slashings = sum(state.slashings)
    adjusted = min(total_slashings * p.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR, total)
    increment = p.EFFECTIVE_BALANCE_INCREMENT
    n = len(state.validators)
    slashed = np.fromiter((v.slashed for v in state.validators), bool, count=n)
    withdrawable = np.fromiter(
        (v.withdrawable_epoch for v in state.validators), np.uint64, count=n
    )
    for i in np.nonzero(
        slashed & (withdrawable == epoch + p.EPOCHS_PER_SLASHINGS_VECTOR // 2)
    )[0]:
        i = int(i)
        v = state.validators[i]
        penalty_numerator = (v.effective_balance // increment) * adjusted
        penalty = penalty_numerator // total * increment
        state.balances[i] = max(0, state.balances[i] - penalty)


def process_participation_flag_updates(state) -> None:
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = [0] * len(state.validators)


def process_sync_committee_updates(p: Preset, state) -> None:
    next_epoch = compute_epoch_at_slot(p, state.slot) + 1
    if next_epoch % p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(p, state)


def process_epoch_altair(p: Preset, cfg: ChainConfig, ctx: EpochContext, state) -> None:
    """Altair epoch transition (stateTransition.ts processEpoch dispatch)."""
    from .epoch import (
        process_effective_balance_updates,
        process_eth1_data_reset,
        process_historical_roots_update,
        process_randao_mixes_reset,
        process_registry_updates,
        process_slashings_reset,
    )

    process_justification_and_finalization_altair(p, state)
    process_inactivity_updates(p, cfg, state)
    process_rewards_and_penalties_altair(p, cfg, state)
    process_registry_updates(p, cfg, state)
    process_slashings_altair(p, state)
    process_eth1_data_reset(p, state)
    process_effective_balance_updates(p, state)
    process_slashings_reset(p, state)
    process_randao_mixes_reset(p, state)
    process_historical_roots_update(p, state)
    process_participation_flag_updates(state)
    process_sync_committee_updates(p, state)
