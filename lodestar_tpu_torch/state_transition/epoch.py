"""Phase0 epoch processing (consensus spec beacon-chain.md, v1.1.10).

Reference: packages/state-transition/src/epoch/ (16 files) with the
beforeProcessEpoch single-pass precompute (src/cache/epochProcess.ts:405).

The precompute (`EpochFlags`) walks the pending attestations once and
leaves per-validator boolean/int numpy columns; every reward/penalty rule
below is then a vectorized expression over those columns — the
array-oriented layout the reference chose for its hot loop, which is also
the one a future device offload consumes unchanged (SURVEY §7 hard part 5).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

from ..config.chain_config import ChainConfig
from ..params import (
    BASE_REWARDS_PER_EPOCH,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    JUSTIFICATION_BITS_LENGTH,
    Preset,
)
from ..ssz import Fields
from ..types import get_types
from .epoch_context import EpochContext, compute_epoch_shuffling
from .misc import (
    compute_activation_exit_epoch,
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_active_validator_indices,
    get_randao_mix,
    integer_squareroot,
)
from .validator_ops import get_validator_churn_limit, initiate_validator_exit


@dataclasses.dataclass
class EpochFlags:
    """Columnar per-validator attestation participation (epochProcess.ts)."""

    current_epoch: int
    previous_epoch: int
    total_active_balance: int
    active_prev: np.ndarray  # bool
    active_cur: np.ndarray  # bool
    eligible: np.ndarray  # bool: active_prev or (slashed and not yet withdrawable)
    prev_source: np.ndarray  # bool, unslashed attesters
    prev_target: np.ndarray
    prev_head: np.ndarray
    cur_target: np.ndarray
    inclusion_delay: np.ndarray  # uint64, 0 = none
    proposer_index: np.ndarray  # int64, -1 = none
    effective_balance: np.ndarray  # uint64


def before_process_epoch(p: Preset, ctx: EpochContext, state) -> EpochFlags:
    n = len(state.validators)
    current_epoch = compute_epoch_at_slot(p, state.slot)
    previous_epoch = max(GENESIS_EPOCH, current_epoch - 1)

    eb = np.array([v.effective_balance for v in state.validators], dtype=np.uint64)
    slashed = np.array([v.slashed for v in state.validators], dtype=bool)
    activation = np.array([v.activation_epoch for v in state.validators], dtype=np.uint64)
    exit_e = np.array([v.exit_epoch for v in state.validators], dtype=np.uint64)
    withdrawable = np.array([v.withdrawable_epoch for v in state.validators], dtype=np.uint64)

    active_prev = (activation <= previous_epoch) & (previous_epoch < exit_e)
    active_cur = (activation <= current_epoch) & (current_epoch < exit_e)
    eligible = active_prev | (slashed & (previous_epoch + 1 < withdrawable))

    total_active = int(eb[active_cur].sum())
    total_active = max(total_active, p.EFFECTIVE_BALANCE_INCREMENT)

    prev_source = np.zeros(n, dtype=bool)
    prev_target = np.zeros(n, dtype=bool)
    prev_head = np.zeros(n, dtype=bool)
    cur_target = np.zeros(n, dtype=bool)
    inclusion_delay = np.zeros(n, dtype=np.uint64)
    proposer_index = np.full(n, -1, dtype=np.int64)

    def block_root_at_slot(slot: int) -> bytes:
        return state.block_roots[slot % p.SLOTS_PER_HISTORICAL_ROOT]

    def epoch_boundary_root(epoch: int) -> bytes:
        slot = compute_start_slot_at_epoch(p, epoch)
        if slot == state.slot:
            # latest header with possibly-zero state root: matches spec
            # get_block_root semantics only for slot < state.slot; callers
            # only hit this during the epoch transition where slot < state.slot
            raise AssertionError("epoch boundary root queried at current slot")
        return block_root_at_slot(slot)

    prev_boundary = epoch_boundary_root(previous_epoch)
    cur_boundary = epoch_boundary_root(current_epoch) if state.slot > compute_start_slot_at_epoch(p, current_epoch) else None

    for att in state.previous_epoch_attestations:
        data = att.data
        committee = ctx.get_beacon_committee(data.slot, data.index)
        attesters = committee[np.asarray(att.aggregation_bits, dtype=bool)]
        # source match is a precondition of inclusion (process_attestation)
        is_target = data.target.root == prev_boundary
        is_head = data.beacon_block_root == block_root_at_slot(data.slot)
        unslashed = attesters[~slashed[attesters]]
        prev_source[unslashed] = True
        if is_target:
            prev_target[unslashed] = True
            if is_head:
                prev_head[unslashed] = True
        # min inclusion delay + its proposer (for proposer/inclusion rewards)
        for vi in attesters:
            if inclusion_delay[vi] == 0 or att.inclusion_delay < inclusion_delay[vi]:
                inclusion_delay[vi] = att.inclusion_delay
                proposer_index[vi] = att.proposer_index

    for att in state.current_epoch_attestations:
        data = att.data
        if cur_boundary is not None and data.target.root == cur_boundary:
            committee = ctx.get_beacon_committee(data.slot, data.index)
            attesters = committee[np.asarray(att.aggregation_bits, dtype=bool)]
            cur_target[attesters[~slashed[attesters]]] = True

    return EpochFlags(
        current_epoch=current_epoch,
        previous_epoch=previous_epoch,
        total_active_balance=total_active,
        active_prev=active_prev,
        active_cur=active_cur,
        eligible=eligible,
        prev_source=prev_source,
        prev_target=prev_target,
        prev_head=prev_head,
        cur_target=cur_target,
        inclusion_delay=inclusion_delay,
        proposer_index=proposer_index,
        effective_balance=eb,
    )


def process_epoch(p: Preset, cfg: ChainConfig, ctx: EpochContext, state) -> None:
    flags = before_process_epoch(p, ctx, state)
    process_justification_and_finalization(p, state, flags)
    process_rewards_and_penalties(p, cfg, state, flags)
    process_registry_updates(p, cfg, state)
    process_slashings(p, state, flags)
    process_eth1_data_reset(p, state)
    process_effective_balance_updates(p, state)
    process_slashings_reset(p, state)
    process_randao_mixes_reset(p, state)
    process_historical_roots_update(p, state)
    process_participation_record_updates(state)


# -- justification / finalization -------------------------------------------


def process_justification_and_finalization(p: Preset, state, flags: EpochFlags) -> None:
    if flags.current_epoch <= GENESIS_EPOCH + 1:
        return
    prev_target_balance = int(flags.effective_balance[flags.prev_target & flags.active_prev].sum())
    cur_target_balance = int(flags.effective_balance[flags.cur_target & flags.active_cur].sum())
    weigh_justification_and_finalization(p, state, flags, prev_target_balance, cur_target_balance)


def weigh_justification_and_finalization(
    p: Preset, state, flags: EpochFlags, prev_target_balance: int, cur_target_balance: int
) -> None:
    previous_epoch = flags.previous_epoch
    current_epoch = flags.current_epoch
    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint
    total = flags.total_active_balance

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[: JUSTIFICATION_BITS_LENGTH - 1]

    def boundary_root(epoch: int) -> bytes:
        return state.block_roots[compute_start_slot_at_epoch(p, epoch) % p.SLOTS_PER_HISTORICAL_ROOT]

    if prev_target_balance * 3 >= total * 2:
        state.current_justified_checkpoint = Fields(epoch=previous_epoch, root=boundary_root(previous_epoch))
        bits[1] = True
    if cur_target_balance * 3 >= total * 2:
        state.current_justified_checkpoint = Fields(epoch=current_epoch, root=boundary_root(current_epoch))
        bits[0] = True
    state.justification_bits = bits

    # finalization rules
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


# -- rewards / penalties -----------------------------------------------------


def get_attestation_component_deltas(p: Preset, cfg: ChainConfig, state, flags: EpochFlags):
    """Vectorized phase0 attestation deltas, split into the spec's five
    components (source/target/head, inclusion_delay, inactivity) — the
    shapes the official rewards vectors pin individually (reference
    getAttestationDeltas / spec get_*_deltas)."""
    n = len(flags.effective_balance)

    total = flags.total_active_balance
    sqrt_total = integer_squareroot(total)
    eb = flags.effective_balance.astype(np.int64)
    base_reward = eb * p.BASE_REWARD_FACTOR // sqrt_total // BASE_REWARDS_PER_EPOCH
    proposer_reward = base_reward // p.PROPOSER_REWARD_QUOTIENT

    eligible = flags.eligible
    increment = p.EFFECTIVE_BALANCE_INCREMENT
    finality_delay = flags.previous_epoch - state.finalized_checkpoint.epoch
    is_inactivity_leak = finality_delay > p.MIN_EPOCHS_TO_INACTIVITY_PENALTY

    components = {}
    for attesting, key in (
        (flags.prev_source, "source"),
        (flags.prev_target, "target"),
        (flags.prev_head, "head"),
    ):
        rewards = np.zeros(n, dtype=np.int64)
        penalties = np.zeros(n, dtype=np.int64)
        unslashed = attesting & eligible
        attesting_balance = int(flags.effective_balance[attesting].sum())
        if is_inactivity_leak:
            # optimal participation assumed: full base reward
            rewards[unslashed] += base_reward[unslashed]
        else:
            reward_numerator = base_reward * (attesting_balance // increment)
            rewards[unslashed] += (reward_numerator // (total // increment))[unslashed]
        penalties[eligible & ~attesting] += base_reward[eligible & ~attesting]
        components[key] = (rewards, penalties)

    # proposer + inclusion delay micro-rewards (for source attesters)
    rewards = np.zeros(n, dtype=np.int64)
    has_delay = (flags.inclusion_delay > 0) & flags.prev_source & eligible
    for vi in np.nonzero(has_delay)[0]:
        pi = int(flags.proposer_index[vi])
        if pi >= 0:
            rewards[pi] += int(proposer_reward[vi])
        max_attester_reward = int(base_reward[vi] - proposer_reward[vi])
        rewards[vi] += max_attester_reward // int(flags.inclusion_delay[vi])
    components["inclusion_delay"] = (rewards, np.zeros(n, dtype=np.int64))

    penalties = np.zeros(n, dtype=np.int64)
    if is_inactivity_leak:
        penalties[eligible] += (BASE_REWARDS_PER_EPOCH * base_reward - proposer_reward)[eligible]
        not_target = eligible & ~flags.prev_target
        penalties[not_target] += (
            eb[not_target] * finality_delay // p.INACTIVITY_PENALTY_QUOTIENT
        )
    components["inactivity"] = (np.zeros(n, dtype=np.int64), penalties)
    return components


def get_attestation_deltas(p: Preset, cfg: ChainConfig, state, flags: EpochFlags):
    """Combined phase0 get_attestation_deltas (sum of the components)."""
    components = get_attestation_component_deltas(p, cfg, state, flags)
    n = len(flags.effective_balance)
    rewards = np.zeros(n, dtype=np.int64)
    penalties = np.zeros(n, dtype=np.int64)
    for r, pen in components.values():
        rewards += r
        penalties += pen
    return rewards, penalties


def process_rewards_and_penalties(p: Preset, cfg: ChainConfig, state, flags: EpochFlags) -> None:
    if flags.current_epoch == GENESIS_EPOCH:
        return
    rewards, penalties = get_attestation_deltas(p, cfg, state, flags)
    # one vectorized pass + a C-level tolist(): the 250k-iteration python
    # write loop was the scale bottleneck
    bal = np.asarray(state.balances, dtype=np.int64)
    new_bal = np.maximum(0, bal + rewards.astype(np.int64) - penalties.astype(np.int64))
    state.balances = new_bal.astype(np.uint64).tolist()


# -- registry ----------------------------------------------------------------


def process_registry_updates(p: Preset, cfg: ChainConfig, state) -> None:
    current_epoch = compute_epoch_at_slot(p, state.slot)
    n = len(state.validators)
    # columnar prefilters: the conditions hit a handful of validators per
    # epoch; only those indices take the python path
    elig_e = np.fromiter(
        (v.activation_eligibility_epoch for v in state.validators), np.uint64, count=n
    )
    act_e = np.fromiter((v.activation_epoch for v in state.validators), np.uint64, count=n)
    exit_e = np.fromiter((v.exit_epoch for v in state.validators), np.uint64, count=n)
    eb = np.fromiter((v.effective_balance for v in state.validators), np.uint64, count=n)

    for i in np.nonzero(
        (elig_e == FAR_FUTURE_EPOCH) & (eb == p.MAX_EFFECTIVE_BALANCE)
    )[0]:
        state.validators[int(i)].activation_eligibility_epoch = current_epoch + 1
    for i in np.nonzero(
        (act_e <= current_epoch) & (current_epoch < exit_e) & (eb <= cfg.EJECTION_BALANCE)
    )[0]:
        initiate_validator_exit(p, cfg, state, int(i))

    # activation queue, FIFO by (eligibility epoch, index); re-read
    # eligibility since the first pass may have set it this epoch
    elig_e = np.fromiter(
        (v.activation_eligibility_epoch for v in state.validators), np.uint64, count=n
    )
    candidates = np.nonzero(
        (elig_e != FAR_FUTURE_EPOCH)
        & (elig_e <= state.finalized_checkpoint.epoch)
        & (act_e == FAR_FUTURE_EPOCH)
    )[0]
    queue = sorted((int(i) for i in candidates), key=lambda i: (int(elig_e[i]), i))
    active_count = int(((act_e <= current_epoch) & (current_epoch < exit_e)).sum())
    churn = get_validator_churn_limit(cfg, active_count)
    for i in queue[:churn]:
        state.validators[i].activation_epoch = compute_activation_exit_epoch(p, current_epoch)


# -- slashings ---------------------------------------------------------------


def process_slashings(p: Preset, state, flags: EpochFlags) -> None:
    epoch = flags.current_epoch
    total = flags.total_active_balance
    total_slashings = sum(state.slashings)
    multiplier = p.PROPORTIONAL_SLASHING_MULTIPLIER
    adjusted = min(total_slashings * multiplier, total)
    increment = p.EFFECTIVE_BALANCE_INCREMENT
    n = len(state.validators)
    slashed = np.fromiter((v.slashed for v in state.validators), bool, count=n)
    withdrawable = np.fromiter(
        (v.withdrawable_epoch for v in state.validators), np.uint64, count=n
    )
    hits = np.nonzero(
        slashed & (withdrawable == epoch + p.EPOCHS_PER_SLASHINGS_VECTOR // 2)
    )[0]
    for i in hits:
        i = int(i)
        v = state.validators[i]
        penalty_numerator = (v.effective_balance // increment) * adjusted
        penalty = penalty_numerator // total * increment
        state.balances[i] = max(0, state.balances[i] - penalty)


# -- housekeeping ------------------------------------------------------------


def process_eth1_data_reset(p: Preset, state) -> None:
    next_epoch = compute_epoch_at_slot(p, state.slot) + 1
    if next_epoch % p.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(p: Preset, state) -> None:
    hysteresis_increment = p.EFFECTIVE_BALANCE_INCREMENT // p.HYSTERESIS_QUOTIENT
    down = hysteresis_increment * p.HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis_increment * p.HYSTERESIS_UPWARD_MULTIPLIER
    n = len(state.validators)
    bal = np.asarray(state.balances, dtype=np.uint64)
    eb = np.fromiter((v.effective_balance for v in state.validators), np.uint64, count=n)
    # hysteresis means only validators whose balance drifted get touched
    hits = np.nonzero((bal + down < eb) | (eb + up < bal))[0]
    for i in hits:
        i = int(i)
        balance = state.balances[i]
        state.validators[i].effective_balance = min(
            balance - balance % p.EFFECTIVE_BALANCE_INCREMENT, p.MAX_EFFECTIVE_BALANCE
        )


def process_slashings_reset(p: Preset, state) -> None:
    next_epoch = compute_epoch_at_slot(p, state.slot) + 1
    state.slashings[next_epoch % p.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(p: Preset, state) -> None:
    current_epoch = compute_epoch_at_slot(p, state.slot)
    next_epoch = current_epoch + 1
    state.randao_mixes[next_epoch % p.EPOCHS_PER_HISTORICAL_VECTOR] = get_randao_mix(
        p, state, current_epoch
    )


def process_historical_roots_update(p: Preset, state) -> None:
    next_epoch = compute_epoch_at_slot(p, state.slot) + 1
    if next_epoch % (p.SLOTS_PER_HISTORICAL_ROOT // p.SLOTS_PER_EPOCH) == 0:
        t = get_types(p).phase0
        batch = Fields(block_roots=list(state.block_roots), state_roots=list(state.state_roots))
        state.historical_roots.append(t.HistoricalBatch.hash_tree_root(batch))


def process_participation_record_updates(state) -> None:
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []
