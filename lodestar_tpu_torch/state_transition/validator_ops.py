"""Validator mutation helpers: exits, slashing, churn.

Reference: packages/state-transition/src/util/validator.ts and
src/block/{initiateValidatorExit,slashValidator}.ts (consensus spec
beacon-chain.md mutators).
"""

from __future__ import annotations

from ..config.chain_config import ChainConfig
from ..params import FAR_FUTURE_EPOCH, Preset
from .misc import (
    compute_activation_exit_epoch,
    compute_epoch_at_slot,
    decrease_balance,
    get_active_validator_indices,
    increase_balance,
)


def get_validator_churn_limit(cfg: ChainConfig, active_count: int) -> int:
    return max(cfg.MIN_PER_EPOCH_CHURN_LIMIT, active_count // cfg.CHURN_LIMIT_QUOTIENT)


def initiate_validator_exit(p: Preset, cfg: ChainConfig, state, index: int) -> None:
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    current_epoch = compute_epoch_at_slot(p, state.slot)
    exit_epochs = [w.exit_epoch for w in state.validators if w.exit_epoch != FAR_FUTURE_EPOCH]
    exit_queue_epoch = max(exit_epochs + [compute_activation_exit_epoch(p, current_epoch)])
    exit_queue_churn = sum(1 for w in state.validators if w.exit_epoch == exit_queue_epoch)
    active_count = len(get_active_validator_indices(state, current_epoch))
    if exit_queue_churn >= get_validator_churn_limit(cfg, active_count):
        exit_queue_epoch += 1
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = exit_queue_epoch + cfg.MIN_VALIDATOR_WITHDRAWABILITY_DELAY


def slash_validator(
    p: Preset,
    cfg: ChainConfig,
    state,
    slashed_index: int,
    proposer_index: int,
    whistleblower_index: int | None = None,
) -> None:
    """Spec slash_validator (phase0 quotients)."""
    epoch = compute_epoch_at_slot(p, state.slot)
    initiate_validator_exit(p, cfg, state, slashed_index)
    v = state.validators[slashed_index]
    v.slashed = True
    v.withdrawable_epoch = max(v.withdrawable_epoch, epoch + p.EPOCHS_PER_SLASHINGS_VECTOR)
    state.slashings[epoch % p.EPOCHS_PER_SLASHINGS_VECTOR] += v.effective_balance
    decrease_balance(state, slashed_index, v.effective_balance // p.MIN_SLASHING_PENALTY_QUOTIENT)

    whistleblower_reward = v.effective_balance // p.WHISTLEBLOWER_REWARD_QUOTIENT
    proposer_reward = whistleblower_reward // p.PROPOSER_REWARD_QUOTIENT
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)
