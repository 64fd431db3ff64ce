"""Weak subjectivity period computation.

Reference: packages/state-transition/src/util/weakSubjectivity.ts
(computeWeakSubjectivityPeriod per the consensus specs' weak-subjectivity
guide, with the reference's default safety decay of 10%).
"""

from __future__ import annotations

from ..params import Preset
from .misc import compute_epoch_at_slot

# default safety decay percentage (weakSubjectivity.ts DEFAULT_SAFETY_DECAY)
DEFAULT_SAFETY_DECAY = 10

# churn constants (chain config in the reference; mainnet values)
MIN_PER_EPOCH_CHURN_LIMIT = 4
CHURN_LIMIT_QUOTIENT = 65536
MIN_VALIDATOR_WITHDRAWABILITY_DELAY = 256


def get_churn_limit(p: Preset, active_validator_count: int) -> int:
    return max(MIN_PER_EPOCH_CHURN_LIMIT, active_validator_count // CHURN_LIMIT_QUOTIENT)


def compute_weak_subjectivity_period(
    p: Preset, state, safety_decay: int = DEFAULT_SAFETY_DECAY
) -> int:
    """ws_period in epochs for `state` (weakSubjectivity.ts:38).

    Two-regime formula: the churn branch applies when the average active
    balance is near the 32 ETH cap; otherwise the deposit branch bounds
    the adversary's stake turnover.
    """
    epoch = compute_epoch_at_slot(p, state.slot)
    active = [
        i
        for i, v in enumerate(state.validators)
        if v.activation_epoch <= epoch < v.exit_epoch
    ]
    N = len(active)
    ws_period = MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    if N == 0:
        return ws_period
    # t = average EFFECTIVE balance in ETH, via effective-balance increments
    # (computeWeakSubjectivityPeriodFromConstituents uses
    # totalActiveBalanceIncrements — raw balances above the 32 ETH cap would
    # inflate ws_period beyond the verified formula)
    increment = p.EFFECTIVE_BALANCE_INCREMENT
    total_increments = sum(
        int(state.validators[i].effective_balance) // increment for i in active
    )
    eth_per_increment = increment // 10**9  # 1 for mainnet/minimal presets
    t = (total_increments // N) * eth_per_increment
    T = p.MAX_EFFECTIVE_BALANCE // 10**9
    delta = get_churn_limit(p, N)
    Delta = p.MAX_DEPOSITS * p.SLOTS_PER_EPOCH
    D = safety_decay
    if T * (200 + 3 * D) < t * (200 + 12 * D):
        epochs_for_validator_set_churn = (
            N * (t * (200 + 12 * D) - T * (200 + 3 * D))
        ) // (600 * delta * (2 * t + T))
        epochs_for_balance_top_ups = (N * (200 + 3 * D)) // (600 * Delta)
        ws_period += max(epochs_for_validator_set_churn, epochs_for_balance_top_ups)
    elif T != t:
        ws_period += (3 * N * D * t) // (200 * Delta * (T - t))
    return ws_period


def is_within_weak_subjectivity_period(
    p: Preset, ws_state, ws_checkpoint_epoch: int, current_epoch: int
) -> bool:
    """isWithinWeakSubjectivityPeriod (weakSubjectivity.ts:94)."""
    ws_period = compute_weak_subjectivity_period(p, ws_state)
    return current_epoch <= ws_checkpoint_epoch + ws_period
