"""Spec misc helpers (consensus spec beacon-chain.md "Helper functions").

Reference: packages/state-transition/src/util/{epoch,seed,validator,math}.ts.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

from ..params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    FAR_FUTURE_EPOCH,
    Preset,
)
from .shuffle import compute_shuffled_index


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def integer_squareroot(n: int) -> int:
    if n < 0:
        raise ValueError
    x, y = n, (n + 1) // 2
    while y < x:
        x, y = y, (y + n // y) // 2
    return x


def compute_epoch_at_slot(p: Preset, slot: int) -> int:
    return slot // p.SLOTS_PER_EPOCH


def compute_start_slot_at_epoch(p: Preset, epoch: int) -> int:
    return epoch * p.SLOTS_PER_EPOCH


def compute_activation_exit_epoch(p: Preset, epoch: int) -> int:
    return epoch + 1 + p.MAX_SEED_LOOKAHEAD


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def get_active_validator_indices(state, epoch: int) -> List[int]:
    # columnar: two array pulls + one boolean mask beat 250k+ attribute
    # probes at registry scale
    import numpy as np

    activation = np.fromiter(
        (v.activation_epoch for v in state.validators), dtype=np.uint64,
        count=len(state.validators),
    )
    exit_e = np.fromiter(
        (v.exit_epoch for v in state.validators), dtype=np.uint64,
        count=len(state.validators),
    )
    return np.nonzero((activation <= epoch) & (epoch < exit_e))[0].tolist()


def get_randao_mix(p: Preset, state, epoch: int) -> bytes:
    return state.randao_mixes[epoch % p.EPOCHS_PER_HISTORICAL_VECTOR]


def get_seed(p: Preset, state, epoch: int, domain_type: bytes) -> bytes:
    mix = get_randao_mix(p, state, epoch + p.EPOCHS_PER_HISTORICAL_VECTOR - p.MIN_SEED_LOOKAHEAD - 1)
    return _sha(domain_type + epoch.to_bytes(8, "little") + mix)


def get_committee_count_per_slot(p: Preset, active_count: int) -> int:
    return max(
        1,
        min(
            p.MAX_COMMITTEES_PER_SLOT,
            active_count // p.SLOTS_PER_EPOCH // p.TARGET_COMMITTEE_SIZE,
        ),
    )


def compute_proposer_index(p: Preset, state, indices: Sequence[int], seed: bytes) -> int:
    """Spec compute_proposer_index (effective-balance weighted)."""
    if not indices:
        raise ValueError("no active validators")
    max_random_byte = 255
    i = 0
    total = len(indices)
    while True:
        candidate = indices[compute_shuffled_index(i % total, total, seed, p.SHUFFLE_ROUND_COUNT)]
        random_byte = _sha(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * max_random_byte >= p.MAX_EFFECTIVE_BALANCE * random_byte:
            return int(candidate)
        i += 1


def compute_committee_slices(epoch_committee_count: int, active_count: int):
    """Start/end bounds of committee k within the shuffled active set."""
    bounds = [
        (active_count * k) // epoch_committee_count for k in range(epoch_committee_count + 1)
    ]
    return bounds


def xor_bytes(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def increase_balance(state, index: int, delta: int) -> None:
    state.balances[index] += delta


def decrease_balance(state, index: int, delta: int) -> None:
    state.balances[index] = max(0, state.balances[index] - delta)
