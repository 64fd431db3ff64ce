"""Domain and signing-root computation (consensus spec beacon-chain.md).

Reference: packages/state-transition/src/util/domain.ts and
packages/config's fork-digest caching (config/src/beaconConfig.ts).
"""

from __future__ import annotations

from ..params import Preset
from ..ssz import Fields
from ..types import get_types

ZERO_ROOT = b"\x00" * 32


def compute_fork_data_root(preset: Preset, current_version: bytes, genesis_validators_root: bytes) -> bytes:
    t = get_types(preset).phase0
    return t.ForkData.hash_tree_root(
        Fields(current_version=current_version, genesis_validators_root=genesis_validators_root)
    )


def compute_fork_digest(preset: Preset, current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(preset, current_version, genesis_validators_root)[:4]


def compute_domain(
    preset: Preset,
    domain_type: bytes,
    fork_version: bytes,
    genesis_validators_root: bytes = ZERO_ROOT,
) -> bytes:
    """domain = domain_type (4 bytes) || fork_data_root[:28]."""
    fork_data_root = compute_fork_data_root(preset, fork_version, genesis_validators_root)
    return domain_type + fork_data_root[:28]


def compute_signing_root(preset: Preset, ssz_type, obj, domain: bytes) -> bytes:
    t = get_types(preset).phase0
    return t.SigningData.hash_tree_root(
        Fields(object_root=ssz_type.hash_tree_root(obj), domain=domain)
    )


def get_domain(preset: Preset, state, domain_type: bytes, epoch: int) -> bytes:
    """Spec get_domain over a BeaconState value (fork-aware version pick)."""
    fork = state.fork
    fork_version = fork.previous_version if epoch < fork.epoch else fork.current_version
    return compute_domain(preset, domain_type, fork_version, state.genesis_validators_root)
