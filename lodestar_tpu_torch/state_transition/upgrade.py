"""Fork upgrade functions + fork detection over plain state/block values.

Reference: packages/state-transition/src/slot/upgradeStateToAltair.ts and
upgradeStateToBellatrix.ts, dispatched from stateTransition.ts:100-144
(processSlots runs the upgrade right after the epoch transition that lands
on the fork epoch).

States/blocks are plain Fields values; the fork is detected structurally
(participation lists => altair+, latest_execution_payload_header =>
bellatrix) so replayed old states keep working without a config lookup.
Upgrades mutate IN PLACE: Fields carries the attributes and the fork-aware
type registry decides how they serialize/merkleize, so adding the new
fields + swapping state.fork is a complete upgrade.
"""

from __future__ import annotations

from ..config.chain_config import ChainConfig
from ..config.fork_config import ForkName
from ..params import Preset
from ..ssz import Fields
from ..types import get_types
from .epoch_context import EpochContext
from .misc import compute_epoch_at_slot


def state_fork_name(state) -> ForkName:
    """Structural fork detection for a BeaconState value."""
    if hasattr(state, "latest_execution_payload_header"):
        return ForkName.bellatrix
    if hasattr(state, "current_epoch_participation"):
        return ForkName.altair
    return ForkName.phase0


def block_fork_name(block) -> ForkName:
    """Structural fork detection for a BeaconBlock value (by body fields)."""
    body = block.body
    if hasattr(body, "execution_payload") or hasattr(body, "execution_payload_header"):
        # blinded bodies (builder flow) carry only the payload header but
        # are the same fork as their full counterpart
        return ForkName.bellatrix
    if hasattr(body, "sync_aggregate"):
        return ForkName.altair
    return ForkName.phase0


def state_types(p: Preset, state):
    """ForkTypes namespace matching a state value's fork."""
    return getattr(get_types(p), state_fork_name(state).value)


def block_types(p: Preset, block):
    return getattr(get_types(p), block_fork_name(block).value)


def translate_participation(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, pending_attestations) -> None:
    """upgradeStateToAltair's pending-attestation -> participation-flag
    translation (spec translate_participation)."""
    from .altair import add_flag, get_attestation_participation_flag_indices

    for att in pending_attestations:
        data = att.data
        inclusion_delay = att.inclusion_delay
        flag_indices = get_attestation_participation_flag_indices(p, state, data, inclusion_delay)
        committee = ctx.get_beacon_committee(data.slot, data.index)
        for vi, bit in zip(committee, att.aggregation_bits):
            if not bit:
                continue
            for flag_index in flag_indices:
                state.previous_epoch_participation[int(vi)] = add_flag(
                    state.previous_epoch_participation[int(vi)], flag_index
                )


def upgrade_state_to_altair(p: Preset, cfg: ChainConfig, ctx: EpochContext, state) -> None:
    """In-place phase0 -> altair upgrade (slot/upgradeStateToAltair.ts)."""
    from .altair import get_next_sync_committee

    epoch = compute_epoch_at_slot(p, state.slot)
    pending = list(state.previous_epoch_attestations)
    n = len(state.validators)
    state.fork = Fields(
        previous_version=bytes(state.fork.current_version),
        current_version=cfg.ALTAIR_FORK_VERSION,
        epoch=epoch,
    )
    state.previous_epoch_participation = [0] * n
    state.current_epoch_participation = [0] * n
    state.inactivity_scores = [0] * n
    del state.previous_epoch_attestations
    del state.current_epoch_attestations
    translate_participation(p, cfg, ctx, state, pending)
    sync_committee = get_next_sync_committee(p, state)
    state.current_sync_committee = sync_committee
    state.next_sync_committee = get_next_sync_committee(p, state)


def upgrade_state_to_bellatrix(p: Preset, cfg: ChainConfig, state) -> None:
    """In-place altair -> bellatrix upgrade (slot/upgradeStateToBellatrix.ts)."""
    from .bellatrix import default_payload_header

    epoch = compute_epoch_at_slot(p, state.slot)
    state.fork = Fields(
        previous_version=bytes(state.fork.current_version),
        current_version=cfg.BELLATRIX_FORK_VERSION,
        epoch=epoch,
    )
    state.latest_execution_payload_header = default_payload_header(p)


def maybe_upgrade_state(p: Preset, cfg: ChainConfig, ctx: EpochContext, state) -> None:
    """Run any fork upgrade scheduled for the state's current epoch
    (stateTransition.ts:100-144 processSlots fork dispatch)."""
    epoch = compute_epoch_at_slot(p, state.slot)
    if epoch == cfg.ALTAIR_FORK_EPOCH and state_fork_name(state) == ForkName.phase0:
        upgrade_state_to_altair(p, cfg, ctx, state)
    if epoch == cfg.BELLATRIX_FORK_EPOCH and state_fork_name(state) == ForkName.altair:
        upgrade_state_to_bellatrix(p, cfg, state)
