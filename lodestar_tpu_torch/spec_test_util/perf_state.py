"""Synthetic big-validator states for scale benchmarks.

Reference: packages/state-transition/test/perf/util.ts:49
(generatePerfTestCachedStatePhase0: `numValidators` = 250_000, all active,
full previous-epoch participation) — the state behind the reference's
epoch-transition and block perf suites, rebuilt here with columnar numpy
assembly so constructing 250k validators takes seconds, not minutes.

Pubkeys are synthetic (counter bytes): scale benchmarks exercise the
state machinery, not BLS; EpochContext's pubkey deserialization is lazy
so fake keys are never decompressed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config.chain_config import ChainConfig
from ..params import Preset
from ..ssz import Fields
from ..state_transition import EpochContext, compute_epoch_at_slot
from ..state_transition.misc import compute_start_slot_at_epoch
from ..params.presets import FAR_FUTURE_EPOCH
from ..types import get_types


def build_perf_state(
    p: Preset,
    cfg: ChainConfig,
    n_validators: int,
    *,
    epochs: int = 2,
    with_attestations: bool = True,
):
    """A phase0 mainnet-shape state at the LAST slot of epoch `epochs`
    (so the next process_slots call crosses an epoch boundary), with every
    validator active and (optionally) full previous-epoch participation.

    Returns (state, ctx).
    """
    t = get_types(p).phase0
    state = t.BeaconState.default()
    state.genesis_time = 1
    state.fork = Fields(
        previous_version=cfg.GENESIS_FORK_VERSION,
        current_version=cfg.GENESIS_FORK_VERSION,
        epoch=0,
    )
    state.slot = compute_start_slot_at_epoch(p, epochs + 1) - 1
    body_root = t.BeaconBlockBody.hash_tree_root(t.BeaconBlockBody.default())
    state.latest_block_header = Fields(
        slot=0, proposer_index=0, parent_root=b"\x00" * 32,
        state_root=b"\x00" * 32, body_root=body_root,
    )
    state.randao_mixes = [bytes([7]) * 32] * p.EPOCHS_PER_HISTORICAL_VECTOR
    state.block_roots = [
        i.to_bytes(32, "big") for i in range(p.SLOTS_PER_HISTORICAL_ROOT)
    ]
    state.state_roots = [b"\x00" * 32] * p.SLOTS_PER_HISTORICAL_ROOT
    state.slashings = [0] * p.EPOCHS_PER_SLASHINGS_VECTOR
    state.eth1_data = Fields(
        deposit_root=b"\x00" * 32, deposit_count=n_validators, block_hash=b"\x00" * 32
    )
    state.justification_bits = [True, True, True, True]
    prev_epoch = epochs - 1
    state.previous_justified_checkpoint = Fields(
        epoch=prev_epoch, root=compute_start_slot_at_epoch(p, prev_epoch).to_bytes(32, "big")
    )
    state.current_justified_checkpoint = Fields(
        epoch=epochs, root=compute_start_slot_at_epoch(p, epochs).to_bytes(32, "big")
    )
    state.finalized_checkpoint = Fields(
        epoch=prev_epoch, root=compute_start_slot_at_epoch(p, prev_epoch).to_bytes(32, "big")
    )

    mb = p.MAX_EFFECTIVE_BALANCE
    for i in range(n_validators):
        state.validators.append(
            Fields(
                pubkey=i.to_bytes(48, "big"),
                withdrawal_credentials=b"\x00" * 32,
                effective_balance=mb,
                slashed=False,
                activation_eligibility_epoch=0,
                activation_epoch=0,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        )
        state.balances.append(mb)

    ctx = EpochContext.create_from_state(p, state)

    if with_attestations:
        _fill_participation(p, state, ctx)
    return state, ctx


def _fill_participation(p: Preset, state, ctx: EpochContext) -> None:
    """One full-participation PendingAttestation per committee of the
    previous epoch, target/head-correct (perf/util.ts attestation fill)."""
    current_epoch = compute_epoch_at_slot(p, state.slot)
    prev_epoch = current_epoch - 1
    prev_boundary = bytes(
        state.block_roots[
            compute_start_slot_at_epoch(p, prev_epoch) % p.SLOTS_PER_HISTORICAL_ROOT
        ]
    )
    committees_per_slot = ctx.get_committee_count_per_slot(prev_epoch)
    source = state.previous_justified_checkpoint
    start = compute_start_slot_at_epoch(p, prev_epoch)
    for slot in range(start, start + p.SLOTS_PER_EPOCH):
        head_root = bytes(state.block_roots[slot % p.SLOTS_PER_HISTORICAL_ROOT])
        for index in range(committees_per_slot):
            committee = ctx.get_beacon_committee(slot, index)
            state.previous_epoch_attestations.append(
                Fields(
                    aggregation_bits=[True] * len(committee),
                    data=Fields(
                        slot=slot,
                        index=index,
                        beacon_block_root=head_root,
                        source=Fields(epoch=source.epoch, root=bytes(source.root)),
                        target=Fields(epoch=prev_epoch, root=prev_boundary),
                    ),
                    inclusion_delay=1,
                    proposer_index=int(committee[0]),
                )
            )
