"""The state transition function: process_slots + per-block transition.

Reference: packages/state-transition/src/stateTransition.ts:19
(eth2fastspec-style: verify-signatures flags so block signature checks can
be deferred to the batched device verifier) and :79 processSlots.
"""

from __future__ import annotations

import copy
from typing import Optional

from ..config.chain_config import ChainConfig
from ..config.fork_config import ForkName
from ..params import Preset
from ..types import get_types
from .block import BlockProcessingError, process_block
from .epoch import process_epoch
from .epoch_context import EpochContext
from .misc import compute_epoch_at_slot
from .upgrade import maybe_upgrade_state, state_fork_name, state_types


class StateTransitionError(Exception):
    pass


def clone_state(p: Preset, state):
    """Deep-copy a state value.  SSZ values are plain python data, so
    copy.deepcopy is correct; columnar caches (EpochContext) are rebuilt,
    not copied — they derive from the state."""
    return copy.deepcopy(state)


def process_slot(p: Preset, state) -> None:
    """Cache state root + block root for the slot (spec process_slot)."""
    t = state_types(p, state)
    prev_state_root = t.BeaconState.hash_tree_root(state)
    state.state_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = prev_state_root
    if state.latest_block_header.state_root == b"\x00" * 32:
        state.latest_block_header.state_root = prev_state_root
    block_root = t.BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    state.block_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = block_root


def process_slots(
    p: Preset,
    cfg: ChainConfig,
    state,
    slot: int,
    ctx: Optional[EpochContext] = None,
) -> EpochContext:
    """Advance state (in place) to `slot`, running epoch transitions at
    boundaries.  Returns a fresh EpochContext for the final epoch."""
    if state.slot > slot:
        raise StateTransitionError(f"cannot rewind state from {state.slot} to {slot}")
    if ctx is None:
        ctx = EpochContext.create_from_state(p, state)
    while state.slot < slot:
        process_slot(p, state)
        if (state.slot + 1) % p.SLOTS_PER_EPOCH == 0:
            if state_fork_name(state) == ForkName.phase0:
                process_epoch(p, cfg, ctx, state)
            else:
                from .altair import process_epoch_altair

                process_epoch_altair(p, cfg, ctx, state)
            state.slot += 1
            ctx = EpochContext.create_from_state(
                p, state, ctx.pubkey2index, ctx.index2pubkey, prev_ctx=ctx
            )
            # fork upgrades fire on the first slot of their epoch
            # (stateTransition.ts:100-144)
            maybe_upgrade_state(p, cfg, ctx, state)
        else:
            state.slot += 1
    return ctx


def state_transition(
    p: Preset,
    cfg: ChainConfig,
    state,
    signed_block,
    ctx: Optional[EpochContext] = None,
    verify_proposer_signature: bool = True,
    verify_signatures: bool = True,
    verify_state_root: bool = True,
    collect_signature_sets: bool = False,
    include_proposer_set: bool = True,
):
    """Full per-block transition on a CLONE of `state`; returns
    (post_state, epoch_context) — or (post, ctx, sets) when
    ``collect_signature_sets`` is set.

    With verify_*=False + collect_signature_sets=True the block's signature
    sets are gathered from THIS single pass (at the slot-advanced pre-block
    state) for one batched verify dispatch — the verifyBlock.ts:152+178
    flow without re-running process_slots.
    """
    block = signed_block.message
    post = clone_state(p, state)
    ctx = process_slots(p, cfg, post, block.slot, ctx)
    t = state_types(p, post)

    sets = None
    if collect_signature_sets:
        from .signature_sets import get_block_signature_sets

        # `post` is the pre-block state advanced to the block's slot; the
        # sets capture signing roots/pubkeys as bytes now, so the in-place
        # block processing below cannot invalidate them
        sets = get_block_signature_sets(
            p, cfg, ctx, post, signed_block, include_proposer=include_proposer_set
        )

    if verify_proposer_signature:
        from ..crypto.bls.verifier import PyBlsVerifier
        from .signature_sets import block_proposer_signature_set

        s = block_proposer_signature_set(p, ctx, post, signed_block)
        if not PyBlsVerifier().verify_signature_sets([s]):
            raise StateTransitionError("invalid block proposer signature")

    try:
        process_block(p, cfg, ctx, post, block, verify_signatures)
    except BlockProcessingError as e:
        raise StateTransitionError(str(e)) from e

    if verify_state_root:
        actual = t.BeaconState.hash_tree_root(post)
        if actual != block.state_root:
            raise StateTransitionError(
                f"state root mismatch: block {block.state_root.hex()} != computed {actual.hex()}"
            )
    if collect_signature_sets:
        return post, ctx, sets
    return post, ctx
