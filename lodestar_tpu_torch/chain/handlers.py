"""Gossip handler map: topic object -> validate -> route into chain state.

Reference: packages/beacon-node/src/network/processor/gossipHandlers.ts
(:72-291): each handler runs the pure validation function from
chain/validation, then applies the accepted object — attestations into the
naive pool + fork-choice votes, aggregates into the aggregated pool,
blocks into BeaconChain.process_block, slashings/exits into the op pool.

The transport (network/gossip) delivers raw objects here; the handlers are
transport-agnostic so in-process tests and the wire path share them.
"""

from __future__ import annotations

from typing import List, Optional

from ..config.chain_config import ChainConfig
from ..params import Preset
from ..state_transition import clone_state, process_slots
from ..utils.logger import get_logger
from .beacon_chain import BeaconChain
from .seen_cache import (
    SeenAggregatedAttestations,
    SeenAggregators,
    SeenAttesters,
    SeenBlockProposers,
)
from .validation import (
    GossipAction,
    GossipValidationError,
    validate_gossip_aggregate_and_proof,
    validate_gossip_attestation,
    validate_gossip_attester_slashing,
    validate_gossip_block,
    validate_gossip_proposer_slashing,
    validate_gossip_voluntary_exit,
)

logger = get_logger("gossip-handlers")


class GossipHandlers:
    """Validated-object router bound to one BeaconChain."""

    def __init__(self, chain: BeaconChain):
        self.chain = chain
        self.p: Preset = chain.p
        self.cfg: ChainConfig = chain.cfg
        self.seen_attesters = SeenAttesters()
        self.seen_aggregators = SeenAggregators()
        self.seen_aggregates = SeenAggregatedAttestations()
        self.seen_proposers = SeenBlockProposers()
        from .seen_cache import SeenContributions, SeenSyncCommitteeMessages

        self.seen_sync_msgs = SeenSyncCommitteeMessages()
        self.seen_contributions = SeenContributions()

    # -- helpers ---------------------------------------------------------------

    def _head_ctx_state(self, slot: int):
        """Head state advanced to `slot` for committee lookups (the
        reference uses the wall-clock state via regen; head-at-slot is the
        same state for canonical gossip).

        Memoized per (head_root, slot): gossip bursts validate hundreds of
        objects against the same dial state, and a full state clone +
        slot advance per message would be a denial-of-service shape (the
        exit validator's too)."""
        key = (self.chain.head_root, slot)
        if getattr(self, "_ctx_memo_key", None) == key:
            return self._ctx_memo_val
        state = clone_state(self.p, self.chain.head_state())
        if state.slot < slot:
            ctx = process_slots(self.p, self.cfg, state, slot)
        else:
            ctx = self.chain.ctx_by_block_root.get(self.chain.head_root)
            if ctx is None:
                from ..state_transition import EpochContext

                ctx = EpochContext.create_from_state(self.p, state)
        self._ctx_memo_key = key
        self._ctx_memo_val = (ctx, state)
        return ctx, state

    def _clock_slot(self) -> int:
        return self.chain.clock.current_slot if self.chain.clock else self.chain.head_state().slot

    # -- handlers (gossipHandlers.ts:72) ---------------------------------------

    async def on_attestation(self, attestation, subnet: Optional[int] = None) -> List[int]:
        data = attestation.data
        ctx, state = self._head_ctx_state(data.slot)
        indices = await validate_gossip_attestation(
            self.p,
            self.cfg,
            attestation=attestation,
            subnet=subnet,
            clock_slot=self._clock_slot(),
            fork_choice=self.chain.fork_choice,
            seen_attesters=self.seen_attesters,
            ctx=ctx,
            state=state,
            pool=self.chain.bls,
        )
        self.chain.att_pool.add(attestation)
        if self.chain.fork_choice.has_block(bytes(data.beacon_block_root)):
            self.chain.fork_choice.on_attestation(
                indices, bytes(data.beacon_block_root), data.target.epoch
            )
        return indices

    async def on_aggregate_and_proof(self, signed_aggregate) -> List[int]:
        aggregate = signed_aggregate.message.aggregate
        ctx, state = self._head_ctx_state(aggregate.data.slot)
        indices = await validate_gossip_aggregate_and_proof(
            self.p,
            self.cfg,
            signed_aggregate=signed_aggregate,
            clock_slot=self._clock_slot(),
            fork_choice=self.chain.fork_choice,
            seen_aggregators=self.seen_aggregators,
            seen_aggregates=self.seen_aggregates,
            ctx=ctx,
            state=state,
            pool=self.chain.bls,
        )
        self.chain.agg_pool.add(aggregate)
        if self.chain.fork_choice.has_block(bytes(aggregate.data.beacon_block_root)):
            self.chain.fork_choice.on_attestation(
                indices, bytes(aggregate.data.beacon_block_root), aggregate.data.target.epoch
            )
        return indices

    async def on_block(self, signed_block) -> bytes:
        block = signed_block.message
        ctx, state = self._head_ctx_state(block.slot)
        await validate_gossip_block(
            self.p,
            self.cfg,
            signed_block=signed_block,
            clock_slot=self._clock_slot(),
            fork_choice=self.chain.fork_choice,
            seen_block_proposers=self.seen_proposers,
            ctx=ctx,
            state=state,
            pool=self.chain.bls,
            clock=self.chain.clock,
        )
        return await self.chain.process_block(signed_block, proposer_sig_verified=True)

    async def on_voluntary_exit(self, signed_exit) -> None:
        ctx, state = self._head_ctx_state(self.chain.head_state().slot)
        await validate_gossip_voluntary_exit(
            self.p, self.cfg, signed_exit=signed_exit, ctx=ctx, state=state,
            pool=self.chain.bls, op_pool=self.chain.op_pool,
        )
        self.chain.op_pool.add_voluntary_exit(signed_exit)

    async def on_proposer_slashing(self, slashing) -> None:
        ctx, state = self._head_ctx_state(self.chain.head_state().slot)
        await validate_gossip_proposer_slashing(
            self.p, self.cfg, slashing=slashing, ctx=ctx, state=state,
            pool=self.chain.bls, op_pool=self.chain.op_pool,
        )
        self.chain.op_pool.add_proposer_slashing(slashing)

    async def on_attester_slashing(self, slashing) -> None:
        ctx, state = self._head_ctx_state(self.chain.head_state().slot)
        await validate_gossip_attester_slashing(
            self.p, self.cfg, slashing=slashing, ctx=ctx, state=state,
            pool=self.chain.bls, op_pool=self.chain.op_pool,
        )
        self.chain.op_pool.add_attester_slashing(slashing)

    # -- altair sync-committee traffic (gossipHandlers.ts syncCommittee*) ------

    async def on_sync_committee_message(self, message, subnet: int) -> None:
        from .sync_committee_pools import validate_sync_committee_message

        ctx, state = self._head_ctx_state(self._clock_slot())
        index_in_sub = await validate_sync_committee_message(
            self.p, self.cfg, message=message, subnet=subnet,
            clock_slot=self._clock_slot(), state=state, ctx=ctx,
            seen_sync_msgs=self.seen_sync_msgs, pool=self.chain.bls,
        )
        self.chain.sync_msg_pool.add(
            message.slot, bytes(message.beacon_block_root), subnet,
            index_in_sub, bytes(message.signature),
        )

    async def on_sync_contribution(self, signed_contribution) -> None:
        from .sync_committee_pools import validate_sync_committee_contribution

        ctx, state = self._head_ctx_state(self._clock_slot())
        await validate_sync_committee_contribution(
            self.p, self.cfg, signed_contribution=signed_contribution,
            clock_slot=self._clock_slot(), state=state, ctx=ctx,
            seen_contributions=self.seen_contributions, pool=self.chain.bls,
        )
        self.chain.contribution_pool.add(signed_contribution.message.contribution)
