"""BeaconChain: the orchestrator tying STF + fork choice + the batched
verifier boundary together.

Reference: packages/beacon-node/src/chain/chain.ts:58 (BeaconChain),
blocks/verifyBlock.ts:45 (verify flow: sanity -> STF with deferred sigs ->
one batched signature-set verification), blocks/importBlock.ts:76
(fork-choice import + head update), blocks/index.ts:25-49 (serialized
import queue), chain/archiver/index.ts:21 (hot->archive migration on
finalization).

Wiring: states live in the bounded StateContextCache and are regenerated
by replay on miss (regen.py); blocks persist through BeaconDb (hot bucket,
migrated to the slot-keyed archive by the Archiver on finalization); block
production packs attestations/slashings/exits from the op pools; signature
sets come from the single STF pass and go to the port's ``BlsBatchPool``
as one job a block, or one job a range-sync segment.

The port's copy of ``lodestar_tpu/chain/beacon_chain.py``.  The MEV
builder flow (``produce_blinded_block``, ``publish_blinded_block``) checks
a bid's signature in C (``native/fastbls.batch_verify``), as the JAX
chain does when its library is built.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config.chain_config import ChainConfig
from ..db.beacon import BeaconDb
from ..fork_choice import Checkpoint, ForkChoice, ForkChoiceStore, ProtoNode
from ..params import Preset
from ..ssz import Fields
from ..state_transition import (
    EpochContext,
    clone_state,
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    process_slots,
    state_transition,
)
from ..types import get_types
from ..utils.logger import get_logger
from .bls_pool import BlsBatchPool
from .emitter import ChainEvent, ChainEventEmitter
from .op_pools import AggregatedAttestationPool, AttestationPool, OpPool
from .regen import CheckpointStateCache, StateContextCache, StateRegenerator
from .seen_cache import SeenBlockAttesters

logger = get_logger("chain")


class BlockError(Exception):
    pass


class _DbBlockSource:
    """block-root -> SignedBeaconBlock view over BeaconDb (hot first, then
    archive) — the regen replay source."""

    def __init__(self, db: BeaconDb):
        self.db = db

    def get(self, root: bytes):
        blk = self.db.block.get(root)
        if blk is not None:
            return blk
        return self.db.get_archived_block_by_root(root)


class BeaconChain:
    def __init__(
        self,
        preset: Preset,
        cfg: ChainConfig,
        genesis_state,
        bls_pool: BlsBatchPool,
        db: Optional[BeaconDb] = None,
        metrics=None,
        clock=None,
        execution_engine=None,
        builder=None,
        default_fee_recipient: bytes = b"\x00" * 20,
    ):
        self.p = preset
        self.cfg = cfg
        self.bls = bls_pool
        self.metrics = metrics
        self.clock = clock
        # Engine-API client (http/mock/disabled) — consulted on every
        # post-merge block import (verifyBlock.ts:195) and notified of
        # forkchoice updates on head change (importBlock.ts:251-280)
        self.execution_engine = execution_engine
        # MEV builder client (execution/builder/http.ts) — used by the
        # blinded production path when configured
        self.builder = builder
        # validator-index -> fee recipient from prepareBeaconProposer
        # (chain/beaconProposerCache.ts), falling back to the node default
        from .beacon_proposer_cache import BeaconProposerCache

        self.beacon_proposer_cache = BeaconProposerCache(default_fee_recipient)
        # opt-in per-validator duty tracking (metrics/validatorMonitor.ts)
        from ..metrics.validator_monitor import ValidatorMonitor

        self.validator_monitor = ValidatorMonitor(preset, metrics=metrics)
        self.emitter = ChainEventEmitter()
        self.t = get_types(preset).phase0
        from ..config.fork_config import ForkConfig

        self.fork_config = ForkConfig(cfg)
        self.db = db or BeaconDb(preset)
        if metrics is not None and getattr(self.db, "db", None) is not None:
            # time every controller op (dbReadReq/dbWriteReq analog) by
            # wrapping the backend under the already-bound repositories
            from ..db.controller import MeteredDbController

            if not isinstance(self.db.db, MeteredDbController):
                metered = MeteredDbController(self.db.db, metrics)
                self.db.db = metered
                for repo in vars(self.db).values():
                    if hasattr(repo, "db") and repo.db is not None and not isinstance(
                        repo.db, MeteredDbController
                    ) and hasattr(repo, "bucket"):
                        repo.db = metered

        # op pools + seen caches (chain/opPools, SURVEY §2.4)
        self.att_pool = AttestationPool(preset)
        self.agg_pool = AggregatedAttestationPool(preset)
        self.op_pool = OpPool(preset)
        from .sync_committee_pools import (
            SyncCommitteeMessagePool,
            SyncContributionAndProofPool,
        )

        self.sync_msg_pool = SyncCommitteeMessagePool(preset)
        self.contribution_pool = SyncContributionAndProofPool(preset)
        self.seen_block_attesters = SeenBlockAttesters()

        # anchor: genesis (or checkpoint) state + implied block header
        self.genesis_state = genesis_state
        header = Fields(**{k: genesis_state.latest_block_header[k] for k in genesis_state.latest_block_header.keys()})
        if header.state_root == b"\x00" * 32:
            from ..state_transition.upgrade import state_types

            header.state_root = state_types(preset, genesis_state).BeaconState.hash_tree_root(
                genesis_state
            )
        anchor_root = self.t.BeaconBlockHeader.hash_tree_root(header)

        balances = np.array(
            [v.effective_balance for v in genesis_state.validators], dtype=np.int64
        )
        anchor_epoch = compute_epoch_at_slot(preset, genesis_state.slot)
        cp = Checkpoint(anchor_epoch, anchor_root)
        store = ForkChoiceStore(
            current_slot=genesis_state.slot,
            justified_checkpoint=cp,
            finalized_checkpoint=cp,
            justified_balances=balances,
        )
        self.fork_choice = ForkChoice(
            store,
            ProtoNode(
                slot=genesis_state.slot,
                block_root=anchor_root,
                parent_root=None,
                state_root=header.state_root,
                target_root=anchor_root,
                justified_epoch=anchor_epoch,
                finalized_epoch=anchor_epoch,
            ),
            proposer_boost_pct=cfg.PROPOSER_SCORE_BOOST,
            slots_per_epoch=preset.SLOTS_PER_EPOCH,
        )

        # bounded state caches + db-replay regenerator (regen/queued.ts:27)
        self.state_cache = StateContextCache()
        self.checkpoint_states = CheckpointStateCache()
        self.state_cache.add(anchor_root, genesis_state)
        self.regen = StateRegenerator(preset, cfg, _DbBlockSource(self.db), self.state_cache, metrics=metrics)
        self.ctx_by_block_root: Dict[bytes, EpochContext] = {}
        self.head_root = anchor_root
        self._finalized_head_root = anchor_root

        # import serialization (BlockProcessor, blocks/index.ts:25-49):
        # concurrent process_block calls queue on this lock so imports are
        # applied one at a time in arrival order
        self._import_lock = asyncio.Lock()

        # next-slot precompute (prepareNextSlot.ts:30): the 2/3-slot tick
        # advances the head state to slot+1 — absorbing the EPOCH
        # TRANSITION ahead of time — and both block production and block
        # IMPORT consume it (imports at epoch boundaries do not stall on
        # the transition)
        from .prepare_next_slot import PrepareNextSlotScheduler

        self.prepare_scheduler = PrepareNextSlotScheduler(preset, self)
        self.prepare_hits = 0
        self._prepare_task: Optional[asyncio.Task] = None

        # archiver wiring: migrate hot -> archive when finalization advances
        self.emitter.on(ChainEvent.FINALIZED, self._on_finalized)

    # -- next-slot precompute ticker (prepareNextSlot.ts:30) -------------------

    def start_prepare_ticker(self) -> None:
        """Background task: at 2/3 of every slot, precompute the next-slot
        head state (requires a clock)."""
        if self.clock is not None and self._prepare_task is None:
            self._prepare_task = asyncio.create_task(self._prepare_loop())

    def stop_prepare_ticker(self) -> None:
        if self._prepare_task is not None:
            self._prepare_task.cancel()
            self._prepare_task = None

    async def _prepare_loop(self) -> None:
        try:
            while True:
                slot = self.clock.current_slot
                two_thirds = (
                    self.clock.slot_start_time(slot)
                    + 2 * self.cfg.SECONDS_PER_SLOT / 3
                )
                delay = two_thirds - self.clock.now_fn()
                if delay > 0:
                    await asyncio.sleep(delay)
                try:
                    await self.prepare_scheduler.prepare(slot + 1)
                except Exception as e:  # noqa: BLE001
                    logger.warning("prepare_next_slot failed: %s", e)
                await asyncio.sleep(
                    max(0.01, self.clock.slot_start_time(slot + 1) - self.clock.now_fn())
                )
        except asyncio.CancelledError:
            pass

    # -- queries --------------------------------------------------------------

    def head_state(self):
        return self.regen.get_state_by_block_root(self.head_root)

    def get_state_by_block_root(self, root: bytes):
        try:
            return self.regen.get_state_by_block_root(root)
        except Exception:
            return None

    def get_block_by_root(self, root: bytes):
        return _DbBlockSource(self.db).get(root)

    # -- block import (verifyBlock + importBlock) ------------------------------

    async def _verify_block_sets(self, sets) -> bool:
        """Block-import signature verification: one job of the pool
        (``chain/bls_pool.BlsBatchPool``) on the BLOCK_PROPOSAL QoS lane:
        under an attestation storm the pool drains it ahead of every gossip
        lane, and the overflow policy can never evict it in favor of storm
        traffic.  A failed verdict returns False and a failed launch
        raises; neither is caught here.

        A shed job (pool shutdown mid-retry is the only reachable case —
        block-lane jobs carry no deadline and outrank every evictee) maps
        to BlockError: callers up the import stack (REST block publish,
        unknown-block sync) are written around the BlockError contract,
        and 'not verified' must stay distinct from 'invalid signature'
        only in the message, never by leaking the pool's typed error."""
        from ..crypto.bls.verifier import (
            SignatureSetPriority,
            VerificationDroppedError,
        )

        try:
            return await self.bls.verify_signature_sets(
                sets, priority=SignatureSetPriority.BLOCK_PROPOSAL
            )
        except VerificationDroppedError as e:
            raise BlockError(
                f"block signature verification dropped ({e.reason})"
            ) from e

    async def process_block(self, signed_block, *, proposer_sig_verified: bool = False) -> bytes:
        async with self._import_lock:
            return await self._process_block_locked(
                signed_block, proposer_sig_verified=proposer_sig_verified
            )

    async def process_chain_segment(self, blocks: Sequence) -> int:
        """Import a contiguous segment (range sync); returns imported count.
        Reference: chain/blocks/index.ts processChainSegment.

        Batched for device throughput: the segment's state
        transitions run back-to-back, threading each post-state to the
        next block WITHOUT importing, and every block's signature sets are
        verified in ONE batched dispatch (the reference submits 1000+ sets
        per sync batch through its worker pool, multithread/index.ts:153).
        On batch failure it falls back to per-block verification so the
        valid prefix still imports (retry-individually semantics)."""
        async with self._import_lock:
            staged = []  # (signed_block, block_root, parent_root, post, ctx, sets)
            all_sets: list = []
            for sb in blocks:
                from ..state_transition.upgrade import block_types

                block = sb.message
                block_root = block_types(self.p, block).BeaconBlock.hash_tree_root(block)
                if self.fork_choice.has_block(block_root):
                    continue
                parent_root = bytes(block.parent_root)
                if staged and parent_root == staged[-1][1]:
                    pre_state, parent_ctx = staged[-1][3], staged[-1][4]
                elif self.fork_choice.has_block(parent_root):
                    try:
                        pre_state = self.regen.get_state_by_block_root(parent_root)
                    except Exception as e:
                        raise BlockError(f"missing pre-state for parent: {e}") from e
                    parent_ctx = self.ctx_by_block_root.get(parent_root)
                else:
                    if not staged:
                        raise BlockError(f"unknown parent {parent_root.hex()}")
                    break  # segment discontinuity: import the linked prefix
                post, ctx, sets = state_transition(
                    self.p,
                    self.cfg,
                    pre_state,
                    sb,
                    ctx=parent_ctx,
                    verify_proposer_signature=False,
                    verify_signatures=False,
                    verify_state_root=True,
                    collect_signature_sets=True,
                    include_proposer_set=True,
                )
                staged.append((sb, block_root, parent_root, post, ctx, sets))
                all_sets.extend(sets)

            verified_prefix = len(staged)
            if all_sets and not await self._verify_block_sets(all_sets):
                # find the longest valid prefix block-by-block
                verified_prefix = 0
                for _, _, _, _, _, sets in staged:
                    if sets and not await self._verify_block_sets(sets):
                        break
                    verified_prefix += 1

            n = 0
            for sb, block_root, parent_root, post, ctx, _ in staged[:verified_prefix]:
                await self._import_block(
                    sb, block_root, parent_root, post, ctx, time.monotonic()
                )
                n += 1
            if verified_prefix < len(staged):
                raise BlockError(
                    f"segment block {verified_prefix} failed batch verification "
                    f"({n} imported)"
                )
            return n

    async def _process_block_locked(self, signed_block, *, proposer_sig_verified: bool) -> bytes:
        from ..state_transition.upgrade import block_types

        t0 = time.monotonic()
        block = signed_block.message
        block_root = block_types(self.p, block).BeaconBlock.hash_tree_root(block)

        # sanity (verifyBlockSanityChecks, verifyBlock.ts:80-121)
        if self.fork_choice.has_block(block_root):
            return block_root  # duplicate import is a no-op
        parent_root = bytes(block.parent_root)
        if not self.fork_choice.has_block(parent_root):
            raise BlockError(f"unknown parent {parent_root.hex()}")
        try:
            pre_state = self.regen.get_state_by_block_root(parent_root)
        except Exception as e:
            raise BlockError(f"missing pre-state for parent: {e}") from e

        # prepared-state fast path: the 2/3-slot precompute already
        # advanced the head state past the (possibly epoch-boundary) slot
        # gap — reuse it so the import pays only the block ops
        parent_ctx = self.ctx_by_block_root.get(parent_root)
        prepared = self.prepare_scheduler.get_prepared_state(parent_root, block.slot)
        if prepared is not None:
            pre_state, parent_ctx = prepared
            self.prepare_hits += 1
            if self.metrics:
                self.metrics.prepare_next_slot_hits_total.inc()

        # ONE STF pass: post-state + signature sets collected at the
        # slot-advanced pre-block state (verifyBlock.ts:152,178)
        _stf_t0 = time.monotonic()
        post, ctx, sets = state_transition(
            self.p,
            self.cfg,
            pre_state,
            signed_block,
            # the parent's cached EpochContext skips three O(n·90-round)
            # shuffles per import at mainnet registry sizes
            ctx=parent_ctx,
            verify_proposer_signature=False,
            verify_signatures=False,
            verify_state_root=True,
            collect_signature_sets=True,
            include_proposer_set=not proposer_sig_verified,
        )

        if self.metrics:
            self.metrics.state_transition_seconds.observe(time.monotonic() - _stf_t0)

        # one batched signature verification
        if sets and not await self._verify_block_sets(sets):
            raise BlockError("block signature sets failed batch verification")

        return await self._import_block(
            signed_block, block_root, parent_root, post, ctx, t0
        )

    def _sync_committee_duty_indices(self, post, ctx):
        """Validator index per current-sync-committee position, cached per
        sync period (feeds ValidatorMonitor registerSyncAggregateInBlock);
        None when nobody is monitored or pre-altair."""
        if not self.validator_monitor.registered:
            return None
        if "current_sync_committee" not in post.keys():
            return None
        period = compute_epoch_at_slot(self.p, post.slot) // (
            self.p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        )
        cached = getattr(self, "_sync_duty_cache", None)
        if cached is not None and cached[0] == period:
            return cached[1]
        indices = []
        for pk in post.current_sync_committee.pubkeys:
            idx = ctx.pubkey2index.get(bytes(pk))
            indices.append(-1 if idx is None else int(idx))
        self._sync_duty_cache = (period, indices)
        return indices

    async def _import_block(
        self, signed_block, block_root: bytes, parent_root: bytes, post, ctx, t0
    ) -> bytes:
        """The post-verification import tail (importBlock.ts:76): engine
        notification, fork choice, persistence, head/finality events.
        Shared by single-block import and the batched segment path."""
        block = signed_block.message
        # execution payload -> engine (verifyBlock.ts:195-263): VALID marks
        # the node fully verified; SYNCING/ACCEPTED imports optimistically
        # (never for the merge-transition block itself); INVALID rejects
        execution_status, execution_block_hash = await self._notify_new_payload(
            block, parent_root
        )

        # import (importBlock.ts:76)
        target_epoch = compute_epoch_at_slot(self.p, block.slot)
        target_root = self._target_root(post, block_root, target_epoch)
        justified = Checkpoint(
            post.current_justified_checkpoint.epoch, bytes(post.current_justified_checkpoint.root)
        )
        finalized = Checkpoint(
            post.finalized_checkpoint.epoch, bytes(post.finalized_checkpoint.root)
        )
        balances = np.array([v.effective_balance for v in post.validators], dtype=np.int64)
        old_finalized = self.fork_choice.store.finalized_checkpoint.epoch
        self.fork_choice.on_block(
            block.slot,
            block_root,
            parent_root,
            bytes(block.state_root),
            target_root,
            justified,
            finalized,
            justified_balances=balances,
            is_timely_proposal=self._is_timely_proposal(block.slot),
            execution_status=execution_status,
            execution_block_hash=execution_block_hash,
        )
        # per-attestation fork-choice votes (importBlock.ts:144)
        for att in block.body.attestations:
            try:
                indices = ctx.get_attesting_indices(att.data, att.aggregation_bits)
            except ValueError:
                continue
            if self.fork_choice.has_block(bytes(att.data.beacon_block_root)):
                self.fork_choice.on_attestation(
                    indices, bytes(att.data.beacon_block_root), att.data.target.epoch
                )
            for idx in indices:
                self.seen_block_attesters.add(att.data.target.epoch, idx)

        # persist + cache (importBlock.ts:219: db.block.put; stateCache.add)
        self.db.block.put(block_root, signed_block)
        self.state_cache.add(block_root, post)
        if post.slot % self.p.SLOTS_PER_EPOCH == 0:
            self.checkpoint_states.add(
                compute_epoch_at_slot(self.p, post.slot), block_root, post
            )
        self.ctx_by_block_root[block_root] = ctx

        def _ancestor_at(slot: int):
            # canonical root at `slot` on the imported block's own chain
            # (validatorMonitor correctHead/correctTarget resolution)
            try:
                return self.fork_choice.get_ancestor(block_root, slot)
            except Exception:
                return None

        self.validator_monitor.on_block(
            block, ctx,
            ancestor_at=_ancestor_at if self.validator_monitor.registered else None,
            sync_committee_indices=self._sync_committee_duty_indices(post, ctx),
        )
        # chain progress drives the monitor's epoch summaries (the
        # reference hooks clockEpoch; block import advances at the same
        # cadence and needs no separate timer)
        self.validator_monitor.on_clock_epoch(target_epoch)
        old_head = self.head_root
        self.head_root = self.fork_choice.update_head()
        self.emitter.emit(ChainEvent.BLOCK, signed_block, block_root)
        if self.head_root != old_head:
            self.emitter.emit(ChainEvent.HEAD, self.head_root)
            await self._notify_forkchoice_update()
        if finalized.epoch > old_finalized:
            self.emitter.emit(ChainEvent.FINALIZED, finalized)
        if self.metrics:
            self.metrics.block_processing_seconds.observe(time.monotonic() - t0)
            self.metrics.state_cache_size.set(len(self.state_cache))
            self.metrics.head_slot.set(block.slot)
            self.metrics.finalized_epoch.set(finalized.epoch)
            self.metrics.op_pool_size.labels(pool="attestations").set(len(self.att_pool))
            self.metrics.op_pool_size.labels(pool="aggregates").set(len(self.agg_pool))
            self.metrics.op_pool_size.labels(pool="sync_messages").set(
                len(self.sync_msg_pool)
            )
            if self.clock is not None:
                self.metrics.clock_slot.set(self.clock.current_slot)
        return block_root

    # -- execution layer (verifyBlock.ts:195-263, importBlock.ts:251-280) -----

    @staticmethod
    async def _maybe_await(x):
        import inspect

        return await x if inspect.isawaitable(x) else x

    async def _notify_new_payload(self, block, parent_root: bytes):
        """Returns (execution_status, execution_block_hash) for fork choice.
        Pre-merge blocks (no payload, or the default zero payload of early
        bellatrix) are 'pre-merge'."""
        body = block.body
        payload = getattr(body, "execution_payload", None)
        if payload is None or bytes(payload.block_hash) == b"\x00" * 32:
            return "pre-merge", b"\x00" * 32
        block_hash = bytes(payload.block_hash)
        parent_node = self.fork_choice.get_block(parent_root)
        is_transition = parent_node is not None and parent_node.execution_status == "pre-merge"
        if self.execution_engine is None:
            # no engine configured: optimistic, but never for the
            # transition block (it must be fully verified)
            if is_transition:
                raise BlockError("merge-transition block requires an execution engine")
            return "syncing", block_hash
        from ..execution.engine import ExecutePayloadStatus

        try:
            status = await self._maybe_await(
                self.execution_engine.notify_new_payload(payload)
            )
        except Exception as e:
            # transient EL outage: treat like SYNCING (optimistic import,
            # same gating) instead of killing block import with a raw
            # transport error — matching the forkchoiceUpdated guard below
            logger.warning("notify_new_payload failed (EL outage?): %s", e)
            status = ExecutePayloadStatus.SYNCING
        if status == ExecutePayloadStatus.INVALID:
            raise BlockError("execution payload INVALID")
        if status == ExecutePayloadStatus.VALID:
            return "valid", block_hash
        # SYNCING / ACCEPTED: optimistic import, gated for the transition
        # block exactly as verifyBlock.ts:219-263
        if is_transition:
            raise BlockError("merge-transition block cannot be imported optimistically")
        return "syncing", block_hash

    async def _notify_forkchoice_update(self, payload_attributes=None):
        """engine_forkchoiceUpdated on head change (importBlock.ts:251-280).
        Returns the payload_id when attributes were supplied."""
        if self.execution_engine is None:
            return None
        head_node = self.fork_choice.get_block(self.head_root)
        if head_node is None or head_node.execution_status == "pre-merge":
            return None
        fin = self.fork_choice.store.finalized_checkpoint
        fin_node = self.fork_choice.get_block(fin.root)
        fin_hash = fin_node.execution_block_hash if fin_node is not None else b"\x00" * 32
        try:
            return await self._maybe_await(
                self.execution_engine.notify_forkchoice_update(
                    head_node.execution_block_hash,
                    head_node.execution_block_hash,
                    fin_hash,
                    payload_attributes,
                )
            )
        except Exception as e:  # EL outage must not kill block import
            logger.warning("forkchoiceUpdated failed: %s", e)
            return None

    async def on_invalid_execution_payload(self, block_root: bytes) -> None:
        """The EL reported INVALID for an optimistically imported payload
        (forkChoice.ts validateLatestHash): invalidate the subtree, reorg
        the head away from it, and re-notify the engine."""
        self.fork_choice.on_invalid_execution(block_root)
        old_head = self.head_root
        self.head_root = self.fork_choice.update_head()
        if self.head_root != old_head:
            self.emitter.emit(ChainEvent.HEAD, self.head_root)
            await self._notify_forkchoice_update()

    def _is_timely_proposal(self, block_slot: int) -> bool:
        """Proposer boost gate (forkChoice onBlock): only a block for the
        CURRENT clock slot arriving before the attestation deadline
        (SECONDS_PER_SLOT / INTERVALS_PER_SLOT into the slot) earns the
        boost.  Late blocks and replayed old blocks (sync) must not — the
        ~40% committee-weight boost would otherwise be reorg-exploitable."""
        from ..params import INTERVALS_PER_SLOT

        if self.clock is None:
            return False
        if block_slot != self.clock.current_slot:
            return False
        return self.clock.seconds_into_slot() < self.cfg.SECONDS_PER_SLOT / INTERVALS_PER_SLOT

    def _target_root(self, post, block_root: bytes, target_epoch: int) -> bytes:
        boundary_slot = compute_start_slot_at_epoch(self.p, target_epoch)
        if boundary_slot >= post.slot:
            return block_root
        return bytes(post.block_roots[boundary_slot % self.p.SLOTS_PER_HISTORICAL_ROOT])

    # -- archiver (chain/archiver/index.ts:21) ---------------------------------

    def _on_finalized(self, finalized: Checkpoint) -> None:
        """Migrate the newly finalized canonical chain hot -> archive, prune
        caches and pools.  Runs synchronously on the FINALIZED event (the
        reference queues it; imports here are already serialized)."""
        new_root = finalized.root
        migrated = 0
        # walk the canonical chain back from the finalized block to the
        # previous finalized anchor, archiving each block
        root = new_root
        while root != self._finalized_head_root:
            blk = self.db.block.get(root)
            if blk is None:
                break
            self.db.archive_block(blk, root)
            self.db.block.delete(root)
            migrated += 1
            root = bytes(blk.message.parent_root)
        state = self.state_cache.get(new_root)
        if state is not None:
            self.db.archive_state(state)
        self._finalized_head_root = new_root
        # prune (archiver calls opPool.pruneAll + checkpoint cache prune)
        self.checkpoint_states.prune_finalized(finalized.epoch)
        finalized_slot = compute_start_slot_at_epoch(self.p, finalized.epoch)
        self.att_pool.prune(finalized_slot)
        self.agg_pool.prune(finalized_slot)
        logger.info("archived %d finalized blocks up to epoch %d", migrated, finalized.epoch)

    # -- block production (chain/factory/block/index.ts:21) --------------------

    G2_INFINITY_SIG = b"\xc0" + b"\x00" * 95

    def produce_block_body(self, fork, state, attestations: Sequence = (), sync_aggregate=None) -> object:
        """Assemble a body from the op pools (factory/block/body.ts:48-82):
        attestations from the aggregated pool (or caller-supplied), plus
        slashings and exits from the op pool."""
        from ..config.fork_config import ForkName
        from ..types import get_types

        t = getattr(get_types(self.p), fork.value)
        body = t.BeaconBlockBody.default()
        if attestations:
            body.attestations = list(attestations)
        else:
            body.attestations = self.agg_pool.get_attestations_for_block(
                state, seen_attesters=self.seen_block_attesters
            )[: self.p.MAX_ATTESTATIONS]
        proposer_slashings, attester_slashings, exits = self.op_pool.get_slashings_and_exits(state)
        body.proposer_slashings = proposer_slashings[: self.p.MAX_PROPOSER_SLASHINGS]
        body.attester_slashings = attester_slashings[: self.p.MAX_ATTESTER_SLASHINGS]
        body.voluntary_exits = exits[: self.p.MAX_VOLUNTARY_EXITS]
        if fork != ForkName.phase0:
            body.sync_aggregate = sync_aggregate or Fields(
                sync_committee_bits=[False] * self.p.SYNC_COMMITTEE_SIZE,
                sync_committee_signature=self.G2_INFINITY_SIG,
            )
        return body

    def _payload_attributes(self, pre, slot: int, proposer_index: int) -> Fields:
        """PayloadAttributes for fcU (factory/block/body.ts
        prepareExecutionPayload): timestamp at slot, pre-reveal randao
        mix, and the proposer's registered fee recipient."""
        from ..state_transition.bellatrix import compute_timestamp_at_slot
        from ..state_transition.misc import get_randao_mix

        epoch = compute_epoch_at_slot(self.p, slot)
        return Fields(
            timestamp=compute_timestamp_at_slot(self.p, self.cfg, pre, slot),
            prev_randao=bytes(get_randao_mix(self.p, pre, epoch)),
            suggested_fee_recipient=self.beacon_proposer_cache.get(proposer_index),
        )

    def _produce_execution_payload(self, pre, slot: int, proposer_index: int = 0):
        """Engine getPayload for bellatrix production (factory/block/body.ts
        getExecutionPayload): fcU with payload attributes, then getPayload.
        Returns None pre-merge without an engine (default payload stays).
        prev_randao is the PRE-reveal mix: process_execution_payload runs
        before process_randao in the spec block order, so the payload check
        reads the mix without this block's reveal (spec
        prepare_execution_payload: get_randao_mix(state, current_epoch))."""
        if self.execution_engine is None:
            return None
        from ..state_transition.bellatrix import is_merge_transition_complete

        attrs = self._payload_attributes(pre, slot, proposer_index)
        head_node = self.fork_choice.get_block(self.head_root)
        head_hash = head_node.execution_block_hash if head_node else b"\x00" * 32
        if not is_merge_transition_complete(self.p, pre) and head_hash == b"\x00" * 32:
            # pre-merge: the engine's view decides whether the terminal PoW
            # block exists; the mock starts building from its genesis hash
            head_hash = getattr(self.execution_engine, "head_block_hash", b"\x00" * 32)
        fin = self.fork_choice.store.finalized_checkpoint
        fin_node = self.fork_choice.get_block(fin.root)
        fin_hash = fin_node.execution_block_hash if fin_node is not None else b"\x00" * 32
        import inspect

        if inspect.iscoroutinefunction(self.execution_engine.notify_forkchoice_update):
            # sync production path cannot await an http engine; fail loudly
            # up front rather than silently emitting a payload-less block
            # that will bounce off its own state transition
            logger.error(
                "async execution engine is not supported in the synchronous "
                "production path; configure an in-process engine or produce "
                "blocks via the async API"
            )
            return None
        try:
            pid = self.execution_engine.notify_forkchoice_update(
                head_hash, head_hash, fin_hash, attrs
            )
            if pid is None:
                return None
            return self.execution_engine.get_payload(pid)
        except Exception as e:
            logger.warning("execution payload production failed: %s", e)
            return None

    def _production_scaffold(
        self, slot: int, randao_reveal: bytes, attestations: Sequence = (), sync_aggregate=None
    ):
        """Everything the full and blinded production paths share BEFORE
        the payload decision: advance a head-state clone to `slot`, pick
        the proposer/fork, assemble the payload-less body.  One helper so
        the two paths cannot drift — they must stay semantically identical
        for the blinded root to equal the full block's."""
        from ..config.fork_config import ForkName

        head_state = self.head_state()
        prepared = self.prepare_scheduler.get_prepared_state(self.head_root, slot)
        if prepared is not None:
            # 2/3-slot precompute hit: the epoch transition (if any) is
            # already paid; clone so the cached copy stays pristine for
            # the import path
            pstate, ctx = prepared
            pre = clone_state(self.p, pstate)
            self.prepare_hits += 1
            if self.metrics:
                self.metrics.prepare_next_slot_hits_total.inc()
        else:
            pre = clone_state(self.p, head_state)
            ctx = process_slots(self.p, self.cfg, pre, slot)
        proposer = ctx.get_beacon_proposer(slot)
        fork = self.fork_config.get_fork_info_at_epoch(
            compute_epoch_at_slot(self.p, slot)
        ).name
        parent_root = self.t.BeaconBlockHeader.hash_tree_root(pre.latest_block_header)
        if sync_aggregate is None and fork != ForkName.phase0:
            # pool-built aggregate: previous-slot messages over the parent
            # root (factory/block/body.ts getSyncAggregate)
            pooled = self.contribution_pool.get_sync_aggregate(slot - 1, parent_root)
            if any(pooled.sync_committee_bits):
                sync_aggregate = pooled
        body = self.produce_block_body(fork, pre, attestations, sync_aggregate)
        body.randao_reveal = randao_reveal
        body.eth1_data = pre.eth1_data
        return head_state, pre, proposer, fork, parent_root, body

    def _finalize_block(self, head_state, slot: int, proposer: int, parent_root: bytes, body):
        """Run the (full or header-only) transition to fill in state_root."""
        from ..state_transition.upgrade import state_types

        block = Fields(
            slot=slot,
            proposer_index=proposer,
            parent_root=parent_root,
            state_root=b"\x00" * 32,
            body=body,
        )
        unsigned = Fields(message=block, signature=b"\x00" * 96)
        post, _ = state_transition(
            self.p, self.cfg, head_state, unsigned,
            verify_proposer_signature=False, verify_signatures=False, verify_state_root=False,
        )
        block.state_root = state_types(self.p, post).BeaconState.hash_tree_root(post)
        return block

    def produce_block(
        self, slot: int, randao_reveal: bytes, attestations: Sequence = (), sync_aggregate=None
    ):
        """Assemble an unsigned block on top of the current head, using the
        body shape of the fork active at `slot`."""
        from ..config.fork_config import ForkName

        head_state, pre, proposer, fork, parent_root, body = self._production_scaffold(
            slot, randao_reveal, attestations, sync_aggregate
        )
        if fork not in (ForkName.phase0, ForkName.altair):
            payload = self._produce_execution_payload(pre, slot, proposer)
            if payload is not None:
                body.execution_payload = payload
        return self._finalize_block(head_state, slot, proposer, parent_root, body), proposer

    def _verify_builder_bid(self, bid) -> None:
        """Refuse a SignedBuilderBid whose signature doesn't verify under
        the bid's own pubkey — the proposer is about to sign over this
        header irrevocably, so a corrupted/hostile response must die here
        (reference builder flow verifies the relay bid signature)."""
        from ..execution.builder import builder_domain
        from ..state_transition import compute_signing_root
        from ..types import get_types

        t = get_types(self.p).bellatrix
        domain = builder_domain(self.p, self.cfg.GENESIS_FORK_VERSION)
        root = compute_signing_root(self.p, t.BuilderBid, bid.message, domain)
        # one pairing on the production path, in C: a failed build of the
        # library raises (no oracle fallback)
        from ..native.fastbls import batch_verify as _native_verify

        ok = _native_verify(
            [([bytes(bid.message.pubkey)], root, bytes(bid.signature))], [1]
        )
        if not ok:
            raise BlockError("builder bid signature invalid")
        expected = getattr(self.builder, "pubkey", None)
        if expected is None:
            # without a pinned identity the signature only proves
            # self-consistency — an HTTP MitM could mint its own keypair
            logger.warning(
                "builder bid accepted WITHOUT an identity pin; configure "
                "the builder pubkey to authenticate bids"
            )
        elif bytes(bid.message.pubkey) != bytes(expected):
            raise BlockError("builder bid signed by an unexpected key")

    async def produce_blinded_block(self, slot: int, randao_reveal: bytes):
        """Builder path (api/impl/validator produceBlindedBlock): assemble
        the local body, swap the payload for the builder's bid header, and
        compute the state root through the header-only transition — the
        resulting root is identical to the full block's, so the proposer
        signature commits to the payload sight-unseen."""
        from ..config.fork_config import ForkName

        if self.builder is None:
            raise BlockError("no builder configured")
        head_state, pre, proposer, fork, parent_root, body = self._production_scaffold(
            slot, randao_reveal
        )
        if fork in (ForkName.phase0, ForkName.altair):
            raise BlockError("blinded production requires an execution fork")

        head_node = self.fork_choice.get_block(self.head_root)
        head_hash = head_node.execution_block_hash if head_node else b"\x00" * 32
        pubkey = bytes(pre.validators[proposer].pubkey)
        attrs = self._payload_attributes(pre, slot, proposer)
        # mock builders take chain-observed attrs; the HTTP client follows
        # builder-specs (slot/parent_hash/pubkey only) — probe the
        # signature rather than catching TypeError, which would also
        # swallow genuine bugs inside the builder
        import inspect as _inspect

        try:
            takes_attrs = "attrs" in _inspect.signature(self.builder.get_header).parameters
        except (TypeError, ValueError):
            takes_attrs = False
        if takes_attrs:
            bid = await self._maybe_await(
                self.builder.get_header(slot, head_hash, pubkey, attrs=attrs)
            )
        else:
            bid = await self._maybe_await(
                self.builder.get_header(slot, head_hash, pubkey)
            )
        self._verify_builder_bid(bid)
        blinded_body = Fields(
            **{k: body[k] for k in body.keys() if k != "execution_payload"}
        )
        blinded_body.execution_payload_header = bid.message.header
        return (
            self._finalize_block(head_state, slot, proposer, parent_root, blinded_body),
            proposer,
        )

    async def publish_blinded_block(self, signed_blinded) -> bytes:
        """Unblind via the builder and import the full block
        (api/impl/beacon/blocks publishBlindedBlock)."""
        from ..execution.builder import unblind_block

        if self.builder is None:
            raise BlockError("no builder configured")
        payload = await self._maybe_await(
            self.builder.submit_blinded_block(signed_blinded)
        )
        signed = unblind_block(self.p, signed_blinded, payload)
        return await self.process_block(signed)
