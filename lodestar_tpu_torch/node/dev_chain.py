"""DevChain: single-process interop chain — genesis, block production with
inline interop validators, attestation flow, batched signature verification,
fork-choice head tracking.  Networking stubbed by construction.

Reference: the `lodestar dev` command (cli/src/cmds/dev/) and the
single-node sim test (beacon-node/test/sim/, SURVEY §4.4): interop genesis,
every validator key local, blocks produced and imported in-process.  This
exercises the complete north-star path: signature-set collectors ->
BlsBatchPool -> the verifier (``TorchBlsVerifier`` on the card,
``FastBlsVerifier`` or ``PyBlsVerifier`` on the host) in one job per block.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..chain.beacon_chain import BeaconChain
from ..chain.bls_pool import BlsBatchPool
from ..chain.clock import LocalClock, ManualClock
from ..config.chain_config import ChainConfig
from ..crypto.bls.api import SecretKey, interop_secret_key, sign_aggregate
from ..params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    Preset,
)
from ..ssz import Fields, uint64
from ..state_transition import (
    clone_state,
    compute_epoch_at_slot,
    compute_signing_root,
    compute_start_slot_at_epoch,
    get_domain,
    interop_genesis_state,
    process_slots,
)
from ..types import get_types
from ..utils.logger import get_logger

logger = get_logger("dev-chain")


class DevChain:
    def __init__(
        self,
        preset: Preset,
        cfg: ChainConfig,
        validator_count: int,
        bls_pool: BlsBatchPool,
        genesis_time: int = 0,
        metrics=None,
        db=None,
        execution_engine=None,
    ):
        self.p = preset
        self.cfg = cfg
        self.t = get_types(preset).phase0
        self.keys: Dict[int, SecretKey] = {
            i: interop_secret_key(i) for i in range(validator_count)
        }
        genesis = interop_genesis_state(preset, cfg, validator_count, genesis_time or 1)
        # manual clock: the dev loop pins the slot as it advances, so
        # clock-gated paths (proposer boost, gossip slot windows) behave
        self.clock = ManualClock(
            genesis_time or 1, cfg.SECONDS_PER_SLOT, preset.SLOTS_PER_EPOCH
        )
        self.chain = BeaconChain(
            preset, cfg, genesis, bls_pool, db=db, metrics=metrics,
            clock=self.clock, execution_engine=execution_engine,
        )
        self.pending_attestations: List = []

    # -- inline validator duties (validator/src/services analogs) -------------

    # dev-chain signatures come from the PUBLISHED interop keys, so the
    # variable-time native ladder is safe here and keeps fixture
    # generation at full speed (the explicit dev/interop opt-in —
    # production signing in validator/store.py defaults constant-time)

    def _sign_randao(self, state, proposer: int, epoch: int) -> bytes:
        domain = get_domain(self.p, state, DOMAIN_RANDAO, epoch)
        root = compute_signing_root(self.p, uint64, epoch, domain)
        return self.keys[proposer].sign(root, variable_time=True).to_bytes()

    def _sign_block(self, state, block, proposer: int) -> bytes:
        from ..state_transition.upgrade import block_types

        epoch = compute_epoch_at_slot(self.p, block.slot)
        domain = get_domain(self.p, state, DOMAIN_BEACON_PROPOSER, epoch)
        t = block_types(self.p, block)
        block_type = (
            t.BlindedBeaconBlock
            if "execution_payload_header" in block.body
            else t.BeaconBlock
        )
        root = compute_signing_root(self.p, block_type, block, domain)
        return self.keys[proposer].sign(root, variable_time=True).to_bytes()

    def _sign_sync_aggregate(self, pre):
        """Full-participation sync aggregate over the previous block root
        (SyncCommitteeService collapsed, validator/services/syncCommittee.ts).
        Returns None pre-altair; `pre` must be advanced to the block slot."""
        from ..state_transition.upgrade import state_fork_name
        from ..config.fork_config import ForkName
        from ..state_transition.altair import sync_aggregate_signing_root

        if state_fork_name(pre) == ForkName.phase0:
            return None
        pk2i = {bytes(interop_pubkey): i for i, interop_pubkey in self._pubkey_by_index().items()}
        root = sync_aggregate_signing_root(self.p, pre)
        signers = []
        bits = []
        for pk in pre.current_sync_committee.pubkeys:
            idx = pk2i.get(bytes(pk))
            if idx is None:
                bits.append(False)
                continue
            bits.append(True)
            signers.append(self.keys[idx])
        if not any(bits):
            return None
        return Fields(
            sync_committee_bits=bits,
            sync_committee_signature=sign_aggregate(signers, root).to_bytes(),
        )

    def _pubkey_by_index(self) -> Dict[int, bytes]:
        if not hasattr(self, "_pubkeys_cache"):
            self._pubkeys_cache = {
                i: sk.to_public_key().to_bytes() for i, sk in self.keys.items()
            }
        return self._pubkeys_cache

    def attest(self, slot: int) -> None:
        """All committees of `slot` attest to the current head (the
        AttestationService at 1/3-slot, validator/services/attestation.ts:22,
        collapsed to full participation)."""
        head_root = self.chain.head_root
        head_state = self.chain.head_state()
        state = clone_state(self.p, head_state)
        ctx = process_slots(self.p, self.cfg, state, max(slot, state.slot))
        epoch = compute_epoch_at_slot(self.p, slot)
        target_root = self._epoch_boundary_root(state, head_root, epoch)
        domain = get_domain(self.p, state, DOMAIN_BEACON_ATTESTER, epoch)
        committees = ctx.get_committee_count_per_slot(epoch)
        for index in range(committees):
            committee = ctx.get_beacon_committee(slot, index)
            data = Fields(
                slot=slot,
                index=index,
                beacon_block_root=head_root,
                source=state.current_justified_checkpoint,
                target=Fields(epoch=epoch, root=target_root),
            )
            root = compute_signing_root(self.p, self.t.AttestationData, data, domain)
            agg_sig = sign_aggregate([self.keys[int(vi)] for vi in committee], root)
            att = Fields(
                aggregation_bits=[True] * len(committee),
                data=data,
                signature=agg_sig.to_bytes(),
            )
            self.pending_attestations.append(att)

    def _epoch_boundary_root(self, state, head_root: bytes, epoch: int) -> bytes:
        boundary_slot = compute_start_slot_at_epoch(self.p, epoch)
        if boundary_slot >= state.slot:
            return head_root
        return bytes(state.block_roots[boundary_slot % self.p.SLOTS_PER_HISTORICAL_ROOT])

    # -- slot driver ----------------------------------------------------------

    async def advance_slot(self, slot: int, with_attestations: bool = True) -> bytes:
        """Produce + import the block for `slot`; then attest on the new
        head for inclusion at slot+1."""
        self.clock.set_slot(slot)
        atts = [
            a
            for a in self.pending_attestations
            if a.data.slot + self.p.MIN_ATTESTATION_INCLUSION_DELAY <= slot
        ][: self.p.MAX_ATTESTATIONS]
        head_state = self.chain.head_state()
        pre = clone_state(self.p, head_state)
        ctx = process_slots(self.p, self.cfg, pre, slot)
        proposer = ctx.get_beacon_proposer(slot)
        epoch = compute_epoch_at_slot(self.p, slot)
        randao = self._sign_randao(pre, proposer, epoch)
        sync_aggregate = self._sign_sync_aggregate(pre)
        block, _ = self.chain.produce_block(
            slot, randao, attestations=atts, sync_aggregate=sync_aggregate
        )
        sig = self._sign_block(pre, block, proposer)
        signed = Fields(message=block, signature=sig)
        root = await self.chain.process_block(signed)
        self.pending_attestations = [
            a for a in self.pending_attestations if a not in atts
        ]
        if with_attestations:
            self.attest(slot)
        logger.debug("slot %d: head %s", slot, root.hex()[:12])
        return root

    async def produce_and_import_block(self, slot: int, attestations=()):
        """Produce, sign, import and RETURN the signed block for `slot`
        (no attestation flow) — the building block for network tests and
        external publishers."""
        self.clock.set_slot(slot)
        head_state = self.chain.head_state()
        pre = clone_state(self.p, head_state)
        ctx = process_slots(self.p, self.cfg, pre, slot)
        proposer = ctx.get_beacon_proposer(slot)
        epoch = compute_epoch_at_slot(self.p, slot)
        randao = self._sign_randao(pre, proposer, epoch)
        sync_aggregate = self._sign_sync_aggregate(pre)
        block, _ = self.chain.produce_block(
            slot, randao, attestations=list(attestations), sync_aggregate=sync_aggregate
        )
        sig = self._sign_block(pre, block, proposer)
        signed = Fields(message=block, signature=sig)
        await self.chain.process_block(signed)
        return signed

    async def run(self, n_slots: int, with_attestations: bool = True) -> None:
        state = self.chain.head_state()
        start = state.slot + 1
        for slot in range(start, start + n_slots):
            await self.advance_slot(slot, with_attestations)
            # the manual-clock analog of the 2/3-slot prepare tick: the
            # next slot's state (including any epoch transition) is
            # precomputed off the import path (prepareNextSlot.ts:30)
            await self.chain.prepare_scheduler.prepare(slot + 1)
