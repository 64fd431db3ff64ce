"""ValidatorStore: keys + every signing path, gated by slashing protection.

Reference: packages/validator/src/services/validatorStore.ts (signBlock,
signAttestation, signAggregateAndProof, signRandao, signVoluntaryExit) —
every signature a VC can make flows through this object so the slashing
protection gate is unbypassable.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..config.chain_config import ChainConfig
from ..crypto.bls.api import SecretKey
from ..params import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
    Preset,
)
from ..ssz import Fields, uint64
from ..state_transition import (
    compute_domain,
    compute_epoch_at_slot,
    compute_signing_root,
)
from ..types import get_types
from .slashing_protection import SlashingProtection


class ValidatorStore:
    def __init__(
        self,
        preset: Preset,
        cfg: ChainConfig,
        keys: Dict[int, SecretKey],
        slashing_protection: Optional[SlashingProtection] = None,
        genesis_validators_root: bytes = b"\x00" * 32,
        remote_signer=None,
        remote_keys: Optional[Dict[int, bytes]] = None,
        dev_signing: bool = False,
    ):
        self.p = preset
        self.cfg = cfg
        self.keys = keys
        # Signing-path discipline: production signing uses the
        # constant-time-safe native ladder (fb_sign_ct — uniform operation
        # sequence, no key-dependent branching).  ``dev_signing=True`` is
        # the explicit dev/interop opt-in for the variable-time
        # double-and-add path (fb_sign): ~2x faster, and its timing
        # leaks the scalar — acceptable ONLY for published interop keys
        # (dev chains, sim fixtures, spec-vector generation).
        self.dev_signing = dev_signing
        self.t = get_types(preset).phase0
        self.gvr = genesis_validators_root
        self.protection = slashing_protection or SlashingProtection(genesis_validators_root)
        self.pubkeys = {i: sk.to_public_key().to_bytes() for i, sk in keys.items()}
        # remote-signer validators (validatorStore.ts SignerType.Remote):
        # we hold only the pubkey; every signing root goes over HTTP.
        # Slashing protection still gates BEFORE the request leaves.
        self.remote_signer = remote_signer
        if remote_keys:
            self.pubkeys.update(remote_keys)

    def _sign(self, validator_index: int, root: bytes) -> bytes:
        sk = self.keys.get(validator_index)
        if sk is not None:
            return sk.sign(root, variable_time=self.dev_signing).to_bytes()
        if self.remote_signer is None:
            raise KeyError(f"no signer for validator {validator_index}")
        return self.remote_signer.sign(self.pubkeys[validator_index], root)

    def _domain(self, domain_type: bytes, epoch: int) -> bytes:
        from ..config.fork_config import ForkConfig

        fork_version = ForkConfig(self.cfg).get_fork_info_at_epoch(epoch).version
        return compute_domain(self.p, domain_type, fork_version, self.gvr)

    # -- signing paths ---------------------------------------------------------

    def sign_randao(self, validator_index: int, epoch: int) -> bytes:
        domain = self._domain(DOMAIN_RANDAO, epoch)
        root = compute_signing_root(self.p, uint64, epoch, domain)
        return self._sign(validator_index, root)

    def sign_block(self, validator_index: int, block) -> bytes:
        from ..state_transition.upgrade import block_types

        epoch = compute_epoch_at_slot(self.p, block.slot)
        domain = self._domain(DOMAIN_BEACON_PROPOSER, epoch)
        t = block_types(self.p, block)
        # a blinded block signs to the SAME root as its full counterpart,
        # but needs its own container type to compute it
        block_type = (
            t.BlindedBeaconBlock
            if "execution_payload_header" in block.body
            else t.BeaconBlock
        )
        root = compute_signing_root(self.p, block_type, block, domain)
        pk = self.pubkeys[validator_index]
        self.protection.check_and_insert_block_proposal(pk, block.slot, root)
        return self._sign(validator_index, root)

    def sign_attestation(self, validator_index: int, data) -> bytes:
        domain = self._domain(DOMAIN_BEACON_ATTESTER, data.target.epoch)
        root = compute_signing_root(self.p, self.t.AttestationData, data, domain)
        pk = self.pubkeys[validator_index]
        self.protection.check_and_insert_attestation(
            pk, data.source.epoch, data.target.epoch, root
        )
        return self._sign(validator_index, root)

    def sign_selection_proof(self, validator_index: int, slot: int) -> bytes:
        epoch = compute_epoch_at_slot(self.p, slot)
        domain = self._domain(DOMAIN_SELECTION_PROOF, epoch)
        root = compute_signing_root(self.p, uint64, slot, domain)
        return self._sign(validator_index, root)

    def sign_aggregate_and_proof(self, validator_index: int, aggregate_and_proof) -> bytes:
        epoch = compute_epoch_at_slot(self.p, aggregate_and_proof.aggregate.data.slot)
        domain = self._domain(DOMAIN_AGGREGATE_AND_PROOF, epoch)
        root = compute_signing_root(
            self.p, self.t.AggregateAndProof, aggregate_and_proof, domain
        )
        return self._sign(validator_index, root)

    def sign_sync_committee_message(
        self, validator_index: int, slot: int, beacon_block_root: bytes
    ) -> Fields:
        """SyncCommitteeMessage (services/syncCommittee.ts signing path)."""
        from ..params import DOMAIN_SYNC_COMMITTEE

        epoch = compute_epoch_at_slot(self.p, slot)
        domain = self._domain(DOMAIN_SYNC_COMMITTEE, epoch)
        root = self.t.SigningData.hash_tree_root(
            Fields(object_root=beacon_block_root, domain=domain)
        )
        return Fields(
            slot=slot,
            beacon_block_root=beacon_block_root,
            validator_index=validator_index,
            signature=self._sign(validator_index, root),
        )

    def sign_sync_selection_proof(
        self, validator_index: int, slot: int, subcommittee_index: int
    ) -> bytes:
        from ..params import DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF
        from ..types import get_types as _gt

        epoch = compute_epoch_at_slot(self.p, slot)
        domain = self._domain(DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch)
        t_alt = _gt(self.p).altair
        data = Fields(slot=slot, subcommittee_index=subcommittee_index)
        root = compute_signing_root(self.p, t_alt.SyncAggregatorSelectionData, data, domain)
        return self._sign(validator_index, root)

    def sign_contribution_and_proof(self, validator_index: int, message) -> bytes:
        from ..params import DOMAIN_CONTRIBUTION_AND_PROOF
        from ..types import get_types as _gt

        epoch = compute_epoch_at_slot(self.p, message.contribution.slot)
        domain = self._domain(DOMAIN_CONTRIBUTION_AND_PROOF, epoch)
        t_alt = _gt(self.p).altair
        root = compute_signing_root(self.p, t_alt.ContributionAndProof, message, domain)
        return self._sign(validator_index, root)

    def sign_voluntary_exit(self, validator_index: int, exit_epoch: int) -> Fields:
        msg = Fields(epoch=exit_epoch, validator_index=validator_index)
        domain = self._domain(DOMAIN_VOLUNTARY_EXIT, exit_epoch)
        root = compute_signing_root(self.p, self.t.VoluntaryExit, msg, domain)
        return Fields(
            message=msg, signature=self._sign(validator_index, root)
        )

    def sign_validator_registration(
        self, validator_index: int, fee_recipient: bytes, gas_limit: int, timestamp: int
    ) -> Fields:
        """SignedValidatorRegistration for the MEV builder
        (validatorStore.ts signValidatorRegistration).  The builder domain
        binds the GENESIS fork version over a zero genesis_validators_root
        — registrations are valid across the fork schedule."""
        from ..params import DOMAIN_APPLICATION_BUILDER
        from ..types import get_types as _gt

        t_be = _gt(self.p).bellatrix
        msg = Fields(
            fee_recipient=bytes(fee_recipient),
            gas_limit=int(gas_limit),
            timestamp=int(timestamp),
            pubkey=self.pubkeys[validator_index],
        )
        domain = compute_domain(
            self.p,
            DOMAIN_APPLICATION_BUILDER,
            self.cfg.GENESIS_FORK_VERSION,
            b"\x00" * 32,
        )
        root = compute_signing_root(self.p, t_be.ValidatorRegistrationV1, msg, domain)
        return Fields(message=msg, signature=self._sign(validator_index, root))
