"""SSZ container schemas per fork, parameterized by Preset.

Field names and orders follow the consensus spec v1.1.10 (the reference's
pinned version, README.md:10); reference schema code:
packages/types/src/phase0/sszTypes.ts, altair/sszTypes.ts,
bellatrix/sszTypes.ts.
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

from ..params import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    JUSTIFICATION_BITS_LENGTH,
    Preset,
)
from ..params.presets import ATTESTATION_SUBNET_COUNT, SYNC_COMMITTEE_SUBNET_COUNT
from ..ssz import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Root,
    Uint,
    Vector,
    boolean,
    uint8,
    uint64,
    uint256,
)

ValidatorIndex = uint64
Gwei = uint64
Slot = uint64
Epoch = uint64
CommitteeIndex = uint64
ParticipationFlags = uint8
Version = Bytes4
Domain = Bytes32
BLSPubkey = Bytes48
BLSSignature = Bytes96


class ForkTypes(SimpleNamespace):
    """Namespace of container types for one fork."""


class TypeRegistry(SimpleNamespace):
    """phase0 / altair / bellatrix ForkTypes + shared primitives."""


def _phase0(p: Preset) -> ForkTypes:
    t = ForkTypes()

    t.Fork = Container(
        "Fork",
        [("previous_version", Version), ("current_version", Version), ("epoch", Epoch)],
    )
    t.ForkData = Container(
        "ForkData",
        [("current_version", Version), ("genesis_validators_root", Root)],
    )
    t.Checkpoint = Container("Checkpoint", [("epoch", Epoch), ("root", Root)])
    t.Validator = Container(
        "Validator",
        [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", Bytes32),
            ("effective_balance", Gwei),
            ("slashed", boolean),
            ("activation_eligibility_epoch", Epoch),
            ("activation_epoch", Epoch),
            ("exit_epoch", Epoch),
            ("withdrawable_epoch", Epoch),
        ],
    )
    t.AttestationData = Container(
        "AttestationData",
        [
            ("slot", Slot),
            ("index", CommitteeIndex),
            ("beacon_block_root", Root),
            ("source", t.Checkpoint),
            ("target", t.Checkpoint),
        ],
    )
    t.IndexedAttestation = Container(
        "IndexedAttestation",
        [
            ("attesting_indices", List(uint64, p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", t.AttestationData),
            ("signature", BLSSignature),
        ],
    )
    t.PendingAttestation = Container(
        "PendingAttestation",
        [
            ("aggregation_bits", Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", t.AttestationData),
            ("inclusion_delay", Slot),
            ("proposer_index", ValidatorIndex),
        ],
    )
    t.Eth1Data = Container(
        "Eth1Data",
        [("deposit_root", Root), ("deposit_count", uint64), ("block_hash", Bytes32)],
    )
    t.HistoricalBatch = Container(
        "HistoricalBatch",
        [
            ("block_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
        ],
    )
    t.DepositMessage = Container(
        "DepositMessage",
        [("pubkey", BLSPubkey), ("withdrawal_credentials", Bytes32), ("amount", Gwei)],
    )
    t.DepositData = Container(
        "DepositData",
        [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", Bytes32),
            ("amount", Gwei),
            ("signature", BLSSignature),
        ],
    )
    t.BeaconBlockHeader = Container(
        "BeaconBlockHeader",
        [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body_root", Root),
        ],
    )
    t.SignedBeaconBlockHeader = Container(
        "SignedBeaconBlockHeader",
        [("message", t.BeaconBlockHeader), ("signature", BLSSignature)],
    )
    t.SigningData = Container("SigningData", [("object_root", Root), ("domain", Domain)])
    t.ProposerSlashing = Container(
        "ProposerSlashing",
        [("signed_header_1", t.SignedBeaconBlockHeader), ("signed_header_2", t.SignedBeaconBlockHeader)],
    )
    t.AttesterSlashing = Container(
        "AttesterSlashing",
        [("attestation_1", t.IndexedAttestation), ("attestation_2", t.IndexedAttestation)],
    )
    t.Attestation = Container(
        "Attestation",
        [
            ("aggregation_bits", Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", t.AttestationData),
            ("signature", BLSSignature),
        ],
    )
    t.Deposit = Container(
        "Deposit",
        [
            ("proof", Vector(Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1)),
            ("data", t.DepositData),
        ],
    )
    t.VoluntaryExit = Container(
        "VoluntaryExit", [("epoch", Epoch), ("validator_index", ValidatorIndex)]
    )
    t.SignedVoluntaryExit = Container(
        "SignedVoluntaryExit", [("message", t.VoluntaryExit), ("signature", BLSSignature)]
    )
    t.BeaconBlockBody = Container(
        "BeaconBlockBody",
        [
            ("randao_reveal", BLSSignature),
            ("eth1_data", t.Eth1Data),
            ("graffiti", Bytes32),
            ("proposer_slashings", List(t.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS)),
            ("attester_slashings", List(t.AttesterSlashing, p.MAX_ATTESTER_SLASHINGS)),
            ("attestations", List(t.Attestation, p.MAX_ATTESTATIONS)),
            ("deposits", List(t.Deposit, p.MAX_DEPOSITS)),
            ("voluntary_exits", List(t.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS)),
        ],
    )
    t.BeaconBlock = Container(
        "BeaconBlock",
        [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", t.BeaconBlockBody),
        ],
    )
    t.SignedBeaconBlock = Container(
        "SignedBeaconBlock", [("message", t.BeaconBlock), ("signature", BLSSignature)]
    )
    t.AggregateAndProof = Container(
        "AggregateAndProof",
        [
            ("aggregator_index", ValidatorIndex),
            ("aggregate", t.Attestation),
            ("selection_proof", BLSSignature),
        ],
    )
    t.SignedAggregateAndProof = Container(
        "SignedAggregateAndProof",
        [("message", t.AggregateAndProof), ("signature", BLSSignature)],
    )
    t.BeaconState = Container(
        "BeaconState",
        [
            ("genesis_time", uint64),
            ("genesis_validators_root", Root),
            ("slot", Slot),
            ("fork", t.Fork),
            ("latest_block_header", t.BeaconBlockHeader),
            ("block_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("historical_roots", List(Root, p.HISTORICAL_ROOTS_LIMIT)),
            ("eth1_data", t.Eth1Data),
            ("eth1_data_votes", List(t.Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH)),
            ("eth1_deposit_index", uint64),
            ("validators", List(t.Validator, p.VALIDATOR_REGISTRY_LIMIT)),
            ("balances", List(Gwei, p.VALIDATOR_REGISTRY_LIMIT)),
            ("randao_mixes", Vector(Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR)),
            ("slashings", Vector(Gwei, p.EPOCHS_PER_SLASHINGS_VECTOR)),
            ("previous_epoch_attestations", List(t.PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH)),
            ("current_epoch_attestations", List(t.PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH)),
            ("justification_bits", Bitvector(JUSTIFICATION_BITS_LENGTH)),
            ("previous_justified_checkpoint", t.Checkpoint),
            ("current_justified_checkpoint", t.Checkpoint),
            ("finalized_checkpoint", t.Checkpoint),
        ],
    )
    # p2p (network layer containers, packages/types/src/phase0/sszTypes.ts)
    t.Status = Container(
        "Status",
        [
            ("fork_digest", Bytes4),
            ("finalized_root", Root),
            ("finalized_epoch", Epoch),
            ("head_root", Root),
            ("head_slot", Slot),
        ],
    )
    t.Goodbye = uint64
    t.Ping = uint64
    t.Metadata = Container(
        "Metadata",
        [("seq_number", uint64), ("attnets", Bitvector(ATTESTATION_SUBNET_COUNT))],
    )
    t.BeaconBlocksByRangeRequest = Container(
        "BeaconBlocksByRangeRequest",
        [("start_slot", Slot), ("count", uint64), ("step", uint64)],
    )
    t.BeaconBlocksByRootRequest = Container(
        "BeaconBlocksByRootRequest",
        [("roots", List(Root, 1024))],
    )
    t.Eth1Block = Container(
        "Eth1Block",
        [("timestamp", uint64), ("deposit_root", Root), ("deposit_count", uint64)],
    )
    return t


def _altair(p: Preset, ph: ForkTypes) -> ForkTypes:
    t = ForkTypes(**vars(ph))  # inherit unchanged phase0 types

    t.SyncCommittee = Container(
        "SyncCommittee",
        [
            ("pubkeys", Vector(BLSPubkey, p.SYNC_COMMITTEE_SIZE)),
            ("aggregate_pubkey", BLSPubkey),
        ],
    )
    t.SyncAggregate = Container(
        "SyncAggregate",
        [
            ("sync_committee_bits", Bitvector(p.SYNC_COMMITTEE_SIZE)),
            ("sync_committee_signature", BLSSignature),
        ],
    )
    t.SyncCommitteeMessage = Container(
        "SyncCommitteeMessage",
        [
            ("slot", Slot),
            ("beacon_block_root", Root),
            ("validator_index", ValidatorIndex),
            ("signature", BLSSignature),
        ],
    )
    t.SyncCommitteeContribution = Container(
        "SyncCommitteeContribution",
        [
            ("slot", Slot),
            ("beacon_block_root", Root),
            ("subcommittee_index", uint64),
            ("aggregation_bits", Bitvector(p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT)),
            ("signature", BLSSignature),
        ],
    )
    t.ContributionAndProof = Container(
        "ContributionAndProof",
        [
            ("aggregator_index", ValidatorIndex),
            ("contribution", t.SyncCommitteeContribution),
            ("selection_proof", BLSSignature),
        ],
    )
    t.SignedContributionAndProof = Container(
        "SignedContributionAndProof",
        [("message", t.ContributionAndProof), ("signature", BLSSignature)],
    )
    t.SyncAggregatorSelectionData = Container(
        "SyncAggregatorSelectionData",
        [("slot", Slot), ("subcommittee_index", uint64)],
    )
    t.BeaconBlockBody = Container(
        "BeaconBlockBody",
        [
            ("randao_reveal", BLSSignature),
            ("eth1_data", ph.Eth1Data),
            ("graffiti", Bytes32),
            ("proposer_slashings", List(ph.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS)),
            ("attester_slashings", List(ph.AttesterSlashing, p.MAX_ATTESTER_SLASHINGS)),
            ("attestations", List(ph.Attestation, p.MAX_ATTESTATIONS)),
            ("deposits", List(ph.Deposit, p.MAX_DEPOSITS)),
            ("voluntary_exits", List(ph.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS)),
            ("sync_aggregate", t.SyncAggregate),
        ],
    )
    t.BeaconBlock = Container(
        "BeaconBlock",
        [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", t.BeaconBlockBody),
        ],
    )
    t.SignedBeaconBlock = Container(
        "SignedBeaconBlock", [("message", t.BeaconBlock), ("signature", BLSSignature)]
    )
    t.BeaconState = Container(
        "BeaconState",
        [
            ("genesis_time", uint64),
            ("genesis_validators_root", Root),
            ("slot", Slot),
            ("fork", ph.Fork),
            ("latest_block_header", ph.BeaconBlockHeader),
            ("block_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("historical_roots", List(Root, p.HISTORICAL_ROOTS_LIMIT)),
            ("eth1_data", ph.Eth1Data),
            ("eth1_data_votes", List(ph.Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH)),
            ("eth1_deposit_index", uint64),
            ("validators", List(ph.Validator, p.VALIDATOR_REGISTRY_LIMIT)),
            ("balances", List(Gwei, p.VALIDATOR_REGISTRY_LIMIT)),
            ("randao_mixes", Vector(Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR)),
            ("slashings", Vector(Gwei, p.EPOCHS_PER_SLASHINGS_VECTOR)),
            ("previous_epoch_participation", List(ParticipationFlags, p.VALIDATOR_REGISTRY_LIMIT)),
            ("current_epoch_participation", List(ParticipationFlags, p.VALIDATOR_REGISTRY_LIMIT)),
            ("justification_bits", Bitvector(JUSTIFICATION_BITS_LENGTH)),
            ("previous_justified_checkpoint", ph.Checkpoint),
            ("current_justified_checkpoint", ph.Checkpoint),
            ("finalized_checkpoint", ph.Checkpoint),
            ("inactivity_scores", List(uint64, p.VALIDATOR_REGISTRY_LIMIT)),
            ("current_sync_committee", t.SyncCommittee),
            ("next_sync_committee", t.SyncCommittee),
        ],
    )
    t.Metadata = Container(
        "Metadata",
        [
            ("seq_number", uint64),
            ("attnets", Bitvector(ATTESTATION_SUBNET_COUNT)),
            ("syncnets", Bitvector(SYNC_COMMITTEE_SUBNET_COUNT)),
        ],
    )
    # light client (altair sync-committee protocol,
    # packages/types/src/altair/sszTypes.ts LightClientUpdate).  The spec
    # container ends with signature_slot — the slot whose committee/domain
    # signed the aggregate; validation and is_better_update ranking both
    # key off it, so an SSZ round-trip must carry it (a container without
    # it silently drops the field and the client falls back to guessing
    # attested.slot + 1).  The outdated altair-draft fork_version field is
    # gone: the client derives the domain from ITS OWN fork schedule at
    # the signature slot — trusting an update-supplied version would let a
    # malicious server pick the domain (light_client/client.py).
    t.LightClientUpdate = Container(
        "LightClientUpdate",
        [
            ("attested_header", ph.BeaconBlockHeader),
            ("next_sync_committee", t.SyncCommittee),
            ("next_sync_committee_branch", Vector(Bytes32, 5)),
            ("finalized_header", ph.BeaconBlockHeader),
            ("finality_branch", Vector(Bytes32, 6)),
            ("sync_aggregate", t.SyncAggregate),
            ("signature_slot", Slot),
        ],
    )
    return t


def _bellatrix(p: Preset, al: ForkTypes, ph: ForkTypes) -> ForkTypes:
    t = ForkTypes(**vars(al))

    payload_fixed = [
        ("parent_hash", Bytes32),
        ("fee_recipient", Bytes20),
        ("state_root", Bytes32),
        ("receipts_root", Bytes32),
        ("logs_bloom", ByteVector(p.BYTES_PER_LOGS_BLOOM)),
        ("prev_randao", Bytes32),
        ("block_number", uint64),
        ("gas_limit", uint64),
        ("gas_used", uint64),
        ("timestamp", uint64),
        ("extra_data", ByteList(p.MAX_EXTRA_DATA_BYTES)),
        ("base_fee_per_gas", uint256),
        ("block_hash", Bytes32),
    ]
    t.ExecutionPayload = Container(
        "ExecutionPayload",
        payload_fixed
        + [("transactions", List(ByteList(p.MAX_BYTES_PER_TRANSACTION), p.MAX_TRANSACTIONS_PER_PAYLOAD))],
    )
    t.ExecutionPayloadHeader = Container(
        "ExecutionPayloadHeader", payload_fixed + [("transactions_root", Root)]
    )
    t.PowBlock = Container(
        "PowBlock",
        [
            ("block_hash", Bytes32),
            ("parent_hash", Bytes32),
            ("total_difficulty", uint256),
        ],
    )
    t.BeaconBlockBody = Container(
        "BeaconBlockBody",
        [
            ("randao_reveal", BLSSignature),
            ("eth1_data", ph.Eth1Data),
            ("graffiti", Bytes32),
            ("proposer_slashings", List(ph.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS)),
            ("attester_slashings", List(ph.AttesterSlashing, p.MAX_ATTESTER_SLASHINGS)),
            ("attestations", List(ph.Attestation, p.MAX_ATTESTATIONS)),
            ("deposits", List(ph.Deposit, p.MAX_DEPOSITS)),
            ("voluntary_exits", List(ph.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS)),
            ("sync_aggregate", al.SyncAggregate),
            ("execution_payload", t.ExecutionPayload),
        ],
    )
    t.BeaconBlock = Container(
        "BeaconBlock",
        [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", t.BeaconBlockBody),
        ],
    )
    t.SignedBeaconBlock = Container(
        "SignedBeaconBlock", [("message", t.BeaconBlock), ("signature", BLSSignature)]
    )
    # blinded blocks + builder flow (packages/types/src/bellatrix/sszTypes.ts
    # BlindedBeaconBlockBody / BuilderBid / ValidatorRegistrationV1): the body
    # carries only the payload HEADER; the full payload stays with the builder
    # until the signed blinded block is revealed.
    t.BlindedBeaconBlockBody = Container(
        "BlindedBeaconBlockBody",
        [
            ("randao_reveal", BLSSignature),
            ("eth1_data", ph.Eth1Data),
            ("graffiti", Bytes32),
            ("proposer_slashings", List(ph.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS)),
            ("attester_slashings", List(ph.AttesterSlashing, p.MAX_ATTESTER_SLASHINGS)),
            ("attestations", List(ph.Attestation, p.MAX_ATTESTATIONS)),
            ("deposits", List(ph.Deposit, p.MAX_DEPOSITS)),
            ("voluntary_exits", List(ph.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS)),
            ("sync_aggregate", al.SyncAggregate),
            ("execution_payload_header", t.ExecutionPayloadHeader),
        ],
    )
    t.BlindedBeaconBlock = Container(
        "BlindedBeaconBlock",
        [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", t.BlindedBeaconBlockBody),
        ],
    )
    t.SignedBlindedBeaconBlock = Container(
        "SignedBlindedBeaconBlock",
        [("message", t.BlindedBeaconBlock), ("signature", BLSSignature)],
    )
    t.ValidatorRegistrationV1 = Container(
        "ValidatorRegistrationV1",
        [
            ("fee_recipient", Bytes20),
            ("gas_limit", uint64),
            ("timestamp", uint64),
            ("pubkey", BLSPubkey),
        ],
    )
    t.SignedValidatorRegistration = Container(
        "SignedValidatorRegistration",
        [("message", t.ValidatorRegistrationV1), ("signature", BLSSignature)],
    )
    t.BuilderBid = Container(
        "BuilderBid",
        [
            ("header", t.ExecutionPayloadHeader),
            ("value", uint256),
            ("pubkey", BLSPubkey),
        ],
    )
    t.SignedBuilderBid = Container(
        "SignedBuilderBid", [("message", t.BuilderBid), ("signature", BLSSignature)]
    )
    t.BeaconState = Container(
        "BeaconState",
        [
            ("genesis_time", uint64),
            ("genesis_validators_root", Root),
            ("slot", Slot),
            ("fork", ph.Fork),
            ("latest_block_header", ph.BeaconBlockHeader),
            ("block_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("historical_roots", List(Root, p.HISTORICAL_ROOTS_LIMIT)),
            ("eth1_data", ph.Eth1Data),
            ("eth1_data_votes", List(ph.Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH)),
            ("eth1_deposit_index", uint64),
            ("validators", List(ph.Validator, p.VALIDATOR_REGISTRY_LIMIT)),
            ("balances", List(Gwei, p.VALIDATOR_REGISTRY_LIMIT)),
            ("randao_mixes", Vector(Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR)),
            ("slashings", Vector(Gwei, p.EPOCHS_PER_SLASHINGS_VECTOR)),
            ("previous_epoch_participation", List(ParticipationFlags, p.VALIDATOR_REGISTRY_LIMIT)),
            ("current_epoch_participation", List(ParticipationFlags, p.VALIDATOR_REGISTRY_LIMIT)),
            ("justification_bits", Bitvector(JUSTIFICATION_BITS_LENGTH)),
            ("previous_justified_checkpoint", ph.Checkpoint),
            ("current_justified_checkpoint", ph.Checkpoint),
            ("finalized_checkpoint", ph.Checkpoint),
            ("inactivity_scores", List(uint64, p.VALIDATOR_REGISTRY_LIMIT)),
            ("current_sync_committee", al.SyncCommittee),
            ("next_sync_committee", al.SyncCommittee),
            ("latest_execution_payload_header", t.ExecutionPayloadHeader),
        ],
    )
    return t


@lru_cache(maxsize=None)
def get_types(preset: Preset) -> TypeRegistry:
    ph = _phase0(preset)
    al = _altair(preset, ph)
    be = _bellatrix(preset, al, ph)
    return TypeRegistry(phase0=ph, altair=al, bellatrix=be)
