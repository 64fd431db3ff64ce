"""Phase0 block processing (consensus spec beacon-chain.md, v1.1.10).

Reference: packages/state-transition/src/block/ (18 files, SURVEY §2.2).
Signature policy mirrors the reference's eth2fastspec style
(stateTransition.ts:19): with ``verify_signatures=False`` every BLS check is
DEFERRED — collectors (signature_sets.py) later produce the whole block's
sets for one batched device dispatch (chain/blocks/verifyBlock.ts:177-190).
Deposit signatures are the exception: an invalid deposit signature skips
the deposit (it can never fail the block), so it is checked inline.
"""

from __future__ import annotations

import hashlib

from ..config.chain_config import ChainConfig
from ..params import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_DEPOSIT,
    DOMAIN_RANDAO,
    DOMAIN_VOLUNTARY_EXIT,
    FAR_FUTURE_EPOCH,
    Preset,
)
from ..ssz import Fields
from ..types import get_types
from .domain import compute_domain, compute_signing_root, get_domain
from .epoch_context import EpochContext
from .misc import (
    compute_epoch_at_slot,
    get_randao_mix,
    increase_balance,
    is_active_validator,
    xor_bytes,
)
from .validator_ops import initiate_validator_exit, slash_validator


class BlockProcessingError(Exception):
    pass


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def process_block(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, block, verify_signatures: bool = True, execution_engine=None) -> None:
    """Fork-dispatching per-block processing (stateTransition.ts processBlock
    + block/index.ts per-fork tables)."""
    from .upgrade import ForkName, block_fork_name

    fork = block_fork_name(block)
    process_block_header(p, ctx, state, block)
    if fork == ForkName.bellatrix:
        from .bellatrix import is_execution_enabled, process_execution_payload

        if is_execution_enabled(p, state, block.body):
            process_execution_payload(p, cfg, state, block.body, execution_engine)
    process_randao(p, cfg, ctx, state, block.body, verify_signatures)
    process_eth1_data(p, state, block.body)
    process_operations(p, cfg, ctx, state, block.body, verify_signatures, fork=fork)
    if fork != ForkName.phase0:
        from .altair import process_sync_aggregate

        process_sync_aggregate(p, cfg, ctx, state, block.body.sync_aggregate, verify_signatures)


def process_block_header(p: Preset, ctx: EpochContext, state, block) -> None:
    from .upgrade import block_types

    t = block_types(p, block)
    if block.slot != state.slot:
        raise BlockProcessingError("block slot != state slot")
    if block.slot <= state.latest_block_header.slot:
        raise BlockProcessingError("block slot not newer than latest header")
    if block.proposer_index != ctx.get_beacon_proposer(block.slot):
        raise BlockProcessingError("wrong proposer index")
    if block.parent_root != t.BeaconBlockHeader.hash_tree_root(state.latest_block_header):
        raise BlockProcessingError("parent root mismatch")
    # a blinded body merkleizes to the SAME root as its full counterpart
    # (transactions_root == htr(transactions) by construction) but needs
    # its own container type to compute it
    body_type = (
        t.BlindedBeaconBlockBody
        if "execution_payload_header" in block.body
        else t.BeaconBlockBody
    )
    state.latest_block_header = Fields(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=b"\x00" * 32,  # set on the next process_slot
        body_root=body_type.hash_tree_root(block.body),
    )
    if state.validators[block.proposer_index].slashed:
        raise BlockProcessingError("proposer is slashed")


def process_randao(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, body, verify_signatures: bool) -> None:
    epoch = compute_epoch_at_slot(p, state.slot)
    if verify_signatures:
        from ..crypto.bls.api import Signature, verify
        from ..ssz import uint64

        proposer = ctx.get_beacon_proposer(state.slot)
        domain = get_domain(p, state, DOMAIN_RANDAO, epoch)
        root = compute_signing_root(p, uint64, epoch, domain)
        try:
            sig = Signature.from_bytes(body.randao_reveal)
        except ValueError as e:
            raise BlockProcessingError(f"malformed randao reveal: {e}") from None
        if not verify(ctx.index2pubkey[proposer], root, sig):
            raise BlockProcessingError("invalid randao reveal")
    mix = xor_bytes(get_randao_mix(p, state, epoch), _sha(bytes(body.randao_reveal)))
    state.randao_mixes[epoch % p.EPOCHS_PER_HISTORICAL_VECTOR] = mix


def process_eth1_data(p: Preset, state, body) -> None:
    state.eth1_data_votes.append(body.eth1_data)
    t = get_types(p).phase0
    vote_bytes = t.Eth1Data.serialize(body.eth1_data)
    count = sum(1 for v in state.eth1_data_votes if t.Eth1Data.serialize(v) == vote_bytes)
    if count * 2 > p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH:
        state.eth1_data = body.eth1_data


def process_operations(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, body, verify_signatures: bool, fork=None) -> None:
    from .upgrade import ForkName

    expected_deposits = min(p.MAX_DEPOSITS, state.eth1_data.deposit_count - state.eth1_deposit_index)
    if len(body.deposits) != expected_deposits:
        raise BlockProcessingError("wrong deposit count in block")
    for op in body.proposer_slashings:
        process_proposer_slashing(p, cfg, ctx, state, op, verify_signatures)
    for op in body.attester_slashings:
        process_attester_slashing(p, cfg, ctx, state, op, verify_signatures)
    for op in body.attestations:
        if fork is None or fork == ForkName.phase0:
            process_attestation(p, ctx, state, op, verify_signatures)
        else:
            from .altair import process_attestation_altair

            process_attestation_altair(p, cfg, ctx, state, op, verify_signatures)
    for op in body.deposits:
        process_deposit(p, cfg, ctx, state, op)
    for op in body.voluntary_exits:
        process_voluntary_exit(p, cfg, ctx, state, op, verify_signatures)


# -- slashings ---------------------------------------------------------------


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and v.activation_epoch <= epoch < v.withdrawable_epoch


def is_slashable_attestation_data(d1, d2) -> bool:
    """Double vote or surround vote."""
    double = (d1.target.epoch == d2.target.epoch) and not _att_data_eq(d1, d2)
    surround = d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    return double or surround


def _att_data_eq(d1, d2) -> bool:
    return (
        d1.slot == d2.slot
        and d1.index == d2.index
        and d1.beacon_block_root == d2.beacon_block_root
        and d1.source.epoch == d2.source.epoch
        and d1.source.root == d2.source.root
        and d1.target.epoch == d2.target.epoch
        and d1.target.root == d2.target.root
    )


def is_valid_indexed_attestation(p: Preset, ctx: EpochContext, state, indexed, verify_signature: bool) -> bool:
    indices = list(indexed.attesting_indices)
    if not indices or indices != sorted(set(indices)):
        return False
    if len(indices) > p.MAX_VALIDATORS_PER_COMMITTEE:
        return False
    if any(i >= len(state.validators) for i in indices):
        return False
    if verify_signature:
        from .signature_sets import indexed_attestation_signature_set
        from ..crypto.bls.verifier import PyBlsVerifier

        s = indexed_attestation_signature_set(p, ctx, state, indexed)
        return PyBlsVerifier().verify_signature_sets([s])
    return True


def process_proposer_slashing(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, slashing, verify_signatures: bool) -> None:
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    t = get_types(p).phase0
    if h1.slot != h2.slot:
        raise BlockProcessingError("proposer slashing: slots differ")
    if h1.proposer_index != h2.proposer_index:
        raise BlockProcessingError("proposer slashing: proposer differs")
    if t.BeaconBlockHeader.serialize(h1) == t.BeaconBlockHeader.serialize(h2):
        raise BlockProcessingError("proposer slashing: identical headers")
    proposer = state.validators[h1.proposer_index]
    if not is_slashable_validator(proposer, compute_epoch_at_slot(p, state.slot)):
        raise BlockProcessingError("proposer slashing: not slashable")
    if verify_signatures:
        from .signature_sets import proposer_slashing_signature_sets
        from ..crypto.bls.verifier import PyBlsVerifier

        if not PyBlsVerifier().verify_signature_sets(
            proposer_slashing_signature_sets(p, ctx, state, slashing)
        ):
            raise BlockProcessingError("proposer slashing: bad signature")
    slash_validator(p, cfg, state, h1.proposer_index, ctx.get_beacon_proposer(state.slot))


def process_attester_slashing(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, slashing, verify_signatures: bool) -> None:
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    if not is_slashable_attestation_data(a1.data, a2.data):
        raise BlockProcessingError("attester slashing: data not slashable")
    if not is_valid_indexed_attestation(p, ctx, state, a1, verify_signatures):
        raise BlockProcessingError("attester slashing: attestation 1 invalid")
    if not is_valid_indexed_attestation(p, ctx, state, a2, verify_signatures):
        raise BlockProcessingError("attester slashing: attestation 2 invalid")
    epoch = compute_epoch_at_slot(p, state.slot)
    slashed_any = False
    proposer = ctx.get_beacon_proposer(state.slot)
    for index in sorted(set(a1.attesting_indices) & set(a2.attesting_indices)):
        if is_slashable_validator(state.validators[index], epoch):
            slash_validator(p, cfg, state, index, proposer)
            slashed_any = True
    if not slashed_any:
        raise BlockProcessingError("attester slashing: no one slashed")


# -- attestations ------------------------------------------------------------


def process_attestation(p: Preset, ctx: EpochContext, state, attestation, verify_signatures: bool) -> None:
    data = attestation.data
    current_epoch = compute_epoch_at_slot(p, state.slot)
    previous_epoch = max(0, current_epoch - 1)
    if data.target.epoch not in (previous_epoch, current_epoch):
        raise BlockProcessingError("attestation: target epoch not current/previous")
    if data.target.epoch != compute_epoch_at_slot(p, data.slot):
        raise BlockProcessingError("attestation: target epoch != slot epoch")
    if not (data.slot + p.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot <= data.slot + p.SLOTS_PER_EPOCH):
        raise BlockProcessingError("attestation: outside inclusion window")
    if data.index >= ctx.get_committee_count_per_slot(data.target.epoch):
        raise BlockProcessingError("attestation: committee index out of range")
    committee = ctx.get_beacon_committee(data.slot, data.index)
    if len(attestation.aggregation_bits) != len(committee):
        raise BlockProcessingError("attestation: bits/committee length mismatch")

    pending = Fields(
        aggregation_bits=list(attestation.aggregation_bits),
        data=data,
        inclusion_delay=state.slot - data.slot,
        proposer_index=ctx.get_beacon_proposer(state.slot),
    )
    if data.target.epoch == current_epoch:
        if not _checkpoint_eq(data.source, state.current_justified_checkpoint):
            raise BlockProcessingError("attestation: wrong source (current)")
        state.current_epoch_attestations.append(pending)
    else:
        if not _checkpoint_eq(data.source, state.previous_justified_checkpoint):
            raise BlockProcessingError("attestation: wrong source (previous)")
        state.previous_epoch_attestations.append(pending)

    indexed = ctx.get_indexed_attestation(attestation)
    if not is_valid_indexed_attestation(p, ctx, state, indexed, verify_signatures):
        raise BlockProcessingError("attestation: invalid indexed attestation")


def _checkpoint_eq(a, b) -> bool:
    return a.epoch == b.epoch and a.root == b.root


# -- deposits ----------------------------------------------------------------


def is_valid_merkle_branch(leaf: bytes, branch, depth: int, index: int, root: bytes) -> bool:
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = _sha(bytes(branch[i]) + value)
        else:
            value = _sha(value + bytes(branch[i]))
    return value == root


def process_deposit(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, deposit) -> None:
    t = get_types(p).phase0
    leaf = t.DepositData.hash_tree_root(deposit.data)
    if not is_valid_merkle_branch(
        leaf,
        deposit.proof,
        DEPOSIT_CONTRACT_TREE_DEPTH + 1,  # +1 for the length mix-in
        state.eth1_deposit_index,
        state.eth1_data.deposit_root,
    ):
        raise BlockProcessingError("deposit: invalid merkle proof")
    state.eth1_deposit_index += 1
    apply_deposit(p, cfg, ctx, state, deposit.data)


def apply_deposit(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, data) -> None:
    """Add validator or top-up.  Invalid-signature deposits are skipped,
    never a block failure (spec); so the check is inline, not collected."""
    pubkey = bytes(data.pubkey)
    amount = data.amount
    index = ctx.pubkey2index.get(pubkey)
    if index is not None:
        increase_balance(state, index, amount)
        return
    # new validator: proof of possession with GENESIS_FORK_VERSION domain
    from ..crypto.bls.api import PublicKey, Signature, verify

    domain = compute_domain(p, DOMAIN_DEPOSIT, cfg.GENESIS_FORK_VERSION)
    msg = Fields(pubkey=data.pubkey, withdrawal_credentials=data.withdrawal_credentials, amount=amount)
    t = get_types(p).phase0
    root = compute_signing_root(p, t.DepositMessage, msg, domain)
    try:
        pk = PublicKey.from_bytes(pubkey)
        sig = Signature.from_bytes(bytes(data.signature))
    except ValueError:
        return  # malformed -> skip deposit
    if not verify(pk, root, sig):
        return
    eff = min(amount - amount % p.EFFECTIVE_BALANCE_INCREMENT, p.MAX_EFFECTIVE_BALANCE)
    state.validators.append(
        Fields(
            pubkey=pubkey,
            withdrawal_credentials=bytes(data.withdrawal_credentials),
            effective_balance=eff,
            slashed=False,
            activation_eligibility_epoch=FAR_FUTURE_EPOCH,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
    )
    state.balances.append(amount)
    new_index = len(state.validators) - 1
    ctx.pubkey2index.set(pubkey, new_index)
    ctx.index2pubkey.append(pk)


# -- exits -------------------------------------------------------------------


def process_voluntary_exit(p: Preset, cfg: ChainConfig, ctx: EpochContext, state, signed_exit, verify_signatures: bool) -> None:
    exit_msg = signed_exit.message
    if exit_msg.validator_index >= len(state.validators):
        raise BlockProcessingError("exit: unknown validator")
    v = state.validators[exit_msg.validator_index]
    current_epoch = compute_epoch_at_slot(p, state.slot)
    if not is_active_validator(v, current_epoch):
        raise BlockProcessingError("exit: validator not active")
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        raise BlockProcessingError("exit: already exiting")
    if current_epoch < exit_msg.epoch:
        raise BlockProcessingError("exit: epoch in the future")
    if current_epoch < v.activation_epoch + cfg.SHARD_COMMITTEE_PERIOD:
        raise BlockProcessingError("exit: too early after activation")
    if verify_signatures:
        from .signature_sets import voluntary_exit_signature_set
        from ..crypto.bls.verifier import PyBlsVerifier

        if not PyBlsVerifier().verify_signature_sets(
            [voluntary_exit_signature_set(p, ctx, state, signed_exit)]
        ):
            raise BlockProcessingError("exit: bad signature")
    initiate_validator_exit(p, cfg, state, exit_msg.validator_index)
