"""Signature-set collectors: turn a signed block into the batch of
SignatureSets the device verifier consumes in one dispatch.

Reference: packages/state-transition/src/signatureSets/index.ts:23
(getBlockSignatureSets) and its per-op files.  This is the producer side of
the north-star boundary (chain/blocks/verifyBlock.ts:177-190 collects these
and calls chain.bls.verifySignatureSets once per block).
"""

from __future__ import annotations

from typing import List

from ..config.chain_config import ChainConfig
from ..crypto.bls.verifier import AggregatedSignatureSet, SignatureSet, SingleSignatureSet
from ..params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_VOLUNTARY_EXIT,
    Preset,
)
from ..ssz import uint64
from ..types import get_types
from .domain import compute_signing_root, get_domain
from .epoch_context import EpochContext
from .misc import compute_epoch_at_slot


def block_proposer_signature_set(p: Preset, ctx: EpochContext, state, signed_block) -> SingleSignatureSet:
    from .upgrade import block_types

    block = signed_block.message
    t = block_types(p, block)
    epoch = compute_epoch_at_slot(p, block.slot)
    domain = get_domain(p, state, DOMAIN_BEACON_PROPOSER, epoch)
    return SingleSignatureSet(
        pubkey=ctx.index2pubkey[block.proposer_index],
        signing_root=compute_signing_root(p, t.BeaconBlock, block, domain),
        signature=bytes(signed_block.signature),
    )


def randao_signature_set(p: Preset, ctx: EpochContext, state, block) -> SingleSignatureSet:
    epoch = compute_epoch_at_slot(p, block.slot)
    domain = get_domain(p, state, DOMAIN_RANDAO, epoch)
    return SingleSignatureSet(
        pubkey=ctx.index2pubkey[block.proposer_index],
        signing_root=compute_signing_root(p, uint64, epoch, domain),
        signature=bytes(block.body.randao_reveal),
    )


def indexed_attestation_signature_set(p: Preset, ctx: EpochContext, state, indexed) -> AggregatedSignatureSet:
    t = get_types(p).phase0
    domain = get_domain(p, state, DOMAIN_BEACON_ATTESTER, indexed.data.target.epoch)
    return AggregatedSignatureSet(
        pubkeys=[ctx.index2pubkey[i] for i in indexed.attesting_indices],
        signing_root=compute_signing_root(p, t.AttestationData, indexed.data, domain),
        signature=bytes(indexed.signature),
    )


def attestation_signature_sets(p: Preset, ctx: EpochContext, state, attestations) -> List[SignatureSet]:
    return [
        indexed_attestation_signature_set(p, ctx, state, ctx.get_indexed_attestation(att))
        for att in attestations
    ]


def proposer_slashing_signature_sets(p: Preset, ctx: EpochContext, state, slashing) -> List[SignatureSet]:
    t = get_types(p).phase0
    out = []
    for signed_header in (slashing.signed_header_1, slashing.signed_header_2):
        header = signed_header.message
        epoch = compute_epoch_at_slot(p, header.slot)
        domain = get_domain(p, state, DOMAIN_BEACON_PROPOSER, epoch)
        out.append(
            SingleSignatureSet(
                pubkey=ctx.index2pubkey[header.proposer_index],
                signing_root=compute_signing_root(p, t.BeaconBlockHeader, header, domain),
                signature=bytes(signed_header.signature),
            )
        )
    return out


def attester_slashing_signature_sets(p: Preset, ctx: EpochContext, state, slashing) -> List[SignatureSet]:
    return [
        indexed_attestation_signature_set(p, ctx, state, indexed)
        for indexed in (slashing.attestation_1, slashing.attestation_2)
    ]


def voluntary_exit_signature_set(p: Preset, ctx: EpochContext, state, signed_exit) -> SingleSignatureSet:
    t = get_types(p).phase0
    domain = get_domain(p, state, DOMAIN_VOLUNTARY_EXIT, signed_exit.message.epoch)
    return SingleSignatureSet(
        pubkey=ctx.index2pubkey[signed_exit.message.validator_index],
        signing_root=compute_signing_root(p, t.VoluntaryExit, signed_exit.message, domain),
        signature=bytes(signed_exit.signature),
    )


def sync_aggregate_signature_set(p: Preset, ctx: EpochContext, state, sync_aggregate):
    """Sync-aggregate set (signatureSets/syncCommittee.ts analog).  Returns
    None when there are no participants and the signature is the G2
    infinity point (eth_fast_aggregate_verify's valid-empty case) — nothing
    to batch."""
    from ..crypto.bls.api import PublicKey
    from .altair import sync_aggregate_signing_root

    bits = list(sync_aggregate.sync_committee_bits)
    participant_pubkeys = [
        bytes(pk) for pk, bit in zip(state.current_sync_committee.pubkeys, bits) if bit
    ]
    sig = bytes(sync_aggregate.sync_committee_signature)
    if not participant_pubkeys:
        # the only valid empty aggregate is the G2 infinity signature; the
        # non-infinity case is rejected structurally in
        # altair.process_sync_aggregate, so there is nothing to batch here
        return None
    return AggregatedSignatureSet(
        pubkeys=[PublicKey.from_bytes(pk) for pk in participant_pubkeys],
        signing_root=sync_aggregate_signing_root(p, state),
        signature=sig,
    )


def get_block_signature_sets(
    p: Preset,
    cfg: ChainConfig,
    ctx: EpochContext,
    state,
    signed_block,
    include_proposer: bool = True,
    include_randao: bool = True,
) -> List[SignatureSet]:
    """All of a block's signature sets (getBlockSignatureSets,
    signatureSets/index.ts:23).  Deposits are excluded by design: their
    proof-of-possession check can only skip a deposit, not fail a block, so
    it stays inline in apply_deposit."""
    block = signed_block.message
    body = block.body
    sets: List[SignatureSet] = []
    if include_proposer:
        sets.append(block_proposer_signature_set(p, ctx, state, signed_block))
    if include_randao:
        sets.append(randao_signature_set(p, ctx, state, block))
    for slashing in body.proposer_slashings:
        sets.extend(proposer_slashing_signature_sets(p, ctx, state, slashing))
    for slashing in body.attester_slashings:
        sets.extend(attester_slashing_signature_sets(p, ctx, state, slashing))
    sets.extend(attestation_signature_sets(p, ctx, state, body.attestations))
    for signed_exit in body.voluntary_exits:
        sets.append(voluntary_exit_signature_set(p, ctx, state, signed_exit))
    if hasattr(body, "sync_aggregate"):
        s = sync_aggregate_signature_set(p, ctx, state, body.sync_aggregate)
        if s is not None:
            sets.append(s)
    return sets
