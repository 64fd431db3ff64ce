"""Bellatrix (the merge) state transition: execution payloads.

Reference: packages/state-transition/src/block/processExecutionPayload.ts,
util/execution.ts (isMergeTransitionComplete/isMergeTransitionBlock/
isExecutionEnabled), and the execution-engine seam consumed by
chain/blocks/verifyBlock.ts:195 (notifyNewPayload).

The engine here is the in-STF interface only; the HTTP Engine-API client
lives in lodestar_tpu_torch.execution (ExecutionEngineHttp analog), with mock and
disabled doubles mirroring execution/engine/{mock,disabled}.ts.
"""

from __future__ import annotations

from typing import Optional, Protocol

from ..config.chain_config import ChainConfig
from ..params import Preset
from ..ssz import Fields
from ..types import get_types
from .block import BlockProcessingError
from .misc import compute_epoch_at_slot, get_randao_mix


class ExecutionEngine(Protocol):
    """notifyNewPayload seam (execution/engine/interface.ts)."""

    def notify_new_payload(self, payload) -> bool: ...


class NoopExecutionEngine:
    """Accept-everything engine for pre-merge dev chains and tests
    (execution/engine/mock.ts:23 analog)."""

    def notify_new_payload(self, payload) -> bool:
        return True


def default_payload_header(p: Preset) -> Fields:
    return Fields(
        parent_hash=b"\x00" * 32,
        fee_recipient=b"\x00" * 20,
        state_root=b"\x00" * 32,
        receipts_root=b"\x00" * 32,
        logs_bloom=b"\x00" * p.BYTES_PER_LOGS_BLOOM,
        prev_randao=b"\x00" * 32,
        block_number=0,
        gas_limit=0,
        gas_used=0,
        timestamp=0,
        extra_data=b"",
        base_fee_per_gas=0,
        block_hash=b"\x00" * 32,
        transactions_root=b"\x00" * 32,
    )


def is_merge_transition_complete(p: Preset, state) -> bool:
    t = get_types(p).bellatrix
    default = default_payload_header(p)
    return t.ExecutionPayloadHeader.serialize(
        state.latest_execution_payload_header
    ) != t.ExecutionPayloadHeader.serialize(default)


def _is_default_payload(p: Preset, payload) -> bool:
    t = get_types(p).bellatrix
    default = Fields(
        **{k: getattr(default_payload_header(p), k) for k in (
            "parent_hash", "fee_recipient", "state_root", "receipts_root",
            "logs_bloom", "prev_randao", "block_number", "gas_limit",
            "gas_used", "timestamp", "extra_data", "base_fee_per_gas",
            "block_hash",
        )},
        transactions=[],
    )
    return t.ExecutionPayload.serialize(payload) == t.ExecutionPayload.serialize(default)


def _is_default_payload_header(p: Preset, header) -> bool:
    t = get_types(p).bellatrix
    return t.ExecutionPayloadHeader.serialize(header) == t.ExecutionPayloadHeader.serialize(
        default_payload_header(p)
    )


def is_merge_transition_block(p: Preset, state, body) -> bool:
    if is_merge_transition_complete(p, state):
        return False
    if "execution_payload_header" in body:
        # blinded body (spec blinded-beacon-block variant): judge by header
        return not _is_default_payload_header(p, body.execution_payload_header)
    return not _is_default_payload(p, body.execution_payload)


def is_execution_enabled(p: Preset, state, body) -> bool:
    return is_merge_transition_block(p, state, body) or is_merge_transition_complete(p, state)


def compute_timestamp_at_slot(p: Preset, cfg: ChainConfig, state, slot: int) -> int:
    slots_since_genesis = slot - 0  # GENESIS_SLOT
    return state.genesis_time + slots_since_genesis * cfg.SECONDS_PER_SLOT


def process_execution_payload(
    p: Preset,
    cfg: ChainConfig,
    state,
    body,
    execution_engine: Optional[ExecutionEngine] = None,
) -> None:
    """Spec process_execution_payload (block/processExecutionPayload.ts).

    Accepts either a full body (``execution_payload``) or a blinded one
    (``execution_payload_header``): the builder flow signs over the
    header alone, so the header-only transition must produce the exact
    state root the full-payload transition would (the installed header
    is identical either way).  Reference: the `blinded` type param
    threading through processExecutionPayload.ts."""
    t = get_types(p).bellatrix
    blinded = "execution_payload_header" in body
    payload = body.execution_payload_header if blinded else body.execution_payload
    if is_merge_transition_complete(p, state):
        if bytes(payload.parent_hash) != bytes(state.latest_execution_payload_header.block_hash):
            raise BlockProcessingError("execution payload parent hash mismatch")
    epoch = compute_epoch_at_slot(p, state.slot)
    if bytes(payload.prev_randao) != bytes(get_randao_mix(p, state, epoch)):
        raise BlockProcessingError("execution payload prev_randao mismatch")
    if payload.timestamp != compute_timestamp_at_slot(p, cfg, state, state.slot):
        raise BlockProcessingError("execution payload timestamp mismatch")
    if not blinded and execution_engine is not None and not execution_engine.notify_new_payload(payload):
        raise BlockProcessingError("execution payload rejected by engine")

    if blinded:
        transactions_root = bytes(payload.transactions_root)
    else:
        tx_list_type = dict(t.ExecutionPayload.fields)["transactions"]
        transactions_root = tx_list_type.hash_tree_root(payload.transactions)
    state.latest_execution_payload_header = Fields(
        parent_hash=bytes(payload.parent_hash),
        fee_recipient=bytes(payload.fee_recipient),
        state_root=bytes(payload.state_root),
        receipts_root=bytes(payload.receipts_root),
        logs_bloom=bytes(payload.logs_bloom),
        prev_randao=bytes(payload.prev_randao),
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=bytes(payload.extra_data),
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=bytes(payload.block_hash),
        transactions_root=transactions_root,
    )
