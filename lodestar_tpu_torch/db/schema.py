"""Bucket schema: one byte-prefix per repository keyspace.

Reference: packages/db/src/schema.ts (Bucket enum + encodeKey).
"""

from __future__ import annotations

import enum


class Bucket(enum.IntEnum):
    # hot chain data
    block = 0
    state = 1
    # finalized archives (blockArchive.ts / stateArchive.ts)
    block_archive = 2
    block_archive_parent_root_index = 3
    block_archive_root_index = 4
    state_archive = 5
    state_archive_root_index = 6
    # eth1 / deposits
    eth1_data = 7
    deposit_event = 8
    deposit_data_root = 9
    # op pool persistence (opPools persisted on close, chain.ts:272-280)
    attester_slashing = 10
    proposer_slashing = 11
    voluntary_exit = 12
    # light client server
    lightclient_sync_committee_witness = 13
    lightclient_best_partial_update = 14
    lightclient_checkpoint_header = 15
    lightclient_genesis_witness = 16
    # sync
    backfilled_ranges = 17
    # validator client / slashing protection
    validator_slashing_protection_block = 32
    validator_slashing_protection_attestation = 33
    validator_slashing_protection_meta = 34
    # keymanager
    keypairs = 48


def encode_key(bucket: Bucket, key: bytes) -> bytes:
    return bytes([int(bucket)]) + key


def uint_key(n: int) -> bytes:
    """Big-endian fixed 8 bytes so lexicographic order == numeric order."""
    return n.to_bytes(8, "big")


def decode_uint_key(b: bytes) -> int:
    return int.from_bytes(b, "big")
