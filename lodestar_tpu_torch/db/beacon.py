"""BeaconDb: the node's repository set.

Reference: packages/beacon-node/src/db/beacon.ts:25 and db/repositories/
(block, blockArchive + indices, stateArchive, eth1, deposits, op pool
persistence, lightclient, backfilledRanges — SURVEY §1 L2).

Keying follows the reference: hot blocks/states by root; archives by slot
(big-endian uint64 so iteration order is slot order) with root->slot index
entries.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional, Tuple

from ..params import Preset
from ..types import get_types
from .controller import IDatabaseController, MemoryDbController
from .repository import Repository
from .schema import Bucket, decode_uint_key, encode_key, uint_key


_FORK_ORDER = ("phase0", "altair", "bellatrix")


def _fork_tagged_block_codec(preset: Preset):
    """Fork-aware SignedBeaconBlock codec: a 1-byte fork tag prefixes the
    SSZ bytes so each fork's container shape round-trips (the reference
    keys its serializers off the fork digest in the same spirit;
    db/repositories/block.ts getSignedBlockTypeFromBytes)."""
    from ..state_transition.upgrade import block_fork_name

    all_t = get_types(preset)

    def enc(signed_block) -> bytes:
        fork = block_fork_name(signed_block.message).value
        t = getattr(all_t, fork)
        return bytes([_FORK_ORDER.index(fork)]) + t.SignedBeaconBlock.serialize(signed_block)

    def dec(b: bytes):
        t = getattr(all_t, _FORK_ORDER[b[0]])
        return t.SignedBeaconBlock.deserialize(b[1:])

    return enc, dec


def _fork_tagged_state_codec(preset: Preset):
    from ..state_transition.upgrade import state_fork_name

    all_t = get_types(preset)

    def enc(state) -> bytes:
        fork = state_fork_name(state).value
        t = getattr(all_t, fork)
        return bytes([_FORK_ORDER.index(fork)]) + t.BeaconState.serialize(state)

    def dec(b: bytes):
        t = getattr(all_t, _FORK_ORDER[b[0]])
        return t.BeaconState.deserialize(b[1:])

    return enc, dec


class BeaconDb:
    def __init__(self, preset: Preset, db: Optional[IDatabaseController] = None):
        self.db = db or MemoryDbController()
        t = get_types(preset).phase0
        self.t = t
        ser = lambda typ: (typ.serialize, typ.deserialize)  # noqa: E731

        enc_b, dec_b = _fork_tagged_block_codec(preset)
        self.block: Repository = Repository(self.db, Bucket.block, enc_b, dec_b)
        self.block_archive: Repository = Repository(self.db, Bucket.block_archive, enc_b, dec_b)
        enc_s, dec_s = _fork_tagged_state_codec(preset)
        self.state: Repository = Repository(self.db, Bucket.state, enc_s, dec_s)
        self.state_archive: Repository = Repository(self.db, Bucket.state_archive, enc_s, dec_s)
        enc_e, dec_e = ser(t.Eth1Data)
        self.eth1_data: Repository = Repository(self.db, Bucket.eth1_data, enc_e, dec_e)
        enc_d, dec_d = ser(t.DepositData)
        self.deposit_event: Repository = Repository(self.db, Bucket.deposit_event, enc_d, dec_d)
        self.deposit_data_root: Repository = Repository(
            self.db, Bucket.deposit_data_root, bytes, bytes
        )
        enc_as, dec_as = ser(t.AttesterSlashing)
        self.attester_slashing: Repository = Repository(self.db, Bucket.attester_slashing, enc_as, dec_as)
        enc_ps, dec_ps = ser(t.ProposerSlashing)
        self.proposer_slashing: Repository = Repository(self.db, Bucket.proposer_slashing, enc_ps, dec_ps)
        enc_ve, dec_ve = ser(t.SignedVoluntaryExit)
        self.voluntary_exit: Repository = Repository(self.db, Bucket.voluntary_exit, enc_ve, dec_ve)
        self.backfilled_ranges: Repository = Repository(
            self.db,
            Bucket.backfilled_ranges,
            lambda v: json.dumps(v).encode(),
            lambda b: json.loads(b.decode()),
        )

    # -- archive helpers (blockArchive.ts slot keying + root index) ----------

    def archive_block(self, signed_block, block_root: bytes) -> None:
        slot = signed_block.message.slot
        self.block_archive.put(uint_key(slot), signed_block)
        self.db.put(encode_key(Bucket.block_archive_root_index, block_root), uint_key(slot))
        self.db.put(
            encode_key(Bucket.block_archive_parent_root_index, bytes(signed_block.message.parent_root)),
            uint_key(slot),
        )

    def get_archived_block_by_root(self, block_root: bytes):
        slot_key = self.db.get(encode_key(Bucket.block_archive_root_index, block_root))
        if slot_key is None:
            return None
        return self.block_archive.get(slot_key)

    def archived_blocks_by_slot_range(self, start_slot: int, end_slot: int) -> Iterator:
        prefix = encode_key(Bucket.block_archive, uint_key(start_slot))
        end = encode_key(Bucket.block_archive, uint_key(end_slot))
        for _k, v in self.db.entries(gte=prefix, lt=end):
            yield self.block_archive.decode_value(v)

    def archive_state(self, state, slot: Optional[int] = None) -> None:
        self.state_archive.put(uint_key(slot if slot is not None else state.slot), state)

    def last_archived_state(self):
        return self.state_archive.last_value()

    def last_archived_slot(self) -> Optional[int]:
        for k in self.state_archive.keys(reverse=True, limit=1):
            return decode_uint_key(k)
        return None

    def close(self) -> None:
        self.db.close()
