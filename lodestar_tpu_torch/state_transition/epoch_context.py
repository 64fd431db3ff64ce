"""EpochContext: the per-epoch derived caches the node hangs off a state.

Reference: packages/state-transition/src/cache/epochContext.ts:78 (pubkey
caches, shufflings, proposers, effectiveBalanceIncrements) and
util/epochShuffling.ts:68.

Columnar layout: shufflings and effective balances are flat numpy
arrays (columnar), committees are contiguous slices of one shuffled index
array — the layout a device kernel consumes directly, and the same one the
reference already chose for its hot loops (Uint32Array-backed).  Pubkeys
are cached deserialized in jacobian form for fast aggregation (mirrors
pubkeyCache.ts:75).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..params import DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, Preset
from ..crypto.bls.api import PublicKey
from .misc import (
    compute_epoch_at_slot,
    compute_proposer_index,
    get_active_validator_indices,
    get_committee_count_per_slot,
    get_seed,
)
from .shuffle import unshuffle_list


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


@dataclasses.dataclass
class EpochShuffling:
    """One epoch's committee assignment (util/epochShuffling.ts:68)."""

    epoch: int
    active_indices: np.ndarray  # (A,) int64 — active validator indices
    shuffling: np.ndarray  # (A,) int64 — unshuffle-gathered order
    committees_per_slot: int
    slots_per_epoch: int

    def committee(self, slot: int, index: int) -> np.ndarray:
        """Members of committee `index` at `slot` — a contiguous slice."""
        slot_in_epoch = slot % self.slots_per_epoch
        committees_in_epoch = self.committees_per_slot * self.slots_per_epoch
        k = slot_in_epoch * self.committees_per_slot + index
        a = len(self.active_indices)
        start = (a * k) // committees_in_epoch
        end = (a * (k + 1)) // committees_in_epoch
        return self.shuffling[start:end]


def compute_epoch_shuffling(p: Preset, state, epoch: int) -> EpochShuffling:
    active = np.array(get_active_validator_indices(state, epoch), dtype=np.int64)
    seed = get_seed(p, state, epoch, DOMAIN_BEACON_ATTESTER)
    shuffled = unshuffle_list(active, seed, p.SHUFFLE_ROUND_COUNT)
    return EpochShuffling(
        epoch=epoch,
        active_indices=active,
        shuffling=shuffled,
        committees_per_slot=get_committee_count_per_slot(p, len(active)),
        slots_per_epoch=p.SLOTS_PER_EPOCH,
    )


class Index2PubkeyCache:
    """index -> deserialized PublicKey, lazily (pubkeyCache.ts
    Index2PubkeyCache keeps jacobian-deserialized keys; here the
    deserialization itself is deferred until a signature set needs the
    key, then memoized).  Append raw 48-byte pubkeys; read PublicKey."""

    def __init__(self):
        self._raw: List[bytes] = []
        self._cache: dict = {}

    def append(self, pk) -> None:
        # accepts raw bytes or an already-deserialized PublicKey
        if isinstance(pk, (bytes, bytearray)):
            self._raw.append(bytes(pk))
        else:
            self._cache[len(self._raw)] = pk
            self._raw.append(pk.to_bytes())

    def __len__(self) -> int:
        return len(self._raw)

    def __getitem__(self, i: int) -> PublicKey:
        pk = self._cache.get(i)
        if pk is None:
            pk = PublicKey.from_bytes(self._raw[i], validate=True)
            self._cache[i] = pk
        return pk


class PubkeyIndexMap:
    """Globally shared pubkey registry (pubkeyCache.ts:29): serialized
    pubkey bytes -> validator index."""

    def __init__(self):
        self._map: Dict[bytes, int] = {}

    def get(self, pubkey: bytes) -> Optional[int]:
        return self._map.get(bytes(pubkey))

    def set(self, pubkey: bytes, index: int) -> None:
        self._map[bytes(pubkey)] = index

    def __len__(self):
        return len(self._map)


class EpochContext:
    """Derived caches for one (state, epoch) pair.

    v1 builds caches from scratch per epoch (the reference mutates/rotates
    incrementally in afterProcessEpoch — planned optimization; the API
    matches so callers won't change).
    """

    def __init__(
        self,
        preset: Preset,
        pubkey2index: PubkeyIndexMap,
        index2pubkey: List[PublicKey],
        previous_shuffling: EpochShuffling,
        current_shuffling: EpochShuffling,
        next_shuffling: EpochShuffling,
        proposers: List[int],
        effective_balance_increments: np.ndarray,
    ):
        self.preset = preset
        self.pubkey2index = pubkey2index
        self.index2pubkey = index2pubkey
        self.previous_shuffling = previous_shuffling
        self.current_shuffling = current_shuffling
        self.next_shuffling = next_shuffling
        self.proposers = proposers
        self.effective_balance_increments = effective_balance_increments

    # -- construction --------------------------------------------------------

    @classmethod
    def create_from_state(
        cls,
        preset: Preset,
        state,
        pubkey2index: Optional[PubkeyIndexMap] = None,
        index2pubkey: Optional[List[PublicKey]] = None,
        prev_ctx: Optional["EpochContext"] = None,
    ) -> "EpochContext":
        """``prev_ctx``: the context of the immediately-preceding epoch.
        When given, the previous/current shufflings ROTATE out of it
        (epochContext.ts afterProcessEpoch) and only the next-epoch
        shuffling is computed fresh — sound because activations/exits
        scheduled at an epoch boundary take effect >= 1 + MAX_SEED_LOOKAHEAD
        epochs later and the seed mixes they read are already final.  At
        mainnet registry sizes this cuts two of the three O(n·90-round)
        shuffles per boundary."""
        p = preset
        if pubkey2index is None:
            pubkey2index = PubkeyIndexMap()
        if index2pubkey is None:
            index2pubkey = Index2PubkeyCache()
        cls._sync_pubkeys(state, pubkey2index, index2pubkey)

        current_epoch = compute_epoch_at_slot(p, state.slot)
        prev_epoch = max(0, current_epoch - 1)
        if (
            prev_ctx is not None
            and prev_ctx.current_shuffling.epoch == prev_epoch
            and prev_ctx.next_shuffling.epoch == current_epoch
        ):
            prev_shuf = prev_ctx.current_shuffling
            cur_shuf = prev_ctx.next_shuffling
        else:
            cur_shuf = compute_epoch_shuffling(p, state, current_epoch)
            prev_shuf = (
                cur_shuf
                if prev_epoch == current_epoch
                else compute_epoch_shuffling(p, state, prev_epoch)
            )
        next_shuf = compute_epoch_shuffling(p, state, current_epoch + 1)

        proposers = cls._compute_proposers(p, state, current_epoch, cur_shuf.active_indices)

        ebi = np.array(
            [v.effective_balance // p.EFFECTIVE_BALANCE_INCREMENT for v in state.validators],
            dtype=np.uint16,
        )
        return cls(p, pubkey2index, index2pubkey, prev_shuf, cur_shuf, next_shuf, proposers, ebi)

    @staticmethod
    def _sync_pubkeys(state, pubkey2index: PubkeyIndexMap, index2pubkey) -> None:
        """Index new validators (epochContext.ts syncPubkeys).  Pubkey
        deserialization is LAZY (Index2PubkeyCache): a mainnet-scale
        registry (250k-500k keys) would otherwise pay one bigint sqrt +
        subgroup check per key up front — minutes to hours of startup —
        while the node only ever touches the keys that actually sign."""
        for i in range(len(index2pubkey), len(state.validators)):
            pk_bytes = bytes(state.validators[i].pubkey)
            pubkey2index.set(pk_bytes, i)
            index2pubkey.append(pk_bytes)

    @staticmethod
    def _compute_proposers(p: Preset, state, epoch: int, active_indices: Sequence[int]) -> List[int]:
        base_seed = get_seed(p, state, epoch, DOMAIN_BEACON_PROPOSER)
        out = []
        start = epoch * p.SLOTS_PER_EPOCH
        for slot in range(start, start + p.SLOTS_PER_EPOCH):
            seed = _sha(base_seed + slot.to_bytes(8, "little"))
            out.append(compute_proposer_index(p, state, list(active_indices), seed))
        return out

    # -- queries (epochContext.ts public surface) ----------------------------

    def epoch(self) -> int:
        return self.current_shuffling.epoch

    def _shuffling_for_epoch(self, epoch: int) -> EpochShuffling:
        for shuf in (self.previous_shuffling, self.current_shuffling, self.next_shuffling):
            if shuf.epoch == epoch:
                return shuf
        raise ValueError(f"no shuffling cached for epoch {epoch} (have {self.epoch()})")

    def get_committee_count_per_slot(self, epoch: int) -> int:
        return self._shuffling_for_epoch(epoch).committees_per_slot

    def get_beacon_committee(self, slot: int, index: int) -> np.ndarray:
        epoch = compute_epoch_at_slot(self.preset, slot)
        shuf = self._shuffling_for_epoch(epoch)
        if index >= shuf.committees_per_slot:
            raise ValueError("committee index out of range")
        return shuf.committee(slot, index)

    def get_beacon_proposer(self, slot: int) -> int:
        epoch = compute_epoch_at_slot(self.preset, slot)
        if epoch != self.epoch():
            raise ValueError("proposer cache only covers the current epoch")
        return self.proposers[slot % self.preset.SLOTS_PER_EPOCH]

    def get_attesting_indices(self, attestation_data, aggregation_bits: Sequence[bool]) -> List[int]:
        committee = self.get_beacon_committee(attestation_data.slot, attestation_data.index)
        if len(aggregation_bits) != len(committee):
            raise ValueError("aggregation bits length != committee size")
        return [int(v) for v, b in zip(committee, aggregation_bits) if b]

    def get_indexed_attestation(self, attestation):
        from ..ssz import Fields

        indices = self.get_attesting_indices(attestation.data, attestation.aggregation_bits)
        return Fields(
            attesting_indices=sorted(indices),
            data=attestation.data,
            signature=attestation.signature,
        )
