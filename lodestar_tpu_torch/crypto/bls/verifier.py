"""Signature-set types behind the verifier boundary (trimmed copy).

``SingleSignatureSet`` / ``AggregatedSignatureSet`` are what a caller
hands ``TorchBlsVerifier.verify_signature_sets``; ``PointCache`` keeps
pack-ready affine coordinates of keys and signatures seen before.  The
scheduling layer (``chain/bls_pool``) adds the QoS lanes
(``SignatureSetPriority``), the typed drop (``VerificationDroppedError``),
the ``IBlsVerifier`` boundary and ``PyBlsVerifier``, the host verifier on
the bigint oracle.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import threading
from typing import List, Optional, Protocol, Sequence, Tuple, Union

from ...utils.errors import LodestarError
from .api import PublicKey, Signature, aggregate_pubkeys, verify, verify_multiple_signatures

# Matches MIN_SET_COUNT_TO_BATCH (maybeBatch.ts:4)
MIN_SET_COUNT_TO_BATCH = 2


class SignatureSetPriority(enum.IntEnum):
    """QoS lane of a verification job (lower value = drained first): under
    overload a block proposal never waits behind stale unaggregated
    attestations, and what has to be dropped is the lowest lane first."""

    BLOCK_PROPOSAL = 0
    AGGREGATE = 1
    UNAGGREGATED = 2
    SYNC_COMMITTEE = 3


#: lane for callers that do not tag their jobs (all share one lane)
DEFAULT_PRIORITY = SignatureSetPriority.UNAGGREGATED


class VerificationDroppedError(LodestarError):
    """A verification job was shed by the overload policy (deadline
    expiry, queue overflow eviction, or pool shutdown) and was therefore
    never verified.  Distinct from a ``False`` verdict on purpose: False
    means "cryptographically invalid"; a dropped job is the node's own
    admission decision."""

    def __init__(self, reason: str, lane: Optional["SignatureSetPriority"] = None):
        lane_name = lane.name if lane is not None else None
        super().__init__(
            {"code": "VERIFICATION_DROPPED", "reason": reason, "lane": lane_name},
            f"verification dropped ({reason}"
            + (f", lane {lane_name})" if lane_name else ")"),
        )
        self.reason = reason
        self.lane = lane


@dataclasses.dataclass
class SingleSignatureSet:
    pubkey: PublicKey
    signing_root: bytes
    signature: bytes  # serialized; deserialized lazily so malformed sigs just fail


@dataclasses.dataclass
class AggregatedSignatureSet:
    pubkeys: List[PublicKey]
    signing_root: bytes
    signature: bytes


SignatureSet = Union[SingleSignatureSet, AggregatedSignatureSet]


def get_aggregated_pubkey(s: SignatureSet) -> PublicKey:
    """The set's public key: the single key, or the jacobian sum of an
    aggregate's keys (memoized on the set object)."""
    if isinstance(s, SingleSignatureSet):
        return s.pubkey
    cached = s.__dict__.get("_agg_pubkey")
    if cached is None:
        cached = aggregate_pubkeys(s.pubkeys)
        s.__dict__["_agg_pubkey"] = cached
    return cached


class PointCache:
    """Thread-safe LRU of pack-ready affine coordinates keyed by compressed
    point bytes, holding at most ``maxsize`` entries.  Values are int
    tuples."""

    __slots__ = ("maxsize", "hits", "misses", "_lock", "_data")

    def __init__(self, maxsize: int = 8192):
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        self._data: "collections.OrderedDict[bytes, Tuple[int, ...]]" = (
            collections.OrderedDict()
        )

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: bytes) -> Optional[Tuple[int, ...]]:
        with self._lock:
            val = self._data.get(key)
            if val is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key: bytes, value: Tuple[int, ...]) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


class IBlsVerifier(Protocol):
    def verify_signature_sets(self, sets: Sequence[SignatureSet]) -> bool: ...

    def close(self) -> None: ...


def _deserialize(s: SignatureSet) -> tuple:
    sig = Signature.from_bytes(s.signature, validate=True)
    return (get_aggregated_pubkey(s), s.signing_root, sig)


class PyBlsVerifier:
    """Single-threaded host verifier on the bigint oracle (reference:
    BlsSingleThreadVerifier, chain/bls/singleThread.ts:7) with maybe-batch
    semantics."""

    def __init__(self) -> None:
        self.batch_retries = 0
        self.batch_sigs_success = 0
        self.malformed_rejects = 0

    def verify_signature_sets(self, sets: Sequence[SignatureSet]) -> bool:
        if not sets:
            raise ValueError("verify_signature_sets: empty batch of signature sets")
        try:
            triples = [_deserialize(s) for s in sets]
        except ValueError:
            # malformed bytes read as an invalid-signature verdict
            self.malformed_rejects += 1
            return False
        if len(triples) >= MIN_SET_COUNT_TO_BATCH:
            if verify_multiple_signatures(triples):
                self.batch_sigs_success += len(triples)
                return True
            # RLC batching has no false negatives: a failed batch holds at
            # least one invalid set, so the verdict is False
            self.batch_retries += 1
            return False
        return all(verify(pk, root, sig) for pk, root, sig in triples)

    def close(self) -> None:
        return None
