"""Signature-set types behind the verifier boundary (trimmed copy).

``SingleSignatureSet`` / ``AggregatedSignatureSet`` are what a caller
hands ``TorchBlsVerifier.verify_signature_sets``; ``PointCache`` keeps
pack-ready affine coordinates of keys and signatures seen before.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import List, Optional, Tuple, Union

from .api import PublicKey, aggregate_pubkeys


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
