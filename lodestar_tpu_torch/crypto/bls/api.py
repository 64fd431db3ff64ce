"""BLS signature objects (ETH2 proof-of-possession ciphersuite), pure Python.

The port's trimmed copy of the key and signature surface: signing is the
plain bigint ladder ``sk * H(msg)`` (variable time — for test and interop
keys only), and points are serialized in the ZCash compressed format.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

from .curve import G1_GEN, Point, g1_from_bytes, g1_to_bytes, g2_from_bytes, g2_to_bytes
from .fields import Fq, Fq2, R
from .hash_to_curve import hash_to_g2


class SecretKey:
    __slots__ = ("value",)

    def __init__(self, value: int):
        if not 0 < value < R:
            raise ValueError("secret key out of range")
        self.value = value

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != 32:
            raise ValueError("secret key must be 32 bytes")
        return cls(int.from_bytes(data, "big"))

    def to_bytes(self) -> bytes:
        return self.value.to_bytes(32, "big")

    def to_public_key(self) -> "PublicKey":
        return PublicKey(G1_GEN * self.value)

    def sign(self, msg: bytes) -> "Signature":
        """sk * H(msg) by the bigint double-and-add ladder (not constant
        time: interop and test keys only)."""
        return Signature(hash_to_g2(msg) * self.value)


class PublicKey:
    """A G1 point, or its compressed bytes decompressed on first use."""

    __slots__ = ("_point", "_raw")

    def __init__(self, point: Optional[Point[Fq]] = None, raw: Optional[bytes] = None):
        if point is None and raw is None:
            raise ValueError("PublicKey needs a point or raw bytes")
        self._point = point
        self._raw = raw

    @property
    def point(self) -> Point[Fq]:
        if self._point is None:
            self._point = g1_from_bytes(self._raw, subgroup_check=False)
        return self._point

    @classmethod
    def from_bytes(cls, data: bytes, validate: bool = True) -> "PublicKey":
        pk = cls(g1_from_bytes(data, subgroup_check=validate))
        pk._raw = bytes(data)
        return pk

    def to_bytes(self) -> bytes:
        if self._raw is None:
            self._raw = g1_to_bytes(self._point)
        return self._raw

    def is_infinity(self) -> bool:
        if self._point is not None:
            return self._point.is_infinity()
        return self._raw[0] == 0xC0 and not any(self._raw[1:])

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PublicKey) and self.to_bytes() == other.to_bytes()

    def __hash__(self) -> int:
        return hash(("PublicKey", self.to_bytes()))


class Signature:
    """A G2 point, or its compressed bytes decompressed on first use."""

    __slots__ = ("_point", "_raw")

    def __init__(self, point: Optional[Point[Fq2]] = None, raw: Optional[bytes] = None):
        if point is None and raw is None:
            raise ValueError("Signature needs a point or raw bytes")
        self._point = point
        self._raw = raw

    @property
    def point(self) -> Point[Fq2]:
        if self._point is None:
            self._point = g2_from_bytes(self._raw, subgroup_check=False)
        return self._point

    @classmethod
    def from_bytes(cls, data: bytes, validate: bool = True) -> "Signature":
        sig = cls(g2_from_bytes(data, subgroup_check=validate))
        sig._raw = bytes(data)
        return sig

    def to_bytes(self) -> bytes:
        if self._raw is None:
            self._raw = g2_to_bytes(self._point)
        return self._raw

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Signature) and self.to_bytes() == other.to_bytes()

    def __hash__(self) -> int:
        return hash(("Signature", self.to_bytes()))


def aggregate_pubkeys(pubkeys: List[PublicKey]) -> PublicKey:
    """Jacobian sum of the keys (the host aggregation of an aggregated set)."""
    acc = pubkeys[0].point
    for pk in pubkeys[1:]:
        acc = acc + pk.point
    return PublicKey(acc)


def interop_secret_key(index: int) -> SecretKey:
    """sk_i = int(LE(sha256(LE64(i) padded to 32)))) mod r — the eth2
    interop key derivation."""
    digest = hashlib.sha256(index.to_bytes(32, "little")).digest()
    return SecretKey(int.from_bytes(digest, "little") % R)
