"""BLS signature API (ETH2 proof-of-possession ciphersuite): the port's
copy of ``lodestar_tpu/crypto/bls/api.py``'s surface.

Keys, signing and aggregation run in the port's native C library
(``native/fastbls``: ``sk_to_pk``, ``sign`` / ``sign_ct``,
``sign_aggregate``, ``aggregate_sigs``, ``aggregate_pks``) and give the
bytes of the bigint ladder; the library is built and self-tested at first
use, and a failed build raises (the JAX package falls back to the bigint
ladder instead).  Signing is constant time by default (``fb_sign_ct``);
``variable_time=True`` takes the sliding ladder, for interop and test keys.
Points are serialized in the ZCash compressed format, and ``verify``,
``fast_aggregate_verify``, ``aggregate_verify`` and
``verify_multiple_signatures`` check with the bigint pairing
(``pairing.py``), the host verifier behind ``verifier.PyBlsVerifier``.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import List, Optional, Sequence, Tuple

from ...native import fastbls as _native
from .curve import B1, B2, G1_GEN, Point, g1_from_bytes, g1_to_bytes, g2_from_bytes, g2_to_bytes
from .fields import Fq, Fq2, R
from .hash_to_curve import hash_to_g2
from .pairing import multi_pairing


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
        """sk * g1, as its compressed bytes (``fb_sk_to_pk``), decompressed
        on first curve use."""
        return PublicKey(raw=_native.sk_to_pk(self.to_bytes()))

    def sign(self, msg: bytes, variable_time: bool = False) -> "Signature":
        """sk * H(msg), the bytes of the bigint ladder.  Constant time by
        default (``fb_sign_ct``: a fixed-length double-and-always-add
        ladder); ``variable_time=True`` takes the sliding ladder
        (``fb_sign``), whose branches follow the key's bits, for interop
        and test keys only."""
        sk = self.to_bytes()
        raw = _native.sign(sk, msg) if variable_time else _native.sign_ct(sk, msg)
        return Signature(raw=raw)


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


def sign_aggregate(sks: Sequence[SecretKey], msg: bytes) -> Signature:
    """The aggregate signature of one message by many keys: one hash and
    one scalar multiplication by the keys' sum (``fb_sign_aggregate``,
    variable time: the whole-committee signing of dev chains and fixtures,
    interop keys only).  Where the library refuses the keys (their sum is 0
    mod r), each key signs and the signatures are aggregated, as in the JAX
    package."""
    raw = _native.sign_aggregate([sk.to_bytes() for sk in sks], msg)
    if raw is not None:
        return Signature(raw=raw)
    return aggregate_signatures([sk.sign(msg, variable_time=True) for sk in sks])


def aggregate_pubkeys(pubkeys: Sequence[PublicKey]) -> PublicKey:
    """The keys' sum: in C (``fb_aggregate_pubkeys_c``) when every key is
    still only its compressed bytes, else in jacobian coordinates (also
    where the library rejects a key's bytes, so that decompressing it
    raises as in the JAX package)."""
    if pubkeys and all(pk._raw is not None and pk._point is None for pk in pubkeys):
        out = _native.aggregate_pks([pk._raw for pk in pubkeys])
        if out is not None:
            return PublicKey(raw=out)
    acc: Point[Fq] = Point.infinity(B1)
    for pk in pubkeys:
        acc = acc + pk.point
    return PublicKey(acc)


def aggregate_signatures(sigs: Sequence[Signature]) -> Signature:
    """The signatures' sum: in C (``fb_aggregate_sigs``) when every one is
    still only its compressed bytes, else in jacobian coordinates."""
    if sigs and all(s._raw is not None and s._point is None for s in sigs):
        out = _native.aggregate_sigs([s._raw for s in sigs])
        if out is not None:
            return Signature(raw=out)
    acc: Point[Fq2] = Point.infinity(B2)
    for s in sigs:
        acc = acc + s.point
    return Signature(acc)


def verify(pk: PublicKey, msg: bytes, sig: Signature) -> bool:
    """Core verify (PoP scheme): e(g1, sig) == e(pk, H(msg))."""
    if pk.point.is_infinity() or sig.point.is_infinity():
        return False
    return multi_pairing([(-G1_GEN, sig.point), (pk.point, hash_to_g2(msg))]).is_one()


def fast_aggregate_verify(pks: Sequence[PublicKey], msg: bytes, sig: Signature) -> bool:
    """One message, many signers (sync committees, aggregate attestations)."""
    if not pks:
        return False
    return verify(aggregate_pubkeys(pks), msg, sig)


def aggregate_verify(pks: Sequence[PublicKey], msgs: Sequence[bytes], sig: Signature) -> bool:
    """Distinct messages, one aggregate signature."""
    if not pks or len(pks) != len(msgs):
        return False
    if any(pk.point.is_infinity() for pk in pks) or sig.point.is_infinity():
        return False
    pairs: List[Tuple[Point[Fq], Point[Fq2]]] = [(-G1_GEN, sig.point)]
    pairs += [(pk.point, hash_to_g2(m)) for pk, m in zip(pks, msgs)]
    return multi_pairing(pairs).is_one()


def verify_multiple_signatures(
    sets: Sequence[Tuple[PublicKey, bytes, Signature]],
    rand_bits: int = 64,
) -> bool:
    """Batch verify with a random linear combination: fresh odd
    ``rand_bits``-bit coefficients c_i, then one multi-pairing
    e(-g1, sum_i c_i sig_i) * prod_i e(c_i pk_i, H(msg_i)) == 1."""
    if not sets:
        return False
    if any(pk.point.is_infinity() or s.point.is_infinity() for pk, _, s in sets):
        return False
    coeffs = [secrets.randbits(rand_bits) | 1 for _ in sets]
    sig_acc: Point[Fq2] = Point.infinity(B2)
    pairs: List[Tuple[Point[Fq], Point[Fq2]]] = []
    for (pk, msg, sig), c in zip(sets, coeffs):
        sig_acc = sig_acc + sig.point * c
        pairs.append((pk.point * c, hash_to_g2(msg)))
    pairs.append((-G1_GEN, sig_acc))
    return multi_pairing(pairs).is_one()


def interop_secret_key(index: int) -> SecretKey:
    """sk_i = int(LE(sha256(LE64(i) padded to 32)))) mod r — the eth2
    interop key derivation."""
    digest = hashlib.sha256(index.to_bytes(32, "little")).digest()
    return SecretKey(int.from_bytes(digest, "little") % R)


def interop_pubkeys(count: int) -> List[bytes]:
    """The compressed public keys of the first ``count`` interop keys."""
    return [interop_secret_key(i).to_public_key().to_bytes() for i in range(count)]
