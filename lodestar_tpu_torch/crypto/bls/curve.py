"""BLS12-381 G1/G2 group operations (jacobian coordinates) and ZCash-format
point serialization.

G1: y^2 = x^3 + 4        over Fq
G2: y^2 = x^3 + 4(1+u)   over Fq2 (the sextic twist)

Jacobian coordinates mirror the reference's choice of storing deserialized
pubkeys in jacobian form for fast aggregation
(packages/state-transition/src/cache/pubkeyCache.ts:75).

Serialization is the ZCash BLS12-381 compressed format used by the consensus
spec: 48-byte G1 / 96-byte G2, flag bits in the top 3 bits of byte 0
(compression, infinity, y-sign).
"""

from __future__ import annotations

from typing import Generic, Optional, TypeVar

from .fields import BLS_X, Fq, Fq2, P

F = TypeVar("F", Fq, Fq2)

B1 = Fq(4)
B2 = Fq2(4, 4)

# psi (untwist-Frobenius-twist) endomorphism constants, computed not transcribed:
#   psi(x, y) = (conj(x) / xi^((p-1)/3), conj(y) / xi^((p-1)/2))
from .fields import XI  # noqa: E402

PSI_CX = XI.pow((P - 1) // 3).inv()
PSI_CY = XI.pow((P - 1) // 2).inv()


class Point(Generic[F]):
    """Jacobian point (X, Y, Z): affine (X/Z^2, Y/Z^3); Z=0 is infinity."""

    __slots__ = ("x", "y", "z", "b")

    def __init__(self, x: F, y: F, z: F, b: F):
        self.x, self.y, self.z, self.b = x, y, z, b

    # -- constructors -------------------------------------------------------

    @staticmethod
    def infinity(b: F) -> "Point[F]":
        return Point(b.__class__.one(), b.__class__.one(), b.__class__.zero(), b)

    @staticmethod
    def from_affine(x: F, y: F, b: F) -> "Point[F]":
        return Point(x, y, b.__class__.one(), b)

    # -- predicates ---------------------------------------------------------

    def is_infinity(self) -> bool:
        return self.z.is_zero()

    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        # Y^2 = X^3 + b Z^6
        z2 = self.z.square()
        z6 = z2.square() * z2
        return self.y.square() == self.x.square() * self.x + self.b * z6

    def to_affine(self) -> Optional[tuple]:
        if self.is_infinity():
            return None
        zinv = self.z.inv()
        zinv2 = zinv.square()
        return (self.x * zinv2, self.y * zinv2 * zinv)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Point):
            return NotImplemented
        if self.is_infinity() or other.is_infinity():
            return self.is_infinity() and other.is_infinity()
        # X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3
        z12, z2sq = self.z.square(), other.z.square()
        if self.x * z2sq != other.x * z12:
            return False
        return self.y * z2sq * other.z == other.y * z12 * self.z

    def __hash__(self) -> int:
        aff = self.to_affine()
        return hash(("Point", None)) if aff is None else hash(("Point", aff[0], aff[1]))

    # -- group law ----------------------------------------------------------

    def double(self) -> "Point[F]":
        if self.is_infinity() or self.y.is_zero():
            return Point.infinity(self.b)
        x, y, z = self.x, self.y, self.z
        a = x.square()
        bb = y.square()
        c = bb.square()
        d = ((x + bb).square() - a - c).mul_scalar(2)
        e = a.mul_scalar(3)
        f = e.square()
        x3 = f - d.mul_scalar(2)
        y3 = e * (d - x3) - c.mul_scalar(8)
        z3 = (y * z).mul_scalar(2)
        return Point(x3, y3, z3, self.b)

    def __add__(self, other: "Point[F]") -> "Point[F]":
        if self.is_infinity():
            return other
        if other.is_infinity():
            return self
        z1z1 = self.z.square()
        z2z2 = other.z.square()
        u1 = self.x * z2z2
        u2 = other.x * z1z1
        s1 = self.y * z2z2 * other.z
        s2 = other.y * z1z1 * self.z
        if u1 == u2:
            if s1 == s2:
                return self.double()
            return Point.infinity(self.b)
        h = u2 - u1
        i = h.mul_scalar(2).square()
        j = h * i
        r = (s2 - s1).mul_scalar(2)
        v = u1 * i
        x3 = r.square() - j - v.mul_scalar(2)
        y3 = r * (v - x3) - (s1 * j).mul_scalar(2)
        z3 = ((self.z + other.z).square() - z1z1 - z2z2) * h
        return Point(x3, y3, z3, self.b)

    def __neg__(self) -> "Point[F]":
        return Point(self.x, -self.y, self.z, self.b)

    def __sub__(self, other: "Point[F]") -> "Point[F]":
        return self + (-other)

    def __mul__(self, k: int) -> "Point[F]":
        if k < 0:
            return (-self) * (-k)
        result = Point.infinity(self.b)
        addend = self
        while k:
            if k & 1:
                result = result + addend
            addend = addend.double()
            k >>= 1
        return result

    __rmul__ = __mul__

    def __repr__(self) -> str:  # pragma: no cover
        aff = self.to_affine()
        return f"Point(infinity)" if aff is None else f"Point({aff[0]!r}, {aff[1]!r})"


def batch_inverse(elems: list) -> list:
    """Montgomery batch inversion: n field inverses for ONE actual
    inversion plus 3(n-1) multiplications.  Works over any field element
    type with ``*`` and ``.inv()`` (Fq and Fq2 here); all elements must be
    nonzero and of the same type.

    This is what makes the pack stage's per-set ``to_affine()`` affordable
    at batch size: the bigint ``pow(a, p-2, p)`` is ~100x a multiplication,
    so amortizing it across the batch collapses the Amdahl serial stage
    (the analog of blst's blst_fp_inverse batching in Lodestar's pack
    path)."""
    if not elems:
        return []
    prefix = [elems[0]]
    for e in elems[1:]:
        prefix.append(prefix[-1] * e)
    acc = prefix[-1].inv()
    out: list = [None] * len(elems)
    for i in range(len(elems) - 1, 0, -1):
        out[i] = acc * prefix[i - 1]
        acc = acc * elems[i]
    out[0] = acc
    return out


def to_affine_batch(points: list) -> list:
    """Affine (x, y) for many jacobian points with one field inversion via
    ``batch_inverse`` over the Z coordinates.  Infinity points map to None
    (callers reject them before packing).  All points must share a field
    type — G1 and G2 batches are inverted separately."""
    live = [(i, p) for i, p in enumerate(points) if not p.is_infinity()]
    zinvs = batch_inverse([p.z for _, p in live])
    out: list = [None] * len(points)
    for (i, p), zi in zip(live, zinvs):
        zi2 = zi.square()
        out[i] = (p.x * zi2, p.y * zi2 * zi)
    return out


# -- generators (standard BLS12-381 generator points) -----------------------

G1_GEN = Point.from_affine(
    Fq(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
    Fq(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
    B1,
)

G2_GEN = Point.from_affine(
    Fq2(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    Fq2(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
    B2,
)


# -- endomorphisms & subgroup checks ---------------------------------------


def psi(pt: Point[Fq2]) -> Point[Fq2]:
    """Untwist-Frobenius-twist endomorphism on E2. On G2, psi(P) = [z]P
    (the Frobenius eigenvalue p is congruent to the BLS parameter z mod r)."""
    if pt.is_infinity():
        return pt
    x, y = pt.to_affine()
    return Point.from_affine(x.conjugate() * PSI_CX, y.conjugate() * PSI_CY, B2)


def g2_subgroup_check(pt: Point[Fq2]) -> bool:
    """P in G2 iff psi(P) == [z]P (z = BLS_X < 0)."""
    if pt.is_infinity():
        return True
    if not pt.is_on_curve():
        return False
    return psi(pt) == pt * BLS_X


def g2_clear_cofactor(pt: Point[Fq2]) -> Point[Fq2]:
    """Fast cofactor clearing (Budroni-Pintore):
    h_eff * P = [z^2 - z - 1]P + [z - 1]psi(P) + psi^2([2]P)."""
    z = BLS_X
    t1 = pt * (z * z - z - 1)
    t2 = psi(pt) * (z - 1)
    t3 = psi(psi(pt.double()))
    return t1 + t2 + t3


# G1 endomorphism: sigma(x, y) = (beta*x, y) with beta a primitive cube root
# of unity; on G1, sigma(P) = [z^2 - 1]P (lambda^2 + lambda + 1 = 0 mod r).
def _find_beta() -> int:
    # beta = c^((p-1)/3) for any c with a nontrivial cube character.
    c = 2
    while True:
        beta = pow(c, (P - 1) // 3, P)
        if beta != 1:
            # pick the root matching eigenvalue z^2 - 1 on the generator
            cand = Point.from_affine(G1_GEN.x * Fq(beta), G1_GEN.y, B1)
            if cand == G1_GEN * (BLS_X * BLS_X - 1):
                return beta
            beta2 = beta * beta % P
            cand = Point.from_affine(G1_GEN.x * Fq(beta2), G1_GEN.y, B1)
            if cand == G1_GEN * (BLS_X * BLS_X - 1):
                return beta2
            raise AssertionError("no cube root of unity matches the G1 eigenvalue")
        c += 1


BETA = _find_beta()


def g1_subgroup_check(pt: Point[Fq]) -> bool:
    """P in G1 iff sigma(P) == [z^2 - 1]P."""
    if pt.is_infinity():
        return True
    if not pt.is_on_curve():
        return False
    x, y = pt.to_affine()
    sigma = Point.from_affine(x * Fq(BETA), y, B1)
    return sigma == pt * (BLS_X * BLS_X - 1)


# -- serialization (ZCash compressed format) --------------------------------

_COMPRESSED_FLAG = 0x80
_INFINITY_FLAG = 0x40
_SIGN_FLAG = 0x20


def g1_to_bytes(pt: Point[Fq]) -> bytes:
    if pt.is_infinity():
        return bytes([_COMPRESSED_FLAG | _INFINITY_FLAG]) + b"\x00" * 47
    x, y = pt.to_affine()
    flags = _COMPRESSED_FLAG | (_SIGN_FLAG if y.n > (P - 1) // 2 else 0)
    out = bytearray(x.n.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g1_from_bytes(data: bytes, subgroup_check: bool = True) -> Point[Fq]:
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & _COMPRESSED_FLAG:
        raise ValueError("uncompressed G1 input not supported")
    if flags & _INFINITY_FLAG:
        if any(data[1:]) or flags & ~(_COMPRESSED_FLAG | _INFINITY_FLAG) or data[0] != 0xC0:
            raise ValueError("malformed G1 infinity encoding")
        return Point.infinity(B1)
    xn = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if xn >= P:
        raise ValueError("G1 x coordinate out of range")
    x = Fq(xn)
    y2 = x.square() * x + B1
    y = y2.sqrt()
    if y is None:
        raise ValueError("G1 x not on curve")
    if (y.n > (P - 1) // 2) != bool(flags & _SIGN_FLAG):
        y = -y
    pt = Point.from_affine(x, y, B1)
    if subgroup_check and not g1_subgroup_check(pt):
        raise ValueError("G1 point not in subgroup")
    return pt


def g2_to_bytes(pt: Point[Fq2]) -> bytes:
    if pt.is_infinity():
        return bytes([_COMPRESSED_FLAG | _INFINITY_FLAG]) + b"\x00" * 95
    x, y = pt.to_affine()
    # sign: lexicographic on (c1, c0)
    greater = y.c1 > (P - 1) // 2 or (y.c1 == 0 and y.c0 > (P - 1) // 2)
    flags = _COMPRESSED_FLAG | (_SIGN_FLAG if greater else 0)
    out = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_from_bytes(data: bytes, subgroup_check: bool = True) -> Point[Fq2]:
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & _COMPRESSED_FLAG:
        raise ValueError("uncompressed G2 input not supported")
    if flags & _INFINITY_FLAG:
        if any(data[1:]) or data[0] != 0xC0:
            raise ValueError("malformed G2 infinity encoding")
        return Point.infinity(B2)
    c1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    c0 = int.from_bytes(data[48:], "big")
    if c0 >= P or c1 >= P:
        raise ValueError("G2 x coordinate out of range")
    x = Fq2(c0, c1)
    y2 = x.square() * x + B2
    y = y2.sqrt()
    if y is None:
        raise ValueError("G2 x not on curve")
    greater = y.c1 > (P - 1) // 2 or (y.c1 == 0 and y.c0 > (P - 1) // 2)
    if greater != bool(flags & _SIGN_FLAG):
        y = -y
    pt = Point.from_affine(x, y, B2)
    if subgroup_check and not g2_subgroup_check(pt):
        raise ValueError("G2 point not in subgroup")
    return pt
