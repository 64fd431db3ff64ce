"""BLS12-381 field towers over Python bigints — the ground-truth implementation.

The port's own copy of the oracle: the constant tables of
``lodestar_tpu_torch.ops`` (fold rows, Barrett constants, Frobenius and
isogeny coefficients) are computed from it, and the host packing stage
uses it to decompress points.

Tower construction (standard for BLS12-381):
    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = 1 + u
    Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

# Field modulus and curve parameters
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter z (negative): p = ((z-1)^2/3) * r + z,  r = z^4 - z^2 + 1
BLS_X = -0xD201000000010000

assert (BLS_X**4 - BLS_X**2 + 1) == R
assert ((BLS_X - 1) ** 2 // 3) * R + BLS_X == P

# G1 cofactor h1 = (z-1)^2 / 3
H1 = (BLS_X - 1) ** 2 // 3


def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (p % 4 == 3, so a^((p+1)/4))."""
    root = pow(a, (P + 1) // 4, P)
    return root if root * root % P == a % P else None


class Fq2:
    """a = c0 + c1*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Fq2) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self) -> int:
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # (a0 + a1 u)(b0 + b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    def mul_scalar(self, k: int) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fq2":
        a0, a1 = self.c0, self.c1
        return Fq2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inv(self) -> "Fq2":
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        ninv = fq_inv(norm)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def pow(self, e: int) -> "Fq2":
        if e < 0:
            return self.inv().pow(-e)
        result, base = Fq2.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for m=2: sign of c0, or of c1 if c0 == 0."""
        sign_0 = self.c0 % 2
        zero_0 = self.c0 == 0
        sign_1 = self.c1 % 2
        return sign_0 or (zero_0 and sign_1)

    def is_square(self) -> bool:
        # Legendre in Fq2: a^((q^2-1)/2) == 1; equivalently norm is a QR in Fq.
        if self.is_zero():
            return True
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        return pow(norm, (P - 1) // 2, P) == 1

    def sqrt(self) -> "Fq2 | None":
        """Square root in Fq2 for p % 4 == 3 (complex-extension method)."""
        if self.is_zero():
            return Fq2.zero()
        # candidate = a^((q+1)/4) with q = p^2; (p^2+7)/16 etc. avoided by
        # the two-step method: a1 = a^((p-3)/4); alpha = a1^2 * a = a^((p-1)/2)
        a1 = self.pow((P - 3) // 4)
        alpha = a1.square() * self
        x0 = a1 * self
        if alpha == Fq2(P - 1, 0):  # alpha == -1
            cand = Fq2(-x0.c1, x0.c0)  # i * x0
        else:
            b = (alpha + Fq2.one()).pow((P - 1) // 2)
            cand = b * x0
        return cand if cand.square() == self else None

    def frobenius(self) -> "Fq2":
        """x -> x^p (conjugation, since u^p = -u for p % 4 == 3)."""
        return self.conjugate()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Fq2({hex(self.c0)}, {hex(self.c1)})"


class Fq:
    """Fq element with the same operator protocol as Fq2 (lets the curve ops
    in curve.py be generic over the base field of G1 vs G2)."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    @staticmethod
    def zero() -> "Fq":
        return Fq(0)

    @staticmethod
    def one() -> "Fq":
        return Fq(1)

    def is_zero(self) -> bool:
        return self.n == 0

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Fq) and self.n == other.n

    def __hash__(self) -> int:
        return hash(("Fq", self.n))

    def __add__(self, o: "Fq") -> "Fq":
        return Fq(self.n + o.n)

    def __sub__(self, o: "Fq") -> "Fq":
        return Fq(self.n - o.n)

    def __neg__(self) -> "Fq":
        return Fq(-self.n)

    def __mul__(self, o: "Fq") -> "Fq":
        return Fq(self.n * o.n)

    def mul_scalar(self, k: int) -> "Fq":
        return Fq(self.n * k)

    def square(self) -> "Fq":
        return Fq(self.n * self.n)

    def inv(self) -> "Fq":
        return Fq(fq_inv(self.n))

    def pow(self, e: int) -> "Fq":
        return Fq(pow(self.n, e, P)) if e >= 0 else self.inv().pow(-e)

    def sgn0(self) -> int:
        return self.n % 2

    def is_square(self) -> bool:
        return self.n == 0 or pow(self.n, (P - 1) // 2, P) == 1

    def sqrt(self) -> "Fq | None":
        root = fq_sqrt(self.n)
        return Fq(root) if root is not None else None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Fq({hex(self.n)})"


XI = Fq2(1, 1)  # the Fq6 non-residue xi = 1 + u

# Frobenius coefficients, computed (not transcribed):
#   Fq6:  v^p  = xi^((p-1)/3) * v,   v^(2p) coefficient for v^2 term
#   Fq12: w^p  = xi^((p-1)/6) * w
FROB_C1_V = XI.pow((P - 1) // 3)  # gamma for v
FROB_C1_V2 = XI.pow(2 * (P - 1) // 3)  # gamma for v^2
FROB_C1_W = XI.pow((P - 1) // 6)  # gamma for w


class Fq6:
    """a = c0 + c1*v + c2*v^2 with v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Fq6)
            and self.c0 == other.c0
            and self.c1 == other.c1
            and self.c2 == other.c2
        )

    def __hash__(self) -> int:
        return hash(("Fq6", self.c0, self.c1, self.c2))

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        # Karatsuba-style (Toom) interpolation
        c0 = t0 + XI * ((a1 + a2) * (b1 + b2) - t1 - t2)
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + XI * t2
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_by_fq2(self, k: Fq2) -> "Fq6":
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self) -> "Fq6":
        """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
        return Fq6(XI * self.c2, self.c0, self.c1)

    def square(self) -> "Fq6":
        return self * self

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - XI * (a1 * a2)
        t1 = XI * a2.square() - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = a0 * t0 + XI * (a2 * t1 + a1 * t2)
        dinv = denom.inv()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def frobenius(self) -> "Fq6":
        return Fq6(
            self.c0.frobenius(),
            self.c1.frobenius() * FROB_C1_V,
            self.c2.frobenius() * FROB_C1_V2,
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"Fq6({self.c0!r}, {self.c1!r}, {self.c2!r})"


class Fq12:
    """a = c0 + c1*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    def is_one(self) -> bool:
        return self == Fq12.one()

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Fq12) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self) -> int:
        return hash(("Fq12", self.c0, self.c1))

    def __mul__(self, o: "Fq12") -> "Fq12":
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        return self * self

    def conjugate(self) -> "Fq12":
        """c0 - c1 w == x^(p^6); on the cyclotomic subgroup this is x^-1."""
        return Fq12(self.c0, -self.c1)

    def inv(self) -> "Fq12":
        # 1/(a0 + a1 w) = (a0 - a1 w)/(a0^2 - a1^2 v)
        denom = self.c0.square() - self.c1.square().mul_by_v()
        dinv = denom.inv()
        return Fq12(self.c0 * dinv, -(self.c1 * dinv))

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        result, base = Fq12.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self) -> "Fq12":
        c0 = self.c0.frobenius()
        c1f = self.c1.frobenius()
        return Fq12(c0, Fq6(c1f.c0 * FROB_C1_W, c1f.c1 * FROB_C1_W, c1f.c2 * FROB_C1_W))

    def frobenius_n(self, n: int) -> "Fq12":
        out = self
        for _ in range(n):
            out = out.frobenius()
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"Fq12({self.c0!r}, {self.c1!r})"
