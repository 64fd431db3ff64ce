"""G1/G2 jacobian point formulas over the limb fields — batched, branchless.

The port of ``lodestar_tpu/ops/points.py`` for the XLA-graph path: the
same formulas, select ladders and infinity conventions.  A point is an
``(x, y, z)`` tuple of field tensors (Fq: (..., 50); Fq2: (..., 2, 50)),
jacobian: affine = (X/Z^2, Y/Z^3).  A point is infinity iff its Z is the
exact all-zero digit array; the complete formulas also test residues
(z == 0 mod p), since adversarial inputs reach cancellations.

The JAX ``lax.scan`` ladders are Python loops over the bits.  Where the
bits are static (``point_mul_static``), a step whose bit is 0 skips the
add that the scan computes and then discards, which leaves every digit as
the scan has it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..crypto.bls import curve as C
from ..crypto.bls.fields import BLS_X
from . import limbs as fl
from . import tower as tw
from .limbs import const_tensor, fp_add, fp_strict, fp_sub

# ---------------------------------------------------------------------------
# field namespaces: the point formulas are written once for Fq (G1) and
# Fq2 (G2)
# ---------------------------------------------------------------------------


class FieldNS(NamedTuple):
    comp_ndim: int  # trailing axes of one element: 1 for Fq, 2 for Fq2
    mul_many: Callable  # stacked independent products along axis -(comp_ndim+1)
    inv: Callable
    is_zero_mod: Callable  # zero as a residue (full reduction)
    eq_mod: Callable
    one_const: np.ndarray

    def stack(self, elems):
        return torch.stack(list(elems), dim=-(self.comp_ndim + 1))

    def unstack(self, arr, k):
        axis = arr.dim() - (self.comp_ndim + 1)
        return tuple(arr.select(axis, i) for i in range(k))

    def select(self, cond, a, b):
        c = cond.reshape(cond.shape + (1,) * self.comp_ndim)
        return torch.where(c, a, b)

    def is_exact_zero(self, a):
        return (a == 0).flatten(-self.comp_ndim).all(-1)


FQ_NS = FieldNS(
    comp_ndim=1,
    mul_many=fl.fp_mul,
    inv=fl.fp_inv,
    is_zero_mod=fl.fp_is_zero,
    eq_mod=fl.fp_eq,
    one_const=fl.ONE,
)

FQ2_NS = FieldNS(
    comp_ndim=2,
    mul_many=tw.fq2_mul_many,
    inv=tw.fq2_inv,
    is_zero_mod=tw.fq2_is_zero,
    eq_mod=tw.fq2_eq,
    one_const=tw.FQ2_ONE,
)

# ---------------------------------------------------------------------------
# constants (computed from the oracle)
# ---------------------------------------------------------------------------

# psi (untwist-Frobenius-twist) coefficients
PSI_CX = tw.fq2_const(C.PSI_CX)
PSI_CY = tw.fq2_const(C.PSI_CY)
G1_GEN_NEG_AFFINE = (fl.int_to_limbs(C.G1_GEN.x.n), fl.int_to_limbs((-C.G1_GEN.y).n))

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def point_infinity(ns: FieldNS, batch_shape, device) -> Point:
    shape = tuple(batch_shape) + ns.one_const.shape
    one = const_tensor(ns.one_const, device).expand(shape)
    return (one, one, torch.zeros(shape, device=device))


def point_from_affine(x: torch.Tensor, y: torch.Tensor, ns: FieldNS) -> Point:
    return (x, y, const_tensor(ns.one_const, x.device).expand(x.shape))


def point_is_infinity(p: Point, ns: FieldNS) -> torch.Tensor:
    return ns.is_exact_zero(p[2])


def point_neg(p: Point, ns: FieldNS) -> Point:
    return (p[0], fl.fp_neg(p[1]), p[2])


def point_select(cond: torch.Tensor, a: Point, b: Point, ns: FieldNS) -> Point:
    return tuple(ns.select(cond, ai, bi) for ai, bi in zip(a, b))


def _batch_shape(p: Point, ns: FieldNS):
    z = p[2]
    return z.shape[: z.dim() - ns.comp_ndim]


def point_double(p: Point, ns: FieldNS) -> Point:
    """2P (jacobian).  Handles infinity and y = 0 implicitly (z3 = 2yz = 0
    exactly, because both cases carry exact-zero digits)."""
    x, y, z = p
    a, bb, yz = ns.unstack(ns.mul_many(ns.stack([x, y, y]), ns.stack([x, y, z])), 3)
    e = fp_strict(fp_add(fp_add(a, a), a))  # 3x^2
    xbb = fp_strict(fp_add(x, bb))
    xbb2, c, f = ns.unstack(ns.mul_many(ns.stack([xbb, bb, e]), ns.stack([xbb, bb, e])), 3)
    # d = 2((x+bb)^2 - a - c)
    d_half = fp_sub(xbb2, fp_add(a, c))
    d = fp_strict(fp_add(d_half, d_half))
    x3 = fp_sub(f, fp_add(d, d))
    c8 = fp_strict(fp_add(fp_add(fp_add(c, c), fp_add(c, c)), fp_add(fp_add(c, c), fp_add(c, c))))
    (ed,) = ns.unstack(ns.mul_many(ns.stack([e]), ns.stack([fp_sub(d, x3)])), 1)
    y3 = fp_sub(ed, c8)
    z3 = fp_strict(fp_add(yz, yz))
    return (x3, y3, z3)


def _add_core(p: Point, q: Point, ns: FieldNS):
    """Shared add machinery; returns (x3, y3, z3, h, sdiff)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = ns.unstack(ns.mul_many(ns.stack([z1, z2]), ns.stack([z1, z2])), 2)
    u1, u2, s1y, s2y = ns.unstack(
        ns.mul_many(ns.stack([x1, x2, y1, y2]), ns.stack([z2z2, z1z1, z2z2, z1z1])), 4
    )
    s1f, s2f = ns.unstack(ns.mul_many(ns.stack([s1y, s2y]), ns.stack([z2, z1])), 2)
    h = fp_sub(u2, u1)
    sdiff = fp_sub(s2f, s1f)
    r = fp_strict(fp_add(sdiff, sdiff))
    hh = fp_strict(fp_add(h, h))
    zsum = fp_strict(fp_add(z1, z2))
    i, r2, zsum2 = ns.unstack(ns.mul_many(ns.stack([hh, r, zsum]), ns.stack([hh, r, zsum])), 3)
    j, v = ns.unstack(ns.mul_many(ns.stack([h, u1]), ns.stack([i, i])), 2)
    x3 = fp_sub(r2, fp_add(j, fp_add(v, v)))
    rvx, s1j, z3 = ns.unstack(
        ns.mul_many(
            ns.stack([r, s1f, fp_sub(zsum2, fp_add(z1z1, z2z2))]),
            ns.stack([fp_sub(v, x3), j, h]),
        ),
        3,
    )
    y3 = fp_sub(rvx, fp_strict(fp_add(s1j, s1j)))
    return x3, y3, z3, h, sdiff


def point_add_unsafe(p: Point, q: Point, ns: FieldNS) -> Point:
    """Jacobian add; correct when p != +-q (or either is infinity)."""
    x3, y3, z3, _, _ = _add_core(p, q, ns)
    out = point_select(point_is_infinity(q, ns), p, (x3, y3, z3), ns)
    return point_select(point_is_infinity(p, ns), q, out, ns)


def point_double_complete(p: Point, ns: FieldNS) -> Point:
    """Double with residue-exact edge handling: doubling a 2-torsion point
    (y == 0 mod p) or a phantom infinity (z == 0 mod p with nonzero
    digits) gives the exact infinity encoding."""
    out = point_double(p, ns)
    degenerate = ns.is_zero_mod(ns.stack([p[1], p[2]])).any(-1)  # one stacked reduction
    inf = point_infinity(ns, degenerate.shape, degenerate.device)
    return point_select(degenerate, inf, out, ns)


def point_add_complete(p: Point, q: Point, ns: FieldNS) -> Point:
    """Jacobian add with the full equal/opposite select ladder (for
    adversary-controlled inputs).  Infinity is residue-based here; the
    five residue-zero predicates (z1, z2, h, sdiff, y1) ride one stacked
    reduction."""
    x3, y3, z3, h, sdiff = _add_core(p, q, ns)
    zeros = ns.is_zero_mod(ns.stack([p[2], q[2], h, sdiff, p[1]]))  # (..., 5)
    p_inf, q_inf, eq_x, eq_y, y1_zero = (zeros[..., i] for i in range(5))
    # doubling arm with its degeneracy folded in (2-torsion / phantom inf)
    dbl_raw = point_double(p, ns)
    inf = point_infinity(ns, p_inf.shape, p_inf.device)
    dbl = point_select(y1_zero | p_inf, inf, dbl_raw, ns)
    out = (x3, y3, z3)
    out = point_select(eq_x & ~eq_y & ~p_inf & ~q_inf, inf, out, ns)
    out = point_select(eq_x & eq_y & ~p_inf & ~q_inf, dbl, out, ns)
    out = point_select(q_inf, p, out, ns)
    return point_select(p_inf, q, out, ns)


# ---------------------------------------------------------------------------
# scalar multiplication
# ---------------------------------------------------------------------------


def point_mul_bits(p: Point, bits: torch.Tensor, ns: FieldNS, complete: bool = False) -> Point:
    """[k]P with per-element scalars: bits (..., NBITS) in {0, 1}, LSB
    first, batch axes matching p.  Double-and-add with selects (the last
    doubling of the addend, which nothing reads, is left out)."""
    add = point_add_complete if complete else point_add_unsafe
    dbl = point_double_complete if complete else point_double
    nbits = bits.shape[-1]
    acc = point_infinity(ns, bits.shape[:-1], bits.device)
    addend = p
    for i in range(nbits):
        acc = point_select(bits[..., i] != 0, add(acc, addend, ns), acc, ns)
        if i + 1 < nbits:
            addend = dbl(addend, ns)
    return acc


def point_mul_static(p: Point, k: int, ns: FieldNS, complete: bool = True) -> Point:
    """[k]P for a static python-int scalar (k may be negative): MSB-first
    double-and-add over the constant bits, complete adds by default (the
    static ladders are the adversary-facing ones)."""
    if k == 0:
        return point_infinity(ns, _batch_shape(p, ns), p[2].device)
    if k < 0:
        return point_mul_static(point_neg(p, ns), -k, ns, complete)
    add = point_add_complete if complete else point_add_unsafe
    dbl = point_double_complete if complete else point_double
    acc = point_infinity(ns, _batch_shape(p, ns), p[2].device)
    for bit in bin(k)[2:]:
        acc = dbl(acc, ns)
        if bit == "1":
            acc = add(acc, p, ns)
    return acc


def point_sum_tree(p: Point, ns: FieldNS, complete: bool = False) -> Point:
    """Sum over axis 0 by pairwise tree addition (log2 N levels, each one
    batched add); odd levels are padded with infinity."""
    x, y, z = p
    add = point_add_complete if complete else point_add_unsafe
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            inf = point_infinity(ns, (1,) + tuple(_batch_shape((x, y, z), ns)[1:]), x.device)
            x, y, z = (torch.cat([c, i]) for c, i in zip((x, y, z), inf))
        half = x.shape[0] // 2
        x, y, z = add((x[:half], y[:half], z[:half]), (x[half:], y[half:], z[half:]), ns)
    return (x[0], y[0], z[0])


# ---------------------------------------------------------------------------
# equality / affine / endomorphisms / subgroup checks
# ---------------------------------------------------------------------------


def point_eq(p: Point, q: Point, ns: FieldNS) -> torch.Tensor:
    """X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3, with infinity handling."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = ns.unstack(ns.mul_many(ns.stack([z1, z2]), ns.stack([z1, z2])), 2)
    u1, u2, t1, t2 = ns.unstack(
        ns.mul_many(ns.stack([x1, x2, y1, y2]), ns.stack([z2z2, z1z1, z2z2, z1z1])), 4
    )
    s1f, s2f = ns.unstack(ns.mul_many(ns.stack([t1, t2]), ns.stack([z2, z1])), 2)
    same = ns.eq_mod(u1, u2) & ns.eq_mod(s1f, s2f)
    p_inf = point_is_infinity(p, ns)
    q_inf = point_is_infinity(q, ns)
    return torch.where(p_inf | q_inf, p_inf & q_inf, same)


def point_to_affine(p: Point, ns: FieldNS):
    """(X/Z^2, Y/Z^3); the caller masks infinity."""
    zinv = ns.inv(p[2])
    (zinv2,) = ns.unstack(ns.mul_many(ns.stack([zinv]), ns.stack([zinv])), 1)
    xa, zinv3 = ns.unstack(ns.mul_many(ns.stack([p[0], zinv2]), ns.stack([zinv2, zinv])), 2)
    (ya,) = ns.unstack(ns.mul_many(ns.stack([p[1]]), ns.stack([zinv3])), 1)
    return xa, ya


def psi(p: Point) -> Point:
    """Untwist-Frobenius-twist endomorphism on E2, jacobian-native:
    psi(X, Y, Z) = (conj(X) * cx, conj(Y) * cy, conj(Z))."""
    x, y, z = p
    dev = x.device
    cxy = torch.stack([const_tensor(PSI_CX, dev).expand(x.shape),
                       const_tensor(PSI_CY, dev).expand(y.shape)], dim=-3)
    s = tw.fq2_mul_many(torch.stack([tw.fq2_conj(x), tw.fq2_conj(y)], dim=-3), cxy)
    return (s[..., 0, :, :], s[..., 1, :, :], tw.fq2_conj(z))


def g2_subgroup_check(p: Point) -> torch.Tensor:
    """P in G2 iff psi(P) == [z]P (z < 0: computed as [-z](-P)); infinity
    passes."""
    target = point_mul_static(p, BLS_X, FQ2_NS, complete=True)
    return point_eq(psi(p), target, FQ2_NS) | point_is_infinity(p, FQ2_NS)


def g2_clear_cofactor(p: Point) -> Point:
    """Budroni-Pintore: h_eff P = [z^2-z-1]P + [z-1]psi(P) + psi^2([2]P),
    with complete adds."""
    z = BLS_X
    t1 = point_mul_static(p, z * z - z - 1, FQ2_NS, complete=True)
    t2 = point_mul_static(psi(p), z - 1, FQ2_NS, complete=True)
    t3 = psi(psi(point_double(p, FQ2_NS)))
    return point_add_complete(point_add_complete(t1, t2, FQ2_NS), t3, FQ2_NS)
