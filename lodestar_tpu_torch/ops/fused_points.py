"""G1/G2 jacobian point formulas over the fused kernel core.

The port of ``lodestar_tpu/ops/fused_points.py``: identical formulas and
infinity/edge-case semantics (exact-zero Z for deliberate infinities,
residue-zero predicates for adversarial inputs); every multiply round is
one lane-stacked kernel call and the predicates ride the canonical
reduction kernel.  Point coordinates carried through ladder loops are
re-wrapped at COORD_B.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..crypto.bls import curve as C
from . import limbs as fl
from . import tower as tw
from .fused_core import (
    LV,
    const_tensor,
    f2_mul,
    f_canon,
    f_mul,
    ladd,
    lcast,
    lconcat,
    ldbl,
    lstack,
    lsub,
    lv,
)
from .fused_field import FQ_ONE, const_like, f2_conj

# loop-carry digit-bound contract for point coordinates
COORD_B = 8192

PSI_CX = tw.fq2_const(C.PSI_CX)
PSI_CY = tw.fq2_const(C.PSI_CY)
G1_GEN_NEG_AFFINE = (
    fl.int_to_limbs(C.G1_GEN.x.n),
    fl.int_to_limbs((-C.G1_GEN.y).n),
)


class FNS(NamedTuple):
    """Fused field namespace: Fq (comp_ndim=1) or Fq2 (comp_ndim=2)."""

    comp_ndim: int
    mul: Callable  # LV x LV -> LV, element-wise over stacked lanes
    one_const: np.ndarray

    def stack(self, elems):
        return lstack(elems, axis=-(self.comp_ndim + 1))

    def unstack(self, x: LV, k: int):
        axis = x.a.dim() - (self.comp_ndim + 1)
        return [LV(x.a.select(axis, i), x.b) for i in range(k)]

    def select(self, cond, a: LV, b: LV) -> LV:
        c = cond.reshape(cond.shape + (1,) * self.comp_ndim)
        return LV(torch.where(c, a.a, b.a), max(a.b, b.b))

    def all_comps(self, x: torch.Tensor) -> torch.Tensor:
        """all() over the value axes (digits, and the Fq2 component)."""
        return x.flatten(-self.comp_ndim).all(-1)

    def is_exact_zero(self, x: LV):
        return self.all_comps(x.a == 0)

    def is_zero_mod(self, x: LV):
        return self.all_comps(f_canon(x) == 0)


def fq_ns() -> FNS:
    return FNS(comp_ndim=1, mul=f_mul, one_const=FQ_ONE)


def fq2_ns() -> FNS:
    return FNS(comp_ndim=2, mul=f2_mul, one_const=tw.FQ2_ONE)


Point = Tuple[LV, LV, LV]


def point_infinity(ns: FNS, batch_shape, device) -> Point:
    shape = tuple(batch_shape) + ns.one_const.shape
    one = lv(const_tensor(ns.one_const, device).expand(shape))
    zero = lv(torch.zeros(shape, dtype=torch.float32, device=device))
    return (one, one, zero)


def point_from_affine(x: LV, y: LV, ns: FNS) -> Point:
    return (x, y, lv(const_like(ns.one_const, x.a)))


def point_is_infinity(p: Point, ns: FNS):
    return ns.is_exact_zero(p[2])


def point_select(cond, a: Point, b: Point, ns: FNS) -> Point:
    return tuple(ns.select(cond, ai, bi) for ai, bi in zip(a, b))


def point_cast(p: Point, bound: int = COORD_B) -> Point:
    return tuple(lcast(c, bound) for c in p)


def point_double(p: Point, ns: FNS) -> Point:
    """2P jacobian: 3 kernel calls."""
    x, y, z = p
    a, bb, yz = ns.unstack(ns.mul(ns.stack([x, y, y]), ns.stack([x, y, z])), 3)
    e = ladd(ladd(a, a), a)
    xbb = ladd(x, bb)
    xbb2, c, f = ns.unstack(ns.mul(ns.stack([xbb, bb, e]), ns.stack([xbb, bb, e])), 3)
    d = ldbl(lsub(xbb2, ladd(a, c)))
    x3 = lsub(f, ldbl(d))
    c8 = ldbl(ldbl(ldbl(c)))
    (ed,) = ns.unstack(ns.mul(ns.stack([e]), ns.stack([lsub(d, x3)])), 1)
    return (x3, lsub(ed, c8), ldbl(yz))


def _add_core(p: Point, q: Point, ns: FNS):
    """Shared add machinery (6 kernel calls); returns (x3, y3, z3, h, sdiff)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = ns.unstack(ns.mul(ns.stack([z1, z2]), ns.stack([z1, z2])), 2)
    u1, u2, s1y, s2y = ns.unstack(
        ns.mul(ns.stack([x1, x2, y1, y2]), ns.stack([z2z2, z1z1, z2z2, z1z1])), 4
    )
    s1f, s2f = ns.unstack(ns.mul(ns.stack([s1y, s2y]), ns.stack([z2, z1])), 2)
    h = lsub(u2, u1)
    sdiff = lsub(s2f, s1f)
    r = ldbl(sdiff)
    hh = ldbl(h)
    zsum = ladd(z1, z2)
    i, r2, zsum2 = ns.unstack(ns.mul(ns.stack([hh, r, zsum]), ns.stack([hh, r, zsum])), 3)
    j, v = ns.unstack(ns.mul(ns.stack([h, u1]), ns.stack([i, i])), 2)
    x3 = lsub(r2, ladd(j, ldbl(v)))
    rvx, s1j, z3 = ns.unstack(
        ns.mul(
            ns.stack([r, s1f, lsub(zsum2, ladd(z1z1, z2z2))]),
            ns.stack([lsub(v, x3), j, h]),
        ),
        3,
    )
    y3 = lsub(rvx, ldbl(s1j))
    return x3, y3, z3, h, sdiff


def point_add_unsafe(p: Point, q: Point, ns: FNS) -> Point:
    """Jacobian add; correct when p != +-q (or either is infinity)."""
    x3, y3, z3, _, _ = _add_core(p, q, ns)
    out = (x3, y3, z3)
    out = point_select(point_is_infinity(q, ns), p, out, ns)
    return point_select(point_is_infinity(p, ns), q, out, ns)


def point_add_complete(p: Point, q: Point, ns: FNS) -> Point:
    """Full equal/opposite select ladder; the five residue predicates ride
    one canonical reduction."""
    x3, y3, z3, h, sdiff = _add_core(p, q, ns)
    zeros = ns.is_zero_mod(ns.stack([p[2], q[2], h, sdiff, p[1]]))
    p_inf, q_inf, eq_x, eq_y, y1_zero = (zeros.select(-1, i) for i in range(5))
    dbl_raw = point_double(p, ns)
    inf = point_infinity(ns, p_inf.shape, p_inf.device)
    dbl = point_select(y1_zero | p_inf, inf, dbl_raw, ns)
    out = (x3, y3, z3)
    out = point_select(eq_x & ~eq_y & ~p_inf & ~q_inf, inf, out, ns)
    out = point_select(eq_x & eq_y & ~p_inf & ~q_inf, dbl, out, ns)
    out = point_select(q_inf, p, out, ns)
    return point_select(p_inf, q, out, ns)


def point_mul_bits(p: Point, bits: torch.Tensor, ns: FNS, complete: bool = False) -> Point:
    """[k]P with per-lane scalars; bits (..., NBITS) LSB-first, a Python
    loop of double-and-add steps."""
    acc = point_infinity(ns, bits.shape[:-1], bits.device)
    addend = point_cast(tuple(lcast(c, COORD_B) for c in p))
    acc = point_cast(acc)
    for i in range(bits.shape[-1]):
        bit = bits[..., i].bool()
        if complete:
            added = point_add_complete(acc, addend, ns)
        else:
            added = point_add_unsafe(acc, addend, ns)
        acc = point_select(bit, added, acc, ns)
        # back to the loop contract (raises if a bound outgrew it)
        acc = point_cast(acc)
        addend = point_cast(point_double(addend, ns))
    return acc


def point_sum_tree(p: Point, ns: FNS) -> Point:
    """Reduce batch axis 0 by pairwise tree addition (unsafe adds — the
    operands are RLC-randomized)."""
    x, y, z = p
    while x.a.shape[0] > 1:
        n = x.a.shape[0]
        if n % 2:
            inf = point_infinity(ns, (1,) + tuple(x.a.shape[1 : x.a.dim() - ns.comp_ndim]), x.a.device)
            x = lconcat([x, inf[0]], axis=0)
            y = lconcat([y, inf[1]], axis=0)
            z = lconcat([z, inf[2]], axis=0)
            n += 1
        half = n // 2
        x, y, z = point_add_unsafe(
            (LV(x.a[:half], x.b), LV(y.a[:half], y.b), LV(z.a[:half], z.b)),
            (LV(x.a[half:], x.b), LV(y.a[half:], y.b), LV(z.a[half:], z.b)),
            ns,
        )
    return (LV(x.a[0], x.b), LV(y.a[0], y.b), LV(z.a[0], z.b))


def point_eq(p: Point, q: Point, ns: FNS):
    """X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3, with infinity handling."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = ns.unstack(ns.mul(ns.stack([z1, z2]), ns.stack([z1, z2])), 2)
    u1, u2, t1, t2 = ns.unstack(
        ns.mul(ns.stack([x1, x2, y1, y2]), ns.stack([z2z2, z1z1, z2z2, z1z1])), 4
    )
    s1f, s2f = ns.unstack(ns.mul(ns.stack([t1, t2]), ns.stack([z2, z1])), 2)
    zeros = ns.is_zero_mod(ns.stack([lsub(u1, u2), lsub(s1f, s2f)]))
    same = zeros.select(-1, 0) & zeros.select(-1, 1)
    p_inf = point_is_infinity(p, ns)
    q_inf = point_is_infinity(q, ns)
    return torch.where(p_inf | q_inf, p_inf & q_inf, same)


def psi(p: Point) -> Point:
    """Untwist-Frobenius-twist endomorphism."""
    x, y, z = p
    cx = lv(const_like(PSI_CX, x.a))
    cy = lv(const_like(PSI_CY, y.a))
    s = f2_mul(lstack([f2_conj(x), f2_conj(y)], axis=-3), lstack([cx, cy], axis=-3))
    return (LV(s.a[..., 0, :, :], s.b), LV(s.a[..., 1, :, :], s.b), f2_conj(z))
