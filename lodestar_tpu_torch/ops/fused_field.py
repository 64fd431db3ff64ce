"""Tower algebra (Fq / Fq2 / Fq6 / Fq12) over the fused kernel core.

The port of ``lodestar_tpu/ops/fused_field.py``: the same tower, the same
flat (..., 6, 2, 50) Fq12 layout and the same lane schemes.  Every
multiply round is one kernel call on lane-stacked operands; the glue
between rounds is loose LV arithmetic.  Exponentiations run 4-bit windows
over the fused r^16 * t kernels (a Python loop over the static windows).
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls import fields as F
from . import limbs as fl
from . import tower as tw
from .fused_core import (
    LV,
    const_tensor,
    f2_mul,
    f2_pow16mul,
    f2_sqr,
    f_canon,
    f_mul,
    f_pow16mul,
    ladd,
    lc,
    ldbl,
    lneg,
    lselect,
    lstack,
    lsub,
    lv,
)

NL = fl.NLIMBS

FQ_ONE = fl.ONE
FQ2_ONE = tw.FQ2_ONE
FQ12_ONE = tw.FQ12_ONE
P_MINUS_1 = fl.int_to_limbs(F.P - 1)
MINUS_ONE_FQ2 = tw.fq2_const(F.Fq2(F.P - 1, 0))

# flat Fq12 Frobenius coefficient set: out_i = conj(c_i) * FROB12[i]
FROB12 = np.stack(
    [
        tw.fq2_const(F.Fq2.one()),
        tw.fq2_const(F.FROB_C1_V),
        tw.fq2_const(F.FROB_C1_V2),
        tw.fq2_const(F.FROB_C1_W),
        tw.fq2_const(F.FROB_C1_V * F.FROB_C1_W),
        tw.fq2_const(F.FROB_C1_V2 * F.FROB_C1_W),
    ]
)  # (6, 2, 50)
_FROB12_TAIL = np.ascontiguousarray(FROB12[1:])

# exponent windows of the static powers
_WIN_INV = fl._exp_windows(F.P - 2)
_WIN_CHI = fl._exp_windows((F.P - 1) // 2)
_WIN_SQRT = fl._exp_windows((F.P - 3) // 4)


def const_like(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A numpy constant broadcast to ``like``'s shape on its device."""
    return const_tensor(arr, like.device).expand(like.shape)


# ---------------------------------------------------------------------------
# Fq2 glue (LVs shaped (..., 2, 50))
# ---------------------------------------------------------------------------


def f2_conj(x: LV) -> LV:
    return lstack([lc(x, 0), lneg(lc(x, 1))], axis=-2)


def f2_mul_by_xi(x: LV) -> LV:
    """(1+u)(c0 + c1 u) = (c0 - c1) + (c0 + c1) u."""
    x0, x1 = lc(x, 0), lc(x, 1)
    return lstack([lsub(x0, x1), ladd(x0, x1)], axis=-2)


def f2_scale_fq(x: LV, s: LV) -> LV:
    """Both components times an Fq element s (..., 50): one Fq kernel call
    on 2 stacked lanes."""
    return f_mul(x, LV(s.a[..., None, :].expand(x.a.shape), s.b))


# ---------------------------------------------------------------------------
# windowed exponentiation (Fq and Fq2)
# ---------------------------------------------------------------------------


def _pow_table(x: LV, mul, one_c: np.ndarray) -> LV:
    """x^0..x^15 stacked on a new leading axis, in lane-stacked multiply
    rounds (each round multiplies pairs of known powers)."""
    powers = {0: lv(const_like(one_c, x.a)), 1: x}
    for k in range(2, 16):
        powers[k] = None
    while any(v is None for v in powers.values()):
        ready = [
            k for k, v in powers.items()
            if v is None and powers[k // 2] is not None and powers[k - k // 2] is not None
        ]
        prod = mul(
            lstack([powers[k // 2] for k in ready], axis=0),
            lstack([powers[k - k // 2] for k in ready], axis=0),
        )
        for i, k in enumerate(ready):
            powers[k] = LV(prod.a[i], prod.b)
    return lstack([powers[k] for k in range(16)], axis=0)


def _pow_windows(x: LV, windows: np.ndarray, mul, pow16mul, one_c: np.ndarray) -> LV:
    table = _pow_table(x, mul, one_c)
    r = const_like(one_c, x.a)
    for w in windows:
        r = pow16mul(lv(r, 256), LV(table.a[int(w)], table.b)).a
    return lv(r)


def fi_pow_windows(x: LV, windows: np.ndarray) -> LV:
    """x^e in Fq for the static exponent whose base-16 digits are windows."""
    return _pow_windows(x, windows, f_mul, f_pow16mul, FQ_ONE)


def f2_pow_windows(x: LV, windows: np.ndarray) -> LV:
    """x^e in Fq2 for the static exponent whose base-16 digits are windows."""
    return _pow_windows(x, windows, f2_mul, f2_pow16mul, FQ2_ONE)


def fi_inv(x: LV) -> LV:
    """1/x in Fq via Fermat (x^(p-2)); x = 0 -> 0."""
    return fi_pow_windows(x, _WIN_INV)


def f2_inv(x: LV) -> LV:
    """1/(x0 + x1 u) = (x0 - x1 u) / (x0^2 + x1^2)."""
    x0, x1 = lc(x, 0), lc(x, 1)
    pair = lstack([x0, x1], axis=-2)
    sq = f_mul(pair, pair)
    norm = ladd(LV(sq.a[..., 0, :], sq.b), LV(sq.a[..., 1, :], sq.b))
    ninv = fi_inv(norm)
    return f2_scale_fq(lstack([x0, lneg(x1)], axis=-2), ninv)


def f2_sqrt(x: LV) -> LV:
    """Square root for p % 4 == 3 (branchless); valid when x is a square."""
    a1 = f2_pow_windows(x, _WIN_SQRT)
    m = f2_mul(lstack([a1, a1], axis=-3), lstack([a1, x], axis=-3))
    a1sq = LV(m.a[..., 0, :, :], m.b)
    x0 = LV(m.a[..., 1, :, :], m.b)
    alpha = f2_mul(a1sq, x)
    is_neg1 = (f_canon(lsub(alpha, lv(const_like(MINUS_ONE_FQ2, alpha.a)))) == 0).all(-1).all(-1)
    cand_a = lstack([lneg(lc(x0, 1)), lc(x0, 0)], axis=-2)  # i * x0
    b = f2_pow_windows(ladd(alpha, lv(const_like(FQ2_ONE, alpha.a))), _WIN_CHI)
    cand_b = f2_mul(b, x0)
    return lselect(is_neg1, cand_a, cand_b)


def f2_sgn0(x: LV) -> torch.Tensor:
    """RFC 9380 sgn0 for m=2, on canonical residues."""
    r = f_canon(x)
    r0, r1 = r[..., 0, :], r[..., 1, :]
    sign0 = (r0[..., 0] % 2) == 1
    zero0 = (r0 == 0).all(-1)
    sign1 = (r1[..., 0] % 2) == 1
    return sign0 | (zero0 & sign1)


# ---------------------------------------------------------------------------
# Fq6 (component lists of Fq2 LVs) and flat Fq12 (..., 6, 2, 50)
# ---------------------------------------------------------------------------


def _fq6_lanes(A, B):
    """Toom lane pairs for one Fq6 product."""
    ls = [A[0], A[1], A[2], ladd(A[1], A[2]), ladd(A[0], A[1]), ladd(A[0], A[2])]
    rs = [B[0], B[1], B[2], ladd(B[1], B[2]), ladd(B[0], B[1]), ladd(B[0], B[2])]
    return ls, rs


def _fq6_recombine(t):
    """One Fq6 product from its 6 Fq2 lane products."""
    t0, t1, t2, t3, t4, t5 = t
    c0 = ladd(t0, f2_mul_by_xi(lsub(t3, ladd(t1, t2))))
    c1 = ladd(lsub(t4, ladd(t0, t1)), f2_mul_by_xi(t2))
    c2 = ladd(lsub(t5, ladd(t0, t2)), t1)
    return [c0, c1, c2]


def _fq6_mul_by_v(A):
    return [f2_mul_by_xi(A[2]), A[0], A[1]]


def _lanes(q: LV, k: int):
    return [LV(q.a[..., i, :, :], q.b) for i in range(k)]


def f6_mul_comps(A, B):
    """Fq6 product on 3-component Fq2 LV lists — one 6-lane kernel call."""
    ls, rs = _fq6_lanes(A, B)
    q = f2_mul(lstack(ls, axis=-3), lstack(rs, axis=-3))
    return _fq6_recombine(_lanes(q, 6))


def _f12_comps(x: LV):
    return _lanes(x, 6)


def f12_mul(a: LV, b: LV) -> LV:
    """Karatsuba over Fq6: 18 Fq2 lanes, one kernel call."""
    A = _f12_comps(a)
    B = _f12_comps(b)
    SA = [ladd(A[j], A[3 + j]) for j in range(3)]
    SB = [ladd(B[j], B[3 + j]) for j in range(3)]
    Ls, Rs = [], []
    for U, V in ((A[0:3], B[0:3]), (A[3:6], B[3:6]), (SA, SB)):
        l6, r6 = _fq6_lanes(U, V)
        Ls += l6
        Rs += r6
    qs = _lanes(f2_mul(lstack(Ls, axis=-3), lstack(Rs, axis=-3)), 18)
    T0 = _fq6_recombine(qs[0:6])
    T1 = _fq6_recombine(qs[6:12])
    T3 = _fq6_recombine(qs[12:18])
    vT1 = _fq6_mul_by_v(T1)
    C0 = [ladd(T0[j], vT1[j]) for j in range(3)]
    C1 = [lsub(T3[j], ladd(T0[j], T1[j])) for j in range(3)]
    return lstack(C0 + C1, axis=-3)


def f12_sqr(a: LV) -> LV:
    """(a0 + a1 w)^2 Karatsuba: 12 Fq2 lanes, one kernel call."""
    A = _f12_comps(a)
    a0c, a1c = A[0:3], A[3:6]
    sa = [ladd(a0c[j], a1c[j]) for j in range(3)]
    va1 = _fq6_mul_by_v(a1c)
    a0va1 = [ladd(a0c[j], va1[j]) for j in range(3)]
    Ls, Rs = [], []
    for U, V in ((a0c, a1c), (sa, a0va1)):
        l6, r6 = _fq6_lanes(U, V)
        Ls += l6
        Rs += r6
    qs = _lanes(f2_mul(lstack(Ls, axis=-3), lstack(Rs, axis=-3)), 12)
    M = _fq6_recombine(qs[0:6])
    T = _fq6_recombine(qs[6:12])
    vM = _fq6_mul_by_v(M)
    C0 = [lsub(T[j], ladd(M[j], vM[j])) for j in range(3)]
    C1 = [ladd(M[j], M[j]) for j in range(3)]
    return lstack(C0 + C1, axis=-3)


def f12_cyc_sqr(a: LV) -> LV:
    """Granger-Scott cyclotomic squaring — 9 Fq2 squarings in one kernel
    call; the squaring kernel's folded-input output keeps the 3t - 2x
    recombination bounds small."""
    X = _f12_comps(a)
    pairs = [(X[0], X[4]), (X[3], X[2]), (X[1], X[5])]
    sq_in = []
    for u, v in pairs:
        sq_in += [u, v, ladd(u, v)]
    sq, folded = f2_sqr(lstack(sq_in, axis=-3))
    SQ = _lanes(sq, 9)
    FD = [LV(folded.a[..., i, :, :], 256) for i in range(9)]
    fx = {0: FD[0], 4: FD[1], 3: FD[3], 2: FD[4], 1: FD[6], 5: FD[7]}
    t_even, t_odd = [], []
    for k in range(3):
        a2, b2, ab2 = SQ[3 * k], SQ[3 * k + 1], SQ[3 * k + 2]
        t_even.append(ladd(a2, f2_mul_by_xi(b2)))
        t_odd.append(lsub(ab2, ladd(a2, b2)))
    t0, t2, t4 = t_even
    t1, t3, t5 = t_odd

    def trip(t):
        return ladd(ladd(t, t), t)

    z0 = lsub(trip(t0), ldbl(fx[0]))
    z1 = lsub(trip(t2), ldbl(fx[1]))
    z2 = lsub(trip(t4), ldbl(fx[2]))
    z3 = ladd(trip(f2_mul_by_xi(t5)), ldbl(fx[3]))
    z4 = ladd(trip(t1), ldbl(fx[4]))
    z5 = ladd(trip(t3), ldbl(fx[5]))
    return lstack([z0, z1, z2, z3, z4, z5], axis=-3)


def f12_conj(a: LV) -> LV:
    """x -> x^(p^6) (the inverse on the cyclotomic subgroup)."""
    A = _f12_comps(a)
    return lstack(A[0:3] + [lneg(c) for c in A[3:6]], axis=-3)


def f12_frobenius(a: LV) -> LV:
    """x -> x^p: conjugate every component, multiply by the precombined
    coefficient set — one 5-lane kernel call (FROB12[0] = 1)."""
    A = _f12_comps(a)
    conj = [f2_conj(c) for c in A]
    coeff = lv(const_tensor(_FROB12_TAIL, a.a.device))  # (5, 2, 50)
    prod = f2_mul(lstack(conj[1:], axis=-3), coeff)
    return lstack([conj[0]] + _lanes(prod, 5), axis=-3)


def f6_inv_comps(A):
    """Fq6 inversion on component lists."""
    a0, a1, a2 = A
    sqs = _lanes(f2_mul(lstack([a0, a2, a1], axis=-3), lstack([a0, a2, a1], axis=-3)), 3)
    crs = _lanes(f2_mul(lstack([a1, a0, a0], axis=-3), lstack([a2, a1, a2], axis=-3)), 3)
    t0 = lsub(sqs[0], f2_mul_by_xi(crs[0]))
    t1 = lsub(f2_mul_by_xi(sqs[1]), crs[1])
    t2 = lsub(sqs[2], crs[2])
    ts = lstack([t0, t1, t2], axis=-3)
    ps = _lanes(f2_mul(lstack([a0, a2, a1], axis=-3), ts), 3)
    denom = ladd(ps[0], f2_mul_by_xi(ladd(ps[1], ps[2])))
    dinv = f2_inv(denom)
    scaled = f2_mul(ts, LV(dinv.a[..., None, :, :].expand(ts.a.shape), dinv.b))
    return _lanes(scaled, 3)


def f12_inv(a: LV) -> LV:
    """Fq12 inversion via the Fq6 norm."""
    A = _f12_comps(a)
    a0, a1 = A[0:3], A[3:6]
    t0 = f6_mul_comps(a0, a0)
    t1 = f6_mul_comps(a1, a1)
    vt1 = _fq6_mul_by_v(t1)
    dinv = f6_inv_comps([lsub(t0[j], vt1[j]) for j in range(3)])
    out0 = f6_mul_comps(a0, dinv)
    out1 = f6_mul_comps(a1, dinv)
    return lstack(out0 + [lneg(c) for c in out1], axis=-3)


def f12_select(cond: torch.Tensor, a: LV, b: LV) -> LV:
    return LV(torch.where(cond[..., None, None, None], a.a, b.a), max(a.b, b.b))


def f12_is_one(a: LV) -> torch.Tensor:
    """a == 1 in Fq12: subtract one from component 0 and canonically
    reduce all 12 coordinates in one stacked call."""
    A = _f12_comps(a)
    one = lv(const_like(FQ2_ONE, A[0].a))
    diff = lstack([lsub(A[0], one)] + A[1:6], axis=-3)
    return (f_canon(diff) == 0).flatten(-3).all(-1)
