"""Extension tower Fq2 / Fq6 / Fq12 over the digit representation.

The port of ``lodestar_tpu/ops/tower.py``, the field layer of the
XLA-graph path.  The tower matches the oracle:

    Fq2  = Fq[u]  / (u^2 + 1)          -> (..., 2, 50) float32 digits
    Fq6  = Fq2[v] / (v^3 - xi), xi=1+u -> (..., 3, 2, 50)
    Fq12 = Fq6[w] / (w^2 - v)          -> (..., 6, 2, 50)  FLAT components
                                          [c00, c01, c02, c10, c11, c12]

The four products that ``pallas_tower`` wrote as Pallas kernels are the
port's CUDA tower kernels (``tower_kernels``): ``fq2_mul_many`` and
``fq2_mul`` (every stacked Fq2 product, so ``fq6_scale_fq2``,
``fq6_inv``, the Frobenius maps and ``fq12_sqr`` go through it too),
``fq2_sqr``, ``fq6_mul`` and ``fq12_mul``.  They follow the Pallas digit
algorithm, so their outputs equal the JAX ``tower.py`` products by value
mod p, not digit for digit; everything downstream that looks at digits
reduces first (``fp_eq``, ``fp_is_zero``, ``fq12_is_one``, sgn0).  The
rest is ``limbs`` glue in the JAX order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls import fields as F
from . import limbs as fl
from . import tower_kernels as tk
from .limbs import const_tensor, fp_add, fp_mul, fp_neg, fp_strict, fp_sub

# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


def fq2_const(v: F.Fq2) -> np.ndarray:
    """Oracle Fq2 -> (2, 50) numpy digit constant."""
    return np.stack([fl.int_to_limbs(v.c0), fl.int_to_limbs(v.c1)])


FQ2_ZERO = fq2_const(F.Fq2.zero())
FQ2_ONE = fq2_const(F.Fq2.one())
FROB_C1_V = fq2_const(F.FROB_C1_V)
FROB_C1_V2 = fq2_const(F.FROB_C1_V2)
FROB_C1_W = fq2_const(F.FROB_C1_W)
FROB_C1_V_PAIR = np.stack([FROB_C1_V, FROB_C1_V2])
FQ6_ZERO = np.stack([FQ2_ZERO] * 3)
FQ6_ONE = np.stack([FQ2_ONE, FQ2_ZERO, FQ2_ZERO])
FQ12_ONE = np.concatenate([FQ6_ONE, FQ6_ZERO])  # (6, 2, 50) flat


def fq12_const(v: F.Fq12) -> np.ndarray:
    out = np.zeros((6, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
    for i, c6 in enumerate((v.c0, v.c1)):
        for j, c2 in enumerate((c6.c0, c6.c1, c6.c2)):
            out[i * 3 + j] = fq2_const(c2)
    return out


# host conversion helpers (digits of any looseness -> oracle values)


def fq2_to_oracle(arr) -> F.Fq2:
    arr = np.asarray(arr)
    return F.Fq2(fl.limbs_to_int(arr[0]), fl.limbs_to_int(arr[1]))


def fq6_to_oracle(arr) -> F.Fq6:
    arr = np.asarray(arr)
    return F.Fq6(*[fq2_to_oracle(arr[i]) for i in range(3)])


def fq12_to_oracle(arr) -> F.Fq12:
    arr = np.asarray(arr)
    return F.Fq12(fq6_to_oracle(arr[:3]), fq6_to_oracle(arr[3:]))


def _c(x: torch.Tensor, i: int) -> torch.Tensor:
    """Fq2 component i of (..., 2, 50)."""
    return x[..., i, :]


def _s(elems, axis: int) -> torch.Tensor:
    return torch.stack(list(elems), dim=axis)


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------


def fq2_mul_many(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Independent Fq2 products over every leading axis, (..., 2, 50)
    semi-strict -> (..., 2, 50): one tower Fq2 kernel call."""
    return tk.call_rows(tk.K_FQ2_MUL, a, b)


fq2_mul = fq2_mul_many


def fq2_sqr(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1)(a0 - a1) + 2 a0 a1 u: one tower Fq2 square kernel call."""
    return tk.call_rows(tk.K_FQ2_SQR, a)


def fq2_conj(a: torch.Tensor) -> torch.Tensor:
    return _s([_c(a, 0), fp_neg(_c(a, 1))], -2)


def fq2_mul_by_xi(a: torch.Tensor) -> torch.Tensor:
    """(1+u) * (c0 + c1 u) = (c0 - c1) + (c0 + c1) u."""
    a0, a1 = _c(a, 0), _c(a, 1)
    return _s([fp_sub(a0, a1), fp_strict(fp_add(a0, a1))], -2)


def fq2_scale_fq(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Both Fq2 components times an Fq element s (..., 50)."""
    return fp_mul(a, s[..., None, :])


def fq2_inv(a: torch.Tensor) -> torch.Tensor:
    """1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)."""
    a0, a1 = _c(a, 0), _c(a, 1)
    sq = fp_mul(a, a)
    norm = fp_strict(fp_add(_c(sq, 0), _c(sq, 1)))
    ninv = fl.fp_inv(norm)
    return fp_mul(_s([a0, fp_neg(a1)], -2), ninv[..., None, :])


def fq2_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fl.fp_eq(a, b).all(-1)


def fq2_is_zero(a: torch.Tensor) -> torch.Tensor:
    return fl.fp_is_zero(a).all(-1)


# ---------------------------------------------------------------------------
# Fq6 — (..., 3, 2, 50); internals pass component lists
# ---------------------------------------------------------------------------


def _fq6_mul_lanes(A, B):
    """The 6 Toom lane pairs of one Fq6 product from component lists:
    [a0b0, a1b1, a2b2, (a1+a2)(b1+b2), (a0+a1)(b0+b1), (a0+a2)(b0+b2)]."""
    s = fp_strict
    ls = [A[0], A[1], A[2], s(fp_add(A[1], A[2])), s(fp_add(A[0], A[1])), s(fp_add(A[0], A[2]))]
    rs = [B[0], B[1], B[2], s(fp_add(B[1], B[2])), s(fp_add(B[0], B[1])), s(fp_add(B[0], B[2]))]
    return ls, rs


def _fq6_recombine(t):
    """One Fq6 product from its 6 Fq2 lane products."""
    t0, t1, t2, t3, t4, t5 = t
    s = fp_strict
    c0 = s(fp_add(t0, fq2_mul_by_xi(fp_sub(t3, fp_add(t1, t2)))))
    c1 = s(fp_add(fp_sub(t4, fp_add(t0, t1)), fq2_mul_by_xi(t2)))
    c2 = s(fp_add(fp_sub(t5, fp_add(t0, t2)), t1))
    return [c0, c1, c2]


def fq6_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq6 product: one tower Fq6 kernel call."""
    return tk.call_rows(tk.K_FQ6_MUL, a, b)


def fq6_mul_by_v_comps(A):
    """v * (c0, c1, c2) = (xi*c2, c0, c1) on a component list."""
    return [fq2_mul_by_xi(A[2]), A[0], A[1]]


def fq6_mul_by_v(a: torch.Tensor) -> torch.Tensor:
    return _s(fq6_mul_by_v_comps([a[..., j, :, :] for j in range(3)]), -3)


def fq6_scale_fq2(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """All three Fq2 components times s (..., 2, 50): 3 stacked Fq2 products."""
    return fq2_mul_many(a, s[..., None, :, :])


def fq6_inv(a: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    sq = fq2_mul_many(_s([a0, a2, a1], -3), _s([a0, a2, a1], -3))
    cross = fq2_mul_many(_s([a1, a0, a0], -3), _s([a2, a1, a2], -3))
    t0 = fp_sub(sq[..., 0, :, :], fq2_mul_by_xi(cross[..., 0, :, :]))
    t1 = fp_sub(fq2_mul_by_xi(sq[..., 1, :, :]), cross[..., 1, :, :])
    t2 = fp_sub(sq[..., 2, :, :], cross[..., 2, :, :])
    parts = fq2_mul_many(_s([a0, a2, a1], -3), _s([t0, t1, t2], -3))
    denom = fp_strict(
        fp_add(
            parts[..., 0, :, :],
            fq2_mul_by_xi(fp_strict(fp_add(parts[..., 1, :, :], parts[..., 2, :, :]))),
        )
    )
    dinv = fq2_inv(denom)
    return fq6_scale_fq2(_s([t0, t1, t2], -3), dinv)


def fq6_frobenius(a: torch.Tensor) -> torch.Tensor:
    c0 = fq2_conj(a[..., 0, :, :])
    scaled = fq2_mul_many(
        _s([fq2_conj(a[..., 1, :, :]), fq2_conj(a[..., 2, :, :])], -3),
        const_tensor(FROB_C1_V_PAIR, a.device),
    )
    return _s([c0, scaled[..., 0, :, :], scaled[..., 1, :, :]], -3)


# ---------------------------------------------------------------------------
# Fq12 — FLAT (..., 6, 2, 50), order [c00, c01, c02, c10, c11, c12]
# ---------------------------------------------------------------------------


def _fq12_comps(a):
    return [a[..., i, :, :] for i in range(6)]


def fq12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq12 product: one tower Fq12 kernel call."""
    return tk.call_rows(tk.K_FQ12_MUL, a, b)


def fq12_sqr(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1 w)^2 via Karatsuba: m = a0*a1; t = (a0+a1)(a0 + v*a1);
    c0 = t - m - v*m; c1 = 2m.  12 Fq2 lanes in one tower Fq2 call."""
    A = _fq12_comps(a)
    s = fp_strict
    a0c, a1c = A[0:3], A[3:6]
    sa = [s(fp_add(a0c[j], a1c[j])) for j in range(3)]
    va1 = fq6_mul_by_v_comps(a1c)
    a0va1 = [s(fp_add(a0c[j], va1[j])) for j in range(3)]
    Ls, Rs = [], []
    for U, V in ((a0c, a1c), (sa, a0va1)):
        l6, r6 = _fq6_mul_lanes(U, V)
        Ls += l6
        Rs += r6
    q = fq2_mul_many(_s(Ls, -3), _s(Rs, -3))  # (..., 12, 2, 50)
    qs = [q[..., i, :, :] for i in range(12)]
    M = _fq6_recombine(qs[0:6])  # a0*a1
    T = _fq6_recombine(qs[6:12])  # (a0+a1)(a0 + v a1)
    vM = fq6_mul_by_v_comps(M)
    C0 = [fp_sub(T[j], fp_add(M[j], vM[j])) for j in range(3)]
    C1 = [s(fp_add(M[j], M[j])) for j in range(3)]
    return _s(C0 + C1, -3)


def fq12_cyc_sqr(a: torch.Tensor) -> torch.Tensor:
    """Granger-Scott cyclotomic squaring (only for the cyclotomic subgroup,
    everything after the easy final-exponentiation part): 9 Fq2 squarings
    of the pairs (x0,x4), (x3,x2), (x1,x5) as 18 Fq lanes of one fp_mul,
    then z0 = 3 t0 - 2 x0, z1 = 3 t2 - 2 x1, z2 = 3 t4 - 2 x2,
    z3 = 3 xi t5 + 2 x3, z4 = 3 t1 + 2 x4, z5 = 3 t3 + 2 x5."""
    X = _fq12_comps(a)
    s = fp_strict
    sq_in = []
    for u, v in ((X[0], X[4]), (X[3], X[2]), (X[1], X[5])):
        sq_in += [u, v, s(fp_add(u, v))]
    stacked = _s(sq_in, -3)  # (..., 9, 2, 50)
    w0, w1 = _c(stacked, 0), _c(stacked, 1)
    lhs = _s([s(fp_add(w0, w1)), w0], -2)
    rhs = _s([fp_sub(w0, w1), w1], -2)
    t = fp_mul(lhs, rhs)
    sq = _s([_c(t, 0), s(fp_add(_c(t, 1), _c(t, 1)))], -2)  # squares of sq_in
    SQ = [sq[..., i, :, :] for i in range(9)]
    t_even, t_odd = [], []
    for k in range(3):
        a2, b2, ab2 = SQ[3 * k], SQ[3 * k + 1], SQ[3 * k + 2]
        t_even.append(s(fp_add(a2, fq2_mul_by_xi(b2))))  # a^2 + xi b^2
        t_odd.append(fp_sub(ab2, fp_add(a2, b2)))  # 2ab
    t0, t2, t4 = t_even
    t1, t3, t5 = t_odd
    z0 = fp_sub(fp_add(fp_add(t0, t0), t0), fp_add(X[0], X[0]))
    z1 = fp_sub(fp_add(fp_add(t2, t2), t2), fp_add(X[1], X[1]))
    z2 = fp_sub(fp_add(fp_add(t4, t4), t4), fp_add(X[2], X[2]))
    xt5 = fq2_mul_by_xi(t5)
    z3 = s(fp_add(fp_add(fp_add(xt5, xt5), xt5), fp_add(X[3], X[3])))
    z4 = s(fp_add(fp_add(fp_add(t1, t1), t1), fp_add(X[4], X[4])))
    z5 = s(fp_add(fp_add(fp_add(t3, t3), t3), fp_add(X[5], X[5])))
    return _s([z0, z1, z2, z3, z4, z5], -3)


def fq12_conj(a: torch.Tensor) -> torch.Tensor:
    """x -> x^(p^6); on the cyclotomic subgroup this is x^-1."""
    A = _fq12_comps(a)
    return _s(A[0:3] + [fp_neg(c) for c in A[3:6]], -3)


def fq12_frobenius(a: torch.Tensor) -> torch.Tensor:
    A = _fq12_comps(a)
    c0f = fq6_frobenius(_s(A[0:3], -3))
    c1f = fq6_frobenius(_s(A[3:6], -3))
    c1 = fq2_mul_many(c1f, const_tensor(FROB_C1_W, a.device))
    return torch.cat([c0f, c1], dim=-3)


def fq12_inv(a: torch.Tensor) -> torch.Tensor:
    a0, a1 = a[..., :3, :, :], a[..., 3:, :, :]
    t0 = fq6_mul(a0, a0)
    t1 = fq6_mul(a1, a1)
    denom = fp_sub(t0, fq6_mul_by_v(t1))
    dinv = fq6_inv(denom)
    out0 = fq6_mul(a0, dinv)
    out1 = fq6_mul(a1, dinv)
    neg1 = _s([fp_neg(out1[..., j, :, :]) for j in range(3)], -3)
    return torch.cat([out0, neg1], dim=-3)


def fq12_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(cond, a, b) with cond shaped (...,) broadcast over (6, 2, 50)."""
    return torch.where(cond[..., None, None, None], a, b)


def fq12_is_one(a: torch.Tensor) -> torch.Tensor:
    one = const_tensor(FQ12_ONE, a.device)
    return fl.fp_eq(a, one.expand(a.shape)).all(-1).all(-1)
