"""Optimal ate pairing over the fused kernel core.

The port of ``lodestar_tpu/ops/fused_pairing.py``: the same inversion-free
jacobian Miller loop (the doubling step shares its multiply rounds with
the point doubling; Fq line scalings ride as Fq2 lanes with zero
imaginary parts) and the same BLS12 x-chain final exponentiation,
computing f^(3 * (p^12 - 1) / r) — the same is-one verdicts.

The loops run over the static bits of |x| in Python: where a Miller bit is
0 the add step is skipped outright (the JAX scan computes it and selects
it away, so both give the same f).
"""

from __future__ import annotations

import torch

from ..crypto.bls.fields import BLS_X
from . import tower as tw
from .fused_core import LV, const_tensor, f2_mul, ladd, lcast, lconcat, ldbl, lneg, lstack, lsub, lv
from .fused_field import (
    const_like,
    f12_conj,
    f12_cyc_sqr,
    f12_frobenius,
    f12_inv,
    f12_mul,
    f12_select,
    f12_sqr,
)
from .fused_points import COORD_B, Point
from .pairing import _X_BITS, _X_WINDOWS

# loop-carry digit-bound contract for Fq12 values (f12_mul peaks ~11k)
F12_B = 16384


def _lanes(m: LV, k: int):
    return [LV(m.a[..., i, :, :], m.b) for i in range(k)]


def _line_lv(c0: LV, c1: LV, c2: LV) -> LV:
    """Sparse line (c0 + c1 v) + (c2 v) w as a flat Fq12: [c0, c1, 0, 0, c2, 0]."""
    zero = LV(torch.zeros_like(c0.a), 1)
    return lstack([c0, c1, zero, zero, c2, zero], axis=-3)


def _embed_fq(s: LV) -> LV:
    """Fq element (..., 50) as the Fq2 lane (s, 0)."""
    return lstack([s, LV(torch.zeros_like(s.a), 1)], axis=-2)


def _dbl_step(t: Point, xp: LV, yp: LV):
    """Tangent line + point double: 3 kernel calls.  Line scaled by 2YZ^3:
    c0 = 3X^3 - 2Y^2, c1 = -3X^2 Z^2 xp, c2 = 2YZ^3 yp."""
    x, y, z = t
    x2, y2, z2, yz = _lanes(f2_mul(lstack([x, y, z, y], -3), lstack([x, y, z, z], -3)), 4)
    e = ladd(ladd(x2, x2), x2)  # 3X^2
    xbb = ladd(x, y2)
    x3_3, c1r, yz3, xbb2, c, f = _lanes(
        f2_mul(lstack([e, e, yz, xbb, y2, e], -3), lstack([x, z2, z2, xbb, y2, e], -3)), 6
    )
    c0 = lsub(x3_3, ldbl(y2))
    d = ldbl(lsub(xbb2, ladd(x2, c)))
    x3 = lsub(f, ldbl(d))
    c8 = ldbl(ldbl(ldbl(c)))
    ed, c1, c2 = _lanes(
        f2_mul(
            lstack([lsub(d, x3), _embed_fq(xp), _embed_fq(yp)], -3),
            lstack([e, lneg(c1r), ldbl(yz3)], -3),
        ),
        3,
    )
    return (x3, lsub(ed, c8), ldbl(yz)), _line_lv(c0, c1, c2)


def _add_step(t: Point, xq: LV, yq: LV, xp: LV, yp: LV):
    """Line through T and the affine point Q at P, scaled by Z*H, plus the
    mixed add T+Q: 6 kernel calls."""
    x, y, z = t
    (zz,) = _lanes(f2_mul(lstack([z], -3), lstack([z], -3)), 1)
    u2, zzz = _lanes(f2_mul(lstack([xq, zz], -3), lstack([zz, z], -3)), 2)
    (s2,) = _lanes(f2_mul(lstack([yq], -3), lstack([zzz], -3)), 1)
    theta = lsub(y, s2)
    h = lsub(x, u2)
    hm = lsub(u2, x)
    rm = ldbl(lsub(s2, y))
    zh, theta_xq, hh, r2, zh_m = _lanes(
        f2_mul(lstack([z, theta, hm, rm, z], -3), lstack([h, xq, hm, rm, hm], -3)), 5
    )
    ii = ladd(ldbl(hh), ldbl(hh))  # 4 HH
    yq_zh, c1, c2, j, v = _lanes(
        f2_mul(
            lstack([yq, _embed_fq(xp), _embed_fq(yp), hm, x], -3),
            lstack([zh, lneg(theta), zh, ii, ii], -3),
        ),
        5,
    )
    c0 = lsub(theta_xq, yq_zh)
    x3 = lsub(r2, ladd(j, ldbl(v)))
    rvx, yj = _lanes(f2_mul(lstack([rm, y], -3), lstack([lsub(v, x3), j], -3)), 2)
    return (x3, lsub(rvx, ldbl(yj)), ldbl(zh_m)), _line_lv(c0, c1, c2)


def miller_loop(xp: LV, yp: LV, xq: LV, yq: LV) -> LV:
    """f_{|z|, Q}(P), conjugated for the negative BLS parameter."""
    dev = xp.a.device
    f = lv(const_tensor(tw.FQ12_ONE, dev).expand(tuple(xp.a.shape[:-1]) + (6, 2, 50)), F12_B)
    xqc, yqc = lcast(xq, COORD_B), lcast(yq, COORD_B)
    t = (xqc, yqc, lv(const_like(tw.FQ2_ONE, xq.a), COORD_B))
    for bit in _X_BITS:
        f = f12_sqr(f)
        t, line = _dbl_step(t, xp, yp)
        f = f12_mul(f, line)
        if bit:
            t, line2 = _add_step(t, xqc, yqc, xp, yp)
            f = f12_mul(f, line2)
        # back to the loop contracts (raises if a bound outgrew them)
        f = lcast(f, F12_B)
        t = tuple(lcast(c, COORD_B) for c in t)
    return f12_conj(f)


def _pow_x_abs(f: LV) -> LV:
    """f^|BLS_X| by the 2-bit-windowed cyclotomic loop: 3 kernel calls a
    window.  Returns the body's own output bound (not the loop contract)."""
    one = lv(const_like(tw.FQ12_ONE, f.a))
    f2c = f12_cyc_sqr(f)
    table = lstack([one, f, f2c, f12_mul(f2c, f)], axis=0)
    r = one
    for w in _X_WINDOWS:
        r = f12_cyc_sqr(f12_cyc_sqr(LV(r.a, F12_B)))
        r = f12_mul(r, LV(table.a[int(w)], table.b))
        if r.b > F12_B:
            raise ValueError(f"pow-by-x bound {r.b} exceeds the loop contract {F12_B}")
    return r


def _pow_x(f: LV) -> LV:
    out = _pow_x_abs(f)
    return f12_conj(out) if BLS_X < 0 else out


def final_exponentiation(f: LV) -> LV:
    """f^(3 * (p^12 - 1) / r) by the x-chain."""
    f1 = f12_mul(f12_conj(f), f12_inv(f))
    m = f12_mul(f12_frobenius(f12_frobenius(f1)), f1)
    y0 = f12_mul(_pow_x(m), f12_conj(m))
    y1 = f12_mul(_pow_x(y0), f12_conj(y0))
    y2 = f12_mul(_pow_x(y1), f12_frobenius(y1))
    y3 = f12_mul(
        f12_mul(_pow_x(_pow_x(y2)), f12_frobenius(f12_frobenius(y2))),
        f12_conj(y2),
    )
    m2 = f12_cyc_sqr(m)
    return f12_mul(y3, f12_mul(m2, m))


def f12_product_tree(f: LV) -> LV:
    """Product over the leading axis: pad to a power of two with FQ12_ONE
    rows, then pairwise products."""
    n = f.a.shape[0]
    npow = 1 << max(0, (n - 1).bit_length())
    if npow != n:
        pad = const_tensor(tw.FQ12_ONE, f.a.device).expand((npow - n,) + tuple(f.a.shape[1:]))
        f = lconcat([f, LV(pad, 256)], axis=0)
    while f.a.shape[0] > 1:
        half = f.a.shape[0] // 2
        f = f12_mul(LV(f.a[:half], f.b), LV(f.a[half:], f.b))
    return LV(f.a[0], f.b)


def multi_miller_product(xp, yp, xq, yq, mask: torch.Tensor) -> LV:
    """prod_i f_i over the leading batch axis, masked entries contributing 1."""
    f = miller_loop(xp, yp, xq, yq)
    f = f12_select(mask, f, lv(const_like(tw.FQ12_ONE, f.a)))
    return f12_product_tree(f)

