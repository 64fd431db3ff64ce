"""Device hash-to-G2 (SSWU + 3-isogeny) over the fused kernel core.

The port of ``lodestar_tpu/ops/fused_htc.py``; the host stage (sha256
expand and hash_to_field) is ``htc.hash_to_field_limbs``.  Both gprime
evaluations ride the same lane-stacked calls, both Legendre tests share
one windowed chi exponentiation, and cofactor clearing is left to the
merged G2 ladder of fused_verify.
"""

from __future__ import annotations

import numpy as np

from . import tower as tw
from .fused_core import LV, f2_mul, f2_sqr, f_canon, f_mul, ladd, lselect, lstack, lv
from .fused_field import (
    P_MINUS_1,
    _WIN_CHI,
    const_like,
    f2_inv,
    f2_sgn0,
    f2_sqrt,
    fi_pow_windows,
    lc,
    lneg,
)
from .fused_points import Point, fq2_ns, point_add_complete
from .htc import B_OVER_ZA, ISO_A, ISO_B, K1, K2, K3, K4, NEG_B_OVER_A, SSWU_Z


def _const(arr: np.ndarray, like: LV) -> LV:
    return lv(const_like(arr, like.a))


def _lanes(m: LV, k: int, start: int = 0):
    return [LV(m.a[..., start + i, :, :], m.b) for i in range(k)]


def _gprime_lanes(xs):
    """g'(x) = x^3 + A'x + B' for a list of x lanes — 2 lane-stacked calls."""
    k = len(xs)
    sq, _ = f2_sqr(lstack(xs, -3))
    x2s = _lanes(sq, k)
    a_c = _const(ISO_A, xs[0])
    m = f2_mul(lstack(x2s + xs, -3), lstack(xs + [a_c] * k, -3))
    b_c = _const(ISO_B, xs[0])
    return [ladd(ladd(x3, ax), b_c) for x3, ax in zip(_lanes(m, k), _lanes(m, k, k))]


def map_to_curve_sswu(u: LV):
    """Simplified SWU onto E', branchless (both arms computed, then selected)."""
    z = _const(SSWU_Z, u)
    u2, _ = f2_sqr(u)
    u4, zu2 = _lanes(f2_mul(lstack([u2, u2], -3), lstack([u2, z], -3)), 2)
    z2 = f2_mul(z, z)
    (z2u4,) = _lanes(f2_mul(lstack([u4], -3), lstack([z2], -3)), 1)
    tv1 = ladd(z2u4, zu2)
    tv1_zero = (f_canon(tv1) == 0).flatten(-2).all(-1)
    tv1_inv = f2_inv(tv1)
    one = _const(tw.FQ2_ONE, u)
    x1_reg = f2_mul(_const(NEG_B_OVER_A, u), ladd(one, tv1_inv))
    x1 = lselect(tv1_zero, _const(B_OVER_ZA, u), x1_reg)
    x2 = f2_mul(zu2, x1)
    gx1, gx2 = _gprime_lanes([x1, x2])
    # one shared chi exponentiation for both Legendre tests
    pair = lstack([gx1, gx2], -3)
    p0, p1 = lc(pair, 0), lc(pair, 1)
    compsq = f_mul(lstack([p0, p1], -2), lstack([p0, p1], -2))
    norm = ladd(LV(compsq.a[..., 0, :], compsq.b), LV(compsq.a[..., 1, :], compsq.b))
    chi = fi_pow_windows(norm, _WIN_CHI)
    not_sq = (f_canon(chi) == const_like(P_MINUS_1, chi.a)).all(-1)
    square1 = ~not_sq[..., 0]
    x = lselect(square1, x1, x2)
    gx = lselect(square1, gx1, gx2)
    y = f2_sqrt(gx)
    flip = f2_sgn0(u) != f2_sgn0(y)
    return x, lselect(flip, lneg(y), y)


def _eval_polys(x: LV):
    """All four isogeny polynomials by joint Horner over lane-stacked
    multiplies; K2 (one degree shorter) joins one round late."""
    deg4 = [K1, K3, K4]  # 4 coefficients each
    acc = [_const(k[-1], x) for k in deg4]
    acc2 = _const(K2[-1], x)
    started2 = False
    for step in (2, 1, 0):
        lanes = acc + ([acc2] if started2 or step <= 1 else [])
        if not started2 and step <= 1:
            started2 = True
        st = lstack(lanes, -3)
        outs = _lanes(f2_mul(st, LV(x.a[..., None, :, :].expand(st.a.shape), x.b)), len(lanes))
        acc = [ladd(outs[i], _const(deg4[i][step], x)) for i in range(3)]
        if len(outs) > 3:
            acc2 = ladd(outs[3], _const(K2[step], x))
    return acc[0], acc2, acc[1], acc[2]  # x_num, x_den, y_num, y_den


def iso_map(x: LV, y: LV):
    """3-isogeny E' -> E2 with one shared inversion."""
    x_num, x_den, y_num, y_den = _eval_polys(x)
    (den,) = _lanes(f2_mul(lstack([x_den], -3), lstack([y_den], -3)), 1)
    dinv = f2_inv(den)
    m2 = f2_mul(lstack([x_num, y_num], -3), lstack([y_den, x_den], -3))
    xn_yd, yn_xd = _lanes(m2, 2)
    m3 = f2_mul(lstack([xn_yd, yn_xd], -3), LV(dinv.a[..., None, :, :].expand(m2.a.shape), dinv.b))
    xm, ym_part = _lanes(m3, 2)
    (ym,) = _lanes(f2_mul(lstack([y], -3), lstack([ym_part], -3)), 1)
    return xm, ym


def map_to_curve_g2(u: LV) -> Point:
    x, y = map_to_curve_sswu(u)
    xm, ym = iso_map(x, y)
    return (xm, ym, _const(tw.FQ2_ONE, xm))


def hash_to_g2_pre_cofactor(u: LV) -> Point:
    """Device stage up to (not including) cofactor clearing: both field
    draws through SSWU + isogeny in one stacked pass, then a complete add.

    u: (..., 2, 2, 50) — two Fq2 draws per message."""
    both = lstack([LV(u.a[..., 0, :, :], u.b), LV(u.a[..., 1, :, :], u.b)], axis=0)
    q = map_to_curve_g2(both)
    q0 = tuple(LV(c.a[0], c.b) for c in q)
    q1 = tuple(LV(c.a[1], c.b) for c in q)
    return point_add_complete(q0, q1, fq2_ns())
