"""Fused G2 ladder iteration: the complete double-and-add step in three
kernels plus one canonical reduction.

The port of ``lodestar_tpu/ops/fused_ladder.py``.  The same formulas as
fused_points.point_add_complete / point_double, re-partitioned into three
multiply-round kernels whose glue (sums, doublings, subtraction pads) runs
inside the kernel:

  lad1: round-1 products  (z1^2, z2^2; x^2, y^2, y*z of both doublings)
  lad2: round-2 products  (u/s cross terms; (x+y^2)^2, c, f of both
        doublings) and the doubling glue to e, x3, d - x3, 8c
  lad3: rounds 3-6        (the rest of the add; y3/z3 of both doublings)

Every kernel output is semi-strict, so the loop carry is bound-stable.
"""

from __future__ import annotations

import torch

from .fused_core import (
    Kernel,
    f_canon,
    f_fold,
    lv,
    m_add,
    m_fold,
    m_fq2_mul,
    m_fq2_sqr,
    m_sub,
)
from .fused_points import FNS, Point, point_infinity, point_select

NL = 50


# -- plain versions of the three round kernels (int64 (N, 2, 50) rows) -------


def _scale(a, k: int, c, bits: int = 10):
    return m_fold(k * a, c, bits)


def _lad1_plain(c, x1, y1, z1, x2, y2, z2):
    x1, y1, z1, x2, y2, z2 = (m_fold(v, c) for v in (x1, y1, z1, x2, y2, z2))
    return (
        m_fq2_sqr(z1, c), m_fq2_sqr(z2, c),
        m_fq2_sqr(x1, c), m_fq2_sqr(y1, c), m_fq2_mul(y1, z1, c),
        m_fq2_sqr(x2, c), m_fq2_sqr(y2, c), m_fq2_mul(y2, z2, c),
    )


def _lad2_plain(c, x1, y1, x2, y2, z1z1, z2z2, a1, bb1, a2, bb2):
    x1, y1, x2, y2 = (m_fold(v, c) for v in (x1, y1, x2, y2))
    outs = [
        m_fq2_mul(x1, z2z2, c), m_fq2_mul(x2, z1z1, c),
        m_fq2_mul(y1, z2z2, c), m_fq2_mul(y2, z1z1, c),
    ]
    for a, bb, x in ((a1, bb1, x1), (a2, bb2, x2)):
        e = _scale(a, 3, c)
        xbb2 = m_fq2_sqr(m_add(x, bb, c), c)
        cc = m_fq2_sqr(bb, c)
        f = m_fq2_sqr(e, c)
        d = _scale(m_sub(xbb2, m_add(a, cc, c), c), 2, c)
        x3 = m_sub(f, _scale(d, 2, c), c)
        outs += [e, x3, m_sub(d, x3, c), _scale(cc, 8, c, 12)]
    return tuple(outs)


def _lad3_plain(c, z1, z2, u1, u2, s1y, s2y, z1z1, z2z2,
                e1, dmx1, c81, yz1, e2, dmx2, c82, yz2):
    z1, z2 = m_fold(z1, c), m_fold(z2, c)
    s1f = m_fq2_mul(s1y, z2, c)
    s2f = m_fq2_mul(s2y, z1, c)
    h = m_sub(u2, u1, c)
    sd = m_sub(s2f, s1f, c)
    r = _scale(sd, 2, c)
    i = m_fq2_sqr(_scale(h, 2, c), c)
    r2 = m_fq2_sqr(r, c)
    zsum2 = m_fq2_sqr(m_add(z1, z2, c), c)
    j = m_fq2_mul(h, i, c)
    v = m_fq2_mul(u1, i, c)
    x3 = m_sub(r2, m_fold(j + v + v, c, 10), c)
    rvx = m_fq2_mul(r, m_sub(v, x3, c), c)
    s1j = m_fq2_mul(s1f, j, c)
    z3 = m_fq2_mul(m_sub(zsum2, m_add(z1z1, z2z2, c), c), h, c)
    y3 = m_sub(rvx, _scale(s1j, 2, c), c)
    outs = [x3, y3, z3, h, sd]
    for e, dmx, c8, yz in ((e1, dmx1, c81, yz1), (e2, dmx2, c82, yz2)):
        outs += [m_sub(m_fq2_mul(e, dmx, c), c8, c), _scale(yz, 2, c)]
    return tuple(outs)


_T2 = (2, NL)
_SRC = "lodestar_tpu/ops/fused_ladder.py"
K_LAD1 = Kernel("lad1", f"{_SRC}:86", 6, 8, _T2, _lad1_plain, loose_in=6)
K_LAD2 = Kernel("lad2", f"{_SRC}:106", 10, 12, _T2, _lad2_plain, loose_in=4)
K_LAD3 = Kernel("lad3", f"{_SRC}:153", 16, 9, _T2, _lad3_plain, loose_in=2)


def _ladder_step(acc, addend, bit: torch.Tensor, ns: FNS):
    """(acc', addend') for one complete double-and-add iteration: the
    three round kernels, one stacked canonical reduction for the
    predicates, then the select chain of point_add_complete."""
    x1, y1, z1 = acc
    x2, y2, z2 = addend
    z1z1, z2z2, a1, bb1, yz1, a2, bb2, yz2 = K_LAD1(x1, y1, z1, x2, y2, z2)
    u1, u2, s1y, s2y, e1, x3d1, dmx1, c81, e2, x3d2, dmx2, c82 = K_LAD2(
        x1, y1, x2, y2, z1z1, z2z2, a1, bb1, a2, bb2
    )
    x3, y3, z3, h, sd, y3d1, z3d1, y3d2, z3d2 = K_LAD3(
        z1, z2, u1, u2, s1y, s2y, z1z1, z2z2, e1, dmx1, c81, yz1, e2, dmx2, c82, yz2
    )

    # predicates: one stacked canonical reduction (z1, z2, h, sdiff, y1)
    zeros = (f_canon(lv(torch.stack([z1, z2, h, sd, y1], dim=0))) == 0).flatten(-2).all(-1)
    p_inf, q_inf, eq_x, eq_y, y1_zero = zeros.unbind(0)

    p = (lv(x1), lv(y1), lv(z1))  # every kernel output is semi-strict
    q = (lv(x2), lv(y2), lv(z2))
    inf = point_infinity(ns, p_inf.shape, p_inf.device)
    dbl = point_select(y1_zero | p_inf, inf, (lv(x3d1), lv(y3d1), lv(z3d1)), ns)
    out = (lv(x3), lv(y3), lv(z3))
    out = point_select(eq_x & ~eq_y & ~p_inf & ~q_inf, inf, out, ns)
    out = point_select(eq_x & eq_y & ~p_inf & ~q_inf, dbl, out, ns)
    out = point_select(q_inf, p, out, ns)
    out = point_select(p_inf, q, out, ns)
    acc_next = point_select(bit, out, p, ns)
    return tuple(c.a.contiguous() for c in acc_next), (x3d2, y3d2, z3d2)


def point_mul_bits_ladder(p: Point, bits: torch.Tensor, ns: FNS) -> Point:
    """[k]P over the fused complete ladder (Fq2 only); bits (..., NBITS)
    LSB-first.  The kernels run over a flat row axis, so leading lane/set
    axes (the merged 4-lane ladder's (4, N)) are collapsed first."""
    if ns.comp_ndim != 2:
        raise ValueError("the fused ladder is the G2 path")
    nbits = bits.shape[-1]
    lead = tuple(bits.shape[:-1])
    bits_f = bits.reshape(-1, nbits).bool()
    acc = tuple(
        c.a.contiguous() for c in point_infinity(ns, (bits_f.shape[0],), bits.device)
    )
    # entry coordinates may carry loose bounds; one fold normalizes them
    addend = tuple(
        f_fold(c).a.expand(lead + (2, NL)).reshape(-1, 2, NL).contiguous() for c in p
    )
    for i in range(nbits):
        acc, addend = _ladder_step(acc, addend, bits_f[:, i], ns)
    return tuple(lv(a.reshape(lead + (2, NL))) for a in acc)
