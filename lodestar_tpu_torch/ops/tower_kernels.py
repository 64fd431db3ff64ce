"""The XLA-graph path's four tower kernels: Fq2, Fq6 and Fq12 products.

The port of ``lodestar_tpu/ops/pallas_tower.py``.  Each product is one
hand-written CUDA kernel (``kernels/tower_kernels.cu``, cooperative block
bodies in ``kernels/tower_coop.cuh``) behind a ``fused_core.Kernel``
wrapper, registered in the same ``KERNELS`` dict as the fused path's ten:
a CPU tensor takes the plain version here, a CUDA tensor the kernel,
anything else raises.

Inputs and outputs are semi-strict float32 digits (<= 256): (N, 2, 50)
for Fq2, (N, 3, 2, 50) for Fq6, (N, 6, 2, 50) flat Fq12.  The plain
versions reproduce the Pallas bodies step by step in int64.  Pallas's
field helpers are fused_core's plain steps: ``k_fp_mul`` is ``m_mul``
(schoolbook, then ``_fold50`` at bound 22), ``k_fp_add`` is ``m_add``
(bound 10) and ``k_fp_sub`` is ``m_sub`` (the bias-2^12 SUBPAD, bound 13),
with the same RED table; ``_fold50``'s closing carry at bound 23 runs the
same 3 passes over the same 52 columns as ``m_fold``'s at bound 22.  On
top of them: the Karatsuba Fq2 product with every sum folded, the Toom
Fq6 product and the Karatsuba-over-Fq6 Fq12 product.  Rows are
independent, so the plain versions stack the lanes of one step into one
call; the digits are the Pallas kernels' bitwise.
"""

from __future__ import annotations

import torch

from .fused_core import NL, Kernel, _C
from .fused_core import m_add as k_fp_add
from .fused_core import m_mul as k_fp_mul
from .fused_core import m_sub as k_fp_sub


def _comp(x, i: int):
    """Fq2 component i of (..., 2, 50)."""
    return x[..., i, :]


def _pick(x, idx):
    """Fq2 components idx of (..., K, 2, 50), stacked (no index tensor: the
    plain versions also run inside CUDA-graph capture)."""
    return torch.stack([x[..., i, :, :] for i in idx], -3)


def k_fq2_mul(a, b, c: _C):
    """Karatsuba: (t0 - t1) + ((a0 + a1)(b0 + b1) - (t0 + t1)) u."""
    t01 = k_fp_mul(a, b, c)
    s = k_fp_add(torch.stack([_comp(a, 0), _comp(b, 0)], -2),
                 torch.stack([_comp(a, 1), _comp(b, 1)], -2), c)
    t2 = k_fp_mul(_comp(s, 0), _comp(s, 1), c)
    t0, t1 = _comp(t01, 0), _comp(t01, 1)
    return k_fp_sub(torch.stack([t0, t2], -2), torch.stack([t1, k_fp_add(t0, t1, c)], -2), c)


def k_fq2_sqr(a, c: _C):
    """(a0 + a1)(a0 - a1) + 2 a0 a1 u."""
    a0, a1 = _comp(a, 0), _comp(a, 1)
    m = k_fp_mul(torch.stack([k_fp_add(a0, a1, c), a0], -2),
                 torch.stack([k_fp_sub(a0, a1, c), a1], -2), c)
    return torch.stack([_comp(m, 0), k_fp_add(_comp(m, 1), _comp(m, 1), c)], -2)


def k_fq2_mul_by_xi(a, c: _C):
    """(1 + u)(c0 + c1 u) = (c0 - c1) + (c0 + c1) u."""
    a0, a1 = _comp(a, 0), _comp(a, 1)
    return torch.stack([k_fp_sub(a0, a1, c), k_fp_add(a0, a1, c)], -2)


def k_fq6_mul(A, B, c: _C):
    """Toom Fq6 product on (..., 3, 2, 50): six Karatsubas [a0b0, a1b1,
    a2b2, (a1+a2)(b1+b2), (a0+a1)(b0+b1), (a0+a2)(b0+b2)], then
    c0 = t0 + xi(t3 - (t1 + t2)), c1 = (t4 - (t0 + t1)) + xi t2,
    c2 = (t5 - (t0 + t2)) + t1."""
    lo, hi = [1, 0, 0], [2, 1, 2]
    sa = k_fp_add(_pick(A, lo), _pick(A, hi), c)
    sb = k_fp_add(_pick(B, lo), _pick(B, hi), c)
    t = k_fq2_mul(torch.cat([A, sa], -3), torch.cat([B, sb], -3), c)
    u = k_fp_add(_pick(t, lo), _pick(t, hi), c)  # t1+t2, t0+t1, t0+t2
    v = k_fp_sub(t[..., 3:, :, :], u, c)
    x = k_fq2_mul_by_xi(torch.stack([v[..., 0, :, :], t[..., 2, :, :]], -3), c)
    left = torch.stack([t[..., 0, :, :], v[..., 1, :, :], v[..., 2, :, :]], -3)
    right = torch.stack([x[..., 0, :, :], x[..., 1, :, :], t[..., 1, :, :]], -3)
    return k_fp_add(left, right, c)


def k_fq12_mul(A, B, c: _C):
    """Karatsuba over Fq6 on flat (..., 6, 2, 50): T0 = a0 b0, T1 = a1 b1,
    T3 = (a0 + a1)(b0 + b1); C0 = T0 + v T1, C1 = T3 - (T0 + T1), with
    v (x0, x1, x2) = (xi x2, x0, x1)."""
    a0, a1, b0, b1 = A[..., :3, :, :], A[..., 3:, :, :], B[..., :3, :, :], B[..., 3:, :, :]
    sa = k_fp_add(a0, a1, c)
    sb = k_fp_add(b0, b1, c)
    T = k_fq6_mul(torch.stack([a0, a1, sa], -4), torch.stack([b0, b1, sb], -4), c)
    t0, t1, t3 = T[..., 0, :, :, :], T[..., 1, :, :, :], T[..., 2, :, :, :]
    vt1 = torch.stack([k_fq2_mul_by_xi(t1[..., 2, :, :], c), t1[..., 0, :, :], t1[..., 1, :, :]], -3)
    c0 = k_fp_add(t0, vt1, c)
    c1 = k_fp_sub(t3, k_fp_add(t0, t1, c), c)
    return torch.cat([c0, c1], -3)


def _fq2_mul_plain(c, a, b):
    return (k_fq2_mul(a, b, c),)


def _fq2_sqr_plain(c, a):
    return (k_fq2_sqr(a, c),)


def _fq6_mul_plain(c, a, b):
    return (k_fq6_mul(a, b, c),)


def _fq12_mul_plain(c, a, b):
    return (k_fq12_mul(a, b, c),)


_SRC = "lodestar_tpu/ops/pallas_tower.py"
K_FQ2_MUL = Kernel("tower_fq2_mul", f"{_SRC}:152", 2, 1, (2, NL), _fq2_mul_plain, loose_in=0)
K_FQ2_SQR = Kernel("tower_fq2_sqr", f"{_SRC}:163", 1, 1, (2, NL), _fq2_sqr_plain, loose_in=0)
K_FQ6_MUL = Kernel("tower_fq6_mul", f"{_SRC}:206", 2, 1, (3, 2, NL), _fq6_mul_plain, loose_in=0)
K_FQ12_MUL = Kernel("tower_fq12_mul", f"{_SRC}:217", 2, 1, (6, 2, NL), _fq12_mul_plain,
                    loose_in=0)
TOWER_KERNELS = (K_FQ2_MUL, K_FQ2_SQR, K_FQ6_MUL, K_FQ12_MUL)


def call_rows(kernel: Kernel, *xs: torch.Tensor) -> torch.Tensor:
    """One kernel call over every row of the broadcast inputs: (..., *tail)
    -> contiguous (N, *tail) rows -> the output back in (..., *tail)."""
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    tail = len(kernel.tail)
    rows = [x.expand(shape).reshape((-1,) + tuple(shape[-tail:])).contiguous() for x in xs]
    (out,) = kernel(*rows)
    return out.reshape(shape)
