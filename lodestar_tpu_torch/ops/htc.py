"""Hash-to-G2: the host stage and the XLA-graph path's device stage.

The port of ``lodestar_tpu/ops/htc.py``.  The host does expand_message_xmd
(sha256) and hash_to_field (``hash_to_field_limbs``); the device stage
(``hash_to_g2_device``) is the branchless SSWU map with both arms computed
and selected per lane, the 3-isogeny to E2 and Budroni-Pintore cofactor
clearing.  (The fused path's device stage is ``fused_htc``.)  Constants
come from the port's oracle (``crypto/bls/hash_to_curve.py``).

The JAX static-exponent scans are Python loops over the exponent's bits;
a bit of 0 skips the product the scan computes and then discards.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..crypto.bls import hash_to_curve as H
from ..crypto.bls.fields import P as P_INT
from . import limbs as fl
from . import tower as tw
from .limbs import const_tensor, fp_add, fp_strict
from .points import FQ2_NS, Point, g2_clear_cofactor, point_add_complete

ISO_A = tw.fq2_const(H.ISO_A)
ISO_B = tw.fq2_const(H.ISO_B)
SSWU_Z = tw.fq2_const(H.SSWU_Z)
NEG_B_OVER_A = tw.fq2_const(-H.ISO_B * H.ISO_A.inv())
B_OVER_ZA = tw.fq2_const(H.ISO_B * (H.SSWU_Z * H.ISO_A).inv())
MINUS_ONE_FQ2 = tw.fq2_const(H.Fq2(P_INT - 1, 0))
P_MINUS_1 = fl.int_to_limbs(P_INT - 1)

K1 = [tw.fq2_const(c) for c in H._K1]  # x_num, degree 3
K2 = [tw.fq2_const(c) for c in H._K2]  # x_den, degree 2 monic
K3 = [tw.fq2_const(c) for c in H._K3]  # y_num, degree 3
K4 = [tw.fq2_const(c) for c in H._K4]  # y_den, degree 3 monic


# ---------------------------------------------------------------------------
# host: messages -> field element digit arrays
# ---------------------------------------------------------------------------


def hash_to_field_limbs(msgs: List[bytes], dst: bytes = H.DST_G2) -> np.ndarray:
    """sha256 expand + reduce for each message, packed as (N, 2, 2, 50):
    two Fq2 draws per message."""
    out = np.zeros((len(msgs), 2, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
    for i, m in enumerate(msgs):
        u0, u1 = H.hash_to_field_fq2(m, 2, dst)
        out[i, 0] = tw.fq2_const(u0)
        out[i, 1] = tw.fq2_const(u1)
    return out


# ---------------------------------------------------------------------------
# device: Fq2 sqrt / is_square
# ---------------------------------------------------------------------------


def _like(arr: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """A constant broadcast to x's shape on x's device."""
    return const_tensor(arr, x.device).expand(x.shape)


def fq2_is_square(a: torch.Tensor) -> torch.Tensor:
    """Legendre via the norm: a square in Fq2 iff (c0^2+c1^2)^((p-1)/2) != -1."""
    sq = fl.fp_mul(a, a)
    norm = fp_strict(fp_add(sq[..., 0, :], sq[..., 1, :]))
    chi = fl.fp_pow_static(norm, (P_INT - 1) // 2)
    return ~(fl.fp_reduce_full(chi) == const_tensor(P_MINUS_1, a.device)).all(-1)


def _fq2_pow_static(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e in Fq2 for a static exponent: square, then multiply where the
    bit (MSB first) is set."""
    r = _like(tw.FQ2_ONE, a)
    for bit in bin(e)[2:]:
        r = tw.fq2_sqr(r)
        if bit == "1":
            r = tw.fq2_mul(r, a)
    return r


def fq2_sqrt(a: torch.Tensor) -> torch.Tensor:
    """Square root for p % 4 == 3 (oracle Fq2.sqrt, branchless); the
    square is a when a is a square (callers guarantee it)."""
    a1 = _fq2_pow_static(a, (P_INT - 3) // 4)
    m = tw.fq2_mul_many(torch.stack([a1, a1], -3), torch.stack([a1, a], -3))
    a1sq, x0 = m[..., 0, :, :], m[..., 1, :, :]
    alpha = tw.fq2_mul(a1sq, a)
    is_neg1 = tw.fq2_eq(alpha, _like(MINUS_ONE_FQ2, alpha))
    # branch A: i * x0 = (-x0.c1, x0.c0)
    cand_a = torch.stack([fl.fp_neg(x0[..., 1, :]), x0[..., 0, :]], -2)
    # branch B: (alpha + 1)^((p-1)/2) * x0
    b = _fq2_pow_static(fp_strict(fp_add(alpha, _like(tw.FQ2_ONE, alpha))), (P_INT - 1) // 2)
    cand_b = tw.fq2_mul(b, x0)
    return torch.where(is_neg1[..., None, None], cand_a, cand_b)


def fq2_sgn0(a: torch.Tensor) -> torch.Tensor:
    """RFC 9380 sgn0 for m = 2: parity of c0, or of c1 when c0 == 0, on
    the canonical residues (both components in one reduction)."""
    r = fl.fp_reduce_full(a)
    r0, r1 = r[..., 0, :], r[..., 1, :]
    sign0 = (r0[..., 0] % 2) == 1
    zero0 = (r0 == 0).all(-1)
    sign1 = (r1[..., 0] % 2) == 1
    return sign0 | (zero0 & sign1)


# ---------------------------------------------------------------------------
# device: SSWU + isogeny
# ---------------------------------------------------------------------------


def _gprime(x: torch.Tensor) -> torch.Tensor:
    """g'(x) = x^3 + A'x + B' on E'."""
    x2 = tw.fq2_sqr(x)
    m = tw.fq2_mul_many(torch.stack([x2, x], -3), torch.stack([x, _like(ISO_A, x)], -3))
    x3, ax = m[..., 0, :, :], m[..., 1, :, :]
    return fp_strict(fp_add(fp_add(x3, ax), _like(ISO_B, x)))


def map_to_curve_sswu(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simplified SWU onto E' (select-based)."""
    z = _like(SSWU_Z, u)
    u2 = tw.fq2_sqr(u)
    m1 = tw.fq2_mul_many(torch.stack([u2, u2], -3), torch.stack([u2, z], -3))
    u4, zu2 = m1[..., 0, :, :], m1[..., 1, :, :]
    z2u4 = tw.fq2_mul(u4, tw.fq2_sqr(z))
    tv1 = fp_strict(fp_add(z2u4, zu2))
    tv1_zero = tw.fq2_is_zero(tv1)
    # regular arm: x1 = (-B/A) * (1 + 1/tv1)
    tv1_inv = tw.fq2_inv(tv1)
    x1_reg = tw.fq2_mul(_like(NEG_B_OVER_A, u), fp_strict(fp_add(_like(tw.FQ2_ONE, u), tv1_inv)))
    # exceptional arm: x1 = B / (Z*A)
    x1 = torch.where(tv1_zero[..., None, None], _like(B_OVER_ZA, u), x1_reg)
    gx1 = _gprime(x1)
    square1 = fq2_is_square(gx1)
    x2 = tw.fq2_mul(zu2, x1)
    gx2 = _gprime(x2)
    x = torch.where(square1[..., None, None], x1, x2)
    gx = torch.where(square1[..., None, None], gx1, gx2)
    y = fq2_sqrt(gx)
    # sign correction: sgn0(y) must equal sgn0(u)
    flip = fq2_sgn0(u) != fq2_sgn0(y)
    return x, torch.where(flip[..., None, None], fl.fp_neg(y), y)


def _eval_poly(coeffs, x: torch.Tensor) -> torch.Tensor:
    """Horner with constant Fq2 coefficients."""
    acc = _like(coeffs[-1], x)
    for c in reversed(coeffs[:-1]):
        acc = fp_strict(fp_add(tw.fq2_mul(acc, x), _like(c, x)))
    return acc


def iso_map(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-isogeny E' -> E2 with one shared inversion, 1/(x_den * y_den)."""
    x_num = _eval_poly(K1, x)
    x_den = _eval_poly(K2, x)
    y_num = _eval_poly(K3, x)
    y_den = _eval_poly(K4, x)
    dinv = tw.fq2_inv(tw.fq2_mul(x_den, y_den))
    m2 = tw.fq2_mul_many(torch.stack([x_num, y_num], -3), torch.stack([y_den, x_den], -3))
    m3 = tw.fq2_mul_many(m2, torch.stack([dinv, dinv], -3))
    return m3[..., 0, :, :], tw.fq2_mul(y, m3[..., 1, :, :])


def map_to_curve_g2(u: torch.Tensor) -> Point:
    """SSWU + isogeny -> jacobian point on E2 (z = 1)."""
    xm, ym = iso_map(*map_to_curve_sswu(u))
    return (xm, ym, _like(tw.FQ2_ONE, xm))


def hash_to_g2_device(u: torch.Tensor) -> Point:
    """Device stage of hash_to_g2: u (..., 2, 2, 50), the two Fq2 draws
    per message.  Both draws go through SSWU + isogeny in one stacked call,
    are added (complete add: adversarial messages could collide the two
    maps), and the cofactor is cleared."""
    q = map_to_curve_g2(torch.stack([u[..., 0, :, :], u[..., 1, :, :]], 0))
    q0 = tuple(c[0] for c in q)
    q1 = tuple(c[1] for c in q)
    return g2_clear_cofactor(point_add_complete(q0, q1, FQ2_NS))
