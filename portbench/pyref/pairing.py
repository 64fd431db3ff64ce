"""Optimal ate pairing on BLS12-381.

e(P, Q) for P in G1 (over Fq), Q in G2 (on the twist, over Fq2):
Miller loop f_{|z|,Q}(P) with affine line evaluations, conjugated for z < 0,
then final exponentiation (p^12 - 1)/r.

Line evaluations use the sparse embedding derived from the twist
(x, y) -> (x/v, y/(v*w)): a doubling/addition line through T evaluated at
P = (xP, yP), scaled by the subfield factor v*w (free modulo final exp), is

    l = (lam * xT - yT)  +  (-lam * xP) * v  +  yP * v*w

with lam the slope in Fq2 — i.e. Fq12 element (c0 + c1*v, c2*v).

The final exponentiation hard part is computed with a plain bigint exponent
(p^4 - p^2 + 1)/r: slower than the cyclotomic addition chains, but this module
is the correctness oracle — the optimized chain lives in the JAX kernels and is
differential-tested against this.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .curve import B2, G1_GEN, Point
from .fields import BLS_X, Fq, Fq2, Fq6, Fq12, P, R

_ABS_X_BITS = bin(abs(BLS_X))[2:]  # MSB first


def _line(lam: Fq2, xT: Fq2, yT: Fq2, xP: Fq, yP: Fq) -> Fq12:
    """Sparse Fq12 line value (see module docstring)."""
    c0 = lam * xT - yT
    c1 = -(lam.mul_scalar(xP.n))
    c2 = Fq2(yP.n, 0)
    return Fq12(Fq6(c0, c1, Fq2.zero()), Fq6(Fq2.zero(), c2, Fq2.zero()))


def miller_loop(p_aff: Tuple[Fq, Fq], q_aff: Tuple[Fq2, Fq2]) -> Fq12:
    """f_{|z|, Q}(P), conjugated for the negative BLS parameter."""
    xP, yP = p_aff
    xQ, yQ = q_aff
    f = Fq12.one()
    xT, yT = xQ, yQ
    for bit in _ABS_X_BITS[1:]:
        # doubling step: slope of the tangent at T
        lam = xT.square().mul_scalar(3) * (yT.mul_scalar(2)).inv()
        f = f.square() * _line(lam, xT, yT, xP, yP)
        # T = 2T (affine)
        x2 = lam.square() - xT.mul_scalar(2)
        yT = lam * (xT - x2) - yT
        xT = x2
        if bit == "1":
            # addition step: line through T and Q
            if xT == xQ:
                if yT == yQ:
                    lam = xT.square().mul_scalar(3) * (yT.mul_scalar(2)).inv()
                else:
                    # T + Q = O mid-loop: only possible for Q of tiny order,
                    # which subgroup-checked inputs never are.
                    raise ZeroDivisionError("degenerate Miller loop input (Q of tiny order)")
            else:
                lam = (yT - yQ) * (xT - xQ).inv()
            f = f * _line(lam, xT, yT, xP, yP)
            x3 = lam.square() - xT - xQ
            yT = lam * (xT - x3) - yT
            xT = x3
    # z < 0: f_{z} = conj(f_{|z|}) modulo final exponentiation
    return f.conjugate()


_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12-1)/r) = [(f^(p^6-1))^(p^2+1)]^((p^4-p^2+1)/r)."""
    # easy part
    f = f.conjugate() * f.inv()  # f^(p^6 - 1)
    f = f.frobenius_n(2) * f  # ^(p^2 + 1)
    # hard part (plain exponent — correctness oracle)
    return f.pow(_HARD_EXP)


def pairing(p: Point[Fq], q: Point[Fq2]) -> Fq12:
    """e(P, Q); returns 1 for either input at infinity."""
    if p.is_infinity() or q.is_infinity():
        return Fq12.one()
    return final_exponentiation(miller_loop(p.to_affine(), q.to_affine()))


def multi_pairing(pairs: Sequence[Tuple[Point[Fq], Point[Fq2]]]) -> Fq12:
    """Product of pairings with a single shared final exponentiation — the
    structure the batched verifier exploits (one final exp per batch)."""
    f = Fq12.one()
    for p, q in pairs:
        if p.is_infinity() or q.is_infinity():
            continue
        f = f * miller_loop(p.to_affine(), q.to_affine())
    return final_exponentiation(f)
