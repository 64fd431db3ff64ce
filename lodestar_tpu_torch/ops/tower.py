"""Tower constants (numpy): Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi),
Fq12 = Fq6[w]/(w^2 - v), with Fq12 in the flat (..., 6, 2, 50) layout
[c00, c01, c02, c10, c11, c12]."""

from __future__ import annotations

import numpy as np

from ..crypto.bls import fields as F
from . import limbs as fl


def fq2_const(v: F.Fq2) -> np.ndarray:
    """Oracle Fq2 -> (2, 50) numpy digit constant."""
    return np.stack([fl.int_to_limbs(v.c0), fl.int_to_limbs(v.c1)])


FQ2_ZERO = fq2_const(F.Fq2.zero())
FQ2_ONE = fq2_const(F.Fq2.one())
FQ6_ZERO = np.stack([FQ2_ZERO] * 3)
FQ6_ONE = np.stack([FQ2_ONE, FQ2_ZERO, FQ2_ZERO])
FQ12_ONE = np.concatenate([FQ6_ONE, FQ6_ZERO])  # (6, 2, 50) flat
