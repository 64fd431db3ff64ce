"""Digit representation of Fq elements and its host-side constants (numpy).

An Fq element is ``(..., 50)`` float32 digits of 8 bits each,
little-endian, value < 2^400 — the JAX package's representation, kept so
that both packages exchange the same arrays.  Every digit operation in the
port is exact integer arithmetic below 2^24.  All modulus-derived tables
are computed here from the port's bigint oracle, never transcribed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..crypto.bls.fields import P as P_INT

LIMB_BITS = 8
NLIMBS = 50  # 400 bits: 19 bits of redundancy above the 381-bit modulus
MASK = (1 << LIMB_BITS) - 1
NP_DTYPE = np.float32


def int_to_limbs(v: int, width: int = NLIMBS) -> np.ndarray:
    """Python int -> little-endian float32 digit array."""
    if v < 0:
        raise ValueError("negative value")
    if v >> (LIMB_BITS * width):
        raise ValueError("value does not fit width")
    return np.frombuffer(v.to_bytes(width, "little"), dtype=np.uint8).astype(NP_DTYPE)


def ints_to_limbs(vals: Sequence[int], width: int = NLIMBS) -> np.ndarray:
    """Batch of Python ints -> (N, width) float32 digits: an 8-bit digit is
    one little-endian byte, so the batch converts as one byte blob."""
    if not len(vals):
        return np.zeros((0, width), dtype=NP_DTYPE)
    try:
        blob = b"".join(int(v).to_bytes(width, "little") for v in vals)
    except OverflowError as e:
        raise ValueError("value does not fit width") from e
    return np.frombuffer(blob, dtype=np.uint8).reshape(len(vals), width).astype(NP_DTYPE)


def limbs_to_int(limbs) -> int:
    """Digit array (any looseness) -> Python int."""
    arr = np.asarray(limbs, dtype=np.float64)
    return sum(int(d) << (LIMB_BITS * i) for i, d in enumerate(arr))


ZERO = int_to_limbs(0)
ONE = int_to_limbs(1)

# Fold table: RED[k] = 2^(8*(49+k)) mod p.  Digit 49+k of a wide value
# folds back into 50 digits as hi_k * RED[k].
_FOLD_BASE = NLIMBS - 1  # 49
_RED_ROWS = 54
RED = np.stack(
    [int_to_limbs((1 << (LIMB_BITS * (_FOLD_BASE + k))) % P_INT) for k in range(_RED_ROWS)]
)

# Two's-complement subtraction pads: digits in [2^12, 2^12 + 2^8), value a
# multiple of p, so a + (pad - b) is digit-wise non-negative for b < 2^12.
_SUB_BIAS_BITS = 12


def _sub_pad(w: int) -> np.ndarray:
    base = sum(1 << (_SUB_BIAS_BITS + LIMB_BITS * i) for i in range(w))
    k = -(-base // P_INT)  # smallest multiple of p >= base
    return int_to_limbs(k * P_INT - base, w) + NP_DTYPE(1 << _SUB_BIAS_BITS)


def _exp_windows(e: int) -> np.ndarray:
    """Base-16 digits of e, most significant first."""
    digits, v = [], e
    while v:
        digits.append(v & 0xF)
        v >>= 4
    return np.array(list(reversed(digits)) or [0], dtype=np.int32)
