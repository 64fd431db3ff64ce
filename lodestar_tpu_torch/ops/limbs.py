"""Fq arithmetic on 8-bit float32 digits: the port of ``lodestar_tpu/ops/limbs.py``.

An Fq element is ``(..., 50)`` float32 digits of 8 bits each,
little-endian, value < 2^400 — the JAX package's representation, kept so
that both packages exchange the same arrays.  "Strict" (semi-strict) digits
are <= 256; loose intermediates stay below 2^24, where float32 arithmetic on
integers is exact.  All modulus-derived tables are computed here from the
port's bigint oracle, never transcribed.

The field operations (``carry_exact`` .. ``fp_inv``) are plain tensor ops:
the JAX package runs them as XLA graph ops, not as Pallas kernels.  Each
gives the JAX function's digits bitwise in its default ``ladder`` multiply
mode (the one-hot MXU modes are TPU workarounds and are not ported).  Two
of them are computed differently to the same digits, because an eager
launch per step would cost more than the arithmetic:

- ``carry_ripple_exact``'s 50-step serial scan becomes a few carry passes
  and a Kogge-Stone prefix over the remaining 0/1 carries (six rounds for
  51 digits); its output is a function of the value alone (the strict
  digits and the carry out), so the digits are the scan's;
- the schoolbook product and the fold through the RED rows are one
  broadcast product and one sum each instead of 50 shifted row adds; the
  sums are of integers below 2^24 in float32, exact in any order.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..crypto.bls.fields import P as P_INT

LIMB_BITS = 8
NLIMBS = 50  # 400 bits: 19 bits of redundancy above the 381-bit modulus
MASK = (1 << LIMB_BITS) - 1
NP_DTYPE = np.float32
# loose-digit cap: every intermediate digit stays below 2^24
LOOSE_BITS = 24


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

# Barrett constants of fp_reduce_full: mu = floor(2^424 / p)
_MU = int_to_limbs((1 << 424) // P_INT, 6)
_P_48 = int_to_limbs(P_INT, 48)
_P_CONST = int_to_limbs(P_INT, NLIMBS)
_2P_CONST = int_to_limbs(2 * P_INT, NLIMBS)
_COMP_P = (NP_DTYPE(MASK) - _P_CONST).astype(NP_DTYPE)
_COMP_2P = (NP_DTYPE(MASK) - _2P_CONST).astype(NP_DTYPE)

# Two's-complement subtraction pads: digits in [2^12, 2^12 + 2^8), value a
# multiple of p, so a + (pad - b) is digit-wise non-negative for b < 2^12.
_SUB_BIAS_BITS = 12
_SUB_PADS: Dict[int, np.ndarray] = {}


def _sub_pad(w: int) -> np.ndarray:
    """The pad of width w (one long-lived array per width)."""
    if w not in _SUB_PADS:
        base = sum(1 << (_SUB_BIAS_BITS + LIMB_BITS * i) for i in range(w))
        k = -(-base // P_INT)  # smallest multiple of p >= base
        _SUB_PADS[w] = int_to_limbs(k * P_INT - base, w) + NP_DTYPE(1 << _SUB_BIAS_BITS)
    return _SUB_PADS[w]


def _exp_windows(e: int) -> np.ndarray:
    """Base-16 digits of e, most significant first."""
    digits, v = [], e
    while v:
        digits.append(v & 0xF)
        v >>= 4
    return np.array(list(reversed(digits)) or [0], dtype=np.int32)


_TENSOR_CACHE: Dict[tuple, tuple] = {}


def _const_key(arr: np.ndarray, device, dtype) -> tuple:
    """The cache key of a constant: the array, the indexed device, the type."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = resolve_device(dev)
    return (id(arr), dev, dtype)


def const_tensor(arr: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    """A numpy constant as a tensor on ``device``, made once per device.
    The cache holds the array itself too, so its id is never reused: pass
    long-lived module-level arrays only."""
    key = _const_key(arr, device, dtype)
    dev = key[1]
    hit = _TENSOR_CACHE.get(key)
    if hit is None:
        hit = (arr, torch.as_tensor(np.ascontiguousarray(arr)).to(device=dev, dtype=dtype))
        _TENSOR_CACHE[key] = hit
    return hit[1]


# ---------------------------------------------------------------------------
# carries and normalization
# ---------------------------------------------------------------------------


def _passes(bound_bits: int) -> int:
    """Carry passes that take digits < 2^bound_bits to <= 256."""
    b, n = (1 << bound_bits) - 1, 0
    while b > 256:
        b = 255 + b // 256
        n += 1
    return n


def _extra(bound_bits: int) -> int:
    """Headroom columns that catch the top carry from digits < 2^bound_bits."""
    return max(1, -(-(bound_bits - LIMB_BITS) // LIMB_BITS))


_ZEROS: Dict[int, np.ndarray] = {}


def _pad_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x with k zero columns appended: one concatenation with a cached zero
    constant (F.pad fills and then copies: two launches on the card)."""
    if k not in _ZEROS:
        _ZEROS[k] = np.zeros(k, dtype=NP_DTYPE)
    zeros = const_tensor(_ZEROS[k], x.device, x.dtype).expand(x.shape[:-1] + (k,))
    return torch.cat([x, zeros], dim=-1)


def _carry_passes(x: torch.Tensor, bound_bits: int) -> torch.Tensor:
    """carry_exact's passes in place on x, which already ends in its
    headroom columns: digit i keeps its low 8 bits and gains digit i-1's
    carry; the top digit's carry is dropped, as the JAX shift drops it."""
    for _ in range(_passes(bound_bits)):
        hi = torch.div(x, 256, rounding_mode="floor")
        x.add_(hi, alpha=-256)
        x[..., 1:].add_(hi[..., :-1])
    return x


def carry_exact(x: torch.Tensor, bound_bits: int = LOOSE_BITS) -> torch.Tensor:
    """Value-preserving carry passes: (..., W) digits < 2^bound_bits ->
    (..., W + extra) digits <= 256, extra = ceil((bound_bits - 8) / 8)."""
    if bound_bits > LOOSE_BITS:
        raise ValueError("digits exceed the f32-exact range")
    return _carry_passes(_pad_right(x, _extra(bound_bits)), bound_bits)


def carry_ripple_exact(x: torch.Tensor, bound_bits: int = LOOSE_BITS) -> torch.Tensor:
    """(..., W) digits < 2^bound_bits -> (..., W + 1): the value's strict
    digits 0..W-1 and the carry out of digit W-1 in the last column — the
    JAX scan's digits and final carry on its semi-strict inputs.

    Carry passes that keep every carry (the last column collects them)
    bring digits 0..W-1 to <= 256; the carries left are 0 or 1, and digit
    i sends one on exactly when it is 256, or 255 with a carry in.  A
    Kogge-Stone prefix over those generate/propagate flags gives every
    carry at once."""
    w = x.shape[-1]
    x = _pad_right(x, 1)
    body = x[..., :w]
    for _ in range(_passes(bound_bits)):
        hi = torch.div(body, 256, rounding_mode="floor")
        body.add_(hi, alpha=-256)
        x[..., 1:].add_(hi)
    gen = (body == 256).to(x.dtype)
    prop = (body == 255).to(x.dtype)
    d = 1
    while d < w:  # generate and propagate are exclusive, so | is +
        gen[..., d:].add_(prop[..., d:] * gen[..., :-d])
        prop[..., d:] = prop[..., d:] * prop[..., :-d]
        d *= 2
    body.add_(gen, alpha=-256)  # gen[i]: the carry out of digit i
    x[..., 1:].add_(gen)
    return x


# RED with the two headroom columns of the carry at bound 23 that follows
# every fold
_RED_EXT = np.pad(RED, ((0, 0), (0, _extra(23))))


def _fold_tail(y: torch.Tensor) -> torch.Tensor:
    """(..., W) digits <= 256, W in (50, 103] -> (..., 52): 50 digits
    < 2^23, the low 49 plus sum_k y[49 + k] * RED[k], and two zero
    headroom columns."""
    k = y.shape[-1] - _FOLD_BASE
    e = (y[..., _FOLD_BASE:, None] * const_tensor(_RED_EXT, y.device)[:k]).sum(-2)
    e[..., :_FOLD_BASE].add_(y[..., :_FOLD_BASE])
    return e


def _finalize(x: torch.Tensor, bound_bits: int = LOOSE_BITS, padded: bool = False) -> torch.Tensor:
    """Loose (..., W <= 99) digits (< 2^bound_bits) -> strict (..., 50).
    ``padded``: x already ends in its headroom columns (and is ours to
    overwrite)."""
    y = _carry_passes(x, bound_bits) if padded else carry_exact(x, bound_bits)
    if y.shape[-1] > NLIMBS:
        y = _carry_passes(_fold_tail(y), 23)
    return y[..., :NLIMBS]


def fp_strict(x: torch.Tensor) -> torch.Tensor:
    """Re-normalize a loose element (digits < 2^24) to strict 50 digits."""
    if x.shape[-1] < NLIMBS:
        x = _pad_right(x, NLIMBS - x.shape[-1])
    return _finalize(x)


# ---------------------------------------------------------------------------
# ring operations
# ---------------------------------------------------------------------------


def fp_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy addition: digitwise sum, no carry."""
    return a + b


def _pad_minus(b: torch.Tensor, a=None) -> torch.Tensor:
    """strict(a + (pad - b)) with the pad of width w = max(wa, wb, 51), in
    one buffer that already holds the headroom columns of the carry."""
    wb = b.shape[-1]
    w = max(wb, NLIMBS + 1, a.shape[-1] if a is not None else 0)
    lead = b.shape[:-1] if a is None else torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    if w not in _SUB_PADS_EXT:
        _SUB_PADS_EXT[w] = np.pad(_sub_pad(w), (0, _extra(LOOSE_BITS)))
    t = const_tensor(_SUB_PADS_EXT[w], b.device).expand(lead + (w + _extra(LOOSE_BITS),)).clone()
    t[..., :wb].sub_(b)
    if a is not None:
        t[..., : a.shape[-1]].add_(a)
    return _finalize(t, padded=True)


_SUB_PADS_EXT: Dict[int, np.ndarray] = {}


def fp_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p, strict output; a digits < 2^23, b digits < 2^12:
    a + (pad - b) with the pad of the operands' width (at least 51)."""
    return _pad_minus(b, a)


def fp_neg(a: torch.Tensor) -> torch.Tensor:
    """-a mod p (strict); a digits < 2^12.  The JAX fp_sub(0, a): adding
    the zero operand changes no digit, so it is left out."""
    return _pad_minus(a)


def fp_mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k for a small non-negative python int k < 2^14; a strict."""
    if not 0 <= k < (1 << 14):
        raise ValueError("small multiplier out of range")
    return _finalize(a * float(k), 22)


def skew_sum(outer: torch.Tensor, extra: int = 0) -> torch.Tensor:
    """(..., m, n) products -> (..., m + n - 1 + extra) anti-diagonal sums
    out[c] = sum_r outer[r, c - r], then ``extra`` zero columns.  Each row
    is padded to L = m + n + extra and the flat array re-read with rows of
    L - 1, which shifts row r by r."""
    m, n = outer.shape[-2:]
    lead = outer.shape[:-2]
    width = m + n + extra
    flat = _pad_right(outer, m + extra).reshape(lead + (m * width,))
    return flat[..., : m * (width - 1)].reshape(lead + (m, width - 1)).sum(-2)


def fp_mul(a: torch.Tensor, b: torch.Tensor, *, a_strict: bool = True,
           b_strict: bool = True) -> torch.Tensor:
    """a * b mod p -> strict (..., 50); leading axes broadcast.  Inputs
    strict (digits <= 256) unless a_strict / b_strict say otherwise.  The
    schoolbook products are <= 2^16 and their anti-diagonal sums < 2^22."""
    if not a_strict:
        a = fp_strict(a)
    if not b_strict:
        b = fp_strict(b)
    acc = skew_sum(a[..., :, None] * b[..., None, :], _extra(22))
    return _finalize(acc, 22, padded=True)


def fp_sqr(a: torch.Tensor, *, a_strict: bool = True) -> torch.Tensor:
    return fp_mul(a, a, a_strict=a_strict, b_strict=a_strict)


def fp_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(cond, a, b) with cond broadcast over the digit axis."""
    return torch.where(cond[..., None], a, b)


# ---------------------------------------------------------------------------
# full reduction, comparison, inversion
# ---------------------------------------------------------------------------


def _sub_known_ge(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """v - w for strict same-width v >= w: two's complement, carry out
    dropped (digits <= 511 into the ripple)."""
    t = v + (MASK - w)
    t[..., 0].add_(1)
    return carry_ripple_exact(t, 9)[..., : v.shape[-1]]


def _cond_sub(a: torch.Tensor, comp: np.ndarray) -> torch.Tensor:
    """a - c if a >= c else a for strict (..., 50) a; comp = 255 - c.  The
    carry out of digit 49 is 1 exactly when a >= c."""
    t = a + const_tensor(comp, a.device)
    t[..., 0].add_(1)
    s = carry_ripple_exact(t, 9)
    return torch.where((s[..., NLIMBS] == 1)[..., None], s[..., :NLIMBS], a)


def fp_reduce_full(a: torch.Tensor) -> torch.Tensor:
    """Digits < 2^24 (semi-strict in practice) -> canonical residue < p.
    Exact ripple, Barrett quotient from digits 47..50 with mu =
    floor(2^424 / p) (qhat is floor(v/p) or up to 2 below it), subtract
    qhat * p, then conditional subtractions of 2p and p."""
    x = carry_ripple_exact(a)[..., : NLIMBS + 1]
    t = x[..., 47:51]
    mu = const_tensor(_MU, a.device)
    z = skew_sum(t[..., :, None] * mu, 2)  # (..., 11), < 2^18
    qhat = carry_ripple_exact(z, 18)[..., 6:9]
    qp = skew_sum(qhat[..., :, None] * const_tensor(_P_48, a.device), 1)  # (..., 51)
    qp = carry_ripple_exact(qp, 18)[..., : NLIMBS + 1]
    r = _sub_known_ge(x, qp)[..., :NLIMBS]
    return _cond_sub(_cond_sub(r, _COMP_2P), _COMP_P)


def fp_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Value equality mod p; returns bool (...).  Both sides ride one
    stacked reduction (rows are independent, so the digits are the same)."""
    r = fp_reduce_full(torch.stack(torch.broadcast_tensors(a, b)))
    return (r[0] == r[1]).all(-1)


def fp_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (fp_reduce_full(a) == 0).all(-1)


def fp_pow_static(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent: a 16-entry power table, then 4 squarings
    and one table product per base-16 window of e, most significant first
    (the JAX scan, unrolled; the first window squares one, as it does)."""
    if e < 0:
        raise ValueError("negative exponent")
    one = const_tensor(ONE, a.device).expand(a.shape)
    if e == 0:
        return one.clone()
    powers = [one, a]
    for k in range(2, 16):
        powers.append(fp_mul(powers[k // 2], powers[k - k // 2]))
    r = one
    for w in _exp_windows(e):
        for _ in range(4):
            r = fp_sqr(r)
        r = fp_mul(r, powers[w])
    return r


def fp_inv(a: torch.Tensor) -> torch.Tensor:
    """Multiplicative inverse via Fermat (a^(p-2)); a = 0 -> 0."""
    return fp_pow_static(a, P_INT - 2)
