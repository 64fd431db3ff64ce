"""Fused core: bound-tracked loose field values and the seven field kernels.

The port of ``lodestar_tpu/ops/fused_core.py``.  A field value is a float32
digit tensor ``(..., 50)`` (8-bit digits, little-endian) with a static
bound on its digits (``LV``); glue between kernels is plain tensor adds and
pad-subtractions, and every multiply round is one kernel call on
lane-stacked rows.  Inputs to a kernel are loose (digits <= 2^22 - 1);
outputs are semi-strict (digits <= 256).

Each kernel has two versions behind one wrapper (``Kernel``):

- the CUDA kernel (``kernels/fused_kernels.cu``), launched for tensors on
  the card;
- a plain PyTorch version here, the same integer algorithm written with
  tensor ops, taken for tensors on the CPU.

Both reproduce the JAX kernel bodies digit for digit (the same carry
passes per bound, the same fold widths), so all three agree bitwise.  The
TPU-only mechanisms of the JAX module (one-hot bf16 matmuls, 512-row grid
padding, the offset-0 aligned splice) are not ported; the plain versions
use no matmul at all.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto.bls.fields import P as P_INT
from . import limbs as fl

NL = fl.NLIMBS

# Hard ceiling for digits entering any kernel: the entry fold is exact
# only below 2^22.
MAX_BOUND = (1 << 22) - 1

# ---------------------------------------------------------------------------
# subtraction pads, tiered by subtrahend bound
# ---------------------------------------------------------------------------

_PAD_CACHE: Dict[int, np.ndarray] = {}


def _pad_for(bound: int) -> np.ndarray:
    """50-digit pad whose value is a multiple of p and whose digits lie in
    [bias, bias + 2^8) for the smallest power-of-two bias >= bound, so
    ``a + pad - b`` is digit-wise non-negative for any b with digits <= bound."""
    bias_bits = max(9, int(bound - 1).bit_length())
    if bias_bits not in _PAD_CACHE:
        bias = 1 << bias_bits
        base = sum(bias << (fl.LIMB_BITS * i) for i in range(NL))
        k = -(-base // P_INT)
        _PAD_CACHE[bias_bits] = fl.int_to_limbs(k * P_INT - base, NL) + fl.NP_DTYPE(bias)
    return _PAD_CACHE[bias_bits]


def _pad_max(bound: int) -> int:
    return (1 << max(9, int(bound - 1).bit_length())) + 255


_TENSOR_CACHE: Dict[tuple, tuple] = {}


def const_tensor(arr: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    """A numpy constant as a tensor on ``device``, made once per device.
    The cache holds the array itself too, so its id is never reused."""
    dev = torch.device(device)
    key = (id(arr), dev, dtype)
    hit = _TENSOR_CACHE.get(key)
    if hit is None:
        hit = (arr, torch.as_tensor(np.ascontiguousarray(arr)).to(device=dev, dtype=dtype))
        _TENSOR_CACHE[key] = hit
    return hit[1]


# ---------------------------------------------------------------------------
# LV: a loose field value with its static digit bound
# ---------------------------------------------------------------------------


class LV(NamedTuple):
    """A float32 digit tensor (..., 50), possibly with component axes before
    the digit axis, plus the bound on any digit's value."""

    a: torch.Tensor
    b: int

    def check(self) -> "LV":
        if self.b > MAX_BOUND:
            raise ValueError(f"loose digit bound {self.b} exceeds f32-exact cap")
        return self


def lv(a: torch.Tensor, bound: int = 256) -> LV:
    return LV(a, bound)


def lcast(x: LV, bound: int) -> LV:
    """Raise (never lower) the tracked bound."""
    if bound < x.b:
        raise ValueError(f"cannot tighten bound {x.b} -> {bound}")
    return LV(x.a, bound)


def ladd(x: LV, y: LV) -> LV:
    return LV(x.a + y.a, x.b + y.b).check()


def ldbl(x: LV) -> LV:
    return LV(x.a + x.a, 2 * x.b).check()


def lsub(x: LV, y: LV) -> LV:
    """x - y mod p, loose: x + (pad - y) with the pad tier sized from y's
    bound.  No carries, no negative digits."""
    pad = const_tensor(_pad_for(y.b), y.a.device)
    return LV(x.a + (pad - y.a), x.b + _pad_max(y.b)).check()


def lneg(x: LV) -> LV:
    pad = const_tensor(_pad_for(x.b), x.a.device)
    return LV(pad - x.a, _pad_max(x.b)).check()


def lselect(cond: torch.Tensor, x: LV, y: LV) -> LV:
    """where(cond, x, y); cond broadcasts over the trailing value axes."""
    c = cond.reshape(cond.shape + (1,) * (x.a.dim() - cond.dim()))
    return LV(torch.where(c, x.a, y.a), max(x.b, y.b))


def lstack(vals, axis: int) -> LV:
    return LV(torch.stack([v.a for v in vals], dim=axis), max(v.b for v in vals))


def lconcat(vals, axis: int) -> LV:
    return LV(torch.cat([v.a for v in vals], dim=axis), max(v.b for v in vals))


def lc(x: LV, i: int, axis: int = -2) -> LV:
    """Fq2 component access on (..., 2, 50) LVs."""
    return LV(x.a.select(axis, i), x.b)


# ---------------------------------------------------------------------------
# constants of the kernels
# ---------------------------------------------------------------------------

RED = fl.RED  # (54, 50): 2^(8(49+k)) mod p
SUBPAD = fl._sub_pad(NL)  # bias-2^12 subtraction pad of m_sub
_MU6 = fl.int_to_limbs((1 << 424) // P_INT, 6)
_P48 = fl.int_to_limbs(P_INT, 48)
_PC = fl.int_to_limbs(P_INT, NL)
_P2C = fl.int_to_limbs(2 * P_INT, NL)
_HOT0_51 = np.zeros(NL + 1, dtype=fl.NP_DTYPE)
_HOT0_51[0] = 1.0

# the int32 table every CUDA kernel receives (layout: lf::K_* in field.cuh,
# lf::K_LEN = 2904 entries)
_CONST_TABLE = np.concatenate([RED.reshape(-1), SUBPAD, _MU6, _P48, _PC, _P2C]).astype(np.int32)
if _CONST_TABLE.size != 2904:
    raise AssertionError("constant table layout differs from field.cuh")


class _C(NamedTuple):
    """The plain versions' constants, int64 on one device."""

    red: torch.Tensor
    pad: torch.Tensor
    mu: torch.Tensor
    p48: torch.Tensor
    pc: torch.Tensor
    p2c: torch.Tensor
    hot0: torch.Tensor


def _consts(device) -> _C:
    i64 = torch.int64
    return _C(*(const_tensor(a, device, i64) for a in (RED, SUBPAD, _MU6, _P48, _PC, _P2C, _HOT0_51)))


# ---------------------------------------------------------------------------
# plain versions: the JAX kernel bodies as int64 tensor ops on (..., W)
# digit rows (an Fq2 value is one (..., 2, 50) tensor: its two components
# go through each step together, as independent rows)
# ---------------------------------------------------------------------------


def _carry(x: torch.Tensor, bound_bits: int) -> torch.Tensor:
    """_m_carry: value-preserving carry passes until digits <= 256 for a
    bound of 2^bound_bits - 1; widens by the headroom columns, and each
    pass drops the top digit's carry.  Updates its own padded copy in place."""
    x = F.pad(x, (0, max(1, -(-(bound_bits - 8) // 8))))
    b = (1 << bound_bits) - 1
    while b > 256:
        hi = x >> 8
        x &= 255
        x[..., 1:] += hi[..., :-1]
        b = 255 + b // 256
    return x


def m_fold(x: torch.Tensor, c: _C, bound_bits: int = 22) -> torch.Tensor:
    """Loose (..., W) -> semi-strict (..., 50): carry, fold digits 49..
    through the RED rows, carry."""
    x = _carry(x, bound_bits)
    w = x.shape[-1]
    if w > 102:
        raise ValueError("fold input wider than the RED table")
    y = (x[..., NL - 1 :, None] * c.red[: w - NL + 1]).sum(-2)
    y[..., : NL - 1] += x[..., : NL - 1]
    return _carry(y, 22)[..., :NL]


def m_mul(a: torch.Tensor, b: torch.Tensor, c: _C, bits: int = 16) -> torch.Tensor:
    """a * b mod p -> semi-strict; bits bounds each digit product.  The
    anti-diagonal sums (skewed by pad-and-reshape) are <= 50 * 2^bits."""
    if bits > 18:
        raise ValueError(f"m_mul bits={bits} breaks 50*2^bits < 2^24 exactness")
    lead = a.shape[:-1]
    outer = a[..., :, None] * b[..., None, :]  # (..., 50, 50)
    acc = (
        F.pad(outer, (0, NL))
        .reshape(lead + (2 * NL * NL,))[..., : NL * (2 * NL - 1)]
        .reshape(lead + (NL, 2 * NL - 1))
        .sum(-2)
    )  # acc[k] = sum_{i+j=k} a_i b_j
    return m_fold(acc, c, min(24, bits + 6))


def m_add(a, b, c: _C):
    return m_fold(a + b, c, 10)


def m_sub(a, b, c: _C):
    return m_fold(a + (c.pad - b), c, 13)


def m_fq2_mul(a, b, c: _C):
    """Karatsuba on semi-strict (..., 2, 50) pairs."""
    t = m_mul(a, b, c)  # t0, t1 side by side
    t0, t1 = t[..., 0, :], t[..., 1, :]
    t2 = m_mul(a[..., 0, :] + a[..., 1, :], b[..., 0, :] + b[..., 1, :], c, bits=18)
    return m_fold(torch.stack([t0 + (c.pad - t1), t2 + (c.pad - (t0 + t1))], dim=-2), c, 13)


def m_fq2_sqr(a, c: _C):
    """(a0 + a1)(a0 - a1) + 2 a0 a1 u on a semi-strict (..., 2, 50) pair."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    d = m_fold(a0 + (c.pad - a1), c, 13)
    c0 = m_mul(a0 + a1, d, c, bits=17)
    m = m_mul(a0, a1, c)
    return torch.stack([c0, m_fold(m + m, c, 10)], dim=-2)


def _ripple(x: torch.Tensor, w: int) -> torch.Tensor:
    """_k_ripple: exact serial carry to w strict digits; the final carry is
    dropped."""
    carry = torch.zeros_like(x[..., 0])
    out = []
    for i in range(w):
        t = carry if i >= x.shape[-1] else x[..., i] + carry
        out.append(t & 255)
        carry = t >> 8
    return torch.stack(out, dim=-1)


def _cond_sub(r: torch.Tensor, k: torch.Tensor, c: _C) -> torch.Tensor:
    """r - k if r >= k else r, for strict r and a constant k."""
    s = _ripple(r + (255 - k) + c.hot0[:NL], NL + 1)
    return torch.where(s[..., NL : NL + 1] == 1, s[..., :NL], r)


def _canon(x: torch.Tensor, c: _C) -> torch.Tensor:
    """Loose -> canonical residue: fold, ripple, Barrett quotient with
    mu = floor(2^424 / p), subtract, two conditional subtractions."""
    x = _ripple(m_fold(x, c), NL + 1)
    t = x[..., 47:51]
    z = sum(F.pad(t[..., i : i + 1] * c.mu, (i, 11 - 6 - i)) for i in range(4))
    qhat = _ripple(z, 12)[..., 6:9]
    qp = sum(F.pad(qhat[..., i : i + 1] * c.p48, (i, NL + 1 - 48 - i)) for i in range(3))
    qp = _ripple(qp, NL + 1)
    r = _ripple(x + (255 - qp) + c.hot0, NL + 1)[..., :NL]
    return _cond_sub(_cond_sub(r, c.p2c, c), c.pc, c)


def _mul_plain(c, a, b):
    return (m_mul(m_fold(a, c), m_fold(b, c), c),)


def _fq2mul_plain(c, a, b):
    return (m_fq2_mul(m_fold(a, c), m_fold(b, c), c),)


def _fq2sqr_plain(c, a):
    f = m_fold(a, c)
    return m_fq2_sqr(f, c), f


def _pow16mul_plain(c, r, t):
    r, t = m_fold(r, c), m_fold(t, c)
    for _ in range(4):
        r = m_mul(r, r, c)
    return (m_mul(r, t, c),)


def _fq2pow16mul_plain(c, r, t):
    r, t = m_fold(r, c), m_fold(t, c)
    for _ in range(4):
        r = m_fq2_sqr(r, c)
    return (m_fq2_mul(r, t, c),)


def _fold_plain(c, x):
    return (m_fold(x, c),)


def _canon_plain(c, x):
    return (_canon(x, c),)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

#: every kernel of the port, by name
KERNELS: Dict[str, "Kernel"] = {}


class Kernel:
    """One hand-written CUDA kernel and its plain PyTorch version.

    ``kernel(*rows)`` takes float32 tensors shaped (N, *tail), all on one
    device.  On the CPU it runs the plain version; on the card it launches
    the kernel on the current stream (no synchronisation) and adds one to
    ``launches``.  Anything else raises: there is no fallback."""

    def __init__(self, name: str, replaces: str, n_in: int, n_out: int,
                 tail: Tuple[int, ...], plain: Callable):
        self.name = name
        self.replaces = replaces
        self.n_in = n_in
        self.n_out = n_out
        self.tail = tail
        self._plain = plain
        self.launches = 0
        KERNELS[name] = self

    def plain(self, *rows: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The plain version on any device (int64 inside, float32 out)."""
        c = _consts(rows[0].device)
        outs = self._plain(c, *(r.to(torch.int64) for r in rows))
        return tuple(o.to(torch.float32) for o in outs)

    def __call__(self, *rows: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if len(rows) != self.n_in:
            raise ValueError(f"{self.name}: expected {self.n_in} inputs, got {len(rows)}")
        devs = {r.device for r in rows}
        if len(devs) != 1:
            raise ValueError(f"{self.name}: inputs on several devices {devs}")
        dev = devs.pop()
        if dev.type == "cpu":
            return self.plain(*rows)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {dev}")
        return self.launch(*rows)

    def launch(self, *rows: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Launch the CUDA kernel on CUDA rows; raises on bad input or a
        refused launch."""
        from .kernels import _build

        n = rows[0].shape[0]
        for r in rows:
            if r.device.type != "cuda" or r.device != rows[0].device:
                raise ValueError(f"{self.name}: inputs must share one CUDA device")
            if r.dtype != torch.float32:
                raise TypeError(f"{self.name}: expected float32, got {r.dtype}")
            if tuple(r.shape) != (n,) + self.tail:
                raise ValueError(f"{self.name}: expected shape {(n,) + self.tail}, got {tuple(r.shape)}")
            if not r.is_contiguous():
                raise ValueError(f"{self.name}: input is not contiguous")
        lib = _build.load()
        dev = rows[0].device
        table = const_tensor(_CONST_TABLE, dev, torch.int32)
        outs = tuple(torch.empty((n,) + self.tail, dtype=torch.float32, device=dev)
                     for _ in range(self.n_out))
        ins_arr = (ctypes.c_void_p * self.n_in)(*(r.data_ptr() for r in rows))
        outs_arr = (ctypes.c_void_p * self.n_out)(*(o.data_ptr() for o in outs))
        with torch.cuda.device(dev):  # the launcher uses the current device
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib, f"launch_{self.name}")(ins_arr, outs_arr, n, table.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"kernel {self.name} launch failed: cudaError {rc}")
        self.launches += 1
        return outs


_F = (NL,)
_F2 = (2, NL)
_SRC = "lodestar_tpu/ops/fused_core.py"
K_MUL = Kernel("mul", f"{_SRC}:404", 2, 1, _F, _mul_plain)
K_FQ2MUL = Kernel("fq2mul", f"{_SRC}:410", 2, 1, _F2, _fq2mul_plain)
K_FQ2SQR = Kernel("fq2sqr", f"{_SRC}:420", 1, 2, _F2, _fq2sqr_plain)
K_POW16MUL = Kernel("pow16mul", f"{_SRC}:434", 2, 1, _F, _pow16mul_plain)
K_FQ2POW16MUL = Kernel("fq2pow16mul", f"{_SRC}:446", 2, 1, _F2,
                       _fq2pow16mul_plain)
K_FOLD = Kernel("fold", f"{_SRC}:459", 1, 1, _F, _fold_plain)
K_CANON = Kernel("canon", f"{_SRC}:504", 1, 1, _F, _canon_plain)


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


# ---------------------------------------------------------------------------
# public fused ops (LV in, LV out; semi-strict outputs)
# ---------------------------------------------------------------------------


def _rows(a: torch.Tensor, tail_ndim: int) -> torch.Tensor:
    """(..., *tail) -> contiguous (N, *tail) rows."""
    return a.reshape((-1,) + tuple(a.shape[a.dim() - tail_ndim:])).contiguous()


def f_mul(x: LV, y: LV) -> LV:
    """Fq product on (..., 50) loose LVs — one kernel call."""
    x.check(), y.check()
    (o,) = K_MUL(_rows(x.a, 1), _rows(torch.broadcast_to(y.a, x.a.shape), 1))
    return lv(o.reshape(x.a.shape))


def f2_mul(x: LV, y: LV) -> LV:
    """Fq2 product on (..., 2, 50) loose LVs — one Karatsuba kernel call."""
    x.check(), y.check()
    shape = torch.broadcast_shapes(x.a.shape, y.a.shape)
    (o,) = K_FQ2MUL(_rows(torch.broadcast_to(x.a, shape), 2), _rows(torch.broadcast_to(y.a, shape), 2))
    return lv(o.reshape(shape))


def f2_sqr(x: LV) -> Tuple[LV, LV]:
    """Fq2 square; returns (square, normalized input)."""
    x.check()
    o, f = K_FQ2SQR(_rows(x.a, 2))
    return lv(o.reshape(x.a.shape)), lv(f.reshape(x.a.shape))


def f_pow16mul(r: LV, t: LV) -> LV:
    r.check(), t.check()
    (o,) = K_POW16MUL(_rows(r.a, 1), _rows(torch.broadcast_to(t.a, r.a.shape), 1))
    return lv(o.reshape(r.a.shape))


def f2_pow16mul(r: LV, t: LV) -> LV:
    r.check(), t.check()
    (o,) = K_FQ2POW16MUL(_rows(r.a, 2), _rows(torch.broadcast_to(t.a, r.a.shape), 2))
    return lv(o.reshape(r.a.shape))


def f_fold(x: LV) -> LV:
    """Explicit normalization to semi-strict."""
    x.check()
    (o,) = K_FOLD(_rows(x.a, 1))
    return lv(o.reshape(x.a.shape))


def f_canon(x: LV) -> torch.Tensor:
    """Loose (..., 50) -> canonical residue digits (< p, strict)."""
    x.check()
    (o,) = K_CANON(_rows(x.a, 1))
    return o.reshape(x.a.shape)


def f_is_zero(x: LV) -> torch.Tensor:
    """x == 0 mod p on (..., 50); returns (...) bool."""
    return (f_canon(x) == 0).all(dim=-1)


def f2_is_zero(x: LV) -> torch.Tensor:
    """Fq2 zero test on (..., 2, 50)."""
    return (f_canon(x) == 0).all(dim=-1).all(dim=-1)
