"""The fused batched signature-set verification — the port's main path.

The port of ``lodestar_tpu/ops/fused_verify.py`` (same random-linear-
combination equation, masking, subgroup and infinity semantics):

- one merged 128-iteration complete-adder G2 ladder carries four scalar
  multiplications per set on stacked lanes: the signature subgroup check
  ([z]sig), both cofactor-clearing terms ([z^2-z-1]H and [z-1]psi(H)) and
  the RLC signature scaling ([c_i]sig);
- one merged Fermat inversion serves every affine conversion (the G2
  z-norms of N+1 points and the N G1 z coordinates);
- the multi-Miller loop and the final exponentiation (fused_pairing).

Inputs are the JAX package's packed 7-tuple (``from_packed`` makes
tensors of it on a device); the device of those tensors decides where the
program runs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..crypto.bls.fields import BLS_X
from . import limbs as fl
from .fused_core import LV, const_tensor, f2_is_zero, f_mul, ladd, lconcat, lneg, lstack, lv
from .fused_field import f12_is_one, fi_inv
from .fused_htc import hash_to_g2_pre_cofactor
from .fused_ladder import point_mul_bits_ladder
from .fused_pairing import final_exponentiation, multi_miller_product
from .fused_points import (
    G1_GEN_NEG_AFFINE,
    Point,
    fq2_ns,
    fq_ns,
    point_add_complete,
    point_double,
    point_eq,
    point_from_affine,
    point_infinity,
    point_is_infinity,
    point_mul_bits,
    point_select,
    point_sum_tree,
    psi,
)

# ---------------------------------------------------------------------------
# static ladder bit patterns (from the curve parameter)
# ---------------------------------------------------------------------------

_NBITS = 128


def _bits_lsb(v: int, width: int = _NBITS) -> np.ndarray:
    if not 0 <= v < (1 << width):
        raise ValueError("scalar does not fit the ladder width")
    return np.array([(v >> i) & 1 for i in range(width)], dtype=fl.NP_DTYPE)


_Z_ABS = abs(BLS_X)
# lane 0: [z]sig as [|z|](-sig)  (z < 0)
_L0_BITS = _bits_lsb(_Z_ABS)
# lane 1: [z^2 - z - 1]H
_L1_BITS = _bits_lsb(BLS_X * BLS_X - BLS_X - 1)
# lane 2: [z - 1]psi(H) as [|z - 1|](-psi(H))
_L2_BITS = _bits_lsb(abs(BLS_X - 1))


def _neg_point(p: Point) -> Point:
    return (p[0], lneg(p[1]), p[2])


def from_packed(packed: Sequence[np.ndarray], device="cuda"):
    """The packed 7-tuple (pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits,
    mask) of numpy arrays as tensors on ``device`` (float32; mask bool)."""
    dev = resolve_device(device)
    *digits, mask = packed
    out = [torch.as_tensor(np.asarray(a, dtype=np.float32)).to(dev) for a in digits]
    return tuple(out) + (torch.as_tensor(np.asarray(mask, dtype=bool)).to(dev),)


def verify_signature_sets_fused(pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask) -> torch.Tensor:
    """Scalar bool tensor: every live set verifies."""
    f, ok = miller_product_fused(pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask)
    return f12_is_one(final_exponentiation(f)) & ok


def miller_product_fused(pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask):
    """(f, ok): f the masked Miller product LV (loose digits), ok = the
    subgroup checks passed and some lane is live."""
    f, subgroup_ok, any_live = miller_product_parts(
        pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask
    )
    return f, subgroup_ok & any_live


def miller_product_parts(pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask):
    """(f, subgroup_ok, any_live) with the two verdict bits uncombined."""
    ns1 = fq_ns()
    ns2 = fq2_ns()
    n = pk_x.shape[0]
    dev = pk_x.device

    sig_jac = point_from_affine(lv(sig_x), lv(sig_y), ns2)

    # hash both field draws through SSWU + isogeny, complete-add the halves
    h_pre = hash_to_g2_pre_cofactor(lv(msg_u))
    psi_h = psi(h_pre)

    # --- the merged G2 ladder: 4 lanes per set, 128 iterations ---
    lanes = [
        _neg_point(sig_jac),  # subgroup target [z]sig
        h_pre,  # cofactor term 1
        _neg_point(psi_h),  # cofactor term 2
        sig_jac,  # RLC scaling
    ]
    stacked = tuple(lstack([lane[i] for lane in lanes], axis=0) for i in range(3))
    cb = F.pad(coeff_bits.to(torch.float32), (0, _NBITS - coeff_bits.shape[-1]))
    bits = torch.stack(
        [
            const_tensor(_L0_BITS, dev).expand(n, _NBITS),
            const_tensor(_L1_BITS, dev).expand(n, _NBITS),
            const_tensor(_L2_BITS, dev).expand(n, _NBITS),
            cb,
        ],
        dim=0,
    )  # (4, N, 128)
    out = point_mul_bits_ladder(stacked, bits, ns2)
    z_sig, t1, t2, sig_scaled = (tuple(LV(c.a[k], c.b) for c in out) for k in range(4))

    # signature subgroup check: psi(sig) == [z]sig (infinity passes)
    sig_in_g2 = point_eq(psi(sig_jac), z_sig, ns2) | point_is_infinity(sig_jac, ns2)
    subgroup_ok = torch.where(mask, sig_in_g2, torch.ones_like(sig_in_g2)).all()

    # finish cofactor clearing: H = t1 + t2 + psi^2([2]H_pre)
    t3 = psi(psi(point_double(h_pre, ns2)))
    h_jac = point_add_complete(point_add_complete(t1, t2, ns2), t3, ns2)

    # masked tree-sum of the scaled signatures
    inf = point_infinity(ns2, (n,), dev)
    s_sum = point_sum_tree(point_select(mask, sig_scaled, inf, ns2), ns2)

    # G1 RLC ladder (unsafe adds: freshly randomized coefficients)
    pk_jac = point_from_affine(lv(pk_x), lv(pk_y), ns1)
    pk_scaled = point_mul_bits(pk_jac, coeff_bits.to(torch.float32), ns1, complete=False)

    # --- merged affine conversion: one Fermat inversion for all ---
    g2_stack = tuple(
        lconcat([h_jac[i], LV(s_sum[i].a[None], s_sum[i].b)], axis=0) for i in range(3)
    )
    zg2 = g2_stack[2]
    z0, z1 = LV(zg2.a[..., 0, :], zg2.b), LV(zg2.a[..., 1, :], zg2.b)
    compsq = f_mul(lstack([z0, z1], -2), lstack([z0, z1], -2))
    norm = ladd(LV(compsq.a[..., 0, :], compsq.b), LV(compsq.a[..., 1, :], compsq.b))
    inv_all = fi_inv(lconcat([norm, pk_scaled[2]], axis=0))  # (2N+1, 50)
    ninv2 = LV(inv_all.a[: n + 1], inv_all.b)
    zinv_g1 = LV(inv_all.a[n + 1 :], inv_all.b)
    # G2 zinv = conj(z) * norm^-1
    numer = lstack([z0, lneg(z1)], axis=-2)
    zinv_g2 = f_mul(numer, LV(ninv2.a[..., None, :].expand(numer.a.shape), ninv2.b))
    g2_aff_x, g2_aff_y = _affine_with_zinv(g2_stack, zinv_g2, ns2)
    pk_aff_x, pk_aff_y = _affine_with_zinv(pk_scaled, zinv_g1, ns1)

    # pair list: (c_i pk_i, H_i) for the live lanes, then (-g1, S)
    neg_x = const_tensor(G1_GEN_NEG_AFFINE[0], dev)
    neg_y = const_tensor(G1_GEN_NEG_AFFINE[1], dev)
    xp = lconcat([pk_aff_x, LV(neg_x[None], 256)], axis=0)
    yp = lconcat([pk_aff_y, LV(neg_y[None], 256)], axis=0)
    s_not_inf = ~f2_is_zero(s_sum[2])
    pair_mask = torch.cat([mask, s_not_inf[None]], dim=0)

    f = multi_miller_product(xp, yp, g2_aff_x, g2_aff_y, pair_mask)
    return f, subgroup_ok, mask.any()


def _affine_with_zinv(p: Point, zinv: LV, ns):
    """point_to_affine with the inversion already done (merged upstream)."""
    (zinv2,) = ns.unstack(ns.mul(ns.stack([zinv]), ns.stack([zinv])), 1)
    xa, zinv3 = ns.unstack(ns.mul(ns.stack([p[0], zinv2]), ns.stack([zinv2, zinv])), 2)
    (ya,) = ns.unstack(ns.mul(ns.stack([p[1]]), ns.stack([zinv3])), 1)
    return xa, ya


def example_inputs(n: int = 8) -> tuple:
    """Deterministic, well-formed packed inputs (numpy), built with the
    port's oracle exactly as ``lodestar_tpu.ops.batch_verify.example_inputs``
    builds them: interop keys, message i, RLC coefficients from seed 7."""
    from ..crypto.bls import curve as C
    from ..crypto.bls.api import interop_secret_key
    from ..crypto.bls.hash_to_curve import hash_to_g2
    from . import tower as tw
    from .htc import hash_to_field_limbs

    pk_x = np.zeros((n, fl.NLIMBS), dtype=fl.NP_DTYPE)
    pk_y = np.zeros((n, fl.NLIMBS), dtype=fl.NP_DTYPE)
    sig_x = np.zeros((n, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
    sig_y = np.zeros((n, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
    msgs = []
    for i in range(n):
        sk = interop_secret_key(i)
        msg = b"graft entry message %d" % i
        msgs.append(msg)
        pk = (C.G1_GEN * sk.value).to_affine()
        sig = (hash_to_g2(msg) * sk.value).to_affine()
        pk_x[i] = fl.int_to_limbs(pk[0].n)
        pk_y[i] = fl.int_to_limbs(pk[1].n)
        sig_x[i] = tw.fq2_const(sig[0])
        sig_y[i] = tw.fq2_const(sig[1])
    msg_u = hash_to_field_limbs(msgs)
    rng = np.random.default_rng(7)
    coeffs = [int(rng.integers(1, 1 << 63)) * 2 + 1 for _ in range(n)]
    bits = np.array([[(c >> i) & 1 for i in range(64)] for c in coeffs], dtype=fl.NP_DTYPE)
    mask = np.ones(n, dtype=bool)
    return (pk_x, pk_y, sig_x, sig_y, msg_u, bits, mask)
