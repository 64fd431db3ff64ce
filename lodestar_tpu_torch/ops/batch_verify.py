"""The XLA-graph batched signature-set verification.

The port of ``lodestar_tpu/ops/batch_verify.py`` (the program the JAX
package runs on every backend but a TPU) in its full-device mode: one
call verifies a padded batch with the random-linear-combination equation

    e(-g1, sum_i c_i s_i) * prod_i e(c_i pk_i, H(m_i)) == 1

with fresh odd 64-bit coefficients c_i.  Stages: G2 subgroup checks on the
signatures (complete-add ladders), hash_to_g2's device stage, the [c_i]pk_i
and [c_i]s_i ladders, the masked tree-sum of the scaled signatures, batched
affine conversions, and the Miller loops over the N+1 pairs, their product
tree and one final exponentiation.  Inputs are the packed 7-tuple of
``TorchBlsVerifier.pack`` (``fused_verify.from_packed`` makes tensors of
it); the device of those tensors decides where the program runs.
"""

from __future__ import annotations

import torch

from . import htc
from . import pairing as kp
from . import points as pts
from . import tower as tw
from .fused_verify import example_inputs, from_packed  # noqa: F401 - the shared packed inputs
from .limbs import const_tensor
from .points import FQ2_NS, FQ_NS


def verify_signature_sets_kernel(pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask) -> torch.Tensor:
    """Scalar bool tensor: every live set verifies.

    pk_x, pk_y (N, 50) affine G1 keys; sig_x, sig_y (N, 2, 50) affine G2
    signatures (on the curve, not yet subgroup-checked); msg_u (N, 2, 2, 50)
    hash_to_field draws; coeff_bits (N, 64) bits of c_i, LSB first; mask
    (N,) bool, the live sets."""
    f, subgroup_ok, any_live = miller_product_parts_kernel(
        pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask
    )
    return tw.fq12_is_one(kp.final_exponentiation(f)) & subgroup_ok & any_live


def miller_product_kernel(pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask):
    """(f, ok): f the (6, 2, 50) masked Miller product before the final
    exponentiation, ok = the subgroup checks passed and some lane is live."""
    f, subgroup_ok, any_live = miller_product_parts_kernel(
        pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask
    )
    return f, subgroup_ok & any_live


def miller_product_parts_kernel(pk_x, pk_y, sig_x, sig_y, msg_u, coeff_bits, mask):
    """(f, subgroup_ok, any_live) with the two verdict bits uncombined."""
    n = pk_x.shape[0]
    dev = pk_x.device

    # 1. signature subgroup checks (only live lanes must pass)
    sig_jac = pts.point_from_affine(sig_x, sig_y, FQ2_NS)
    sig_in_g2 = pts.g2_subgroup_check(sig_jac)
    subgroup_ok = torch.where(mask, sig_in_g2, torch.ones_like(sig_in_g2)).all()

    # 2. message points
    h_jac = htc.hash_to_g2_device(msg_u)

    # 3. scalar ladders (unsafe adds: freshly randomized coefficients)
    pk_jac = pts.point_from_affine(pk_x, pk_y, FQ_NS)
    pk_scaled = pts.point_mul_bits(pk_jac, coeff_bits, FQ_NS)
    sig_scaled = pts.point_mul_bits(sig_jac, coeff_bits, FQ2_NS)

    # 4. masked tree-sum of the scaled signatures
    inf = pts.point_infinity(FQ2_NS, (n,), dev)
    s_sum = pts.point_sum_tree(pts.point_select(mask, sig_scaled, inf, FQ2_NS), FQ2_NS)

    # batched affine conversions: the G2 side stacks H (N) and S (1)
    g2_stack = tuple(torch.cat([h_jac[i], s_sum[i][None]], dim=0) for i in range(3))
    g2_aff_x, g2_aff_y = pts.point_to_affine(g2_stack, FQ2_NS)
    pk_aff_x, pk_aff_y = pts.point_to_affine(pk_scaled, FQ_NS)

    # 5. pairs (c_i pk_i, H_i) for the live lanes, then (-g1, S); S at
    # infinity (masked-out batches) is masked out, as e(-, O) = 1
    xp = torch.cat([pk_aff_x, const_tensor(pts.G1_GEN_NEG_AFFINE[0], dev)[None]], dim=0)
    yp = torch.cat([pk_aff_y, const_tensor(pts.G1_GEN_NEG_AFFINE[1], dev)[None]], dim=0)
    s_not_inf = ~tw.fq2_is_zero(s_sum[2])
    pair_mask = torch.cat([mask, s_not_inf[None]], dim=0)

    f = kp.multi_miller_product(xp, yp, g2_aff_x, g2_aff_y, pair_mask)
    return f, subgroup_ok, mask.any()
