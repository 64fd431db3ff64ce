"""Live twins of the port's vector tests: the JAX package's fused ops run
on the fly (Pallas interpret mode on the CPU) beside the port's plain
versions.  Slow-marked: the bucket-4 Miller product alone takes minutes in
interpret mode, like the JAX package's own fused-vs-XLA value check."""

import importlib.util
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

import jax.numpy as jnp  # noqa: E402

from lodestar_tpu.ops import batch_verify as bv  # noqa: E402
from lodestar_tpu.ops import fused_core as J  # noqa: E402
from lodestar_tpu.ops import fused_ladder as JL  # noqa: E402
from lodestar_tpu.ops import fused_points as JP  # noqa: E402
from lodestar_tpu.ops import fused_verify as JV  # noqa: E402
from lodestar_tpu_torch.ops import fused_core as T  # noqa: E402
from lodestar_tpu_torch.ops import fused_ladder as TL  # noqa: E402
from lodestar_tpu_torch.ops import fused_points as TP  # noqa: E402
from lodestar_tpu_torch.ops import fused_verify as TV  # noqa: E402

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.mark.parametrize("op", sorted(gen.CORE_OPS))
def test_plain_op_equals_live_jax_op(op):
    arity, _tail = gen.CORE_OPS[op]
    ins = gen.core_inputs()
    arrs = [ins[f"{op}_in{k}"] for k in range(arity)]
    ref = getattr(J, op)(*[J.lv(jnp.asarray(a), J.MAX_BOUND) for a in arrs], interpret=True)
    got = getattr(T, op)(*[T.lv(torch.from_numpy(a), T.MAX_BOUND) for a in arrs])
    if op == "f2_sqr":
        pairs = [(got[0].a, ref[0].a), (got[1].a, ref[1].a)]
    elif op == "f_canon":
        pairs = [(got, ref)]
    else:
        pairs = [(got.a, ref.a)]
    for g, r in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_ladder_equals_live_jax_ladder():
    lad = gen.ladder_inputs()
    jns = JP.fq2_ns(True)
    jp = JP.point_from_affine(J.lv(jnp.asarray(lad["x"])), J.lv(jnp.asarray(lad["y"])), jns)
    ref = JL.point_mul_bits_ladder(jp, jnp.asarray(lad["bits"]), jns, interpret=True)
    tns = TP.fq2_ns()
    tp = TP.point_from_affine(T.lv(torch.from_numpy(lad["x"])), T.lv(torch.from_numpy(lad["y"])), tns)
    got = TL.point_mul_bits_ladder(tp, torch.from_numpy(lad["bits"]), tns)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.a.numpy(), np.asarray(r.a))


def test_miller_product_fused_equals_jax_at_bucket4():
    args = bv.example_inputs(4)
    f_j, ok_j = JV.miller_product_fused(*[jnp.asarray(a) for a in args], interpret=True)
    f_t, ok_t = TV.miller_product_fused(*TV.from_packed(args, "cpu"))
    np.testing.assert_array_equal(T.f_canon(f_t).numpy(), np.asarray(J.f_canon(f_j, True)))
    assert bool(ok_t) is bool(ok_j) is True
