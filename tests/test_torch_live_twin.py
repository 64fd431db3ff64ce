"""Live twins of the port's vector tests: the JAX package's fused ops, its
pallas_tower kernels (Pallas interpret mode on the CPU) and
its XLA-graph batch_verify run on the fly beside the port's plain versions.
Slow-marked: the bucket-4 Miller products alone take minutes (interpret
mode, or the XLA compile of the whole program), like the JAX package's own
fused-vs-XLA value check."""

import importlib.util
import os
import subprocess
import sys

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
from lodestar_tpu_torch.ops import batch_verify as TB  # noqa: E402
from lodestar_tpu_torch.ops import fused_core as T  # noqa: E402
from lodestar_tpu_torch.ops import fused_ladder as TL  # noqa: E402
from lodestar_tpu_torch.ops import fused_points as TP  # noqa: E402
from lodestar_tpu_torch.ops import fused_verify as TV  # noqa: E402
from lodestar_tpu_torch.ops import tower_kernels as TK  # noqa: E402
from lodestar_tpu_torch.ops.limbs import fp_reduce_full  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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



def _jax_in_child(code: str, tmp_path) -> dict:
    """Run ``code`` (which fills a dict ``out`` of arrays) in a child
    process on the CPU and return ``out``: the JAX compiles of the tower
    kernels and the XLA-graph program take seconds to minutes and stay out
    of this process's compile guard."""
    path = tmp_path / "jax_out.npz"
    script = (
        "import sys\n"
        "import numpy as np\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import jax.numpy as jnp\n"
        "out = {}\n" + code + "\nnp.savez(sys.argv[2], **out)\n"
    )
    subprocess.run([sys.executable, "-c", script, _REPO, str(path)], check=True, timeout=3000)
    with np.load(path) as z:
        return dict(z)


def test_tower_kernel_plain_equals_live_pallas_kernel(tmp_path):
    ref = _jax_in_child(
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('g', sys.argv[1] + '/tests/port_vectors/generate.py')\n"
        "g = importlib.util.module_from_spec(spec); spec.loader.exec_module(g)\n"
        "from lodestar_tpu.ops import pallas_tower as JT\n"
        "ins = g.tower_inputs()\n"
        "for op, (arity, _) in g.TOWER_OPS.items():\n"
        "    args = [jnp.asarray(ins[f'{op}_in{k}']) for k in range(arity)]\n"
        "    out[op] = np.asarray(getattr(JT, op)(*args, interpret=True))\n",
        tmp_path,
    )
    ins = gen.tower_inputs()
    kernel = {"fq2_mul": TK.K_FQ2_MUL, "fq2_sqr": TK.K_FQ2_SQR, "fq6_mul": TK.K_FQ6_MUL,
              "fq12_mul": TK.K_FQ12_MUL}
    for op, (arity, _tail) in gen.TOWER_OPS.items():
        (got,) = kernel[op](*(torch.from_numpy(ins[f"{op}_in{k}"]) for k in range(arity)))
        np.testing.assert_array_equal(got.numpy(), ref[op], err_msg=op)


def test_xla_miller_product_equals_jax_batch_verify_at_bucket4(tmp_path):
    ref = _jax_in_child(
        "from lodestar_tpu.ops import batch_verify as bv\n"
        "f, ok = jax.jit(bv.miller_product_kernel)(*map(jnp.asarray, bv.example_inputs(4)))\n"
        "out.update(f=np.asarray(f), ok=np.asarray(ok))\n",
        tmp_path,
    )
    args = bv.example_inputs(4)
    f_t, ok_t = TB.miller_product_kernel(*TB.from_packed(args, "cpu"))
    canon = lambda f: fp_reduce_full(torch.as_tensor(np.asarray(f))).numpy()  # noqa: E731
    np.testing.assert_array_equal(canon(f_t), canon(ref["f"]))
    assert bool(ok_t) is bool(ref["ok"]) is True
