"""The PyTorch port's fused core and ladder against the JAX package.

Tier-1, no compile: the JAX outputs come from the committed golden vectors
(tests/port_vectors/generate.py ran the JAX ops in Pallas interpret mode),
and the port's plain versions (CPU tensors) must equal them bitwise — the
arithmetic is exact integer arithmetic in float32 below 2^24, so the
tolerance is zero.  The constant tables are held bitwise against the JAX
package's arrays.  The live twins of these checks are slow-marked in
test_torch_live_twin.py.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.ops import fused_core as T
from lodestar_tpu_torch.ops import fused_ladder as TL
from lodestar_tpu_torch.ops.fused_points import fq2_ns, point_from_affine

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.fixture(scope="module")
def core_npz():
    with np.load(gen.CORE_NPZ) as z:
        return dict(z)


@pytest.fixture(scope="module")
def ladder_npz():
    with np.load(gen.LADDER_NPZ) as z:
        return dict(z)


def test_core_inputs_regenerate_from_seed(core_npz):
    for name, arr in gen.core_inputs().items():
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr, core_npz[name], err_msg=name)


def test_ladder_inputs_regenerate_from_seed(ladder_npz):
    for name, arr in gen.ladder_inputs().items():
        np.testing.assert_array_equal(arr, ladder_npz[name], err_msg=name)


@pytest.mark.parametrize("op", sorted(gen.CORE_OPS))
def test_plain_op_equals_jax_vectors_bitwise(op, core_npz):
    arity, _tail = gen.CORE_OPS[op]
    args = [T.lv(torch.from_numpy(core_npz[f"{op}_in{k}"]), T.MAX_BOUND) for k in range(arity)]
    res = getattr(T, op)(*args)
    if op == "f2_sqr":
        got = [res[0].a, res[1].a]
    elif op == "f_canon":
        got = [res]
    else:
        got = [res.a]
    for k, g in enumerate(got):
        want = core_npz[f"{op}_out{k}"]
        assert g.dtype == torch.float32 and tuple(g.shape) == want.shape
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f"{op} output {k}")
        assert g.numpy().max() <= 256  # semi-strict contract


def test_point_mul_bits_ladder_equals_jax_vectors_bitwise(ladder_npz):
    ns = fq2_ns()
    p = point_from_affine(
        T.lv(torch.from_numpy(ladder_npz["x"])), T.lv(torch.from_numpy(ladder_npz["y"])), ns
    )
    out = TL.point_mul_bits_ladder(p, torch.from_numpy(ladder_npz["bits"]), ns)
    for c, key in zip(out, ("out_x", "out_y", "out_z")):
        np.testing.assert_array_equal(c.a.numpy(), ladder_npz[key], err_msg=key)


def test_lv_check_raises_above_the_exact_bound():
    x = T.lv(torch.zeros(1, 50), T.MAX_BOUND)
    T.ladd(x, T.lv(torch.zeros(1, 50), 0))
    with pytest.raises(ValueError):
        T.ladd(x, x)
    with pytest.raises(ValueError):
        T.lcast(x, 256)


def test_cpu_rows_take_the_plain_version_and_nothing_else_launches():
    T.reset_launch_counts()
    x = torch.zeros(3, 50)
    (o,) = T.K_MUL(x, x)
    assert o.shape == (3, 50) and T.K_MUL.launches == 0
    meta = torch.zeros(3, 50, device="meta")
    with pytest.raises(ValueError):
        T.K_MUL(meta, meta)  # neither CPU nor CUDA: no fallback
    with pytest.raises(ValueError):
        T.K_MUL.launch(x, x)  # the CUDA launcher refuses CPU tensors
    with pytest.raises(ValueError):
        T.K_MUL(x)  # wrong arity


# ---------------------------------------------------------------------------
# constant tables: recomputed from the port's own oracle, equal to JAX's
# ---------------------------------------------------------------------------


def _jax_tables():
    from lodestar_tpu.ops import fused_core as J
    from lodestar_tpu.ops import fused_field as JF
    from lodestar_tpu.ops import fused_points as JP
    from lodestar_tpu.ops import fused_verify as JV
    from lodestar_tpu.ops import htc as JH
    from lodestar_tpu.ops import limbs as JL
    from lodestar_tpu.ops import pairing as JPa
    from lodestar_tpu.ops import pallas_tower as JT
    from lodestar_tpu.ops import tower as JTw

    return {
        "RED": JT.RED,
        "SUBPAD": JT.SUBPAD,
        "MU6": J._MU6,
        "P48": J._P48,
        "PC": J._PC,
        "P2C": J._P2C,
        "HOT0_51": J._HOT0_51,
        "FROB12": JF.FROB12,
        "FQ2_ONE": JTw.FQ2_ONE,
        "FQ12_ONE": JTw.FQ12_ONE,
        "P_MINUS_1": JF.P_MINUS_1,
        "ISO_A": JH.ISO_A,
        "ISO_B": JH.ISO_B,
        "SSWU_Z": JH.SSWU_Z,
        "NEG_B_OVER_A": JH.NEG_B_OVER_A,
        "B_OVER_ZA": JH.B_OVER_ZA,
        "K1": np.stack(JH.K1),
        "K2": np.stack(JH.K2),
        "K3": np.stack(JH.K3),
        "K4": np.stack(JH.K4),
        "PSI_CX": JP.PSI_CX,
        "PSI_CY": JP.PSI_CY,
        "G1_GEN_NEG_AFFINE": np.stack(JP.G1_GEN_NEG_AFFINE),
        "L0_BITS": JV._L0_BITS,
        "L1_BITS": JV._L1_BITS,
        "L2_BITS": JV._L2_BITS,
        "X_BITS": JPa._X_BITS,
        "X_WINDOWS": JPa._X_WINDOWS,
        "EXP_WINDOWS_P_MINUS_2": JL._exp_windows(JL.P_INT - 2),
        **{f"PAD_FOR_{b}": J._pad_for(b) for b in (1, 256, 257, 4096, 8192, 16384, 70000)},
    }


def _port_tables():
    from lodestar_tpu_torch.ops import fused_field as F
    from lodestar_tpu_torch.ops import fused_points as P
    from lodestar_tpu_torch.ops import fused_verify as V
    from lodestar_tpu_torch.ops import htc as H
    from lodestar_tpu_torch.ops import pairing as Pa
    from lodestar_tpu_torch.ops import tower as Tw

    return {
        "RED": T.RED,
        "SUBPAD": T.SUBPAD,
        "MU6": T._MU6,
        "P48": T._P48,
        "PC": T._PC,
        "P2C": T._P2C,
        "HOT0_51": T._HOT0_51,
        "FROB12": F.FROB12,
        "FQ2_ONE": Tw.FQ2_ONE,
        "FQ12_ONE": Tw.FQ12_ONE,
        "P_MINUS_1": F.P_MINUS_1,
        "ISO_A": H.ISO_A,
        "ISO_B": H.ISO_B,
        "SSWU_Z": H.SSWU_Z,
        "NEG_B_OVER_A": H.NEG_B_OVER_A,
        "B_OVER_ZA": H.B_OVER_ZA,
        "K1": np.stack(H.K1),
        "K2": np.stack(H.K2),
        "K3": np.stack(H.K3),
        "K4": np.stack(H.K4),
        "PSI_CX": P.PSI_CX,
        "PSI_CY": P.PSI_CY,
        "G1_GEN_NEG_AFFINE": np.stack(P.G1_GEN_NEG_AFFINE),
        "L0_BITS": V._L0_BITS,
        "L1_BITS": V._L1_BITS,
        "L2_BITS": V._L2_BITS,
        "X_BITS": Pa._X_BITS,
        "X_WINDOWS": Pa._X_WINDOWS,
        "EXP_WINDOWS_P_MINUS_2": F._WIN_INV,
        **{f"PAD_FOR_{b}": T._pad_for(b) for b in (1, 256, 257, 4096, 8192, 16384, 70000)},
    }


_TABLE_NAMES = sorted(_port_tables())


@pytest.mark.parametrize("name", _TABLE_NAMES)
def test_constant_table_equals_jax_bitwise(name):
    mine, ref = _port_tables()[name], _jax_tables()[name]
    assert mine.dtype == ref.dtype and mine.shape == ref.shape, name
    np.testing.assert_array_equal(mine, ref, err_msg=name)
