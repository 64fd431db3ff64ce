"""The port's limbs ops against the JAX package's (ladder mode), bitwise.

Tier-1, no compile: the JAX outputs come from the committed golden vectors
(tests/port_vectors/generate.py, ``xla_path.npz``).  Both sides are exact
integer arithmetic in float32 below 2^24, so the tolerance is zero: the
port's digits must be the JAX digits, not only the same values.  The
constant tables are held against the JAX package's arrays."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lodestar_tpu.ops import limbs as JL
from lodestar_tpu_torch.ops import limbs as fl

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.fixture(scope="module")
def xla_npz():
    with np.load(gen.XLA_NPZ) as z:
        return dict(z)


def _t(z, name):
    return torch.from_numpy(z[name])


OPS = {
    "carry_exact": lambda z: fl.carry_exact(_t(z, "loose")),
    "carry_ripple_exact": lambda z: fl.carry_ripple_exact(_t(z, "semi_a")),
    "fp_strict": lambda z: fl.fp_strict(_t(z, "loose")),
    "fp_sub": lambda z: fl.fp_sub(_t(z, "sub_a"), _t(z, "sub_b")),
    "fp_neg": lambda z: fl.fp_neg(_t(z, "sub_b")),
    "fp_mul_small": lambda z: fl.fp_mul_small(_t(z, "semi_a"), 12345),
    "fp_mul": lambda z: fl.fp_mul(_t(z, "semi_a"), _t(z, "semi_b")),
    "fp_mul_loose": lambda z: fl.fp_mul(_t(z, "loose"), _t(z, "semi_b"), a_strict=False),
    "fp_reduce_full": lambda z: fl.fp_reduce_full(_t(z, "semi_a")),
    "fp_eq": lambda z: fl.fp_eq(_t(z, "semi_a"), _t(z, "semi_b")),
    "fp_is_zero": lambda z: fl.fp_is_zero(_t(z, "semi_a")),
    "fp_inv": lambda z: fl.fp_inv(_t(z, "semi_a")),
}


def test_xla_inputs_regenerate_from_seed(xla_npz):
    for name, arr in gen.xla_inputs().items():
        assert arr.dtype == xla_npz[name].dtype, name
        np.testing.assert_array_equal(arr, xla_npz[name], err_msg=name)


@pytest.mark.parametrize("op", sorted(OPS))
def test_limbs_op_equals_jax_vectors_bitwise(op, xla_npz):
    got = OPS[op](xla_npz).numpy()
    want = xla_npz[op]
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_edge_rows_reduce_as_the_oracle_says(xla_npz):
    """zero, p and 2p reduce to zero; the all-256 row to its value mod p."""
    red = fl.fp_reduce_full(_t(xla_npz, "semi_a")).numpy()
    assert not red[:3].any()
    assert fl.limbs_to_int(red[3]) == fl.limbs_to_int(xla_npz["semi_a"][3]) % fl.P_INT
    assert fl.fp_is_zero(_t(xla_npz, "semi_a"))[:3].all()


def test_constants_equal_the_jax_package_arrays():
    np.testing.assert_array_equal(fl.RED, JL.RED)
    for w in (50, 51, 53):
        np.testing.assert_array_equal(fl._sub_pad(w), JL._sub_pad(w))
    for mine, ref in ((fl._MU, JL._MU), (fl._P_48, JL._P_48), (fl._P_CONST, JL._P_CONST),
                      (fl._2P_CONST, JL._2P_CONST)):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(fl._exp_windows(fl.P_INT - 2), JL._exp_windows(fl.P_INT - 2))


def test_ripple_handles_every_digit_below_2_24():
    """The passes-plus-prefix ripple gives the value's strict digits and
    carry out on digits up to 2^24 - 1 and on long 255/256 carry chains.
    (The JAX f32 scan is exact only within its semi-strict contract: with
    digits near 2^24 its digit-plus-carry sums leave the exact range.)"""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 24, size=(16, 51)).astype(np.float32)
    x[0] = 255
    x[0, 0] = 256  # one carry runs the whole width
    x[1] = (1 << 24) - 1
    got = fl.carry_ripple_exact(torch.from_numpy(x)).numpy()
    for row, out in zip(x, got):
        v = fl.limbs_to_int(row)
        assert fl.limbs_to_int(out[:51]) == v % (1 << 408)
        assert (out[:51] < 256).all() and int(out[51]) == v >> 408
