"""The XLA-graph path's four tower kernels (the port of pallas_tower) and
the tower above them, against the JAX package.

Tier-1, no compile: the JAX outputs come from the committed golden vectors
(tests/port_vectors/generate.py ran pallas_tower's kernels in interpret
mode on the CPU).  The plain versions (CPU tensors) must equal them
bitwise, with every output digit <= 256: both are exact integer
arithmetic, so the tolerance is zero.  The tower's products follow the
Pallas digit algorithm, not the JAX tower.py one, so ``tower`` is held to
the bigint oracle by value mod p (canonical residues, tolerance zero).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lodestar_tpu.ops import pallas_tower as JT
from lodestar_tpu_torch.crypto.bls import fields as F
from lodestar_tpu_torch.ops import fused_core as fc
from lodestar_tpu_torch.ops import tower as tw
from lodestar_tpu_torch.ops import tower_kernels as tk

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

KERNEL = {"fq2_mul": tk.K_FQ2_MUL, "fq2_sqr": tk.K_FQ2_SQR, "fq6_mul": tk.K_FQ6_MUL,
          "fq12_mul": tk.K_FQ12_MUL}


@pytest.fixture(scope="module")
def tower_npz():
    with np.load(gen.TOWER_NPZ) as z:
        return dict(z)


def test_tower_inputs_regenerate_from_seed(tower_npz):
    for name, arr in gen.tower_inputs().items():
        assert arr.dtype == np.float32 and arr.max() <= 256
        np.testing.assert_array_equal(arr, tower_npz[name], err_msg=name)


@pytest.mark.parametrize("op", sorted(gen.TOWER_OPS))
def test_plain_kernel_equals_pallas_vectors_bitwise(op, tower_npz):
    arity, tail = gen.TOWER_OPS[op]
    k = KERNEL[op]
    assert k.tail == tail and k.n_in == arity and k.loose_in == 0
    ins = [torch.from_numpy(tower_npz[f"{op}_in{i}"]) for i in range(arity)]
    (got,) = k(*ins)  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and float(got.max()) <= 256
    np.testing.assert_array_equal(got.numpy(), tower_npz[f"{op}_out"])


def test_kernels_are_registered_with_the_fused_ones():
    for k in tk.TOWER_KERNELS:
        assert fc.KERNELS[k.name] is k
        assert k.replaces.startswith("lodestar_tpu/ops/pallas_tower.py:")
    fc.reset_launch_counts()
    tw.fq2_mul(torch.from_numpy(np.stack([tw.FQ2_ONE] * 2)), torch.from_numpy(tw.FQ2_ONE))
    assert tk.K_FQ2_MUL.launches == 0  # the CPU takes the plain version


def test_constants_equal_the_pallas_operands():
    np.testing.assert_array_equal(fc.RED, JT.RED)
    np.testing.assert_array_equal(fc.SUBPAD, JT.SUBPAD)


# -- the tower, by value against the oracle ------------------------------------


def _rand_fq2(rng):
    return F.Fq2(int(rng.integers(0, 1 << 62)) * 7919 % F.P, int(rng.integers(0, 1 << 62)) ** 6 % F.P)


def _rand_fq12(rng):
    return F.Fq12(F.Fq6(*[_rand_fq2(rng) for _ in range(3)]),
                  F.Fq6(*[_rand_fq2(rng) for _ in range(3)]))


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))


def _cyclotomic(rng):
    f = _rand_fq12(rng)
    m = f.conjugate() * f.inv()
    return m.frobenius().frobenius() * m


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(5)


def test_fq2_products_match_oracle(rng):
    a, b = _rand_fq2(rng), _rand_fq2(rng)
    ta, tb = _t(tw.fq2_const(a)), _t(tw.fq2_const(b))
    assert tw.fq2_to_oracle(tw.fq2_mul(ta, tb)) == a * b
    assert tw.fq2_to_oracle(tw.fq2_sqr(ta)) == a * a
    assert tw.fq2_to_oracle(tw.fq2_inv(ta)) == a.inv()
    assert tw.fq2_to_oracle(tw.fq2_mul_by_xi(ta)) == a * F.XI
    assert bool(tw.fq2_eq(tw.fq2_mul(ta, tb), tw.fq2_mul(tb, ta)))


def test_fq6_and_fq12_products_match_oracle(rng):
    x, y = _rand_fq12(rng), _rand_fq12(rng)
    tx, ty = _t(tw.fq12_const(x)), _t(tw.fq12_const(y))
    assert tw.fq6_to_oracle(tw.fq6_mul(tx[:3], ty[:3])) == x.c0 * y.c0
    assert tw.fq6_to_oracle(tw.fq6_inv(tx[:3])) == x.c0.inv()
    assert tw.fq12_to_oracle(tw.fq12_mul(tx, ty)) == x * y
    assert tw.fq12_to_oracle(tw.fq12_sqr(tx)) == x * x
    assert tw.fq12_to_oracle(tw.fq12_inv(tx)) == x.inv()
    assert tw.fq12_to_oracle(tw.fq12_frobenius(tx)) == x.frobenius()
    assert tw.fq12_to_oracle(tw.fq12_conj(tx)) == x.conjugate()


def test_cyclotomic_square_and_is_one_match_oracle(rng):
    m = _cyclotomic(rng)
    tm = _t(tw.fq12_const(m))
    assert tw.fq12_to_oracle(tw.fq12_cyc_sqr(tm)) == m * m
    assert not bool(tw.fq12_is_one(tm))
    assert bool(tw.fq12_is_one(tw.fq12_mul(tm, tw.fq12_inv(tm))))
