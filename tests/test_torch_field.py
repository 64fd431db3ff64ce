"""The PyTorch port's tower, hash-to-G2 and pairing modules against the JAX
package's bigint oracle (lodestar_tpu.crypto.bls), on the CPU plain
versions.  Tier-1: nothing here compiles a JAX program.

Values are compared as residues mod p (the port's digits are loose), so
each check is exact."""

import random

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import fields as OF
from lodestar_tpu.crypto.bls import hash_to_curve as OH
from lodestar_tpu.crypto.bls import pairing as OP
from lodestar_tpu.crypto.bls.curve import G1_GEN
from lodestar_tpu_torch.ops import fused_field as FF
from lodestar_tpu_torch.ops.fused_core import lv
from lodestar_tpu_torch.ops.fused_htc import hash_to_g2_pre_cofactor
from lodestar_tpu_torch.ops.fused_pairing import final_exponentiation
from lodestar_tpu_torch.ops.limbs import int_to_limbs, limbs_to_int

P = OF.P
RNG = random.Random(20261016)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one thread is as fast and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fq2(v: OF.Fq2) -> np.ndarray:
    return np.stack([int_to_limbs(v.c0), int_to_limbs(v.c1)])


def _fq12(v: OF.Fq12) -> np.ndarray:
    return np.stack([_fq2(c) for c in (v.c0.c0, v.c0.c1, v.c0.c2, v.c1.c0, v.c1.c1, v.c1.c2)])


def _int(a) -> int:
    return limbs_to_int(np.asarray(a)) % P


def _to_fq2(a) -> OF.Fq2:
    return OF.Fq2(_int(a[0]), _int(a[1]))


def _to_fq12(a) -> OF.Fq12:
    c = [_to_fq2(a[i]) for i in range(6)]
    return OF.Fq12(OF.Fq6(c[0], c[1], c[2]), OF.Fq6(c[3], c[4], c[5]))


def _rand_fq2() -> OF.Fq2:
    return OF.Fq2(RNG.randrange(P), RNG.randrange(P))


def _rand_fq12() -> OF.Fq12:
    return OF.Fq12(
        OF.Fq6(_rand_fq2(), _rand_fq2(), _rand_fq2()),
        OF.Fq6(_rand_fq2(), _rand_fq2(), _rand_fq2()),
    )


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr))


def test_f12_mul_matches_oracle():
    a, b = [_rand_fq12() for _ in range(2)], [_rand_fq12() for _ in range(2)]
    got = FF.f12_mul(lv(_t(np.stack([_fq12(x) for x in a]))), lv(_t(np.stack([_fq12(x) for x in b]))))
    for i in range(2):
        assert _to_fq12(got.a[i]) == a[i] * b[i]


def test_f12_cyc_sqr_matches_oracle_on_the_cyclotomic_subgroup():
    f = _rand_fq12()
    g = f.conjugate() * f.inv()  # f^(p^6 - 1)
    g = g.frobenius_n(2) * g  # ... ^(p^2 + 1): cyclotomic
    got = FF.f12_cyc_sqr(lv(_t(_fq12(g)[None])))
    assert _to_fq12(got.a[0]) == g * g


def test_f12_frobenius_matches_oracle():
    f = _rand_fq12()
    got = FF.f12_frobenius(lv(_t(_fq12(f)[None])))
    assert _to_fq12(got.a[0]) == f.frobenius()


def test_fi_inv_matches_oracle_and_maps_zero_to_zero():
    xs = [RNG.randrange(1, P) for _ in range(3)] + [0]
    got = FF.fi_inv(lv(_t(np.stack([int_to_limbs(x) for x in xs]))))
    for x, row in zip(xs, got.a):
        assert _int(row) == (pow(x, P - 2, P) if x else 0)


def test_f2_sqrt_matches_oracle_up_to_sign():
    squares = [_rand_fq2().square() for _ in range(3)]
    got = FF.f2_sqrt(lv(_t(np.stack([_fq2(s) for s in squares]))))
    for s, row in zip(squares, got.a):
        r = _to_fq2(row)
        assert r * r == s
        assert r == s.sqrt() or r == -s.sqrt()


def test_hash_to_g2_pre_cofactor_matches_oracle():
    msgs = [b"", b"abc", bytes(range(32))]
    u = np.stack(
        [np.stack([_fq2(v) for v in OH.hash_to_field_fq2(m, 2)]) for m in msgs]
    )  # (3, 2, 2, 50)
    x, y, z = hash_to_g2_pre_cofactor(lv(_t(u)))
    for i, m in enumerate(msgs):
        u0, u1 = OH.hash_to_field_fq2(m, 2)
        want = (OH.map_to_curve_g2(u0) + OH.map_to_curve_g2(u1)).to_affine()
        zi = _to_fq2(z.a[i]).inv()
        assert _to_fq2(x.a[i]) * zi * zi == want[0]
        assert _to_fq2(y.a[i]) * zi * zi * zi == want[1]


@pytest.mark.parametrize("relation", ["pairing_product_one", "random"])
def test_final_exponentiation_is_one_exactly_when_the_oracle_says_so(relation):
    if relation == "random":
        f = _rand_fq12()
    else:
        q = OH.hash_to_g2(b"final exponentiation")
        sk = 0x1234567890ABCDEF
        p_aff = (G1_GEN * sk).to_affine()
        f = OP.miller_loop((-G1_GEN).to_affine(), (q * sk).to_affine()) * OP.miller_loop(
            p_aff, q.to_affine()
        )
    want = OP.final_exponentiation(f).is_one()
    got = FF.f12_is_one(final_exponentiation(lv(_t(_fq12(f)[None]))))
    assert bool(got[0]) is want
    assert want is (relation == "pairing_product_one")
