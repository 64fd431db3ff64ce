"""The port's XLA-graph path (points, htc, pairing, batch_verify) against
the JAX package, at a small size on the CPU plain versions.

Tier-1, no compile: the JAX outputs come from the committed golden vectors
(tests/port_vectors/generate.py, ``xla_path.npz``).  The port's tower
products follow pallas_tower's digit algorithm, not the JAX tower.py one,
so everything above them is compared by value mod p: each coordinate's
canonical residue (``fp_reduce_full``) must equal the JAX one exactly, and
every verdict must be the JAX verdict.  Tolerance zero in both."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.crypto.bls import curve as C
from lodestar_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
from lodestar_tpu_torch.ops import batch_verify as bv
from lodestar_tpu_torch.ops import htc, pairing, points, tower
from lodestar_tpu_torch.ops.limbs import fp_reduce_full

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one thread is as fast and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def xla_npz():
    with np.load(gen.XLA_NPZ) as z:
        return dict(z)


def _canon(x) -> np.ndarray:
    return fp_reduce_full(torch.as_tensor(np.asarray(x))).numpy()


def test_hash_to_g2_device_equals_jax_canonically_and_the_oracle(xla_npz):
    h = htc.hash_to_g2_device(torch.from_numpy(xla_npz["msg_u"]))
    for got, name in zip(h, ("htc_x", "htc_y", "htc_z")):
        np.testing.assert_array_equal(_canon(got), _canon(xla_npz[name]), err_msg=name)
    xa, ya = points.point_to_affine(h, points.FQ2_NS)
    for i, msg in enumerate(gen.XLA_MSGS):
        x, y = hash_to_g2(msg).to_affine()
        assert tower.fq2_to_oracle(xa[i]) == x and tower.fq2_to_oracle(ya[i]) == y


def test_g2_subgroup_check_equals_jax_on_a_member_and_a_non_member(xla_npz):
    p = points.point_from_affine(torch.from_numpy(xla_npz["g2_x"]),
                                 torch.from_numpy(xla_npz["g2_y"]), points.FQ2_NS)
    got = points.g2_subgroup_check(p).numpy()
    np.testing.assert_array_equal(got, xla_npz["g2_subgroup"])
    assert got.tolist() == [True, False]


def test_bucket4_miller_product_and_verdict_equal_jax(xla_npz):
    args = bv.from_packed(gen.bucket4(xla_npz), "cpu")
    f, ok = bv.miller_product_kernel(*args)
    assert f.shape == (6, 2, 50) and float(f.max()) <= 256
    np.testing.assert_array_equal(_canon(f), _canon(xla_npz["b4_f"]))
    assert bool(ok) is bool(xla_npz["b4_ok"]) is True
    verdict = bool(tower.fq12_is_one(pairing.final_exponentiation(f)) & ok)
    assert verdict is bool(xla_npz["b4_verdict"]) is True


def test_bucket4_corrupted_verdict_equals_jax(xla_npz):
    args = bv.from_packed(gen.bucket4(xla_npz, corrupted=True), "cpu")
    got = bool(bv.verify_signature_sets_kernel(*args))
    assert got is bool(xla_npz["b4_bad_verdict"]) is False


def test_point_formulas_match_the_oracle():
    """Doubling, the complete add (distinct, equal and opposite points) and
    the affine conversion on hashed G2 points."""
    pa = hash_to_g2(b"port points a")
    pb = hash_to_g2(b"port points b")

    def jac(pts):
        xs, ys = zip(*(pt.to_affine() for pt in pts))
        x = torch.from_numpy(np.stack([tower.fq2_const(v) for v in xs]))
        y = torch.from_numpy(np.stack([tower.fq2_const(v) for v in ys]))
        return points.point_from_affine(x, y, points.FQ2_NS)

    p, q = jac([pa, pa, pa]), jac([pb, pa, -pa])
    s = points.point_add_complete(p, q, points.FQ2_NS)
    inf = points.point_is_infinity(s, points.FQ2_NS).tolist()
    assert inf == [False, False, True]
    xa, ya = points.point_to_affine(tuple(c[:2] for c in s), points.FQ2_NS)
    for i, want in enumerate((pa + pb, pa + pa)):
        wx, wy = want.to_affine()
        assert tower.fq2_to_oracle(xa[i]) == wx and tower.fq2_to_oracle(ya[i]) == wy
    d = points.point_double(jac([pb]), points.FQ2_NS)
    dx, dy = points.point_to_affine(d, points.FQ2_NS)
    wx, wy = (pb + pb).to_affine()
    assert tower.fq2_to_oracle(dx[0]) == wx and tower.fq2_to_oracle(dy[0]) == wy
    psi = points.psi(jac([pb]))
    px, py = points.point_to_affine(psi, points.FQ2_NS)
    wx, wy = C.psi(pb).to_affine()
    assert tower.fq2_to_oracle(px[0]) == wx and tower.fq2_to_oracle(py[0]) == wy
