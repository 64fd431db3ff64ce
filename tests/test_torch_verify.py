"""The PyTorch port's whole slice on the CPU plain versions, at bucket 4:
TorchBlsVerifier's verdicts equal the JAX package's host verifier
(lodestar_tpu.crypto.bls.PyBlsVerifier) on the same signature sets, and the
port's example inputs and packing equal the JAX package's arrays.

Tier-1: no JAX program is compiled (PyBlsVerifier is the bigint oracle)."""

import dataclasses

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import PyBlsVerifier
from lodestar_tpu.crypto.bls import api as oapi
from lodestar_tpu.crypto.bls import verifier as over
from lodestar_tpu.crypto.bls.curve import g2_to_bytes
from lodestar_tpu.crypto.bls.hash_to_curve import hash_to_field_fq2, map_to_curve_g2
from lodestar_tpu_torch.crypto.bls import PublicKey, SingleSignatureSet
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
from lodestar_tpu_torch.ops import fused_verify as fv
from lodestar_tpu_torch.ops.htc import hash_to_field_limbs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one thread is as fast and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw_sets(n: int):
    """(pubkey bytes, message, signature bytes) for interop keys 0..n-1."""
    out = []
    for i in range(n):
        sk = oapi.interop_secret_key(i)
        msg = b"port verdict message %d" % i
        out.append((sk.to_public_key().to_bytes(), msg, sk.sign(msg).to_bytes()))
    return out


def _scenario(name: str):
    raw = _raw_sets(4)
    if name == "corrupted":
        raw[1] = (raw[1][0], raw[1][1], raw[2][2])  # another message's signature
    elif name == "non_subgroup":
        pt = map_to_curve_g2(hash_to_field_fq2(b"not in G2", 2)[0])
        raw[2] = (raw[2][0], raw[2][1], g2_to_bytes(pt))
    elif name == "padded":
        raw = raw[:3]  # 3 live sets in bucket 4
    return raw


@pytest.mark.parametrize(
    "name,expected",
    [("valid", True), ("corrupted", False), ("non_subgroup", False), ("padded", True)],
)
def test_bucket4_verdict_equals_py_bls_verifier(name, expected):
    raw = _scenario(name)
    ref_sets = [
        over.SingleSignatureSet(oapi.PublicKey.from_bytes(pk), msg, sig) for pk, msg, sig in raw
    ]
    port_sets = [SingleSignatureSet(PublicKey(raw=pk), msg, sig) for pk, msg, sig in raw]
    want = PyBlsVerifier().verify_signature_sets(ref_sets)
    verifier = TorchBlsVerifier(device="cpu", rng=np.random.default_rng(1))
    got = verifier.verify_signature_sets(port_sets)
    assert got is want is expected


def test_example_inputs_equal_the_jax_package_arrays():
    from lodestar_tpu.ops import batch_verify as bv

    for mine, ref in zip(fv.example_inputs(4), bv.example_inputs(4)):
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        np.testing.assert_array_equal(mine, ref)


def test_pack_pads_with_lane_zero_and_empty_messages():
    raw = _raw_sets(3)
    sets = [SingleSignatureSet(PublicKey(raw=pk), msg, sig) for pk, msg, sig in raw]
    pk_x, pk_y, sig_x, sig_y, msg_u, bits, mask = TorchBlsVerifier(
        device="cpu", rng=np.random.default_rng(2)
    ).pack(sets)
    assert pk_x.shape == (4, 50) and sig_x.shape == (4, 2, 50) and msg_u.shape == (4, 2, 2, 50)
    np.testing.assert_array_equal(mask, [True, True, True, False])
    for a in (pk_x, pk_y, sig_x, sig_y):
        np.testing.assert_array_equal(a[3], a[0])
    np.testing.assert_array_equal(msg_u[3], hash_to_field_limbs([b""])[0])
    np.testing.assert_array_equal(msg_u[:3], hash_to_field_limbs([m for _, m, _ in raw]))
    assert (bits[:, 0] == 1).all() and bits.shape == (4, 64)  # odd coefficients


def test_malformed_signature_is_false_without_dispatch():
    raw = _raw_sets(2)
    sets = [SingleSignatureSet(PublicKey(raw=pk), msg, sig) for pk, msg, sig in raw]
    sets[0] = dataclasses.replace(sets[0], signature=b"\x00" * 96)
    verifier = TorchBlsVerifier(device="cpu")
    assert verifier.pack(sets) is None
    assert verifier.verify_signature_sets(sets) is False
    with pytest.raises(ValueError):
        verifier.verify_signature_sets([])
