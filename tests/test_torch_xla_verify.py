"""TorchBlsVerifier(fused=False), the XLA-graph program, at bucket 4 on
the CPU plain versions: its verdicts equal the JAX package's host verifier
(lodestar_tpu.crypto.bls.PyBlsVerifier, the bigint oracle) on the valid,
corrupted, non-subgroup and padded batches of test_torch_verify.

Tier-1: no JAX program is compiled."""

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import PyBlsVerifier
from lodestar_tpu.crypto.bls import api as oapi
from lodestar_tpu.crypto.bls import verifier as over
from lodestar_tpu_torch.crypto.bls import PublicKey, SingleSignatureSet
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
from lodestar_tpu_torch.ops import fused_core
from test_torch_verify import _scenario


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize(
    "name,expected",
    [("valid", True), ("corrupted", False), ("non_subgroup", False), ("padded", True)],
)
def test_bucket4_xla_verdict_equals_py_bls_verifier(name, expected):
    raw = _scenario(name)
    ref_sets = [
        over.SingleSignatureSet(oapi.PublicKey.from_bytes(pk), msg, sig) for pk, msg, sig in raw
    ]
    port_sets = [SingleSignatureSet(PublicKey(raw=pk), msg, sig) for pk, msg, sig in raw]
    want = PyBlsVerifier().verify_signature_sets(ref_sets)
    # the full-device mode; the split default: test_torch_split_xla.py
    verifier = TorchBlsVerifier(device="cpu", rng=np.random.default_rng(1), fused=False,
                                host_final_exp=False)
    assert verifier.fused is False
    fused_core.reset_launch_counts()
    got = verifier.verify_signature_sets(port_sets)
    assert got is want is expected
    # the CPU runs the plain versions: no kernel is launched
    assert all(k.launches == 0 for k in fused_core.KERNELS.values())


def test_fused_stays_the_default():
    assert TorchBlsVerifier(device="cpu").fused is True
