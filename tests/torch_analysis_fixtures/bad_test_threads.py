"""Known-bad fixture for ``torch-test-threads``: a test module whose
program-running tests run with torch's default intra-op threads.  Parsed
by tests/test_torch_analysis.py, never imported or collected."""

import numpy as np
import torch

from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
from lodestar_tpu_torch.ops import fused_verify


def verifier():
    return TorchBlsVerifier(device="cpu", buckets=(4,), rng=np.random.default_rng(1))


def stub_verifier():
    v = TorchBlsVerifier(devices=["cpu"] * 2, buckets=(4,))
    v._program = lambda card, bucket: None
    return v


def test_a_real_batch(sets):  # VIOLATION: a whole program, unpinned
    assert verifier().verify_signature_sets(sets)


def test_the_entry_itself(packed):  # VIOLATION: the ops entry, unpinned
    fused_verify.miller_product_fused(*packed)


def test_pinned_in_its_body(sets):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert verifier().verify_signature_sets(sets)
    finally:
        torch.set_num_threads(before)


def test_a_stubbed_program(packed):
    assert stub_verifier().dispatch(packed).result()


def test_no_program():
    assert TorchBlsVerifier(device="cpu").buckets
