"""The XLA-graph program's split dispatch at bucket 4 on the CPU:
``TorchBlsVerifier(fused=False)`` with the host C final exponentiation
(the default) gives, on valid, corrupted, non-subgroup and padded
batches, the JAX vectors' and the JAX host verifier's verdicts, and the
full-device verdict on the same Miller product (exact: verdicts).

A file of its own beside test_torch_split.py, so that the two files'
bucket-4 verdicts (several seconds each) run on two test workers."""

import pytest
import torch

from test_torch_split import SCENARIOS, split_verdict, xla_npz  # noqa: F401 - the fixture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name,expected", SCENARIOS)
def test_xla_split_verdict_equals_full_device_and_jax(name, expected, xla_npz, monkeypatch):  # noqa: F811
    got, full, want = split_verdict(False, name, xla_npz, monkeypatch)
    assert got is full is want is expected
