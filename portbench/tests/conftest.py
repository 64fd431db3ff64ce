"""Tests of the benchmark itself, on the CPU, apart from the port's
``tests/``:

    python3 -m pytest portbench/tests -q

A test that needs the card carries the ``cuda`` marker and takes the
``card`` fixture, which decides at run time whether a card is present."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no NVIDIA card: the port's kernels run only on one")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def tiny_config():
    """The default node's configuration at a size a CPU run holds: 512
    keys, committees of 8, blocks of 11 sets, a sync committee of 32."""
    from portbench import traffic

    cfg = traffic.load_json(os.path.join(ROOT, "portbench", "configs",
                                         "mainnet-default-node.json"))
    cfg.update(active_validators=32 * 64 * 8, target_committee_size=8, validator_keys=512,
               max_attestations_per_block=8, sync_committee_size=32)
    return cfg
