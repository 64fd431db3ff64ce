"""The port's CUDA kernels on the card (cuda-marked: they skip without one).

Run on the H100 with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Each kernel is held bitwise against its plain version on the same CUDA
inputs, and the bucket-4 slice on the card against the CPU plain run.
``tests/kernel_build_variants.py`` holds builds of the same sources that
the port does not run to the same check."""

import numpy as np
import pytest
import torch

import chip_smoke
from lodestar_tpu_torch.ops import fused_core as fc
from lodestar_tpu_torch.ops import fused_ladder  # noqa: F401 - registers lad1..3
from lodestar_tpu_torch.ops import fused_verify as fv

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels only run on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(fc.KERNELS))
@pytest.mark.parametrize("rows", [1, 37, 512, 2560])
def test_kernel_equals_plain_version_on_the_card(name, rows, card):
    k = fc.KERNELS[name]
    ins = chip_smoke.kernel_inputs(k, max(rows, 4), np.random.default_rng(rows), card)
    ins = [t[:rows].contiguous() for t in ins]
    before = k.launches
    got = k(*ins)
    assert k.launches == before + 1
    for g, w in zip(got, k.plain(*ins)):
        assert g.is_cuda and torch.equal(g, w)


def test_bucket4_miller_product_on_the_card_equals_the_cpu_plain_run(card):
    packed = fv.example_inputs(4)
    f_gpu, ok_gpu = fv.miller_product_fused(*fv.from_packed(packed, card))
    f_cpu, ok_cpu = fv.miller_product_fused(*fv.from_packed(packed, "cpu"))
    assert torch.equal(f_gpu.a.cpu(), f_cpu.a)
    assert bool(ok_gpu) and bool(ok_cpu)
    assert bool(fv.verify_signature_sets_fused(*fv.from_packed(packed, card)))
