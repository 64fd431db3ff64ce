"""The port's CUDA kernels on the card (cuda-marked: they skip without one).

Run on the H100 with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Each kernel (the fused path's ten and the XLA-graph path's four tower
kernels) is held bitwise against its plain version on the same CUDA
inputs, and the bucket-4 slice of each path on the card against the CPU
plain run.  The ring hop kernel is held against its plain version as an
all-gather and as a one-hop permute at 2 and 4 logical shards on card 0
and across cards when two or more are visible; the sharded tier's
verdicts at bucket 4 over 2 logical shards.
``tests/kernel_build_variants.py`` holds builds of the same sources that
the port does not run to the same check."""

import numpy as np
import pytest
import torch

import chip_smoke
from lodestar_tpu_torch.ops import fused_core as fc
from lodestar_tpu_torch.ops import batch_verify as bv
from lodestar_tpu_torch.ops import fused_ladder  # noqa: F401 - registers lad1..3
from lodestar_tpu_torch.ops import fused_verify as fv
from lodestar_tpu_torch.ops import ring_gather as rg
from lodestar_tpu_torch.ops import sharded_verify as sv
from lodestar_tpu_torch.ops import tower_kernels  # noqa: F401 - registers the tower kernels
from lodestar_tpu_torch.ops.limbs import fp_reduce_full

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels only run on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(fc.KERNELS))
@pytest.mark.parametrize("rows", [1, 37, 512, 1548, 2560])
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


def test_bucket4_xla_miller_product_on_the_card_equals_the_cpu_plain_run(card):
    packed = bv.example_inputs(4)
    f_gpu, ok_gpu = bv.miller_product_kernel(*bv.from_packed(packed, card))
    f_cpu, ok_cpu = bv.miller_product_kernel(*bv.from_packed(packed, "cpu"))
    assert torch.equal(fp_reduce_full(f_gpu).cpu(), fp_reduce_full(f_cpu))
    assert bool(ok_gpu) and bool(ok_cpu)
    assert bool(bv.verify_signature_sets_kernel(*bv.from_packed(packed, card)))


def _check_ring(devices, shape, seed):
    rng = np.random.default_rng(seed)
    chunks = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(d)
              for d in devices]
    streams = [torch.cuda.Stream(device=d) for d in devices]
    for d in set(devices):
        torch.cuda.synchronize(d)
    before = rg.RING_HOP.launches
    got = rg.ring_all_gather(chunks, streams=streams)
    got_p = rg.ring_permute(chunks, streams=streams)
    n = len(devices)
    assert rg.RING_HOP.launches == before + n * n + n
    for d in set(devices):
        torch.cuda.synchronize(d)
    want = rg.ring_all_gather_plain(chunks, [torch.empty_like(g) for g in got])
    for g, w in zip(got + got_p, want + rg.ring_permute_plain(chunks)):
        assert g.is_cuda and g.device == w.device and torch.equal(g, w)
    for g in got:
        assert torch.equal(g.cpu(), torch.stack([c.cpu() for c in chunks]))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", [(6, 2, 50), (2,)])
def test_ring_kernel_equals_plain_version_on_logical_shards(n, shape, card):
    _check_ring([card] * n, shape, n)


@pytest.mark.parametrize("shape", [(6, 2, 50), (2,)])
def test_ring_kernel_equals_plain_version_across_cards(shape, card):
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("one card visible: the cross-card ring needs two")
    _check_ring([torch.device("cuda", i) for i in range(min(count, 4))], shape, 7)


@pytest.mark.parametrize("fused", [True, False])
def test_sharded_bucket4_verdicts_on_logical_shards(fused, card):
    packed = fv.example_inputs(4)
    program = sv.verify_signature_sets_sharded([card, card], fused=fused)
    assert bool(program(*packed)) is True
    bad = list(packed)
    bad[2] = bad[2].copy()
    bad[2][0, 0, 0] += 1
    assert bool(program(*bad)) is False
