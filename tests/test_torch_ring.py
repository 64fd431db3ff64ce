"""The ring all-gather (the port of pallas_ring) and the sharded tier's
combines, on CPU logical shards, against the JAX package.

Tier-1, no compile: the JAX outputs come from the committed golden vectors
(tests/port_vectors/generate.py ``sharded`` ran ``lax.all_gather`` inside
``shard_map`` on a CPU mesh of 4 virtual devices, the fused product tree
in Pallas interpret mode, and the sharded entry).  Tolerance is zero
throughout: the gather moves float32 values unchanged, the fused combine
repeats the JAX digit algorithm, and the XLA-graph combines are compared
by canonical residue (the Pallas tower digits differ from JAX tower.py's
by design).  The kernel path needs the card (tests/test_torch_cuda.py).
"""

import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch

import lodestar_tpu_torch
from lodestar_tpu_torch.ops import batch_verify as bv
from lodestar_tpu_torch.ops import fused_core as fc
from lodestar_tpu_torch.ops import fused_verify as fv
from lodestar_tpu_torch.ops import limbs as fl
from lodestar_tpu_torch.ops import ring_gather as rg
from lodestar_tpu_torch.ops import sharded_verify as sv
from lodestar_tpu_torch.ops.fused_core import LV

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.fixture(scope="module")
def npz():
    with np.load(gen.SHARDED_NPZ) as z:
        return dict(z)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one thread each is as fast and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chunks(stack: np.ndarray):
    return [torch.from_numpy(np.ascontiguousarray(c)) for c in stack]


def _seeded_stack(n: int, shape) -> np.ndarray:
    return np.random.default_rng(n).standard_normal((n,) + shape).astype(np.float32)


def test_sharded_inputs_regenerate_from_seed(npz):
    for name, arr in gen.sharded_inputs().items():
        np.testing.assert_array_equal(arr, npz[name], err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("what", ["parts", "bits"])
def test_plain_gather_equals_lax_all_gather_bitwise(n, what, npz):
    before = rg.RING_HOP.launches
    out = rg.ring_all_gather(_chunks(npz[f"{what}{n}"]))
    want = npz[f"gather_{what}{n}"]  # (n, n, ...): every shard's replica
    assert want.shape == (n, n) + npz[f"{what}{n}"].shape[1:]
    for s in range(n):
        assert out[s].dtype == torch.float32
        np.testing.assert_array_equal(out[s].numpy(), want[s])
    assert rg.RING_HOP.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("shape", [(6, 2, 50), (2,)])
def test_plain_gather_lands_every_chunk_at_its_shard_index(n, shape):
    stack = _seeded_stack(n, shape)
    out = [torch.full((n,) + shape, float("nan")) for _ in range(n)]
    got = rg.ring_all_gather(_chunks(stack), out)
    for s in range(n):
        assert got[s] is out[s]
        np.testing.assert_array_equal(out[s].numpy(), stack)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("shape", [(6, 2, 50), (2,)])
def test_plain_permute_is_one_hop_of_the_ring(n, shape):
    stack = _seeded_stack(n, shape)
    got = rg.ring_permute(_chunks(stack))
    np.testing.assert_array_equal(torch.stack(got).numpy(), np.roll(stack, 1, axis=0))


def test_hop_order_is_the_pallas_schedule():
    # hop k: shard s forwards the chunk of shard (s - k) mod n
    assert rg.hop_order(3) == [(0, 0, 0), (0, 1, 1), (0, 2, 2), (1, 0, 2), (1, 1, 0), (1, 2, 1)]
    assert rg.hop_order(1) == []


def test_wrapper_raises_on_mixed_shapes_types_and_devices():
    a = torch.zeros(6, 2, 50)
    with pytest.raises(ValueError):
        rg.ring_all_gather([a, torch.zeros(2)])
    with pytest.raises(TypeError):
        rg.ring_all_gather([a, a.double()])
    with pytest.raises(TypeError):
        rg.ring_permute([a.double(), a.double()])
    with pytest.raises(ValueError):
        rg.ring_all_gather([a, torch.zeros(6, 2, 50, device="meta")])
    with pytest.raises(ValueError):
        rg.ring_all_gather([a, a], out=[torch.zeros(2, 6, 2, 50), torch.zeros(3, 6, 2, 50)])
    with pytest.raises(ValueError):
        rg.ring_all_gather([])


@pytest.mark.parametrize("n", [2, 4])
def test_fused_combine_equals_the_jax_product_tree_bitwise(n, npz):
    mesh = sv.Mesh(["cpu"] * n)
    parts = [LV(t, 256) for t in _chunks(npz[f"parts{n}"])]
    f = sv.f12_combine_all_gather_lv(mesh, parts)
    assert float(f.a.max()) <= f.b <= fc.MAX_BOUND  # loose digits within their bound
    np.testing.assert_array_equal(f.a.numpy(), npz[f"f12_tree{n}"])


def test_fused_ring_combine_equals_the_jax_ring_bitwise(npz):
    mesh = sv.Mesh(["cpu"] * 4)
    parts = [LV(t, 256) for t in _chunks(npz["parts4"])]
    got = sv.f12_combine_ring_lv(mesh, parts)  # shard 0's accumulation order
    np.testing.assert_array_equal(got.a.numpy(), npz["combine_f12_ring4"][0])


@pytest.mark.parametrize("combine", ["all_gather", "ring"])
def test_xla_graph_combine_equals_the_jax_combine_by_residue(combine, npz):
    fn = sv.fq12_combine_ring if combine == "ring" else sv.fq12_combine_all_gather
    got = fn(sv.Mesh(["cpu"] * 4), _chunks(npz["parts4"]))
    want = npz[f"combine_fq12_{combine}4"][0]  # shard 0's replica
    np.testing.assert_array_equal(fl.fp_reduce_full(got).numpy(),
                                  fl.fp_reduce_full(torch.from_numpy(want)).numpy())


@pytest.mark.parametrize(
    "bits,expected",
    [
        ([(1, 1), (1, 1)], True),
        ([(1, 1), (1, 0)], True),  # an all-padding shard does not veto
        ([(1, 0), (1, 1), (1, 0), (1, 0)], True),
        ([(1, 1), (0, 1)], False),  # a signature outside G2 on shard 1
        ([(0, 0), (1, 1)], False),
        ([(1, 0), (1, 0)], False),  # no live lane anywhere
    ],
)
def test_combine_ok_truth_table(bits, expected):
    mesh = sv.Mesh(["cpu"] * len(bits))
    sg = [torch.tensor(bool(b[0])) for b in bits]
    al = [torch.tensor(bool(b[1])) for b in bits]
    got = sv.combine_ok(mesh, sg, al)
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) is expected


@pytest.mark.parametrize("n", [2, 4])
def test_combine_ok_on_the_gathered_jax_bits(n, npz):
    bits = npz[f"bits{n}"].astype(bool)
    want = bool(bits[:, 0].all() & bits[:, 1].any())
    got = sv.combine_ok(sv.Mesh(["cpu"] * n), [torch.tensor(b[0]) for b in bits],
                        [torch.tensor(b[1]) for b in bits])
    assert bool(got) is want


def test_map_issues_every_shard_in_order_from_the_calling_thread():
    mesh = sv.Mesh(["cpu"] * 4)
    calls = []

    def fn(s, x, y):
        calls.append((s, threading.current_thread()))
        return s, x + y

    assert mesh.map(fn, "abcd", "efgh") == [(0, "ae"), (1, "bf"), (2, "cg"), (3, "dh")]
    assert calls == [(s, threading.current_thread()) for s in range(4)]


# the single-card entry on the sharded vectors' bucket-8 batches (the
# sharded entry's verdicts: tests/test_torch_sharded.py)
@pytest.mark.parametrize("n,case", [(2, "valid"), (2, "corrupted"), (4, "live5")])
def test_single_card_entry_verdict_equals_the_jax_sharded_entry(n, case, npz):
    packed = gen.bucket8(npz, case)
    got = bv.verify_signature_sets_kernel(*fv.from_packed(packed, "cpu"))
    assert bool(got) is bool(npz[f"verdict_{case}{n}"])


def test_unknown_combine_and_uneven_split_raise():
    with pytest.raises(ValueError):
        sv.verify_signature_sets_sharded(["cpu", "cpu"], combine="tree")
    with pytest.raises(ValueError):
        sv.Mesh(["cpu"] * 3).split((np.zeros((4, 50)),))


def test_cuda_and_cuda0_name_one_device_and_one_constant(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    want = torch.device("cuda", 0)
    for spec in ("cuda", "cuda:0", torch.device("cuda"), torch.device("cuda", 0)):
        assert lodestar_tpu_torch.resolve_device(spec) == want
    arr = fc._CONST_TABLE
    assert fl._const_key(arr, "cuda", torch.int32) == fl._const_key(arr, "cuda:0", torch.int32)
    assert fl._const_key(arr, "cpu", torch.int32)[1] == torch.device("cpu")


def test_launch_count_is_exact_under_parallel_issuing_threads():
    k = fc.KERNELS["mul"]
    k.reset()
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 2000
    start = threading.Barrier(n_threads)

    def issue():
        start.wait(timeout=60)
        for _ in range(per_thread):
            k.count_launch()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        threads = [threading.Thread(target=issue) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == n_threads * per_thread
    fc.reset_launch_counts()
    assert k.launches == 0 and rg.RING_HOP.launches == 0
    assert fc.COUNTED["ring_hop"] is rg.RING_HOP and "ring_hop" not in fc.KERNELS
