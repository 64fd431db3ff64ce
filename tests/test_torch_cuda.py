"""The port's CUDA kernels on the card (cuda-marked: they skip without one).

Run on the H100 with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Each kernel (the fused path's ten, the XLA-graph path's four tower
kernels and the library kernel) is held bitwise against its plain version
on the same CUDA inputs (the cooperative kernels of chip_smoke.COOP, every
row kernel, also at 1 to 2,560 rows and at the digit bounds, and their launches do not
wait for the card; canon also at its path's 512, 1,280 and 5,120 rows and
at the edges of its branches), the library kernel also against the JAX vectors
of pallas_fuse(tower.fq2_mul) and the registry's every entry, and the
bucket-4 slice of each path on the card against the CPU plain run.  The
split dispatch (the host C final exponentiation) gives the JAX vectors'
verdicts on the card for both programs and on 2 logical shards, its
verdict does not wait for work enqueued after the batch, and one pool
flush runs through it.  The ring hop kernel is held against ``copy_`` alone
at chunks of 0-40 floats (and three longer) at every pointer offset and at every slot of the
ring's stacks (the verdict bits' odd slots 8-byte aligned), and against its plain version as an
all-gather and as a one-hop permute at 2 and 4 logical shards on card 0
and across cards when two or more are visible; the sharded tier's
verdicts at bucket 4 over 2 logical shards.  The verifier's per-bucket
graphs: a replay gives the eager program's outputs bitwise and its launch
counts, for both programs and both modes, and so does the sharded tier's
per-bucket program over 2 logical shards; two batches in flight read
their own verdicts; a dispatch after ``warmup`` calls no kernel wrapper;
a failed capture raises, and nothing runs in its place.  One profile
window over one pool flush names the ten fused kernels.  The analysis
layer's card halves: the kernels' launch resources, the child that
launches all sixteen, the default program's graph audit on the card.
``tests/kernel_build_variants.py`` holds builds of the same sources that
the port does not run to the same check."""

import asyncio
import importlib.util
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import chip_smoke
from lodestar_tpu_torch.ops import fused_core as fc
from lodestar_tpu_torch.ops import batch_verify as bv
from lodestar_tpu_torch.ops import fused_ladder  # noqa: F401 - registers lad1..3
from lodestar_tpu_torch.ops import fused_verify as fv
from lodestar_tpu_torch.ops import library_fuse as lf
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


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rows", [1, 37, 256, 257, 512, 513, 1548, 2560])
@pytest.mark.parametrize("name", chip_smoke.COOP)
def test_cooperative_ladder_kernel_equals_plain_version_on_the_card(name, rows, seed, card):
    """The cooperative kernels (lad1, lad2, lad3, fq2pow16mul,
    tower_fq6_mul and tower_fq12_mul one row a block, fq2mul, pow16mul,
    mul, fq2sqr, fold, canon, tower_fq2_mul, tower_fq2_sqr and
    library_fq2_mul as many as their builds set, with a partial last block
    at the odd counts): seeded rows
    and rows at the digit bounds (2^22 - 1 loose, 256 semi-strict),
    bitwise."""
    k = fc.KERNELS[name]
    rng = np.random.default_rng(100 * rows + seed)
    for make in (chip_smoke.kernel_inputs, chip_smoke.edge_inputs):
        ins = make(k, rows, rng, card)
        before = k.launches
        got = k(*ins)
        assert k.launches == before + 1
        for g, w in zip(got, k.plain(*ins)):
            assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("rows", chip_smoke.SHAPES["canon"])
def test_canon_equals_plain_version_at_its_path_shapes_and_branch_edges(rows, card):
    """canon at the rows its path gives it (the ladder's stacked predicate
    5,120, 1,280 and 512), seeded, at the digit bounds and, stacked in
    front, at the edges of its branches: bitwise."""
    k = fc.K_CANON
    rng = np.random.default_rng(rows)
    edges = torch.cat([chip_smoke.canon_edge_rows(c, i) for i, c in enumerate(chip_smoke.CANON_EDGES)])
    for make in (chip_smoke.kernel_inputs, chip_smoke.edge_inputs):
        (x,) = make(k, rows, rng, card)
        x[:edges.shape[0]] = edges.to(card)
        before = k.launches
        (got,) = k(x)
        assert k.launches == before + 1
        assert got.is_cuda and torch.equal(got, k.plain(x)[0])


def test_ring_hop_equals_copy_at_every_length_and_offset(card):
    chip_smoke.check_hop_offsets(card, np.random.default_rng(3), "card test")


@pytest.mark.parametrize("n", chip_smoke.RING_SHARDS)
@pytest.mark.parametrize("shape", chip_smoke.RING_SHAPES)
def test_ring_hop_fills_every_slot_of_the_rings_stacks(n, shape, card):
    """Every slot of an (n, *shape) stack (the verdict bits' odd slots
    8-byte aligned only) through one hop each, against copy_."""
    rng = np.random.default_rng(n)
    chunks = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card)
              for _ in range(n)]
    out = torch.full((n,) + shape, -7.0, device=card)
    before = rg.RING_HOP.launches
    for slot, chunk in enumerate(chunks):
        rg.launch_hop(chunk, out[slot], torch.cuda.current_stream(card))
    assert rg.RING_HOP.launches == before + n
    assert torch.equal(out, torch.stack(chunks))


def test_cooperative_launch_does_not_wait_for_the_card(card):
    """A cooperative kernel's launch, which sets the kernel's shared-memory
    attribute, returns while earlier work still runs on the card: the host
    runs ahead of the card through these launches too."""
    stream = torch.cuda.current_stream(card)
    for name in chip_smoke.COOP:
        k = fc.KERNELS[name]
        ins = chip_smoke.kernel_inputs(k, 4, np.random.default_rng(5), card)
        k(*ins)  # the first launch on the card
        torch.cuda.synchronize(card)
        with torch.cuda.device(card):
            torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's clock
        t0 = time.perf_counter()
        k(*ins)
        host_s = time.perf_counter() - t0
        busy = not stream.query()
        stream.synchronize()
        assert busy and host_s < 0.02, f"{name}: the launch took {host_s} s on the host"


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


_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


def test_library_kernel_equals_the_jax_vectors_on_the_card(card):
    with np.load(gen.FUSE_NPZ) as z:
        for name in ("b4", "rows"):
            a, b = (torch.from_numpy(z[f"{name}_in{k}"]).to(card) for k in range(2))
            before = lf.K_LIBRARY_FQ2_MUL.launches
            got = lf.fq2_mul(a, b)
            assert lf.K_LIBRARY_FQ2_MUL.launches == before + 1
            np.testing.assert_array_equal(got.cpu().numpy(), z[f"{name}_out"])


def test_every_registry_entry_launches_and_equals_its_plain_version(card):
    fc.reset_launch_counts()
    launches = chip_smoke.run_registry(card, "card test")
    assert len(launches) == 16 and all(n >= 1 for n in launches.values())


@pytest.mark.parametrize("fused", [True, False])
def test_split_bucket4_verdicts_on_the_card(fused, card):
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    with np.load(gen.XLA_NPZ) as z:
        ins = dict(z)
    v = TorchBlsVerifier(device=card, fused=fused, rng=np.random.default_rng(1))
    assert v.host_final_exp and v.device == card
    assert v.dispatch(gen.bucket4(ins)).result() is bool(ins["b4_verdict"]) is True
    assert v.dispatch(gen.bucket4(ins, corrupted=True)).result() is False
    assert v.host_final_exps == 2 and v.device_inflight() == {str(card): 0}


def test_split_verdict_waits_for_its_own_batch_only(card):
    """The split sync is the event after the batch's copies of ok and f to
    the host, not the stream: work enqueued after the batch is still
    running when its verdict has been read."""
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    with np.load(gen.XLA_NPZ) as z:
        ins = dict(z)
    v = TorchBlsVerifier(device=card, rng=np.random.default_rng(2))
    pending = v.dispatch(gen.bucket4(ins))
    stream = torch.cuda.current_stream(card)
    with torch.cuda.device(card):
        torch.cuda._sleep(4_000_000_000)  # about 2 s of the card's clock
    assert pending.result() is True
    assert not stream.query()  # the later work is still on the stream
    stream.synchronize()


def test_sharded_split_bucket8_verdicts_on_logical_shards(card):
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    with np.load(gen.SHARDED_NPZ) as z:
        ins = dict(z)
    v = TorchBlsVerifier(devices=[card, card], sharded=True, sharded_min_batch=8)
    for case, key in (("valid", "verdict_valid2"), ("corrupted", "verdict_corrupted2")):
        assert v.dispatch(gen.bucket8(ins, case)).result() is bool(ins[key])
    assert v.sharded_batches == 2


@pytest.mark.parametrize("host_final_exp", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_mesh_replay_equals_the_eager_sharded_program_bitwise(fused, host_final_exp, card):
    """The sharded tier's per-bucket program over 2 logical shards (a graph
    per shard and one for the combine) gives the eager ``ShardedProgram``'s
    outputs on the same batch bitwise, and every kernel's launches, the
    ring hop's included."""
    from lodestar_tpu_torch.crypto.bls.bucket_program import _tensors
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    with np.load(gen.SHARDED_NPZ) as z:
        ins = dict(z)
    v = TorchBlsVerifier(devices=[card, card], sharded=True, sharded_min_batch=8, fused=fused,
                         host_final_exp=host_final_exp)
    v.warmup_sharded((8,))
    program = v.mesh_programs[("mesh", 8, fused, host_final_exp)]
    assert len(program.graphs) == 3 and program.launch_rows["ring_hop"]
    entry = sv.miller_product_sharded if host_final_exp else sv.verify_signature_sets_sharded
    for case in ("valid", "corrupted"):
        packed = gen.bucket8(ins, case)
        torch.cuda.synchronize(card)
        fc.reset_launch_counts()
        want = _tensors(entry([card, card], fused)(*packed))
        torch.cuda.synchronize(card)
        eager = {name: k.launches for name, k in fc.COUNTED.items()}
        fc.reset_launch_counts()
        got, ready = program.run(packed)
        ready.synchronize()
        assert {name: k.launches for name, k in fc.COUNTED.items()} == eager
        for g, w in zip(got, want):
            assert g.is_pinned() and torch.equal(g, w.cpu())
    assert v.dispatch(gen.bucket8(ins, "valid")).result() is True
    assert v.device_inflight() == {"mesh2": 0}


def test_one_pool_flush_on_the_card(card):
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.crypto.bls import PublicKey, SingleSignatureSet, interop_secret_key
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    sets = []
    for i in range(6):
        sk = interop_secret_key(i)
        msg = b"card pool %d" % i
        sets.append(SingleSignatureSet(PublicKey.from_bytes(sk.to_public_key().to_bytes()), msg,
                                       sk.sign(msg).to_bytes()))
    sets[4] = SingleSignatureSet(sets[4].pubkey, sets[4].signing_root, sets[5].signature)

    async def main():
        pool = BlsBatchPool(TorchBlsVerifier(device=card), max_buffer_wait=0.01)
        out = await asyncio.gather(*[pool.verify_signature_sets(sets[j:j + 2])
                                     for j in range(0, 6, 2)])
        pool.close()
        return out, pool

    results, pool = asyncio.run(main())
    assert results == [True, True, False] and pool.batch_retries == 1


def test_one_profile_window_over_one_pool_flush_on_the_card(card, tmp_path):
    """One profile window (observatory/xprof.py: torch.profiler on its own
    thread) over one pool flush of the split fused program at bucket 4:
    the window finishes without an error, and its merged trace names the
    ten fused kernels among its device events."""
    from lodestar_tpu_torch import tracing
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.crypto.bls import PublicKey, SingleSignatureSet, interop_secret_key
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.observatory import xprof

    sets = []
    for i in range(3):
        sk = interop_secret_key(i)
        msg = b"card window %d" % i
        sets.append(SingleSignatureSet(PublicKey.from_bytes(sk.to_public_key().to_bytes()), msg,
                                       sk.sign(msg).to_bytes()))
    v = TorchBlsVerifier(device=card, buckets=(4,))
    v.warmup()
    tracing.enable(4096)
    cap = xprof.ProfileCapture(str(tmp_path))
    xprof.CAPTURE = cap
    try:
        async def main():
            cap.request_window(flushes=1)
            pool = BlsBatchPool(v, max_buffer_wait=0.01)
            out = await asyncio.gather(*[pool.verify_signature_sets([s]) for s in sets])
            pool.close()
            return out

        assert asyncio.run(main()) == [True] * 3
        assert cap.wait_idle(60.0) and cap.snapshot()["last_error"] is None
        doc = cap.last_window()["trace"]
    finally:
        xprof.CAPTURE = None
        tracing.disable()
        tracing.TRACER.clear()
    device = {e["name"].split("(")[0] for e in doc["traceEvents"]
              if e.get("pid", 0) >= xprof.DEVICE_PID_BASE and e.get("ph") == "X"}
    assert {f"{name}_k" for name in chip_smoke.FUSED} <= device


# -- the verifier's per-bucket graphs -------------------------------------------


def _warmed(card, fused=True, host_final_exp=True):
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    v = TorchBlsVerifier(device=card, fused=fused, host_final_exp=host_final_exp,
                         rng=np.random.default_rng(3))
    v.warmup((4,))
    return v


@pytest.mark.parametrize("host_final_exp", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_replay_equals_the_eager_program_bitwise(fused, host_final_exp, card):
    """A bucket-4 batch through the verifier's graph gives the eager ops
    entry's outputs on the same packed arrays (f's digits and ok, or the
    verdict) bitwise, and every kernel's launches of the eager run."""
    from lodestar_tpu_torch.crypto.bls.bucket_program import _tensors

    with np.load(gen.XLA_NPZ) as z:
        ins = dict(z)
    v = _warmed(card, fused, host_final_exp)
    program = v.programs[(card, 4, fused, host_final_exp)]
    assert program.graph is not None
    for corrupted in (False, True):
        packed = gen.bucket4(ins, corrupted=corrupted)
        torch.cuda.synchronize(card)
        fc.reset_launch_counts()
        want = _tensors(v._entry()(*fv.from_packed(packed, card)))
        torch.cuda.synchronize(card)
        eager = {name: k.launches for name, k in fc.COUNTED.items()}
        fc.reset_launch_counts()
        got, ready = program.run(packed)
        ready.synchronize()
        assert {name: k.launches for name, k in fc.COUNTED.items()} == eager
        assert len(got) == len(want) == (2 if host_final_exp else 1)
        for g, w in zip(got, want):
            assert g.is_pinned() and torch.equal(g, w.cpu())


@pytest.mark.parametrize("host_final_exp", [True, False])
def test_two_batches_in_flight_on_the_card_read_their_own_verdicts(host_final_exp, card):
    with np.load(gen.XLA_NPZ) as z:
        ins = dict(z)
    v = _warmed(card, host_final_exp=host_final_exp)
    valid = v.dispatch(gen.bucket4(ins))
    bad = v.dispatch(gen.bucket4(ins, corrupted=True))
    assert bad.result() is False and valid.result() is True
    assert v.device_inflight() == {str(card): 0}


def test_a_dispatch_after_warmup_makes_no_eager_launch(card, monkeypatch):
    with np.load(gen.XLA_NPZ) as z:
        ins = dict(z)
    v = _warmed(card)
    calls = []
    for k in fc.KERNELS.values():
        monkeypatch.setattr(k, "launch", lambda *rows, _k=k: calls.append(_k.name))
    assert v.dispatch(gen.bucket4(ins)).result() is True
    assert calls == []
    v.close()
    assert v.programs == {}


def test_a_failed_capture_raises_and_no_batch_runs_eagerly(card):
    """A program that copies to the host, which a capture refuses: making
    its graph raises, the verifier keeps no program and returns the
    batch's slot, and the batch does not run eagerly in its place.  In a
    process of its own: a failed capture leaves the caching allocator's
    capture state behind."""
    code = textwrap.dedent("""
        import numpy as np, torch
        from lodestar_tpu_torch.crypto.bls.bucket_program import input_specs
        from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

        runs = []

        def entry(*args):
            runs.append(torch.cuda.is_current_stream_capturing())
            return args[6].any().cpu()

        v = TorchBlsVerifier(device="cuda:0", host_final_exp=False)
        v._entry = lambda: entry
        packed = [np.zeros(shape, np.float32) for shape, _ in input_specs(4)[:6]]
        try:
            v.dispatch(packed + [np.ones(4, bool)])
        except RuntimeError:
            print("raised", runs, v.programs, v.device_inflight())
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=300)
    assert proc.stdout.strip() == "raised [False, True] {} {'cuda:0': 0}", proc.stderr


def test_launch_resources_and_the_launch_all_child_on_the_card(card):
    """The kernel audit's card half: every kernel's attributes within its
    launch configuration (the ladder kernels at their measured spill, no
    more), and the child the sanitizer watches launches all sixteen."""
    from lodestar_tpu_torch.analysis import kernel_audit

    rows = kernel_audit.launch_resources()
    assert len(rows) == 15 + 3
    assert kernel_audit.check_resources(rows) == []
    res = kernel_audit.launch_all(kernel_audit.PARTIAL_ROWS)
    assert sorted(res) == sorted(list(fc.KERNELS) + ["ring_hop"])
    assert all(r["max_abs_err"] == 0 for r in res.values())


def test_the_graph_audit_of_the_default_program_on_the_card(card):
    from lodestar_tpu_torch.analysis import graph_audit

    assert graph_audit.audit_programs((128,), "cuda", ["fused_verify.miller_product_fused"],
                                      twice=False) == []
