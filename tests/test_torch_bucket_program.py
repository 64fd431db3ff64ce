"""The verifier's per-bucket programs (``crypto/bls/bucket_program.py``), its
bucket ladder, ``warmup`` / ``warmup_async`` and its counters, on the CPU.

- The counters (``dispatches``, ``sets_verified``, ``padding_wasted``,
  ``pack_rejected``, ``pack_cache_hits``, ``pack_cache_misses``) equal the
  JAX verifier's after every step of one sequence of batches (a bucket-4
  batch, a bucket-8 one, a chunked one, a malformed signature, the first
  batch again), both verifiers' device programs replaced by host stubs as
  the JAX tests' ``stub_verifier`` replaces them.
- The bucket a batch takes equals the JAX ``_bucket`` for every ladder and
  size tried, and ``pack()`` pads to it.
- Two batches in flight through one ``BucketProgram`` read their own
  outputs, not the program's static ones: a valid and a corrupted
  bucket-4 batch, both dispatched before either is read, read in reverse
  order give True, then False (the fused split program's plain versions:
  about 20 s).
- ``warmup`` adds its seconds to ``stage_seconds["warmup"]`` and makes
  every requested program; ``warmup_async`` does it on a daemon thread.
- A capture records its launches instead of counting them; each replay
  adds the record.

The programs on the card (graph replay against the eager launches, bitwise;
equal launch counts; no eager launch after ``warmup``) are cuda-marked in
``test_torch_cuda.py``.
"""

import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import api as oapi
from lodestar_tpu.crypto.bls import verifier as over
from lodestar_tpu.crypto.bls.tpu_verifier import TpuBlsVerifier
from lodestar_tpu_torch.crypto.bls import PublicKey, SingleSignatureSet
from lodestar_tpu_torch.crypto.bls.bucket_program import BucketProgram, input_specs
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
from lodestar_tpu_torch.ops import fused_core as fc

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

CPU = torch.device("cpu")
COUNTERS = ("dispatches", "sets_verified", "padding_wasted", "pack_rejected",
            "pack_cache_hits", "pack_cache_misses")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests here run a verifier's programs' plain versions: one intra-op
    thread, as the other program-running files pin it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def raw_sets():
    """10 interop-key sets as raw (public key, message, signature) bytes."""
    out = []
    for i in range(10):
        sk = oapi.interop_secret_key(i)
        msg = b"bucket program message %d" % i
        out.append((sk.to_public_key().to_bytes(), msg, sk.sign(msg).to_bytes()))
    return out


def _both(raw):
    """(JAX sets, port sets) of the same raw sets."""
    ref = [over.SingleSignatureSet(oapi.PublicKey.from_bytes(pk), m, s) for pk, m, s in raw]
    port = [SingleSignatureSet(PublicKey(raw=pk), m, s) for pk, m, s in raw]
    return ref, port


def _stubbed_pair(buckets=(4, 8)):
    """A JAX verifier and a port verifier at ``buckets``, the XLA-graph
    program in the full-device mode, each program a host stub that says
    True."""
    ref = TpuBlsVerifier(buckets=buckets, fused=False, host_final_exp=False)
    for ex in ref._executors:
        for b in buckets:
            ex.compiled[(b, False, False)] = lambda *a: True
    port = TorchBlsVerifier(device="cpu", buckets=buckets, fused=False, host_final_exp=False)
    port._entry = lambda: (lambda *a: torch.tensor(True))
    return ref, port


def test_counters_equal_the_jax_verifiers_after_every_step(raw_sets):
    ref, port = _stubbed_pair()
    malformed = list(raw_sets[:3])
    malformed[0] = (malformed[0][0], malformed[0][1], b"\x00" * 96)
    steps = [("3 valid sets, bucket 4", raw_sets[:3], True),
             ("5 sets, bucket 8", raw_sets[3:8], True),
             ("10 sets, chunked", raw_sets, True),
             ("a malformed signature", malformed, False),
             ("the first batch again", raw_sets[:3], True)]
    try:
        for what, raw, want in steps:
            ref_sets, port_sets = _both(raw)
            assert ref.verify_signature_sets(ref_sets) is want, what
            assert port.verify_signature_sets(port_sets) is want, what
            got = {name: getattr(port, name) for name in COUNTERS}
            assert got == {name: getattr(ref, name) for name in COUNTERS}, what
        # (1 + 1 + 2 + 0 + 1 dispatches; padding 1 + 3 + (0 + 2) + 1; the
        # malformed batch's first key hits and its signature misses)
        assert got == {"dispatches": 5, "sets_verified": 21, "padding_wasted": 7,
                       "pack_rejected": 1, "pack_cache_hits": 23, "pack_cache_misses": 21}
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("buckets", [(4, 8), (4, 16, 64, 128, 256), (1,), (3, 7, 32),
                                     (16, 4)])
def test_bucket_choice_is_the_jax_verifiers(buckets):
    ref = TpuBlsVerifier(buckets=buckets)
    port = TorchBlsVerifier(device="cpu", buckets=buckets)
    assert port.buckets == ref.buckets == tuple(sorted(buckets))
    for n in range(1, 2 * max(buckets) + 2):
        assert port._bucket(n) == ref._bucket(n), n


def test_pack_pads_to_the_jax_bucket(raw_sets):
    ref, port = _stubbed_pair()
    for n in (1, 3, 4, 5, 8):
        ref_sets, port_sets = _both(raw_sets[:n])
        b = ref._bucket(n)
        packed = port.pack(port_sets)
        assert packed[0].shape[0] == ref.pack(ref_sets)[0].shape[0] == b, n
        assert [a.shape for a in packed] == [shape for shape, _ in input_specs(b)]
        assert packed[6].sum() == n
    with pytest.raises(ValueError):
        port.pack(_both(raw_sets)[1] + _both(raw_sets)[1][:1])  # 11 sets above bucket 8


def test_two_batches_in_flight_read_their_own_verdicts():
    """A valid and a corrupted batch through one program, both dispatched
    before either verdict is read, read in reverse order."""
    with np.load(gen.XLA_NPZ) as z:
        ins = dict(z)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        v = TorchBlsVerifier(device="cpu", rng=np.random.default_rng(13))
        valid = v.dispatch(gen.bucket4(ins))
        bad = v.dispatch(gen.bucket4(ins, corrupted=True))
        assert list(v.programs) == [(CPU, 4, True, True)]
        assert v.device_inflight() == {"cpu": 2}
        assert bad.result() is False
        assert valid.result() is True
    finally:
        torch.set_num_threads(threads)
    assert v.device_inflight() == {"cpu": 0} and v.dispatches == 2 and v.sets_verified == 8


def test_each_run_returns_outputs_of_its_own():
    """The static outputs are overwritten by every run; a run's returned
    outputs are not."""
    program = BucketProgram(CPU, 4, lambda pk_x, *rest: (pk_x.sum(), rest[-1].any()),
                            threading.Lock())
    packed = [np.zeros(shape, np.float32) for shape, _ in input_specs(4)[:6]]
    first, ready = program.run(packed + [np.ones(4, bool)])
    packed[0] = np.ones_like(packed[0])
    second, _ = program.run(packed + [np.zeros(4, bool)])
    assert ready is None
    assert (float(first[0]), bool(first[1])) == (0.0, True)
    assert (float(second[0]), bool(second[1])) == (200.0, False)
    assert torch.equal(program.outputs[0], second[0])
    with pytest.raises(ValueError):
        program.run(packed[:5] + [np.zeros((4, 50), np.float32), np.zeros(4, bool)])
    with pytest.raises(ValueError):
        program.run(packed)


def test_warmup_makes_every_program_and_counts_its_seconds():
    v = TorchBlsVerifier(device="cpu", fused=False)
    dt = v.warmup((4,))
    assert dt > 0 and v.stage_seconds["warmup"] == dt
    assert list(v.programs) == [(CPU, 4, False, True)]
    assert v.programs[(CPU, 4, False, True)].graph is None  # nothing to capture on the CPU
    v.warmup()
    assert sorted(k[1] for k in v.programs) == list(v.buckets)
    v.close()
    assert v.programs == {}
    with pytest.raises(RuntimeError):
        v.warmup()


def test_warmup_async_runs_warmup_on_a_daemon_thread():
    v = TorchBlsVerifier(device="cpu", buckets=(4, 8, 16))
    t = v.warmup_async((8, 16))
    assert isinstance(t, threading.Thread) and t.daemon
    t.join(timeout=60)
    assert not t.is_alive()
    assert sorted(k[1] for k in v.programs) == [8, 16]
    assert v.stage_seconds["warmup"] > 0


def test_a_capture_records_its_launches_and_each_replay_adds_them():
    k = fc.KERNELS["fold"]
    before = k.launches
    other = []
    with fc.recording_launches() as record:
        for rows in (1024, 1024, 8):
            k.count_launch(rows)
        # another thread's launches are counted as ever
        t = threading.Thread(target=lambda: other.append(k.count_launch(3)))
        t.start()
        t.join()
        with pytest.raises(RuntimeError):
            with fc.recording_launches():
                pass
    assert record == {"fold": {1024: 2, 8: 1}}
    assert k.launches == before + 1 and other == [None]
    fc.add_launches(record)
    fc.add_launches(record)
    assert k.launches == before + 7
    k.count_launch(5)
    assert k.launches == before + 8
