"""The split dispatch (the device Miller product, the host C final
exponentiation), the asynchronous verdict and chunking, on the CPU.

- The port's C final exponentiation (``native/fastbls``, a copy of the JAX
  package's ``csrc/fastbls.c``) gives the verdict of the port's bigint
  oracle and of the JAX package's native library on the same Fq12 blobs
  (stored Miller products, one whose final power is one, and seeded
  random ones); its full output is the oracle's, cubed (the C hard part
  computes f^(3 (p^12 - 1) / r)).  Exact: tolerance zero.
- A failed build raises; nothing falls back.
- The fused program's split verdicts at bucket 4 (valid, corrupted,
  non-subgroup, padded) equal the JAX vectors' and the JAX host verifier's
  verdicts, and the full-device verdict on the same Miller product; the
  sharded split over 2 logical CPU shards at bucket 8 equals the JAX
  sharded entry's stored verdicts (valid, corrupted) and the JAX host
  verifier's (a signature outside G2 in shard 1, which returns on the
  combined ok bits before any host final exponentiation).
- ``PendingVerdict.result()`` is idempotent and returns its in-flight
  slot exactly once; batches above the largest bucket are chunked, every
  chunk enqueued before any verdict is read, and a chunk whose pack
  raises leaves no slot taken.

The XLA-graph program's split verdicts are in test_torch_split_xla.py.
Each bucket-4 verdict runs the plain versions for several seconds.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import PyBlsVerifier
from lodestar_tpu.crypto.bls import api as oapi
from lodestar_tpu.crypto.bls import verifier as over
from lodestar_tpu.crypto.bls.curve import g2_to_bytes
from lodestar_tpu.crypto.bls.hash_to_curve import hash_to_field_fq2, map_to_curve_g2
from lodestar_tpu.native import fastbls as jax_fastbls
from lodestar_tpu.ops.sharded_verify import mesh_device_name as jax_mesh_device_name
from lodestar_tpu_torch.crypto.bls import PublicKey, SingleSignatureSet
from lodestar_tpu_torch.crypto.bls import fields as F
from lodestar_tpu_torch.crypto.bls import torch_verifier as tv
from lodestar_tpu_torch.crypto.bls.bucket_program import input_specs
from lodestar_tpu_torch.crypto.bls.pairing import final_exponentiation
from lodestar_tpu_torch.crypto.bls.torch_verifier import (
    DEFAULT_BUCKETS,
    PendingVerdict,
    TorchBlsVerifier,
)
from lodestar_tpu_torch.native import fastbls
from lodestar_tpu_torch.ops.fused_field import f12_is_one
from lodestar_tpu_torch.ops.fused_pairing import final_exponentiation as device_final_exp

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many tiny ops: one thread is as fast and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def xla_npz():
    with np.load(gen.XLA_NPZ) as z:
        return dict(z)


@pytest.fixture(scope="module")
def sharded_npz():
    with np.load(gen.SHARDED_NPZ) as z:
        return dict(z)


def _oracle(blob: bytes) -> F.Fq12:
    c = [int.from_bytes(blob[48 * i:48 * i + 48], "big") for i in range(12)]
    return F.Fq12(F.Fq6(F.Fq2(*c[0:2]), F.Fq2(*c[2:4]), F.Fq2(*c[4:6])),
                  F.Fq6(F.Fq2(*c[6:8]), F.Fq2(*c[8:10]), F.Fq2(*c[10:12])))


def _blob(f: F.Fq12) -> bytes:
    comps = [x for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2) for x in (f2.c0, f2.c1)]
    return b"".join(c.to_bytes(48, "big") for c in comps)


def _blobs(xla_npz, sharded_npz):
    """The stored Miller products (the JAX bucket-4 one, whose final power
    is one, and the sharded product trees) and two seeded random Fq12s."""
    out = {"b4_f": tv.fq12_blob(xla_npz["b4_f"]),
           "f12_tree2": tv.fq12_blob(sharded_npz["f12_tree2"]),
           "f12_tree4": tv.fq12_blob(sharded_npz["f12_tree4"])}
    rng = np.random.default_rng(gen.SEED + 40)
    for k in range(2):
        vals = [int.from_bytes(rng.bytes(48), "big") % F.P for _ in range(12)]
        out[f"random{k}"] = b"".join(v.to_bytes(48, "big") for v in vals)
    return out


def test_c_final_exp_equals_the_oracle_and_the_jax_native_library(xla_npz, sharded_npz):
    verdicts = {}
    for name, blob in _blobs(xla_npz, sharded_npz).items():
        want = final_exponentiation(_oracle(blob))
        got = fastbls.final_exp_is_one(blob)
        assert got is want.is_one() is jax_fastbls.final_exp_is_one(blob), name
        assert fastbls.final_exp(blob) == _blob(want * want * want), name
        verdicts[name] = got
    # the stored valid batch's product has final power one; the others not
    assert verdicts == {"b4_f": True, "f12_tree2": False, "f12_tree4": False,
                        "random0": False, "random1": False}


def test_fq12_blob_reduces_loose_digits():
    digits = np.zeros((6, 2, 50), np.float32)
    digits[0, 0, :] = 256.0  # above p's top digits: the value exceeds p
    digits[5, 1, 0] = 3.0
    blob = tv.fq12_blob(digits)
    first = sum(256 << (8 * i) for i in range(50)) % F.P
    assert blob[:48] == first.to_bytes(48, "big") and blob[-48:] == (3).to_bytes(48, "big")
    with pytest.raises(ValueError):
        fastbls.final_exp_is_one(blob[:-1])


@pytest.mark.parametrize("cc", ["/nonexistent/bin/cc", "false"])
def test_a_failed_build_raises_and_nothing_falls_back(cc, monkeypatch):
    with pytest.raises(RuntimeError):
        fastbls.build(cc=cc)
    monkeypatch.setattr(fastbls, "CC", cc)
    monkeypatch.setattr(fastbls, "_lib", None)
    monkeypatch.setattr(fastbls, "_error", None)
    blob = (1).to_bytes(48, "big") + bytes(48 * 11)
    for _ in range(2):  # the first failure is kept, not retried
        with pytest.raises(RuntimeError):
            fastbls.final_exp_is_one(blob)
    assert fastbls._lib is None
    monkeypatch.setattr(fastbls, "_error", None)
    with pytest.raises(RuntimeError):
        TorchBlsVerifier(device="cpu")._host_final_exp_verdict(torch.zeros(6, 2, 50),
                                                               torch.tensor(True))


# -- the split verdicts ---------------------------------------------------------


def _raw_sets(n: int, outside_g2=()):
    """n interop-key sets; the signatures at ``outside_g2`` replaced by a
    point of the curve outside G2."""
    out = []
    for i in range(n):
        sk = oapi.interop_secret_key(i)
        msg = b"port split message %d" % i
        out.append((sk.to_public_key().to_bytes(), msg, sk.sign(msg).to_bytes()))
    for i in outside_g2:
        pt = map_to_curve_g2(hash_to_field_fq2(b"split: not in G2", 2)[0])
        out[i] = (out[i][0], out[i][1], g2_to_bytes(pt))
    return out


def _both(raw):
    """(JAX sets, port sets) of the same raw (pubkey, message, signature)s."""
    ref = [over.SingleSignatureSet(oapi.PublicKey.from_bytes(pk), m, s) for pk, m, s in raw]
    port = [SingleSignatureSet(PublicKey(raw=pk), m, s) for pk, m, s in raw]
    return ref, port


def _scenario_sets(name: str):
    """(JAX sets, port sets) of a bucket-4 scenario the stored vectors do
    not hold: a signature outside G2, or 3 live sets in bucket 4."""
    if name == "non_subgroup":
        return _both(_raw_sets(4, outside_g2=(2,)))
    return _both(_raw_sets(3))


def split_verdict(fused: bool, name: str, xla_npz, monkeypatch):
    """(split verdict, full-device verdict on the same Miller product,
    reference verdict) of one bucket-4 scenario: the stored valid and
    corrupted batches against the JAX vectors, the others against the JAX
    host verifier."""
    miller_name = "miller_product_fused" if fused else "miller_product_kernel"
    seen = []
    real = getattr(tv, miller_name)
    monkeypatch.setattr(tv, miller_name, lambda *a: seen.append(real(*a)) or seen[-1])
    verifier = TorchBlsVerifier(device="cpu", fused=fused, rng=np.random.default_rng(5))
    assert verifier.host_final_exp is True  # the default
    if name in ("valid", "corrupted"):
        packed = gen.bucket4(xla_npz, corrupted=name == "corrupted")
        want = bool(xla_npz["b4_verdict" if name == "valid" else "b4_bad_verdict"])
        got = verifier.dispatch(packed).result()
    else:
        ref, port = _scenario_sets(name)
        want = PyBlsVerifier().verify_signature_sets(ref)
        got = verifier.verify_signature_sets(port)
    (f, ok), = seen
    if fused:
        full = bool(f12_is_one(device_final_exp(f)) & ok)
    else:
        from lodestar_tpu_torch.ops import pairing as kp
        from lodestar_tpu_torch.ops import tower as tw

        full = bool(tw.fq12_is_one(kp.final_exponentiation(f)) & ok)
    assert verifier.host_final_exps == int(bool(ok))
    assert verifier.device_inflight() == {"cpu": 0}
    return got, full, want


SCENARIOS = [("valid", True), ("corrupted", False), ("non_subgroup", False), ("padded", True)]


@pytest.mark.parametrize("name,expected", SCENARIOS)
def test_fused_split_verdict_equals_full_device_and_jax(name, expected, xla_npz, monkeypatch):
    got, full, want = split_verdict(True, name, xla_npz, monkeypatch)
    assert got is full is want is expected


@pytest.mark.parametrize("case,key", [("valid", "verdict_valid2"),
                                      ("corrupted", "verdict_corrupted2"),
                                      ("non_subgroup", None)])
def test_sharded_split_over_two_cpu_shards_equals_jax(case, key, sharded_npz):
    verifier = TorchBlsVerifier(devices=["cpu", "cpu"], sharded=True, sharded_min_batch=8,
                                rng=np.random.default_rng(6))
    if key is None:  # set 5 (shard 1) signed outside G2
        ref, port = _both(_raw_sets(8, outside_g2=(5,)))
        want = PyBlsVerifier().verify_signature_sets(ref)
        packed = verifier.pack(port)
    else:
        want = bool(sharded_npz[key])
        packed = gen.bucket8(sharded_npz, case)
    pending = verifier.dispatch(packed)
    mesh = jax_mesh_device_name(2)
    assert pending.device == mesh and verifier.device_inflight() == {mesh: 1}
    assert pending.result() is want is (case == "valid")
    assert verifier.sharded_batches == 1 and verifier.device_inflight() == {mesh: 0}
    # the ok bits decide a batch outside G2 before any host final exponentiation
    if case != "corrupted":  # (the stored corrupted x may fail either check)
        assert verifier.host_final_exps == int(case == "valid")


# -- PendingVerdict and chunking -----------------------------------------------


def test_pending_verdict_is_idempotent_and_releases_once():
    released = []
    p = PendingVerdict(out=torch.tensor(True), release=lambda: released.append(1))
    assert released == []
    assert p.result() is True and p.result() is True
    assert released == [1]

    class Broken:
        calls = 0

        def _host_final_exp_verdict(self, f, ok, ready=None):
            Broken.calls += 1
            raise RuntimeError("sync failed")

    p = PendingVerdict(verifier=Broken(), f=torch.zeros(1), ok=torch.tensor(True),
                       release=lambda: released.append(2))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="sync failed"):
            p.result()
    assert released == [1, 2] and Broken.calls == 1
    assert PendingVerdict(value=False).result() is False


def _fake_packed(n):
    b = next(b for b in DEFAULT_BUCKETS if n <= b)
    digits = tuple(np.zeros(shape, np.float32) for shape, _ in input_specs(b)[:6])
    return digits + (np.arange(b) < n,)


def test_chunks_above_the_largest_bucket_enqueue_before_any_read(xla_npz, monkeypatch):
    events = []
    verifier = TorchBlsVerifier(device="cpu")
    f = torch.from_numpy(xla_npz["b4_f"])  # a product whose final power is one
    monkeypatch.setattr(verifier, "pack", lambda sets: events.append(("pack", len(sets)))
                        or _fake_packed(len(sets)))
    monkeypatch.setattr(tv, "miller_product_fused",
                        lambda *a: events.append("enqueue") or (f, torch.tensor(True)))
    real = fastbls.final_exp_is_one
    monkeypatch.setattr(tv.fastbls, "final_exp_is_one",
                        lambda blob: events.append("final") or real(blob))
    sets = [object()] * (2 * DEFAULT_BUCKETS[-1] + 10)
    pending = verifier.verify_signature_sets_async(sets)
    assert pending.device is None
    assert events == [("pack", 256), "enqueue", ("pack", 256), "enqueue", ("pack", 10),
                      "enqueue"]
    assert verifier.device_inflight() == {"cpu": 3}
    assert pending.result() is True
    assert events[6:] == ["final"] * 3
    assert verifier.device_inflight() == {"cpu": 0} and verifier.host_final_exps == 3


def test_a_malformed_chunk_is_false_and_every_chunk_releases(monkeypatch):
    verifier = TorchBlsVerifier(device="cpu")
    calls = []
    monkeypatch.setattr(verifier, "pack", lambda sets: None if calls else _fake_packed(len(sets)))
    monkeypatch.setattr(tv, "miller_product_fused",
                        lambda *a: calls.append(1) or (torch.zeros(6, 2, 50), torch.tensor(False)))
    pending = verifier.verify_signature_sets_async([object()] * (DEFAULT_BUCKETS[-1] + 1))
    assert verifier.device_inflight() == {"cpu": 1}
    assert pending.result() is False
    assert verifier.device_inflight() == {"cpu": 0} and verifier.host_final_exps == 0


def test_placement_is_least_loaded_with_a_round_robin_tie_break(monkeypatch):
    verifier = TorchBlsVerifier(devices=["cpu", "meta"])  # two distinct "cards"
    monkeypatch.setattr(tv, "miller_product_fused",
                        lambda *a: (torch.zeros(6, 2, 50), torch.tensor(False)))
    assert verifier.n_devices == 2
    a = verifier.dispatch(_fake_packed(4))
    b = verifier.dispatch(_fake_packed(4))
    assert (a.device, b.device) == ("cpu", "meta")
    a.result()  # cpu is free again, meta still busy
    c = verifier.dispatch(_fake_packed(4))  # the least loaded
    d = verifier.dispatch(_fake_packed(4))  # one batch each: the cursor's turn
    e = verifier.dispatch(_fake_packed(4))
    assert (c.device, d.device, e.device) == ("cpu", "meta", "cpu")
    assert verifier.device_inflight() == {"cpu": 2, "meta": 2}
    for p in (b, c, d, e):
        assert p.result() is False
    assert verifier.device_inflight() == {"cpu": 0, "meta": 0}


def test_a_chunk_whose_pack_raises_leaves_no_slot_taken(monkeypatch):
    verifier = TorchBlsVerifier(device="cpu")
    packs = []

    def pack(sets):
        packs.append(len(sets))
        if len(packs) == 2:
            raise RuntimeError("pack failed")
        return _fake_packed(len(sets))

    monkeypatch.setattr(verifier, "pack", pack)
    monkeypatch.setattr(tv, "miller_product_fused",
                        lambda *a: (torch.zeros(6, 2, 50), torch.tensor(False)))
    with pytest.raises(RuntimeError, match="pack failed"):
        verifier.verify_signature_sets_async([object()] * (2 * DEFAULT_BUCKETS[-1] + 1))
    assert packs == [256, 256]
    assert verifier.device_inflight() == {"cpu": 0}


def test_verify_signature_sets_reads_the_async_verdict(monkeypatch):
    verifier = TorchBlsVerifier(device="cpu")
    monkeypatch.setattr(verifier, "verify_signature_sets_async",
                        lambda sets: PendingVerdict(value=len(sets) == 2))
    assert verifier.verify_signature_sets([1, 2]) is True
    with pytest.raises(ValueError):
        TorchBlsVerifier(device="cpu").verify_signature_sets_async([])
    sets = [SingleSignatureSet(PublicKey(raw=pk), m, s) for pk, m, s in _raw_sets(2)]
    sets[0] = dataclasses.replace(sets[0], signature=b"\x00" * 96)
    pending = TorchBlsVerifier(device="cpu").verify_signature_sets_async(sets)
    assert pending.result() is False and pending.device is None


def test_concurrent_dispatch_and_results_keep_exact_in_flight_counts(monkeypatch):
    """Host threads pack, dispatch and read verdicts at once (the pool's
    worker threads): the placement and the counters lose no update."""
    import sys
    import threading

    verifier = TorchBlsVerifier(devices=["cpu", "meta"], rng=np.random.default_rng(8))
    monkeypatch.setattr(tv, "miller_product_fused",
                        lambda *a: (torch.zeros(6, 2, 50), torch.tensor(False)))
    threads, per_thread, errors = 32, 50, []
    placed = {"cpu": 0, "meta": 0}
    lock = threading.Lock()

    def work():
        try:
            for _ in range(per_thread):
                verifier._coefficients(4)
                p = verifier.dispatch(_fake_packed(4))
                with lock:
                    placed[p.device] += 1
                assert p.result() is False
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool) and errors == []
    assert verifier.device_inflight() == {"cpu": 0, "meta": 0}
    assert sum(placed.values()) == threads * per_thread and min(placed.values()) > 0
    assert verifier.stage_seconds["sync"] > 0
