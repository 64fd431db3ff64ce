"""The sharded tier's per-bucket program (``bucket_program.MeshProgram``) on
CPU logical shards, against the eager ``ShardedProgram`` and the JAX
package's sharded entry; ``warmup_sharded`` and ``warmup``'s mesh pass
against the JAX verifier's (``tpu_verifier.py`` ``_warmup_sharded_tier``,
``warmup_sharded``, ``warmup``).

On the CPU nothing is captured: the program runs its pieces (each shard's
local body, then the combine) eagerly through its static inputs and
outputs, so these tests hold the cut of the tier into pieces and the
program's copies; the card holds the graphs (chip_smoke phase 9).  The
JAX verdicts come from the committed golden vectors
(``tests/port_vectors/sharded.npz``, as ``test_torch_sharded.py``); each
bucket-8 run takes tens of seconds on one CPU thread, so the XLA-graph
program's cases are in test_torch_mesh_program_xla.py, which another test
worker runs.
"""

import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import tpu_verifier as jtv
from lodestar_tpu.forensics.journal import JOURNAL as JJOURNAL
from lodestar_tpu_torch.crypto.bls import torch_verifier as tv
from lodestar_tpu_torch.crypto.bls.bucket_program import MeshProgram
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier, fq12_blob
from lodestar_tpu_torch.forensics import JOURNAL
from lodestar_tpu_torch.native import fastbls
from lodestar_tpu_torch.observatory import COMPILE_LEDGER
from lodestar_tpu_torch.ops import sharded_verify as sv

# the JAX side's stub verifier (the port's is lodestar_tpu_torch.tools.chaos_campaign's)
from tools.chaos_campaign import stub_verifier as jax_stub_verifier

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

#: shards -> the bucket-8 batch of the JAX vectors held at that count
CASE = {2: "valid", 4: "live5"}


@pytest.fixture(scope="module")
def npz():
    with np.load(gen.SHARDED_NPZ) as z:
        return dict(z)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def verdict(outs, full: bool) -> bool:
    """A program's verdict from its host outputs: the device's, or (f, ok)
    through the C final exponentiation."""
    if full:
        return bool(outs[0])
    return bool(outs[1]) and fastbls.final_exp_is_one(fq12_blob(outs[0].numpy()))


def check_against_eager(n, fused, full, npz):
    """At bucket 8 over n CPU shards: the program's outputs (f's digits
    and ok, or the verdict) bitwise equal the eager entry's on the same
    mesh, and the verdict is the JAX sharded entry's."""
    packed = gen.bucket8(npz, CASE[n])
    eager = sv.ShardedProgram(["cpu"] * n, fused, "all_gather", full)
    want = eager(*packed)
    want = (want,) if full else want
    program = MeshProgram(eager.mesh, 8, fused, "all_gather", full, [threading.Lock()])
    assert not program.graphs and program.seconds == {}  # nothing captured on the CPU
    got, ready = program.run(packed)
    assert ready is None and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert verdict(got, full) is bool(npz[f"verdict_{CASE[n]}{n}"]) is True
    if (n, fused, full) == (2, False, True):
        # a second batch through the same program: its own verdict, and the
        # first batch's outputs are its own
        kept = [g.clone() for g in got]
        bad, _ = program.run(gen.bucket8(npz, "corrupted"))
        assert verdict(bad, full) is bool(npz["verdict_corrupted2"]) is False
        assert all(torch.equal(g, k) for g, k in zip(got, kept))


@pytest.mark.parametrize("full", [False, True], ids=["split", "full"])
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_program_equals_the_eager_sharded_program(n, full, npz):
    """The fused program (the XLA-graph one: test_torch_mesh_program_xla.py)."""
    check_against_eager(n, True, full, npz)


def test_mesh_program_refuses_a_bucket_the_shards_do_not_split():
    with pytest.raises(ValueError, match="split"):
        MeshProgram(sv.Mesh(["cpu"] * 4), 6, True, "all_gather", False, [threading.Lock()])


def _pair(n, monkeypatch, min_batch=16):
    """A port verifier over n CPU shards (no program is run: its made mesh
    programs are recorded) and the JAX verifier over n CPU devices whose
    ``_mesh_fn`` and per-device tier are stubbed, both with the sharded
    tier on at ``min_batch``."""
    made = {"port": [], "jax": []}
    port = TorchBlsVerifier(devices=["cpu"] * n, sharded=True, sharded_min_batch=min_batch,
                            host_final_exp=False)
    real = port._mesh_program_for

    def port_mesh(bucket, load_only=None):
        made["port"].append(("mesh", bucket))
        return real(bucket, load_only)

    monkeypatch.setattr(port, "_mesh_program_for", port_mesh)
    monkeypatch.setattr(port, "_program",
                        lambda card, bucket, load_only=None: made["port"].append(("card", bucket)))
    jax = jax_stub_verifier(n_devices=n, device_s=0.0, sharded=True, bucket=4)
    jax.sharded_min_batch = min_batch
    jax.buckets = tv.DEFAULT_BUCKETS
    monkeypatch.setattr(jax, "_mesh_fn", lambda b: made["jax"].append(("mesh", b)))
    monkeypatch.setattr(jax, "_warmup_tier", lambda buckets, load_only: made["jax"].extend(
        ("card", b) for b in buckets) or [])
    return port, jax, made


def _warmup_events(journal, seq0):
    keys = ("kind", "sharded", "mesh_programs", "devices", "load_only", "fused")
    return [{k: e[k] for k in keys if k in e} for e in journal.events()
            if e["seq"] >= seq0 and e["kind"] == "bls.warmup"]


@pytest.mark.parametrize("n", [2, 4])
def test_warmup_sharded_makes_the_jax_verifiers_mesh_programs(n, monkeypatch):
    """``warmup_sharded`` makes one program per bucket of the JAX
    verifier's ``_sharded_buckets`` (at least ``sharded_min_batch``, split
    evenly over the shards) and journals ``bls.warmup`` as it does; a
    second call makes nothing new."""
    port, jax, made = _pair(n, monkeypatch)
    seq = (JOURNAL.seq, JJOURNAL.seq)
    buckets = (4, 8, 16, 24, 64, 256)
    assert port.warmup_sharded(buckets) >= 0 and jax.warmup_sharded(buckets) >= 0
    want = [("mesh", b) for b in jax._sharded_buckets(buckets)]
    assert made["port"] == made["jax"] == want
    assert sorted(k[1] for k in port.mesh_programs) == [b for _, b in want]
    assert all(k == ("mesh", k[1], True, False) for k in port.mesh_programs)
    assert _warmup_events(JOURNAL, seq[0]) == _warmup_events(JJOURNAL, seq[1]) == [
        {"kind": "bls.warmup", "sharded": True, "mesh_programs": len(want), "devices": n}]
    before = dict(port.mesh_programs)
    port.warmup_sharded(buckets)
    assert port.mesh_programs == before


def test_warmup_runs_the_mesh_pass_after_the_per_card_pass(monkeypatch):
    port, jax, made = _pair(4, monkeypatch)
    buckets = (16, 64)
    port.warmup(buckets)
    jax.warmup(buckets)
    want = [("card", 16), ("card", 64), ("mesh", 16), ("mesh", 64)]
    assert made["port"] == made["jax"] == want


def test_warmup_sharded_without_the_tier_makes_nothing(monkeypatch):
    """Off, or over one shard, the pass makes no program (the JAX
    verifier's ``n_devices < 2`` and tier checks)."""
    seq0 = JOURNAL.seq
    off = TorchBlsVerifier(devices=["cpu"] * 2, sharded=False)
    one = TorchBlsVerifier(devices=["cpu"], sharded=True, sharded_min_batch=4)
    for v in (off, one):
        v.warmup_sharded()
        assert v.mesh_programs == {}
    assert [e["mesh_programs"] for e in JOURNAL.events()
            if e["seq"] >= seq0 and e["kind"] == "bls.warmup"] == [0, 0]


def test_a_second_dispatch_at_a_bucket_reuses_its_program(monkeypatch):
    v = TorchBlsVerifier(devices=["cpu"] * 2, sharded=True, sharded_min_batch=8,
                         host_final_exp=False)
    ran = []

    def run(self, packed):
        ran.append(self)
        return (torch.tensor(True),), None

    monkeypatch.setattr(MeshProgram, "run", run)
    packed = tuple(np.zeros(s, np.float32) for s in ((8, 50), (8, 50), (8, 2, 50), (8, 2, 50),
                                                     (8, 2, 2, 50), (8, 64))) + (np.ones(8, bool),)
    assert v.dispatch(packed).result() and v.dispatch(packed).result()
    assert len(ran) == 2 and ran[0] is ran[1]
    assert list(v.mesh_programs) == [("mesh", 8, True, False)]
    assert v.mesh_programs[("mesh", 8, True, False)] is ran[0]
    assert v.sharded_batches == 2


def test_warmup_sharded_ledgers_a_capture_then_a_hit_under_the_mesh_label(monkeypatch):
    """On a card a made program notes its eager, capture and instantiation
    seconds as one ``capture`` on (``sharded_full``, bucket, ``mesh{n}``);
    a bucket already made is a ``hit`` (the JAX mesh pass's window)."""

    class Captured:
        def __init__(self, mesh, bucket, *args):
            self.seconds = {"eager": 1.0, "capture": 0.5, "instantiate": 0.25}

    monkeypatch.setattr(tv, "MeshProgram", Captured)
    COMPILE_LEDGER.clear()
    v = TorchBlsVerifier(devices=["cpu"] * 4, sharded=True, sharded_min_batch=16,
                         host_final_exp=False)
    v.warmup_sharded((16,))
    v.warmup_sharded((16,))
    key = COMPILE_LEDGER.key("sharded_full", 16, "mesh4")
    kinds = COMPILE_LEDGER.to_dict()[key]["kinds"]
    assert kinds["capture"]["count"] == 1 and kinds["capture"]["total_s"] == 1.75
    assert kinds["hit"]["count"] == 1
    assert jtv._entry_name((16, False, False)) == tv.entry_name(False, False) == "xla_full"
    COMPILE_LEDGER.clear()
