"""The sharded tier on CPU logical shards, against the JAX package's sharded
entry, and the verifier's routing between the sharded and per-card tiers.

Tier-1, no compile: the JAX verdicts come from the committed golden
vectors (tests/port_vectors/generate.py ``sharded`` ran
``verify_signature_sets_sharded(make_mesh(n), fused=False)`` at bucket 8
on a CPU mesh of virtual devices).  The port's entry over the same mesh
must give the same verdict (the port's single-card entry on the same
batches: tests/test_torch_ring.py).  Each bucket-8 verdict takes tens of
seconds on the CPU (every shard's plain versions, one after the other).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.crypto.bls.bucket_program import input_specs
from lodestar_tpu_torch.crypto.bls.torch_verifier import DEFAULT_BUCKETS, TorchBlsVerifier
from lodestar_tpu_torch.ops import sharded_verify as sv

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

# (shards, case): the bucket-8 batches of the JAX vectors
CASES = [(2, "valid"), (2, "corrupted"), (4, "live5")]


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


@pytest.mark.parametrize("n,case", CASES)
def test_sharded_entry_verdict_equals_the_jax_sharded_entry(n, case, npz):
    packed = gen.bucket8(npz, case)
    want = bool(npz[f"verdict_{case}{n}"])
    assert want is (case != "corrupted")
    program = sv.verify_signature_sets_sharded(["cpu"] * n, fused=False)
    got = program(*packed)
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) is want
    assert len(program.mesh.enqueue_walls) == n


def test_shard_slices_are_contiguous_batch_ranges(npz):
    packed = gen.bucket8(npz)
    slices = sv.Mesh(["cpu"] * 4).split(packed)
    for s, sl in enumerate(slices):
        for a, part in zip(packed, sl):
            np.testing.assert_array_equal(part, a[2 * s:2 * s + 2])
    # the live5 mask leaves shard 3 all padding, shard 2 one live lane
    mask = gen.bucket8(npz, "live5")[6]
    assert [bool(sl[0].any()) for sl in sv.Mesh(["cpu"] * 4).split((mask,))] == [
        True, True, True, False]


def test_verifier_tier_defaults(monkeypatch):
    """The sharded tier is opt-in: two devices leave it off unless the
    caller passes ``sharded=True`` (or ``LODESTAR_TPU_SHARDED`` turns it
    on, below)."""
    monkeypatch.delenv("LODESTAR_TPU_SHARDED", raising=False)
    single = TorchBlsVerifier(device="cpu")
    assert single.devices == [torch.device("cpu")] and not single.sharded
    assert single.mesh_devices == 0 and single.sharded_batches == 0
    assert single.shard_enqueue_walls == []
    two = TorchBlsVerifier(devices=["cpu", "cpu"])
    assert not two.sharded and two.mesh_devices == 0 and not two.sharded_active
    assert two.n_devices == 1 and two.shard_enqueue_walls == []
    mesh = TorchBlsVerifier(devices=["cpu", "cpu"], sharded=True)
    assert mesh.sharded and mesh.mesh_devices == 2
    assert mesh.sharded_min_batch == DEFAULT_BUCKETS[-1] == 256
    assert TorchBlsVerifier(devices=["cpu", "cpu"], sharded=False).mesh_devices == 0
    with pytest.raises(ValueError):
        TorchBlsVerifier(devices=[])
    with pytest.raises(ValueError):
        TorchBlsVerifier(devices=["cpu", "cpu"], sharded=True, sharded_combine="tree")


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("env", [None, "0", "1", "no"])
def test_sharded_default_is_the_jax_verifiers(env, n, monkeypatch):
    """``sharded=None`` resolves as the JAX verifier's ``_sharded_default``
    on the CPU backend: off unless ``LODESTAR_TPU_SHARDED`` says on, which
    it does for any value but 0, false and no."""
    from lodestar_tpu.crypto.bls.tpu_verifier import _sharded_default

    if env is None:
        monkeypatch.delenv("LODESTAR_TPU_SHARDED", raising=False)
    else:
        monkeypatch.setenv("LODESTAR_TPU_SHARDED", env)
    want = _sharded_default(n)
    assert want is (env == "1")
    v = TorchBlsVerifier(devices=["cpu"] * n)
    assert v.sharded is want
    # one executor builds no mesh, as in the JAX verifier
    assert v.mesh_devices == (n if want and n >= 2 else 0)


def _zero_packed(b):
    """Zero digit arrays of ``pack()``'s shapes at bucket b, every lane live."""
    digits = tuple(np.zeros(shape, np.float32) for shape, _ in input_specs(b)[:6])
    return digits + (np.ones(b, bool),)


def test_verifier_routes_eligible_buckets_to_the_mesh(monkeypatch):
    v = TorchBlsVerifier(devices=["cpu"] * 4, sharded=True, sharded_min_batch=16,
                         host_final_exp=False)
    assert [b for b in DEFAULT_BUCKETS if v.sharded_eligible(b)] == [16, 64, 128, 256]
    assert not TorchBlsVerifier(devices=["cpu"] * 3, sharded=True,
                                sharded_min_batch=16).sharded_eligible(64)
    calls = []

    class _Mesh:
        def run(self, packed):
            calls.append("mesh")
            return (torch.tensor(True),), None

    monkeypatch.setattr(v, "_mesh_program_for", lambda bucket: _Mesh())
    monkeypatch.setattr(
        "lodestar_tpu_torch.crypto.bls.torch_verifier.verify_signature_sets_fused",
        lambda *args: calls.append(("card", args[0].device)) or torch.tensor(True))
    for b in (4, 16, 256):
        packed = _zero_packed(b)
        assert v.dispatch(packed).result() is True
    assert calls == [("card", torch.device("cpu")), "mesh", "mesh"]
    assert v.sharded_batches == 2


def test_per_card_tier_round_robins_over_distinct_cards(monkeypatch):
    v = TorchBlsVerifier(devices=["cpu", "meta"], sharded=False,  # two distinct "cards"
                         host_final_exp=False)
    seen = []
    monkeypatch.setattr(
        "lodestar_tpu_torch.crypto.bls.torch_verifier.verify_signature_sets_fused",
        lambda *args: seen.append(args[0].device) or torch.tensor(True))
    packed = _zero_packed(4)
    pending = [v.dispatch(packed) for _ in range(3)]
    assert seen == [torch.device("cpu"), torch.device("meta"), torch.device("cpu")]
    assert v.sharded_batches == 0
    # resolved, so the batches leave the process-wide in-flight table
    assert [p.result() for p in pending] == [True, True, True]
