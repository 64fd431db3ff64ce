"""The sharded tier's per-bucket program (``bucket_program.MeshProgram``)
of the XLA-graph program on CPU logical shards, against the eager
``ShardedProgram`` and the JAX sharded entry's vectors, as
test_torch_mesh_program.py holds the fused program's; and the ring of
products through the program's pieces.

A file of its own beside test_torch_mesh_program.py, so that the two
files' bucket-8 runs (tens of seconds each on one CPU thread) run on two
test workers."""

import threading

import pytest
import torch

from lodestar_tpu_torch.crypto.bls.bucket_program import MeshProgram
from lodestar_tpu_torch.ops import sharded_verify as sv

from test_torch_mesh_program import check_against_eager, gen, npz, verdict  # noqa: F401 - the fixture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("full", [False, True], ids=["split", "full"])
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_program_equals_the_eager_sharded_program(n, full, npz):
    check_against_eager(n, False, full, npz)


def test_ring_combine_program_equals_the_eager_ring(npz):
    """The ring of products (``sharded_combine="ring"``) through the
    program's pieces equals the eager ring, bitwise."""
    packed = gen.bucket8(npz, "valid")
    eager = sv.ShardedProgram(["cpu"] * 2, False, "ring", False)
    want = eager(*packed)
    got, _ = MeshProgram(eager.mesh, 8, False, "ring", False, [threading.Lock()]).run(packed)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert verdict(got, False) is True
