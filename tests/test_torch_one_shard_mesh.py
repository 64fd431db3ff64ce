"""The sharded tier needs two executors, in the port as in the JAX verifier.

With one executor and the tier asked for (``sharded=True``, or
``LODESTAR_TPU_SHARDED=1`` with ``sharded=None``) the JAX ``TpuBlsVerifier``
routes no batch to a mesh: ``_sharded_eligible(256)`` and
``sharded_active`` are False and ``executor_health()`` has no mesh row.
``TorchBlsVerifier`` is held to the same answers at one and two executors
on the CPU, card names mapped by executor index as in
``test_torch_health.py`` (the port names a repeated card ``cpu``,
``cpu#1``; the JAX verifier its CPU devices ``cpu:0``, ``cpu:1``, and its
one unpinned executor ``default``; the mesh
is ``mesh{n}`` in both).  Nothing is compiled: both verifiers are only
constructed.
"""

import re

import jax
import pytest

from lodestar_tpu.crypto.bls.tpu_verifier import TpuBlsVerifier
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

_NAMES = {"port": re.compile(r"\bcpu(?:#(\d+))?"),
          "jax": re.compile(r"\bcpu:(\d+)|\bdefault\b")}


def norm(side, name):
    return _NAMES[side].sub(lambda m: f"ex{int(m.group(1) or 0)}", name)


def answers(side, v):
    eligible = v.sharded_eligible(256) if side == "port" else v._sharded_eligible(256)
    return (eligible, v.sharded_active, sorted(norm(side, k) for k in v.executor_health()))


@pytest.mark.parametrize("how", ["sharded=True", "LODESTAR_TPU_SHARDED=1"])
@pytest.mark.parametrize("n", [1, 2])
def test_one_executor_builds_no_mesh_as_the_jax_verifier(n, how, monkeypatch):
    if how == "sharded=True":
        monkeypatch.delenv("LODESTAR_TPU_SHARDED", raising=False)
        sharded = True
    else:
        monkeypatch.setenv("LODESTAR_TPU_SHARDED", "1")
        sharded = None
    jax_devices = jax.devices("cpu")[:n] if n > 1 else None
    jv = TpuBlsVerifier(devices=jax_devices, sharded=sharded, host_final_exp=False)
    pv = TorchBlsVerifier(devices=["cpu"] * n, sharded=sharded, host_final_exp=False)
    want = answers("jax", jv)
    assert answers("port", pv) == want
    if n == 1:
        assert want == (False, False, ["ex0"])
        assert pv.mesh_devices == 0 and pv._mesh is None
    else:
        assert want == (True, True, ["ex0", "ex1", "mesh2"])
        assert pv.mesh_devices == 2
    # the caller's choice is kept, as the JAX verifier keeps it
    assert pv.sharded is True
