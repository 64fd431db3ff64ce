"""The library kernel (the port of pallas_fuse's one instance,
pallas_fuse(tower.fq2_mul)) and the kernel registry, against the JAX
package.

Tier-1, no compile: the JAX outputs come from the committed golden vectors
(tests/port_vectors/generate.py ran pallas_fuse(tower.fq2_mul) in
interpret mode on the CPU).  The plain version (CPU tensors) must equal
them digit for digit, every output digit <= 256: both are exact integer
arithmetic, so the tolerance is zero.  Against the XLA-graph path's Fq2
product (the pallas_tower algorithm, other digits) and the bigint oracle
the comparison is by value mod p, tolerance zero.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.crypto.bls import fields as F
from lodestar_tpu_torch.ops import fused_core as fc
from lodestar_tpu_torch.ops import library_fuse as lf
from lodestar_tpu_torch.ops import limbs as fl
from lodestar_tpu_torch.ops import tower_kernels as tk

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_vectors", "generate.py")
_spec = importlib.util.spec_from_file_location("port_vectors_generate", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)


@pytest.fixture(scope="module")
def fuse_npz():
    with np.load(gen.FUSE_NPZ) as z:
        return dict(z)


def test_fuse_inputs_regenerate_from_seed(fuse_npz):
    ins = gen.fuse_inputs()
    assert set(ins) == {"b4_in0", "b4_in1", "rows_in0", "rows_in1"}
    for name, arr in ins.items():
        assert arr.dtype == np.float32 and arr.max() <= 256
        np.testing.assert_array_equal(arr, fuse_npz[name], err_msg=name)
    # digits of 256, the semi-strict edge, are among the inputs
    assert (ins["rows_in1"][4:8] == 256).all() and (ins["rows_in0"][3] == 256).all()


@pytest.mark.parametrize("name", ["b4", "rows"])
def test_plain_equals_jax_pallas_fuse_digits_bitwise(name, fuse_npz):
    a, b = (torch.from_numpy(fuse_npz[f"{name}_in{k}"]) for k in range(2))
    got = lf.fq2_mul(a, b)  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and float(got.max()) <= 256
    np.testing.assert_array_equal(got.numpy(), fuse_npz[f"{name}_out"])
    (rows,) = lf.K_LIBRARY_FQ2_MUL(a.contiguous(), b.contiguous())
    assert torch.equal(rows, got)


def test_plain_equals_the_tower_kernel_and_the_oracle_by_value(fuse_npz):
    a, b = (torch.from_numpy(fuse_npz[f"rows_in{k}"]) for k in range(2))
    got = lf.fq2_mul(a, b)
    (tower,) = tk.K_FQ2_MUL(a, b)
    assert not torch.equal(got, tower)  # two digit algorithms
    assert torch.equal(fl.fp_reduce_full(got), fl.fp_reduce_full(tower))
    for r in (0, 1, 2, 3, 4, 17, 299):
        x = F.Fq2(*(fl.limbs_to_int(a[r, i].numpy()) % F.P for i in range(2)))
        y = F.Fq2(*(fl.limbs_to_int(b[r, i].numpy()) % F.P for i in range(2)))
        want = x * y
        assert [fl.limbs_to_int(got[r, i].numpy()) % F.P for i in range(2)] == [want.c0, want.c1]


def test_fq2_mul_broadcasts_leading_axes(fuse_npz):
    a = torch.from_numpy(fuse_npz["rows_in0"][:6]).reshape(2, 3, 2, 50)
    b = torch.from_numpy(fuse_npz["rows_in1"][:3])
    got = lf.fq2_mul(a, b)
    assert got.shape == (2, 3, 2, 50)
    for i in range(2):
        assert torch.equal(got[i], lf.fq2_mul(a[i], b))


def test_kernel_entry_points_name_all_sixteen_kernels():
    entries = lf.kernel_entry_points()
    assert len(entries) == 16
    assert set(entries) == set(fc.COUNTED) == set(fc.KERNELS) | {"ring_hop"}
    assert entries["library_fq2_mul"]["fn"] is lf.K_LIBRARY_FQ2_MUL
    assert entries["library_fq2_mul"]["replaces"] == "lodestar_tpu/ops/pallas_fuse.py:41"
    assert entries["library_fq2_mul"]["args"] == ((4, 2, 50), (4, 2, 50))
    assert entries["ring_hop"]["replaces"] == "lodestar_tpu/ops/pallas_ring.py:93"
    for name, e in entries.items():
        k = fc.KERNELS.get(name)
        if k is not None:
            assert e["args"] == tuple((4,) + k.tail for _ in range(k.n_in)), name


def test_every_entry_runs_its_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    fc.reset_launch_counts()
    for name, e in lf.kernel_entry_points().items():
        k = fc.KERNELS.get(name)
        top = [(1 << 22) - 1 if k is not None and i < k.loose_in else 256
               for i in range(len(e["args"]))]
        ins = [torch.from_numpy(rng.integers(0, t + 1, size=shape).astype(np.float32))
               for t, shape in zip(top, e["args"])]
        got, want = e["fn"](*ins), e["plain"](*ins)
        assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)), name
    # the CPU takes the plain versions: no kernel was launched
    assert all(c.launches == 0 for c in fc.COUNTED.values())


def test_the_library_kernel_is_built_with_the_others():
    from lodestar_tpu_torch.ops.kernels import _build

    assert _build.LAUNCHERS["library_fq2_mul"] == "library_kernels.cu"
    assert {"field_coop.cuh", "library_kernels.cu"} <= set(_build.SOURCES)
    assert len(_build.LAUNCHERS) == 16
    # the width-51 pad of limbs.fp_sub sits at the end of the kernels' table
    np.testing.assert_array_equal(fc._CONST_TABLE[-(fl.NLIMBS + 1):],
                                  fl._sub_pad(fl.NLIMBS + 1).astype(np.int32))
