"""The library kernel and the kernel registry: the port of
``lodestar_tpu/ops/pallas_fuse.py``.

The JAX factory ``pallas_fuse(fn, *examples)`` replays any single-output
op's jaxpr inside one Pallas kernel, bit-identical to the op.  PyTorch has
no jaxpr to replay, so the factory does not port; its one instance in the
JAX package, ``pallas_fuse(tower.fq2_mul)`` (the kernel-library registry
``analysis/pallas_audit.pallas_entry_points``), does: ``fq2_mul`` is one
hand-written CUDA kernel (``kernels/library_kernels.cu``, block body
``block_library_fq2_mul`` in ``kernels/field_coop.cuh``) that gives the
JAX library ``tower.fq2_mul``'s digits bitwise.  Its plain version, ``fq2_mul_many``, is
``tower.fq2_mul_many`` written over the port's ``limbs`` ops, which equal
the JAX ``limbs`` ops bitwise.

This is not the XLA-graph path's Fq2 product: ``tower.fq2_mul_many`` of
the port runs ``tower_kernels``' ``tower_fq2_mul``, the ``pallas_tower``
algorithm, which folds every add and subtract on its own and so gives
other digits of the same value.  As in the JAX package, no verification
path runs this kernel; ``kernel_entry_points()`` does, as the JAX
registry runs its instance.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from . import limbs as fl
from .fused_core import COUNTED, KERNELS, NL, Kernel


def fq2_mul_many(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K independent Fq2 products in one limb multiply (the JAX
    ``tower.fq2_mul_many``): a, b (..., K, 2, 50) semi-strict -> the same
    shape, semi-strict.  Karatsuba per pair: t0 = a0 b0, t1 = a1 b1,
    t2 = (a0 + a1)(b0 + b1); (t0 - t1) + (t2 - (t0 + t1)) u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    lhs = torch.stack([a0, a1, fl.fp_strict(fl.fp_add(a0, a1))], dim=-2)
    rhs = torch.stack([b0, b1, fl.fp_strict(fl.fp_add(b0, b1))], dim=-2)
    t = fl.fp_mul(lhs, rhs)
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    c0 = fl.fp_sub(t0, t1)
    c1 = fl.fp_sub(t2, fl.fp_add(t0, t1))
    return torch.stack([c0, c1], dim=-2)


def _fq2_mul_plain(_c, a, b):
    return (fq2_mul_many(a.to(torch.float32), b.to(torch.float32)),)


K_LIBRARY_FQ2_MUL = Kernel("library_fq2_mul", "lodestar_tpu/ops/pallas_fuse.py:41", 2, 1,
                           (2, NL), _fq2_mul_plain, loose_in=0)


def fq2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX library's Fq2 product of (..., 2, 50) semi-strict operands
    (leading axes broadcast): the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    from .tower_kernels import call_rows

    return call_rows(K_LIBRARY_FQ2_MUL, a, b)


def _ring_gather(*chunks: torch.Tensor):
    from .ring_gather import ring_all_gather

    return tuple(ring_all_gather(list(chunks)))


def _ring_gather_plain(*chunks: torch.Tensor):
    from .ring_gather import ring_all_gather_plain

    out = [c.new_empty((len(chunks),) + tuple(c.shape)) for c in chunks]
    return tuple(ring_all_gather_plain(chunks, out))


#: shards of the ring hop's registry entry (logical shards of one device)
RING_SHARDS = 2


def kernel_entry_points(batch: int = 4) -> Dict[str, Dict[str, object]]:
    """Every hand-written kernel of the port, by name: ``fn`` (the kernel
    on CUDA tensors, its plain version on CPU tensors), ``args`` (the
    example shapes: ``batch`` rows, as the JAX registry's B = 4; the ring
    hop, one GT partial a logical shard), ``plain`` (the plain version on
    any device) and ``replaces`` (the TPU kernel, file:line).  The row
    kernels come from ``fused_core.KERNELS`` and the ring hop from
    ``fused_core.COUNTED``: this is a view of the registry, not a second
    list."""
    from . import fused_ladder, ring_gather, tower_kernels  # noqa: F401 - they register

    out: Dict[str, Dict[str, object]] = {}
    for name, counter in COUNTED.items():
        k = KERNELS.get(name)
        if k is not None:
            fn: Callable = k
            plain: Callable = k.plain
            args = tuple((batch,) + k.tail for _ in range(k.n_in))
        elif name == "ring_hop":
            fn, plain = _ring_gather, _ring_gather_plain
            args = tuple((6, 2, NL) for _ in range(RING_SHARDS))
        else:
            raise AssertionError(f"kernel {name}: no registry entry for this kind of kernel")
        out[name] = {"fn": fn, "args": args, "plain": plain, "replaces": counter.replaces}
    return out
