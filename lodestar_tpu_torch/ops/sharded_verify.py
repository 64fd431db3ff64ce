"""The sharded tier: one merged batch split over a 1-D mesh of shards.

The port of ``lodestar_tpu/ops/sharded_verify.py``.  A mesh is a list of
devices, one per shard; a card may appear several times (logical shards,
as the JAX package's tests use virtual CPU devices).  The batch axis is cut
into n contiguous slices, as ``PartitionSpec('x')`` cuts it, and:

(a) each shard runs the unchanged single-card program on its slice
    (``fused_verify.miller_product_parts`` or
    ``batch_verify.miller_product_parts_kernel``): its own (-g1, S_shard)
    pair, so its (6, 2, 50) Miller partial and two verdict bits;
(b) the partials and the bits cross the mesh through the ring kernel
    (``ops/ring_gather``): an all-gather (the default; shard 0 then runs
    the pow2 product tree on its stack) or a ring of n - 1 one-hop
    permutes, each followed by one Fq12 product on shard 0;
(c) on shard 0: the combined product, the mesh verdict bits
    (``combine_ok``), and in the full entry the final exponentiation and
    the is-one check.  The JAX program replicates these steps on every
    shard, where they cost nothing; here each replica is thousands of host
    launches, and only shard 0's result is returned.

The final exponentiation thus runs once per merged batch, never once per
slice.  A shard whose slice is all padding contributes 1 and does not veto
the batch: the mesh verdict is ``all(subgroup_ok) & any(any_live)``, not an
AND of per-shard verdicts.

The host issues every shard's work in turn, each under its device and a
stream of its own on the card: launches are asynchronous, so the shards'
device work overlaps.  The entries return shard 0's result, ordered on the
caller's current stream.

The tier is cut into the pieces a CUDA graph can hold
(``crypto/bls/bucket_program.MeshProgram``): ``local_body`` (a) is a
function of one shard's static inputs that returns its partial and its
two verdict bits, and ``finish`` (b, c) reads every shard's partial and
bits and writes shard 0's result.  ``ShardedProgram``, the eager entry,
runs the same pieces op by op; the graphs are held against it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from .fused_core import LV
from .limbs import NLIMBS
from .ring_gather import ring_all_gather, ring_permute

#: supported GT cross-shard combine topologies
COMBINES = ("all_gather", "ring")


def mesh_device_name(n_devices: int) -> str:
    """The mesh pseudo-executor's name and the label its programs are
    ledgered under: one ``mesh{n}`` entry per program, never n rows, as
    the JAX package's ``sharded_verify.mesh_device_name``."""
    return f"mesh{n_devices}"


def _check_combine(combine: str) -> None:
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")


class Mesh:
    """n shards over ``devices`` (indexed; a card may repeat), each with a
    stream of its own on the card."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [resolve_device(d) for d in devices]
        types = {d.type for d in self.devices}
        if len(types) != 1 or types.pop() not in ("cpu", "cuda"):
            raise ValueError(f"a mesh is all CPU or all CUDA devices, got {self.devices}")
        self.cuda = self.devices[0].type == "cuda"
        self.streams = ([torch.cuda.Stream(device=d) for d in self.devices]
                        if self.cuda else None)
        #: host seconds each shard took to enqueue its local body, last run
        self.enqueue_walls: List[float] = []

    @property
    def n(self) -> int:
        return len(self.devices)

    def context(self, s: int, issuer: Optional[torch.cuda.Stream] = None):
        """Shard s's device and stream as the current ones (``issuer``:
        that stream instead, on its card)."""
        if not self.cuda:
            return contextlib.nullcontext()
        stream = self.streams[s] if issuer is None else issuer
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(stream.device))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    def map(self, fn: Callable, *per_shard: Sequence) -> list:
        """[fn(s, *(a[s] for a in per_shard)) for every shard s], issued in
        shard order, each call under shard s's context."""
        out = []
        for s in range(self.n):
            with self.context(s):
                out.append(fn(s, *(a[s] for a in per_shard)))
        return out

    def split(self, packed: Sequence[np.ndarray]) -> List[tuple]:
        """The packed 7-tuple cut into n contiguous slices of the batch axis."""
        b = packed[0].shape[0]
        if b % self.n:
            raise ValueError(f"batch {b} does not split over {self.n} shards")
        w = b // self.n
        return [tuple(np.asarray(a)[s * w:(s + 1) * w] for a in packed) for s in range(self.n)]

    def to_caller(self, t: torch.Tensor) -> torch.Tensor:
        """Shard 0's result, ordered on the caller's current stream."""
        if self.cuda:
            cur = torch.cuda.current_stream(self.devices[0])
            cur.wait_stream(self.streams[0])
            t.record_stream(cur)
        return t


# ---------------------------------------------------------------------------
# GT combine: the product over shards of one Fq12 value per shard
# ---------------------------------------------------------------------------


# Each combine takes one contiguous partial per shard, made on the shard's
# stream, and returns the combined product on shard 0's stream.  ``out``
# (``combine_buffers``) and ``issuer`` (one stream that issues every hop,
# shard 0's in a graph) are the graph's; eager callers leave them None.


def fq12_combine_all_gather(mesh: Mesh, fs: Sequence[torch.Tensor], out=None,
                            issuer=None) -> torch.Tensor:
    """XLA-graph flavour: the ring all-gather of the (6, 2, 50) partials,
    then shard 0's pow2 product tree of ``pairing``."""
    from .pairing import fq12_product_tree

    stacks = ring_all_gather(fs, out=out, streams=None if issuer else mesh.streams,
                             issuer=issuer)
    with mesh.context(0, issuer):
        return fq12_product_tree(stacks[0])


def fq12_combine_ring(mesh: Mesh, fs: Sequence[torch.Tensor], out=None,
                      issuer=None) -> torch.Tensor:
    """XLA-graph flavour ring: n - 1 one-hop permutes, each followed by one
    Fq12 product on shard 0 (the JAX ring's shard-0 accumulation order)."""
    from . import tower as tw

    acc, rot = fs[0], list(fs)
    for k in range(mesh.n - 1):
        rot = ring_permute(rot, None if issuer else mesh.streams,
                           out=None if out is None else out[k], issuer=issuer)
        with mesh.context(0, issuer):
            acc = tw.fq12_mul(acc, rot[0])
    return acc


def f12_combine_all_gather_lv(mesh: Mesh, fs: Sequence[LV], out=None, issuer=None) -> LV:
    """Fused flavour of ``fq12_combine_all_gather``: gathers the loose
    digits and runs ``fused_pairing``'s product tree."""
    from .fused_pairing import f12_product_tree

    stacks = ring_all_gather([f.a for f in fs], out=out,
                             streams=None if issuer else mesh.streams, issuer=issuer)
    with mesh.context(0, issuer):
        return f12_product_tree(LV(stacks[0], fs[0].b))


def f12_combine_ring_lv(mesh: Mesh, fs: Sequence[LV], out=None, issuer=None) -> LV:
    """Fused flavour of ``fq12_combine_ring``."""
    from .fused_field import f12_mul

    acc, rot = fs[0], [f.a for f in fs]
    for k in range(mesh.n - 1):
        rot = ring_permute(rot, None if issuer else mesh.streams,
                           out=None if out is None else out[k], issuer=issuer)
        with mesh.context(0, issuer):
            acc = f12_mul(acc, LV(rot[0], fs[0].b))
    return acc


def verdict_bits(subgroup_ok: torch.Tensor, any_live: torch.Tensor) -> torch.Tensor:
    """A shard's two verdict bits as the float32 (2,) chunk the ring
    carries."""
    return torch.stack([subgroup_ok, any_live]).to(torch.float32)


def combine_bits(mesh: Mesh, bits: Sequence[torch.Tensor], out=None,
                 issuer=None) -> torch.Tensor:
    """The mesh verdict from every shard's ``verdict_bits``, on shard 0:
    every shard's subgroup checks pass and at least one shard carries a
    live lane (an all-padding shard must not veto the batch)."""
    both = ring_all_gather(bits, out=out, streams=None if issuer else mesh.streams,
                           issuer=issuer)
    with mesh.context(0, issuer):
        return (both[0][:, 0] != 0).all() & (both[0][:, 1] != 0).any()


def combine_ok(mesh: Mesh, subgroup_ok: Sequence[torch.Tensor],
               any_live: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mesh verdict bits, on shard 0, from each shard's two bits,
    which cross the mesh as one float32 (2,) chunk through the ring
    kernel."""
    return combine_bits(mesh, mesh.map(lambda s, sg, al: verdict_bits(sg, al),
                                       subgroup_ok, any_live))


def combine_buffers(mesh: Mesh, combine: str) -> dict:
    """The combine's ring outputs, one set per shard on its device, made
    outside a capture: the gathered (n, 6, 2, 50) stacks (``all_gather``)
    or the n - 1 permutes' (6, 2, 50) chunks (``ring``), and the gathered
    (n, 2) verdict bits."""
    _check_combine(combine)
    n, part = mesh.n, (6, 2, NLIMBS)

    def on(s, *shape):
        return torch.empty(shape, dtype=torch.float32, device=mesh.devices[s])

    f = ([on(s, n, *part) for s in range(n)] if combine == "all_gather"
         else [[on(s, *part) for s in range(n)] for _ in range(n - 1)])
    return {"f": f, "bits": [on(s, n, 2) for s in range(n)]}


# ---------------------------------------------------------------------------
# the pieces and the entries
# ---------------------------------------------------------------------------


def local_body(fused: bool) -> Callable:
    """(a), one shard's body: its 7 packed tensors (its slice of the
    batch) -> (its Miller partial, contiguous: an LV on the fused program,
    its digits on the XLA-graph one; its ``verdict_bits``)."""
    if fused:
        from .fused_verify import miller_product_parts as parts
    else:
        from .batch_verify import miller_product_parts_kernel as parts

    def body(*inputs):
        f, sg, al = parts(*inputs)
        f = LV(f.a.contiguous(), f.b) if fused else f.contiguous()
        return f, verdict_bits(sg, al)

    return body


def finish(mesh: Mesh, fused: bool, combine: str, full: bool, fs, bits,
           out=None, issuer=None):
    """(b) and (c): every shard's partial and bits -> (f, ok) (split) or
    the verdict (full, ``final_verdict`` of the split's), on shard 0.
    ``out`` and ``issuer``: a graph's (``combine_buffers`` and shard 0's
    stream); None, eager."""
    out = out or {}
    if fused:
        gather = f12_combine_ring_lv if combine == "ring" else f12_combine_all_gather_lv
    else:
        gather = fq12_combine_ring if combine == "ring" else fq12_combine_all_gather
    fc = gather(mesh, fs, out.get("f"), issuer)
    ok = combine_bits(mesh, bits, out.get("bits"), issuer)
    return final_verdict(mesh, fused, fc, ok, issuer) if full else (fc, ok)


def final_verdict(mesh: Mesh, fused: bool, fc, ok, issuer=None) -> torch.Tensor:
    """(c) the final exponentiation of the combined product, once, on shard
    0, and the is-one check with the mesh's verdict bits: the full entry's
    tail after the split entry's (f, ok)."""
    with mesh.context(0, issuer):
        if fused:
            from .fused_field import f12_is_one
            from .fused_pairing import final_exponentiation

            return f12_is_one(final_exponentiation(fc)) & ok
        from . import pairing as kp
        from . import tower as tw

        return tw.fq12_is_one(kp.final_exponentiation(fc)) & ok


def _run(mesh: Mesh, fused: bool, combine: str, packed, full: bool):
    """The sharded program, eager: (f, ok) (split) or the verdict (full),
    on shard 0's stream."""
    from .fused_verify import from_packed

    body = local_body(fused)

    def local(s, sl):
        t0 = time.perf_counter()
        out = body(*from_packed(sl, mesh.devices[s]))
        return out, time.perf_counter() - t0

    # (a) every local body enqueued, shard after shard
    res = mesh.map(local, mesh.split(packed))
    mesh.enqueue_walls = [w for _, w in res]
    fs, bits = (list(x) for x in zip(*(r for r, _ in res)))
    # (b), (c) the partials and the verdict bits cross the mesh to shard 0
    return finish(mesh, fused, combine, full, fs, bits)


class ShardedProgram:
    """A sharded entry over one mesh: ``program(*packed)`` takes the packed
    7-tuple of numpy arrays (the batch axis divisible by the shard count)
    and returns the result on shard 0's device."""

    def __init__(self, devices: Sequence, fused: bool, combine: str, full: bool):
        _check_combine(combine)
        self.mesh = Mesh(devices)
        self.fused = fused
        self.combine = combine
        self.full = full

    def __call__(self, *packed):
        out = _run(self.mesh, self.fused, self.combine, packed, self.full)
        if self.full:
            return self.mesh.to_caller(out)
        f, ok = out
        f = f.a if self.fused else f
        return self.mesh.to_caller(f), self.mesh.to_caller(ok)


def miller_product_sharded(devices: Sequence, fused: bool = False,
                           combine: str = "all_gather") -> ShardedProgram:
    """The split entry: ``fn(*packed) -> (f, ok)``, f the (6, 2, 50)
    digits of the whole-mesh Miller product and ok the mesh verdict bits,
    for a final exponentiation that runs once per merged batch."""
    return ShardedProgram(devices, fused, combine, full=False)


def verify_signature_sets_sharded(devices: Sequence, fused: bool = False,
                                  combine: str = "all_gather") -> ShardedProgram:
    """The full entry: ``fn(*packed) -> bool tensor``, the final
    exponentiation on the post-combine product."""
    return ShardedProgram(devices, fused, combine, full=True)
