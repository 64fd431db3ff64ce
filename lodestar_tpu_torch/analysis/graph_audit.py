"""The device programs' trace audit: what a CUDA graph of them may hold.

The port's counterpart of ``lodestar_tpu/analysis/jaxpr_audit.py``.  Each
device-program entry is traced at buckets 4 and 128 with a
``TorchDispatchMode`` that records every aten op, its tensors' dtypes and
devices, and the port's source line where it matters.  The kernels are
opaque in the trace: a row kernel's call returns zeros of its outputs'
shapes (``kernel:<name>`` in the census) and the ring hop copies; their
bodies are the kernel audit's and the bound proofs'.  So a trace is the
program's glue, issued on the audit's device.

The tensors are zeros on the entry's device, or, with ``fake=True``, fake
tensors under ``FakeTensorMode`` (shapes and types only, where a read of
a value on the host raises).  The recorder sees the same host syncs
either way: ``_local_scalar_dense`` is recorded before the fake mode
raises at it, and the reads that on a CPU tensor never reach aten
(``.tolist()``, ``.numpy()``, ``__array__``) are caught a level up, by a
``TorchFunctionMode`` (on the CPU only: on the card they copy to the host
through ``aten._to_copy``, or raise, and the mode costs a fifth of a
trace).  A zeros trace is the cheaper: on one CPU core the
fused split entry took 21 s under fake tensors against 2 s on zeros, the
XLA-graph one 267 s against 16 s (its 0.8 million ops); so the entries
are traced on zeros, and the fixtures in both modes.  The entries:

- ``fused_verify`` split (``miller_product_fused``) and full-device
  (``verify_signature_sets_fused``);
- ``batch_verify`` split (``miller_product_kernel``) and full-device
  (``verify_signature_sets_kernel``);
- ``sharded_verify.local_body`` and ``finish`` over 2 shards: the fused
  program's, split with the all-gather and full-device with the ring (the
  XLA-graph flavour's local body is ``batch_verify``'s parts, traced
  above; a 2-shard trace of it is 2 million ops).

The rules:

- ``torch-host-sync`` (from ``jaxpr-host-callback``): a host sync inside a
  program, the CUDA graphs' precondition (a capture refuses one):
  ``aten._local_scalar_dense`` (``.item()``, ``bool()``, ``int()`` of a
  tensor), ``.tolist()``, ``.numpy()``, ``nonzero``, a copy from the card
  to the host,
  and a data-dependent Python branch (fake tensors raise at it: recorded
  at its line).
- ``torch-wide-dtype`` (from ``jaxpr-f64-leak``): float64 or complex128
  anywhere, or int64 in a digit tensor (last dimension 50 to 104).
- ``torch-unstable-program`` (from ``jaxpr-unstable-cache-key``, the JAX
  audit's constant census): two traces at one bucket with different op
  censuses (a made value, ``full`` / ``zeros`` / ``arange`` ..., counted
  with its shape) or constant censuses (the cached constants a program
  reads, ``limbs.const_tensor``; the ops that make one on a cache miss
  are not the program's), or constants that differ between buckets.
- ``torch-sharded-entry`` (from the JAX sharded-entry rules): each shard's
  ``local_body`` reads only its own shard's inputs (the tensors carry the
  shards they derive from), and the partials meet only in ``finish``,
  which must read every shard's.
- ``torch-matmul-in-program`` (for ``jaxpr-mxu-precision``): no ``mm``,
  ``bmm``, ``matmul`` or ``einsum`` (any of their aten forms) in a program:
  the plain versions use no matrix product (the TPU's one-hot matrix
  products are not ported).

Not carried over: ``jaxpr-narrow-mixed-concat``, a Mosaic retiling fault
of the TPU (``aligned_splice``, not ported).
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .report import Violation

RULE_SYNC = "torch-host-sync"
RULE_DTYPE = "torch-wide-dtype"
RULE_UNSTABLE = "torch-unstable-program"
RULE_SHARDED = "torch-sharded-entry"
RULE_MATMUL = "torch-matmul-in-program"

AUDIT_BUCKETS = (4, 128)
_HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(_HERE))

_SYNC_OPS = {"_local_scalar_dense", "nonzero", "tolist", "item", "masked_select",
             "_assert_async"}
_MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "einsum", "dot", "vdot",
               "mv", "addmv", "_int_mm", "linear", "tensordot", "chain_matmul"}
_DIGIT_WIDTHS = range(50, 105)
#: the ops that make a value from nothing: counted with the shape asked for
_CREATION = {"full", "zeros", "ones", "empty", "arange", "scalar_tensor", "randn", "rand",
             "empty_strided", "new_full", "new_zeros", "new_ones", "new_empty"}
#: the ops whose site is looked up on every call
_WATCHED = _SYNC_OPS | _MATMUL_OPS | {"_to_copy", "copy_", "copy", "to"}


def _site() -> Tuple[str, int]:
    """The port's (or a fixture's) innermost line on the stack."""
    import torch

    skip = (os.path.dirname(torch.__file__), _HERE, os.path.dirname(contextlib.__file__))
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if not name.startswith(skip) and not name.startswith("<"):
            return name, f.f_lineno
        f = f.f_back
    return "", 0


def _rel(path: str) -> str:
    return os.path.relpath(path, REPO) if path.startswith(REPO + os.sep) else path


@dataclass
class Trace:
    """One trace of one entry: its op census, its constants, what the
    rules found, and the error that ended it (None: it ran through)."""

    ops: collections.Counter = field(default_factory=collections.Counter)
    consts: collections.Counter = field(default_factory=collections.Counter)
    found: List[Tuple[str, str, int, str]] = field(default_factory=list)  # rule, file, line, msg
    error: Optional[str] = None
    #: per shard, the ops of its local body that read another shard's tensors
    cross: List[Tuple[str, int, str]] = field(default_factory=list)
    #: the shards whose tensors ``finish`` read
    finish_reads: set = field(default_factory=set)


class _Recorder:
    """The dispatch mode's state: the census, the findings, the shards each
    fake tensor derives from."""

    def __init__(self, trace: Trace, fake: bool = False):
        self.trace = trace
        self.fake = fake
        self.taint: Dict[int, tuple] = {}  # id -> (a weak reference, the shards)
        self.shard: Optional[int] = None   # the local body being traced
        self.in_finish = False
        self.creating = False   # inside the constant cache's miss
        self.last: Tuple[str, int] = ("", 0)

    def mark(self, tensors, shard) -> None:
        """The tensors derive from ``shard`` (an index, or a set of them)."""
        shards = frozenset(shard) if isinstance(shard, (set, frozenset)) else frozenset({shard})
        for t in tensors:
            if shards:
                self.taint[id(t)] = (weakref.ref(t), shards)

    def shards_of(self, tensors) -> frozenset:
        out = frozenset()
        for t in tensors:
            entry = self.taint.get(id(t))
            if entry is not None and entry[0]() is t:
                out |= entry[1]
        return out

    def note(self, rule: str, site: Tuple[str, int], msg: str) -> None:
        key = (rule, site[0], site[1])
        if all((r, f, ln) != key for r, f, ln, _ in self.trace.found):
            self.trace.found.append((rule, site[0], site[1], msg))


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _make_mode(rec: _Recorder):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    names: Dict = {}
    wide = (torch.float64, torch.complex128)

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = names.get(func)
            if name is None:
                name = names[func] = (func.overloadpacket.__name__
                                      if hasattr(func, "overloadpacket") else str(func))
            if rec.creating:  # a constant made on a cache miss: the constant census's
                return func(*args, **kwargs)
            if name in _CREATION:  # a made value: its shape is part of the census
                rec.trace.ops[(name, tuple(args[0]) if args and isinstance(
                    args[0], (list, tuple)) else None)] += 1
            else:
                rec.trace.ops[name] += 1
            flagged = name in _WATCHED
            if not flagged and rec.shard is None and not rec.in_finish:
                out = func(*args, **kwargs)
                if isinstance(out, torch.Tensor) and (
                        out.dtype in wide or (out.dtype == torch.int64 and out.dim()
                                              and out.shape[-1] in _DIGIT_WIDTHS)):
                    self._wide(name, out)
                elif isinstance(out, (tuple, list)):
                    for t in _tensors(out):
                        self._wide(name, t)
                return out
            site = _site()
            rec.last = site
            ins = list(_tensors((args, kwargs)))
            if name in _SYNC_OPS:
                rec.note(RULE_SYNC, site, f"`aten.{name}` reads a tensor's value on the host "
                                          f"inside a device program")
            if name in _MATMUL_OPS:
                rec.note(RULE_MATMUL, site, f"`aten.{name}` in a device program: the plain "
                                            f"versions use no matrix product")
            if name in ("_to_copy", "copy_", "copy", "to") and ins:
                src = [t.device.type for t in ins]
                dst = kwargs.get("device")
                if name in ("copy_", "copy") and len(ins) >= 2:
                    dst, src = ins[0].device, [ins[1].device.type]
                if "cuda" in src and dst is not None and torch.device(dst).type == "cpu":
                    rec.note(RULE_SYNC, site, "a copy from the card to the host inside a "
                                              "device program")
            shards = rec.shards_of(ins)
            if rec.shard is not None and shards - {rec.shard}:
                rec.trace.cross.append((site[0], site[1], f"`aten.{name}` in shard "
                                        f"{rec.shard}'s local body reads shard(s) "
                                        f"{sorted(shards - {rec.shard})}'s tensors"))
            if rec.in_finish:
                rec.trace.finish_reads |= shards
            out = func(*args, **kwargs)
            for t in _tensors(out):
                self._wide(name, t, site)
            rec.mark(_tensors(out), shards)
            return out

        @staticmethod
        def _wide(name, t, site=None):
            if t.dtype in wide:
                what = f"a {t.dtype} tensor"
            elif t.dtype == torch.int64 and t.dim() and t.shape[-1] in _DIGIT_WIDTHS:
                what = f"int64 digits {tuple(t.shape)}"
            else:
                return
            rec.note(RULE_DTYPE, site or _site(), f"`aten.{name}` makes {what} in a device "
                                                  f"program")

    return Mode()


def _make_host_reads(rec: _Recorder):
    """A function mode for the host reads that never reach aten on a CPU
    tensor (``.tolist()``, ``.numpy()``, ``__array__`` read its memory
    directly): each is a host sync at its line."""
    import torch
    from torch.overrides import TorchFunctionMode

    reads = {torch.Tensor.tolist: "tolist", torch.Tensor.numpy: "numpy",
             torch.Tensor.__array__: "__array__"}

    class HostReads(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = reads.get(func)
            if name is not None:
                site = _site()
                rec.last = site
                rec.note(RULE_SYNC, site, f"`Tensor.{name}` reads a tensor's values on the "
                                          f"host inside a device program")
            return func(*args, **(kwargs or {}))

    return HostReads()


_SWAP_LOCK = threading.Lock()
_TRACING = threading.local()


def _mine(rec: _Recorder) -> bool:
    """The calling thread is the one tracing with ``rec``."""
    return getattr(_TRACING, "rec", None) is rec


@contextlib.contextmanager
def _opaque_kernels(rec: _Recorder):
    """The row kernels and the ring hop as opaque ops: zeros of their
    outputs' shapes, a ``kernel:<name>`` entry in the census, their
    inputs' shards carried to their outputs; the constant cache counted.
    Constants made under a fake mode are dropped after (they are fake).
    The swaps act only on the tracing thread: another thread's launch runs
    the kernel and its constants come from the cache as it is; one trace
    swaps them at a time."""
    import torch

    from ..ops import fused_core as fc
    from ..ops import fused_ladder, library_fuse, tower_kernels  # noqa: F401 - the kernels
    from ..ops import limbs as fl
    from ..ops import ring_gather as rg

    with _SWAP_LOCK:
        call, hop, cache = fc.Kernel.__call__, rg.launch_hop, fl._TENSOR_CACHE

        class Counted(dict):
            """The constant cache, counting every constant the trace reads
            (the tracing thread's; another thread reads and fills
            ``cache``)."""

            def get(self, key, default=None):
                if not _mine(rec):
                    return cache.get(key, default)
                hit = super().get(key, default)
                if hit is not None:
                    rec.trace.consts[(tuple(hit[1].shape), str(hit[1].dtype))] += 1
                else:
                    rec.creating = True  # until the new constant is stored
                return hit

            def __setitem__(self, key, value):
                if not _mine(rec):
                    cache[key] = value
                    return
                rec.creating = False
                rec.trace.consts[(tuple(value[1].shape), str(value[1].dtype))] += 1
                super().__setitem__(key, value)

        def kernel(self, *rows):
            if not _mine(rec):
                return call(self, *rows)
            rec.trace.ops[f"kernel:{self.name}"] += 1
            outs = tuple(torch.zeros((rows[0].shape[0],) + self.tail, dtype=torch.float32,
                                     device=rows[0].device) for _ in range(self.n_out))
            rec.mark(outs, rec.shards_of(rows))
            return outs

        def launch_hop(src, dst, stream):
            if not _mine(rec):
                return hop(src, dst, stream)
            rec.trace.ops["kernel:ring_hop"] += 1
            dst.copy_(src)

        traced = Counted(cache)
        fc.Kernel.__call__, rg.launch_hop = kernel, launch_hop
        fl._TENSOR_CACHE = traced
        _TRACING.rec = rec
        try:
            yield
        finally:
            _TRACING.rec = None
            fc.Kernel.__call__, rg.launch_hop = call, hop
            fl._TENSOR_CACHE = cache
            if not rec.fake:  # the cache must not keep the trace's fake constants
                cache.update(dict.items(traced))


def zero_inputs(bucket: int, device: str = "cpu"):
    """The packed 7-tuple's tensors at ``bucket``, zeros (fake under a fake
    mode)."""
    import torch

    from ..crypto.bls.bucket_program import input_specs

    return [torch.zeros(shape, dtype=dtype, device=device) for shape, dtype in input_specs(bucket)]


def trace_entry(run: Callable[[_Recorder], object], fake: bool = False,
                host_reads: bool = True) -> Trace:
    """``run(recorder)`` under the recorder (and, ``fake``, a fake mode;
    ``host_reads``, the function mode of the reads that skip aten on a CPU
    tensor); an error that ends the trace (a data-dependent branch on a
    fake value) is recorded as a host sync at the line that raised."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    trace = Trace()
    rec = _Recorder(trace, fake)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()
    with _opaque_kernels(rec), fake_mode:
        try:
            with (_make_host_reads(rec) if host_reads else contextlib.nullcontext()), \
                    _make_mode(rec):
                run(rec)
        except Exception as e:  # noqa: BLE001 - the trace's end is the finding
            trace.error = f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"
            site = _error_site(e) or rec.last
            rec.note(RULE_SYNC, site, f"the trace stopped: {trace.error[:200]} (a value read "
                                      f"on the host, or a branch on one)")
    return trace


def _error_site(e: BaseException) -> Optional[Tuple[str, int]]:
    import traceback

    import torch

    skip = (os.path.dirname(torch.__file__), _HERE)
    site = None
    for fs in traceback.extract_tb(e.__traceback__):
        if not fs.filename.startswith(skip) and not fs.filename.startswith("<"):
            site = (fs.filename, fs.lineno)
    return site


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------


def _program(module: str, fn: str, bucket: int, device: str):
    def run(rec):
        import importlib

        entry = getattr(importlib.import_module(f"lodestar_tpu_torch.ops.{module}"), fn)
        return entry(*zero_inputs(bucket, device))

    return run


def _sharded(fused: bool, combine: str, full: bool, bucket: int, device: str, shards: int = 2):
    def run(rec):
        from ..ops import sharded_verify as sv

        mesh = sv.Mesh([device] * shards)
        body = sv.local_body(fused)
        w = bucket // shards
        inputs = [zero_inputs(w, d) for d in mesh.devices]
        for s, ins in enumerate(inputs):
            rec.mark(ins, s)
        fs, bits = [], []
        for s in range(shards):
            rec.shard = s
            with mesh.context(s):
                f, b = body(*inputs[s])
            fs.append(f)
            bits.append(b)
        rec.shard = None
        rec.in_finish = True
        out = sv.finish(mesh, fused, combine, full, fs, bits)
        rec.in_finish = False
        return out

    return run


ENTRIES = {
    "fused_verify.miller_product_fused": lambda b, d: _program(
        "fused_verify", "miller_product_fused", b, d),
    "fused_verify.verify_signature_sets_fused": lambda b, d: _program(
        "fused_verify", "verify_signature_sets_fused", b, d),
    "batch_verify.miller_product_kernel": lambda b, d: _program(
        "batch_verify", "miller_product_kernel", b, d),
    "batch_verify.verify_signature_sets_kernel": lambda b, d: _program(
        "batch_verify", "verify_signature_sets_kernel", b, d),
    "sharded_verify[fused, all_gather, split]": lambda b, d: _sharded(True, "all_gather", False,
                                                                      b, d),
    "sharded_verify[fused, ring, full]": lambda b, d: _sharded(True, "ring", True, b, d),
}
SHARDED = {"sharded_verify[fused, all_gather, split]", "sharded_verify[fused, ring, full]"}


def check_trace(name: str, trace: Trace, sharded: bool = False,
                shards: int = 2) -> List[Violation]:
    """The rules of one trace (the stability rule compares traces)."""
    out = [Violation(rule, _rel(f) or name, line, f"{name}: {msg}")
           for rule, f, line, msg in trace.found]
    if sharded:
        seen = set()
        for f, line, msg in trace.cross:
            if (f, line) not in seen:
                seen.add((f, line))
                out.append(Violation(RULE_SHARDED, _rel(f) or name, line, f"{name}: {msg}"))
        if trace.error is None and trace.finish_reads != set(range(shards)):
            out.append(Violation(RULE_SHARDED, name, 0,
                                 f"{name}: finish read the partials of shards "
                                 f"{sorted(trace.finish_reads)}, not of all {shards}"))
    return out


def check_stable(name: str, traces: Dict[int, Sequence[Trace]]) -> List[Violation]:
    """Two traces at each bucket agree; the constants agree across buckets."""
    out = []
    for b, (t1, t2) in traces.items():
        if t1.ops != t2.ops or t1.consts != t2.consts:
            diff = sorted(set(t1.ops.items()) ^ set(t2.ops.items()), key=repr)[:4]
            out.append(Violation(RULE_UNSTABLE, name, 0,
                                 f"{name}@{b}: two traces differ ({len(t1.ops)} / {len(t2.ops)} "
                                 f"op kinds, {sum(t1.consts.values())} / "
                                 f"{sum(t2.consts.values())} constant reads; first op "
                                 f"differences {diff})"))
    buckets = sorted(traces)
    base = traces[buckets[0]][0].consts
    for b in buckets[1:]:
        if set(traces[b][0].consts) != set(base):
            out.append(Violation(RULE_UNSTABLE, name, 0,
                                 f"{name}: the constants differ between buckets {buckets[0]} "
                                 f"and {b}: {sorted(set(base) ^ set(traces[b][0].consts))[:4]}"))
    return out


def audit_entry(name: str, run_at: Callable, buckets: Sequence[int] = AUDIT_BUCKETS,
                device: str = "cpu", sharded: bool = False, twice: bool = True,
                fake: bool = False) -> List[Violation]:
    """One entry's rules at every bucket; ``twice``: a second trace at
    each for the stability rule."""
    # on the card a host read is a copy to the host, which aten sees
    traces = {b: [trace_entry(run_at(b, device), fake, host_reads=device == "cpu")
                  for _ in range(1 + twice)] for b in buckets}
    out: List[Violation] = []
    seen = set()
    for b in buckets:
        for v in check_trace(f"{name}@{b}", traces[b][0], sharded):
            key = (v.rule, v.path, v.line)
            if key not in seen:
                seen.add(key)
                out.append(v)
    if twice and all(t.error is None for ts in traces.values() for t in ts):
        out += check_stable(name, traces)
    return out


def audit_programs(buckets: Sequence[int] = AUDIT_BUCKETS, device: str = "cpu",
                   entries: Optional[Sequence[str]] = None,
                   twice: bool = True) -> List[Violation]:
    """Every entry at every bucket on ``device`` (the card's run: bucket
    128 once, ``twice=False``; the stability rule is the CPU run's)."""
    out: List[Violation] = []
    for name in entries if entries is not None else ENTRIES:
        out += audit_entry(name, ENTRIES[name], buckets, device, sharded=name in SHARDED,
                           twice=twice)
    return out
