"""Interval proofs of the digit bounds: ``torch-limb-overflow``.

The port's counterpart of ``lodestar_tpu/analysis/limb_interval.py``.  The
digits are exact integers held in float32 (``ops/limbs.py``) or int64
(``ops/fused_core.py``'s plain versions) and int32 in the kernels, and the
kernels' any-order sums equal the plain versions' only while every value a
step forms stays below 2^24 (``field_coop.cuh``'s header).  A value past it
does not crash: float32 rounds, and the kernels would part from the plain
versions only at scale, on the card.  The rule has two halves.

*The plain versions.*  Each entry is traced with
``make_fx(fn, tracing_mode="fake")`` to an aten graph (no arithmetic: fake
tensors), each node tagged with the port's source line that made it.  The
analyzer propagates one interval per storage node by node, as the JAX
``_Analyzer`` does over jaxpr equations (elementwise arithmetic, shape ops
and selects directly; sums by the reduced extent; a constant by its
values): a view reads its base's interval, and an in-place op on a view
widens its base (replaces it when it writes every element).  The carry's
split ``x - 256 * floor(x / 256)`` (and ``x & 255``) is matched so that the
low byte keeps its [0, 255] and the carry chains converge.  Unknown ops
go to TOP: a finding is a *proven* value past 2^24 in a digit tensor,
reported at the line that made it, and the coverage ratio says how much
was proven; an entry not proven whole (a digit node left at TOP) is a
violation too, since the rule cannot bound it.

Two results rest on a contract, not on a proof.  ``carry_ripple_exact``
(a Kogge-Stone ripple, no scan) is analyzed as written, and its proven
interval is wider than its contract; so where another entry calls it, its
output is summarized by that contract (strict digits and the carry out,
held bitwise against the JAX scan by the tests).  ``fp_reduce_full`` is
built on it: its canonical [0, 255] comes from the ripple's contract.
Both differ from the JAX analyzer's intervals by design (the tests name
them as the two exceptions).

The entries: the ``limbs`` core at the JAX contracts (``fp_strict``,
``fp_add``, ``fp_sub``, ``fp_mul``, ``fp_sqr``, ``fp_mul_small``,
``carry_exact``, ``fp_reduce_full``) and ``carry_ripple_exact`` at its
semi-strict contract; the fused core's steps at the bounds their ``LV``
callers assert (``m_fold`` at bound_bits 22, ``m_mul`` at bits 16, 17 and
18, ``m_fq2_mul``, ``m_fq2_sqr``, ``_canon``) and every row kernel's plain
body at its inputs' contracts (loose inputs below 2^22, the rest
semi-strict).  Not carried over: the JAX entries ``fp_mul@mxu``,
``fp_mul@mxu9``, ``pack9`` and ``carry_base512``, the TPU's one-hot matrix
unit workarounds, which the port does not have.

*The kernel headers.*  Each place in ``field_coop.cuh`` and
``tower_coop.cuh`` whose any-order argument needs a bound is a named
obligation (``lcb::Id``): a ``static_assert`` where the bound is a constant
expression, and otherwise a check of the host audit build
(``-DLC_BOUND_AUDIT``, g++ only): ``host_shim.cpp`` runs every cooperative
body on rows at the contracts' extremes (every digit at its bound) and on
seeded rows and reads the least and largest value each obligation reached.
Each must stay within [0, 2^24), a fold input within [0, 2^BITS - 1], and
each at or below the interval proven for the same step of the plain
version (``PLAIN_STEPS``).
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import sys
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .report import Violation

RULE = "torch-limb-overflow"

INF = math.inf
TOP = (-INF, INF)
EXACT = float(1 << 24)  # every integer below it is exact in float32
Interval = Tuple[float, float]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
REPO = os.path.dirname(_PKG)


def _union(a: Interval, b: Interval) -> Interval:
    return (min(a[0], b[0]), max(a[1], b[1]))


def _finite(iv: Interval) -> bool:
    return math.isfinite(iv[0]) and math.isfinite(iv[1])


# ---------------------------------------------------------------------------
# tracing: an aten graph whose nodes carry the port's source line
# ---------------------------------------------------------------------------


_SWAP_LOCK = threading.Lock()
_TRACING = threading.local()


def _site_frame():
    """The innermost frame outside torch and this package: the line of the
    port (or of a fixture) that called the torch function."""
    import torch

    skip = (os.path.dirname(torch.__file__), _HERE)
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if not name.startswith(skip) and not name.startswith("<"):
            return f
        f = f.f_back
    return None


def trace(fn: Callable, args: Sequence):
    """``fn`` traced on fake copies of ``args`` to an aten graph, each
    node's ``meta["stack_trace"]`` the port's line that made it."""
    import torch
    import torch.fx.traceback as fx_traceback
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.overrides import TorchFunctionMode

    from ..ops import limbs as fl

    marking = []

    class _Sites(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if marking:
                fx_traceback.set_stack_trace([SUMMARY + marking.pop() + ">\n"])
            else:
                f = _site_frame()
                if f is not None:
                    fx_traceback.set_stack_trace(
                        [f'  File "{f.f_code.co_filename}", line {f.f_lineno}, '
                         f'in {f.f_code.co_name}\n'])
            return func(*args, **(kwargs or {}))

    def sited(*a):
        with _Sites():
            return fn(*a)

    fn(*args)  # real constants into the port's caches first: a trace must not fill them
    # ``limbs.carry_ripple_exact`` is swapped for the trace; the swap acts
    # only on this thread (another thread's call runs the function as it
    # is), and one trace swaps it at a time
    with _SWAP_LOCK:
        ripple = fl.carry_ripple_exact

        def summarized_ripple(x, bound_bits=fl.LOOSE_BITS):
            out = ripple(x, bound_bits)
            if getattr(_TRACING, "marking", None) is not marking:
                return out
            parts = [out, x[..., :0]]
            marking.append("carry_ripple_exact")  # for the next torch call, the cat
            return torch.cat(parts, dim=-1)  # the marker: the output, then the input

        fl.carry_ripple_exact = summarized_ripple
        _TRACING.marking = marking
        try:
            with fx_traceback.preserve_node_meta():
                return make_fx(sited, tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
        finally:
            _TRACING.marking = None
            fl.carry_ripple_exact = ripple


def node_site(node) -> Tuple[str, int, str]:
    """(file, line, function) of a traced node ("", 0, "") when unknown."""
    st = node.meta.get("stack_trace") or ""
    try:
        head, rest = st.strip().split('", line ', 1)
        line, func = rest.split(", in ", 1)
        return head.split('File "', 1)[1], int(line), func.strip()
    except (ValueError, IndexError):
        return "", 0, ""


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


@dataclass
class Finding:
    file: str
    line: int
    op: str
    lo: float
    hi: float
    bound: float


@dataclass
class LimbReport:
    outputs: List[Interval]
    findings: List[Finding]
    digit_nodes: int
    bounded_nodes: int
    #: (file, function) -> the widest interval a digit node of it reached
    steps: Dict[Tuple[str, str], Interval] = field(default_factory=dict)
    #: (file, line, op) of the first digit node left unbounded
    first_unbounded: Optional[Tuple[str, int, str]] = None

    @property
    def coverage(self) -> float:
        return 1.0 if not self.digit_nodes else self.bounded_nodes / self.digit_nodes


def _schema(node):
    return getattr(node.target, "_schema", None)


def _is_view(node) -> bool:
    """The op returns a view of its first argument."""
    sch = _schema(node)
    if sch is None or not sch.returns:
        return False
    info = sch.returns[0].alias_info
    return info is not None and not info.is_write


def _is_inplace(node) -> bool:
    """The op writes its first argument (and returns it)."""
    sch = _schema(node)
    if sch is None or not sch.arguments:
        return False
    info = sch.arguments[0].alias_info
    return info is not None and info.is_write


_BOOLEAN = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
            "logical_xor", "all", "any", "isfinite", "isnan"}


class V:
    """An interval per digit position: ``lo`` and ``hi`` of shape (n,), n
    the tensor's last dimension, or of shape () (one interval for every
    element)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        import numpy as np

        self.lo = np.asarray(lo, dtype=np.float64)
        self.hi = np.asarray(hi, dtype=np.float64)

    @classmethod
    def of(cls, iv: Interval) -> "V":
        return cls(iv[0], iv[1])

    def hull(self) -> Interval:
        if self.lo.size == 0:
            return (0.0, 0.0)
        lo, hi = float(self.lo.min()), float(self.hi.max())
        return (lo if not math.isnan(lo) else -INF, hi if not math.isnan(hi) else INF)

    def width(self, n: int) -> "V":
        """The vector for a tensor whose last dimension is n."""
        import numpy as np

        if self.lo.ndim == 1 and self.lo.size == n:
            return self
        lo, hi = self.hull()
        return V(np.full(n, lo), np.full(n, hi))


def _last(node) -> int:
    """The last dimension's size of a node's tensor (0 for a 0-d one, -1
    when unknown)."""
    val = node.meta.get("val") if hasattr(node, "meta") else None
    shape = getattr(val, "shape", None)
    if shape is None:
        return -1
    return int(shape[-1]) if len(shape) else 0


def _ndim(node) -> int:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    return len(getattr(val, "shape", ())) if val is not None else -1


#: the stack-trace tag of a summarized step's marker (``trace``)
SUMMARY = "<summary "


class Analyzer:
    """Intervals per digit position, propagated in graph order; a view
    reads its base's positions, an in-place op writes them (replacing
    what it writes in full, widening the rest)."""

    def __init__(self, bound: float = EXACT):
        self.bound = bound
        self.findings: List[Finding] = []
        self.digit_nodes = 0
        self.bounded_nodes = 0
        self.steps: Dict[Tuple[str, str], Interval] = {}
        self._flagged = set()
        self.first_unbounded: Optional[Tuple[str, int, str]] = None
        self._root: Dict = {}      # node -> the node that owns its storage
        self._cols: Dict = {}      # node -> its columns' indices in the root's (None: unknown)
        self._v: Dict = {}         # storage node -> V
        self._version: Dict = {}   # storage node -> writes so far
        self._read_at: Dict = {}   # node -> (storage, version) of its first argument

    def run(self, gm, in_intervals: Sequence[Interval]) -> LimbReport:
        import numpy as np

        inputs = iter(in_intervals)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                self._new(node, V.of(next(inputs)))
            elif node.op == "get_attr":
                t = getattr(gm, node.target)
                if t.numel() == 0:
                    self._new(node, V(0.0, 0.0))
                elif t.dim() == 0:
                    self._new(node, V(float(t), float(t)))
                else:
                    a = t.detach().to("cpu").double().numpy().reshape(-1, t.shape[-1])
                    self._new(node, V(a.min(0), a.max(0)))
            elif node.op == "call_function":
                self._step(node)
            elif node.op == "output":
                outs = node.args[0]
                outs = outs if isinstance(outs, (tuple, list)) else (outs,)
                return LimbReport([self._read(o).hull() for o in outs], self.findings,
                                  self.digit_nodes, self.bounded_nodes, self.steps,
                                  self.first_unbounded)
        raise ValueError("graph without an output")

    # -- storage -----------------------------------------------------------

    def _new(self, node, v: V) -> None:
        import numpy as np

        n = _last(node)
        self._root[node] = node
        self._cols[node] = np.arange(n) if n > 0 else None
        self._v[node] = v.width(n) if n > 0 else V(*v.hull())
        self._version[node] = 0

    def _read(self, a) -> V:
        if isinstance(a, (bool, int, float)):
            return V(float(a), float(a))
        if isinstance(a, (tuple, list)):  # a list of tensors: their hull
            out = None
            for x in a:
                iv = self._read(x).hull()
                out = iv if out is None else _union(out, iv)
            return V.of(out if out is not None else (0.0, 0.0))
        root = self._root.get(a)
        if root is None:
            return V.of(TOP)
        v, cols = self._v[root], self._cols.get(a)
        if cols is None or v.lo.ndim == 0:
            return V(*v.hull())
        return V(v.lo[cols], v.hi[cols])

    def _vec(self, a, n: int) -> V:
        """Argument ``a``'s intervals broadcast to a last dimension of n."""
        v = self._read(a)
        if n <= 0:
            return V(*v.hull())
        if hasattr(a, "meta") and _last(a) == n and _ndim(a) > 0:
            return v.width(n)
        return V(*v.hull()).width(n)

    @staticmethod
    def _numel(node) -> int:
        val = node.meta.get("val") if hasattr(node, "meta") else None
        return int(val.numel()) if val is not None and hasattr(val, "numel") else -1

    def _view_cols(self, node):
        """The columns of the root a view reads (None: unknown)."""
        import numpy as np

        src = node.args[0]
        cols = self._cols.get(src)
        name = str(node.target).replace("aten.", "", 1).split(".")[0]
        n_in, n_out, nd = _last(src), _last(node), _ndim(src)
        if cols is None or n_out <= 0:
            return None
        if name == "slice":
            dim = node.args[1] if len(node.args) > 1 else 0
            if dim % nd == nd - 1:
                start = node.args[2] if len(node.args) > 2 else 0
                end = node.args[3] if len(node.args) > 3 else n_in
                step = node.args[4] if len(node.args) > 4 else 1
                start = 0 if start is None else start
                end = n_in if end is None else min(end, n_in)
                return cols[slice(start, end, step)]
            return cols
        if name == "select":
            dim = node.args[1] % nd
            if dim == nd - 1:
                return np.full(n_out, cols[node.args[2]])
            return cols
        if name == "expand":
            if n_in == n_out:
                return cols
            if n_in == 1:
                return np.repeat(cols, n_out)
            return None
        if name in ("view", "_unsafe_view", "reshape", "alias", "detach", "squeeze",
                    "unsqueeze", "permute", "transpose", "t"):
            if n_in != n_out:
                return None
            if name == "unsqueeze" and (node.args[1] % (nd + 1)) == nd:
                return None
            if name in ("permute", "transpose", "t"):
                out_nd = _ndim(node)
                if name == "permute" and node.args[1][-1] % out_nd != out_nd - 1:
                    return None
                if name in ("transpose", "t"):
                    dims = node.args[1:3] if name == "transpose" else (0, 1)
                    if any(d % out_nd == out_nd - 1 for d in dims):
                        return None
            return cols
        return None

    def _step(self, node) -> None:
        import numpy as np

        first = node.args[0] if node.args else None
        if hasattr(first, "op") and first in self._root:
            root = self._root[first]
            self._read_at[node] = (root, self._version[root])
        if str(node.target) == "<built-in function getitem>":
            self._root[node] = self._root.get(first)
            self._cols[node] = None
            if self._root[node] is None:
                self._new(node, V.of(TOP))
            return
        if _is_view(node) and hasattr(first, "op") and first in self._root:
            self._root[node] = self._root[first]
            self._cols[node] = self._view_cols(node)
            self._record(node, self._read(node))
            return
        v = self._eval(node)
        if _is_inplace(node) and hasattr(first, "op") and first in self._root:
            root = self._root[first]
            self._write(root, self._cols.get(first), v, self._numel(first))
            self._root[node] = root
            self._cols[node] = self._cols.get(first)
        else:
            self._new(node, v)
        self._record(node, self._read(node))

    def _write(self, root, cols, v: V, numel: int) -> None:
        """An in-place op wrote v into the root's columns ``cols``: replace
        the columns it covers in full, widen the others."""
        import numpy as np

        rv = self._v[root]
        self._version[root] += 1
        if cols is None or rv.lo.ndim == 0:
            lo, hi = v.hull()
            rlo, rhi = rv.hull()
            whole = numel == self._numel(root) and numel > 0
            self._v[root] = V(lo, hi).width(_last(root)) if whole else \
                V(min(lo, rlo), max(hi, rhi)).width(_last(root))
            return
        n_root = _last(root)
        uniq = np.unique(cols)
        per_col = self._numel(root) // max(1, n_root)
        full = numel == per_col * len(uniq) and len(uniq) == len(cols)
        lo, hi = rv.lo.copy(), rv.hi.copy()
        vv = v.width(len(cols))
        if full:
            lo[cols], hi[cols] = vv.lo, vv.hi
        else:
            for c, a, b in zip(cols, vv.lo, vv.hi):
                lo[c], hi[c] = min(lo[c], a), max(hi[c], b)
        self._v[root] = V(lo, hi)

    # -- recording ---------------------------------------------------------

    def _record(self, node, v: V) -> None:
        import torch

        val = node.meta.get("val")
        vals = val if isinstance(val, (tuple, list)) else (val,)
        if not vals or not isinstance(vals[0], torch.Tensor) or vals[0].dtype == torch.bool:
            return
        if not (vals[0].dtype.is_floating_point or vals[0].dtype in (torch.int32, torch.int64)):
            return
        iv = v.hull()
        self.digit_nodes += 1
        f, line, func = node_site(node)
        if not _finite(iv):
            if self.first_unbounded is None:
                self.first_unbounded = (f, line, str(node.target))
            return
        self.bounded_nodes += 1
        key = (f, func)
        self.steps[key] = _union(self.steps.get(key, iv), iv)
        if iv[1] >= self.bound or iv[0] <= -self.bound:
            if (f, line) not in self._flagged:
                self._flagged.add((f, line))
                self.findings.append(Finding(f, line, str(node.target), iv[0], iv[1], self.bound))

    # -- evaluation --------------------------------------------------------

    def _split(self, node, n: int) -> Optional[V]:
        """add(x, floor(x / c), alpha=-c) on x in [0, 2^24], x unwritten
        between the two: x mod c."""
        x, q = node.args[0], node.args[1]
        alpha = node.kwargs.get("alpha", 1)
        if not hasattr(q, "target") or str(q.target) != "aten.div.Tensor_mode":
            return None
        if q.kwargs.get("rounding_mode") != "floor" or self._root.get(x) is not \
                self._root.get(q.args[0]):
            return None
        c = q.args[1]
        if not isinstance(c, (int, float)) or c <= 0 or alpha != -c:
            return None
        xr, qr = self._read_at.get(node), self._read_at.get(q)
        if xr is None or xr != qr:  # not the same storage at the same version
            return None
        xi = self._read(x).hull()
        if xi[0] < 0 or xi[1] > EXACT:
            return None
        return V(0.0, float(c) - 1.0).width(n) if n > 0 else V(0.0, float(c) - 1.0)

    def _summary(self, node, n: int) -> Optional[V]:
        """A summarized step's marker: ``carry_ripple_exact``'s output is
        the value's strict digits and its carry out (the function's
        contract, held bitwise against the JAX scan by the tests), on
        digits that are non-negative and exact."""
        import numpy as np

        out, inp = node.args[0]
        xi = self._v[self._root[inp]].hull()
        if xi[0] < 0 or xi[1] > EXACT:
            return None
        lo, hi = np.zeros(n), np.full(n, 255.0)
        hi[-1] = math.floor(xi[1] / 255)
        return V(lo, hi)

    def _eval(self, node) -> V:
        import numpy as np

        target = str(node.target)
        name = target.replace("aten.", "", 1)
        base = name.split(".")[0].strip("_")
        if name.startswith("__i"):
            base = base[1:]  # __iand__ -> and
        args = node.args
        n = _last(node)
        vec = lambda i: self._vec(args[i], n)  # noqa: E731

        def span(a: V, b: V) -> V:
            c = np.stack(np.broadcast_arrays(a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi))
            c = np.nan_to_num(c, nan=0.0, posinf=INF, neginf=-INF)
            return V(c.min(0), c.max(0))

        if (node.meta.get("stack_trace") or "").startswith(SUMMARY) and base == "cat":
            m = self._summary(node, n)
            if m is not None:
                return m
        if base in _BOOLEAN:
            return V(0.0, 1.0).width(n) if n > 0 else V(0.0, 1.0)
        if base == "add":
            m = self._split(node, n)
            if m is not None:
                return m
            alpha = float(node.kwargs.get("alpha", 1))
            a, b = vec(0), span(vec(1), V(alpha, alpha))
            return V(a.lo + b.lo, a.hi + b.hi)
        if base == "sub":
            alpha = float(node.kwargs.get("alpha", 1))
            a, b = vec(0), span(vec(1), V(alpha, alpha))
            return V(a.lo - b.hi, a.hi - b.lo)
        if base == "rsub":  # other - self
            a, b = vec(0), vec(1)
            return V(b.lo - a.hi, b.hi - a.lo)
        if base == "mul":
            return span(vec(0), vec(1))
        if base == "neg":
            a = vec(0)
            return V(-a.hi, -a.lo)
        if base in ("div", "floor_divide"):
            mode = node.kwargs.get("rounding_mode", "floor" if base == "floor_divide" else None)
            a, b = vec(0), self._read(args[1]).hull()
            if mode == "floor" and b[0] == b[1] and b[0] > 0 and _finite(a.hull()):
                return V(np.floor(a.lo / b[0]), np.floor(a.hi / b[0]))
            return V.of(TOP)
        if base in ("bitwise_right_shift", "rshift"):
            a, sh = vec(0), args[1]
            if isinstance(sh, int) and _finite(a.hull()):
                return V(np.floor(a.lo / (1 << sh)), np.floor(a.hi / (1 << sh)))
            return V.of(TOP)
        if base in ("bitwise_and", "and"):
            a, m = vec(0), args[1]
            if isinstance(m, int) and m >= 0 and a.hull()[0] >= 0:
                return V(np.zeros_like(a.lo), np.minimum(a.hi, m))
            return V.of(TOP)
        if base in ("clone", "_to_copy", "to_copy", "lift_fresh_copy", "contiguous", "detach",
                    "expand_copy", "slice_copy", "view_copy"):
            return vec(0)
        if base == "copy":  # copy(self, src): src's values
            return vec(1)
        if base in ("slice_scatter", "select_scatter"):
            b = vec(0)
            nd = _ndim(args[0])
            dim = args[2] % nd if len(args) > 2 else 0
            if dim == nd - 1 and n > 0:
                lo, hi = b.lo.copy(), b.hi.copy()
                if base == "slice_scatter":
                    start = args[3] if len(args) > 3 and args[3] is not None else 0
                    end = args[4] if len(args) > 4 and args[4] is not None else n
                    step = args[5] if len(args) > 5 else 1
                    idx = np.arange(n)[slice(start, min(end, n), step)]
                    sv = self._vec(args[1], len(idx))
                    lo[idx], hi[idx] = sv.lo, sv.hi
                else:
                    s_lo, s_hi = self._read(args[1]).hull()
                    lo[args[3]], hi[args[3]] = s_lo, s_hi
                return V(lo, hi)
            src = vec(1)
            return V(np.minimum(b.lo, src.lo), np.maximum(b.hi, src.hi))
        if base in ("cat", "stack"):
            parts = [t for t in args[0] if not (hasattr(t, "meta") and self._numel(t) == 0)] \
                or list(args[0])
            dim = args[1] if len(args) > 1 else 0
            nd = _ndim(node)
            if base == "cat" and n > 0 and dim % nd == nd - 1:
                vs = [self._vec(t, _last(t)) for t in parts]
                return V(np.concatenate([np.broadcast_to(v.lo, (max(_last(t), 0),))
                                         for v, t in zip(vs, parts)]),
                         np.concatenate([np.broadcast_to(v.hi, (max(_last(t), 0),))
                                         for v, t in zip(vs, parts)]))
            if base == "stack" and dim % nd == nd - 1:
                return V(*self._read(list(parts)).hull())
            vs = [self._vec(t, n) for t in parts]
            return V(np.min([v.lo for v in vs], 0), np.max([v.hi for v in vs], 0))
        if base == "constant_pad_nd":
            pad = list(args[1])
            value = float(args[2]) if len(args) > 2 else 0.0
            x = self._vec(args[0], _last(args[0]))
            if len(pad) == 2 and pad[0] >= 0 and pad[1] >= 0 and x.lo.ndim == 1:
                return V(np.concatenate([np.full(pad[0], value), x.lo, np.full(pad[1], value)]),
                         np.concatenate([np.full(pad[0], value), x.hi, np.full(pad[1], value)]))
            lo, hi = x.hull()
            return V(min(lo, value), max(hi, value)).width(n)
        if base == "where":
            a, b = vec(1), vec(2)
            return V(np.minimum(a.lo, b.lo), np.maximum(a.hi, b.hi))
        if base == "sum":
            val, out = args[0].meta.get("val"), node.meta.get("val")
            k = max(1, val.numel() // max(1, out.numel())) if val is not None else 1
            dims = args[1] if len(args) > 1 and args[1] is not None else list(range(_ndim(args[0])))
            nd = _ndim(args[0])
            keep_last = n > 0 and all(d % nd != nd - 1 for d in dims) and _last(args[0]) == n
            a = self._vec(args[0], n) if keep_last else V(*self._read(args[0]).hull())
            lo = np.where(a.lo < 0, np.minimum(a.lo * k, 0.0), a.lo)
            hi = np.where(a.hi > 0, a.hi * k, np.maximum(a.hi * k, a.hi))
            return V(lo, hi) if keep_last else V(float(lo), float(hi)).width(n)
        if base in ("full", "fill", "new_full", "full_like"):
            v = float(args[-1] if base != "full" else args[1])
            return V(v, v)
        if base in ("zeros", "zeros_like", "new_zeros", "zero", "empty", "empty_like",
                    "new_empty"):
            return V(0.0, 0.0)
        if base in ("ones", "ones_like", "new_ones"):
            return V(1.0, 1.0)
        if base in ("maximum", "minimum"):
            a, b = vec(0), vec(1)
            f = np.maximum if base == "maximum" else np.minimum
            return V(f(a.lo, b.lo), f(a.hi, b.hi))
        if base == "abs":
            a = vec(0)
            lo = np.where((a.lo <= 0) & (a.hi >= 0), 0.0, np.minimum(abs(a.lo), abs(a.hi)))
            return V(lo, np.maximum(abs(a.lo), abs(a.hi)))
        return V.of(TOP)


def analyze(fn: Callable, args: Sequence, in_intervals: Sequence[Interval]) -> LimbReport:
    """``fn`` traced on ``args`` (their shapes and types) and analyzed with
    its inputs in ``in_intervals``."""
    return Analyzer().run(trace(fn, args), in_intervals)


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------


@dataclass
class LimbEntry:
    name: str
    fn: Callable
    shapes: Sequence[Tuple[int, ...]]
    in_intervals: Sequence[Interval]
    contract: str = ""
    dtype: str = "float32"


STRICT = (0.0, 256.0)
LOOSE24 = (0.0, float((1 << 24) - 1))
LOOSE22 = (0.0, float((1 << 22) - 1))


def limb_entries() -> List[LimbEntry]:
    """``ops/limbs.py``'s arithmetic core at the JAX package's contracts
    (``lodestar_tpu/analysis/limb_interval.limb_entries``, without the
    one-hot matrix modes), and ``carry_ripple_exact`` at its semi-strict
    contract."""
    from ..ops import limbs as fl

    n = fl.NLIMBS
    sub_a = (0.0, float((1 << 23) - 1))
    sub_b = (0.0, float((1 << 12) - 1))
    return [
        LimbEntry("fp_strict", fl.fp_strict, [(n,)], [LOOSE24], "loose digits < 2^24 -> strict"),
        LimbEntry("fp_add", fl.fp_add, [(n,), (n,)], [STRICT, STRICT],
                  "lazy digitwise sum of two strict elements"),
        LimbEntry("fp_sub", fl.fp_sub, [(n,), (n,)], [sub_a, sub_b],
                  "a digits < 2^23, b digits < 2^12"),
        LimbEntry("fp_mul", fl.fp_mul, [(n,), (n,)], [STRICT, STRICT], "strict x strict"),
        LimbEntry("fp_sqr", fl.fp_sqr, [(n,)], [STRICT], "strict square"),
        LimbEntry("fp_mul_small", lambda a: fl.fp_mul_small(a, (1 << 14) - 1), [(n,)], [STRICT],
                  "strict x largest small multiplier"),
        LimbEntry("carry_exact", fl.carry_exact, [(n,)], [LOOSE24],
                  "loose -> semi-strict carry passes"),
        LimbEntry("fp_reduce_full", fl.fp_reduce_full, [(n,)], [STRICT],
                  "semi-strict -> canonical (exact ripples + Barrett)"),
        LimbEntry("carry_ripple_exact", fl.carry_ripple_exact, [(n,)], [STRICT],
                  "semi-strict -> strict digits and the carry out"),
    ]


def _with_consts(step: Callable) -> Callable:
    from ..ops import fused_core as fc

    c = fc._consts("cpu")
    return lambda *rows: step(*rows, c)


def fused_entries() -> List[LimbEntry]:
    """The fused core's steps at the bounds their ``LV`` callers assert,
    and every row kernel's plain body at its inputs' contracts."""
    from ..ops import fused_core as fc
    from ..ops import fused_ladder, library_fuse, tower_kernels  # noqa: F401 - the kernels

    n = fc.NL
    semi2 = (0.0, 512.0)
    out = [
        LimbEntry("m_fold@22", _with_consts(lambda x, c: fc.m_fold(x, c, 22)), [(n,)], [LOOSE22],
                  "loose digits < 2^22", "int64"),
        LimbEntry("m_mul@16", _with_consts(lambda a, b, c: fc.m_mul(a, b, c, 16)),
                  [(n,), (n,)], [STRICT, STRICT], "semi-strict x semi-strict", "int64"),
        LimbEntry("m_mul@17", _with_consts(lambda a, b, c: fc.m_mul(a, b, c, 17)),
                  [(n,), (n,)], [semi2, STRICT], "a sum of two x semi-strict", "int64"),
        LimbEntry("m_mul@18", _with_consts(lambda a, b, c: fc.m_mul(a, b, c, 18)),
                  [(n,), (n,)], [semi2, semi2], "sums of two x sums of two", "int64"),
        LimbEntry("m_fq2_mul", _with_consts(fc.m_fq2_mul), [(2, n), (2, n)], [STRICT, STRICT],
                  "semi-strict Fq2 pairs", "int64"),
        LimbEntry("m_fq2_sqr", _with_consts(fc.m_fq2_sqr), [(2, n)], [STRICT],
                  "a semi-strict Fq2 pair", "int64"),
        LimbEntry("_canon", _with_consts(fc._canon), [(n,)], [LOOSE22], "loose digits < 2^22",
                  "int64"),
    ]
    for name, k in sorted(fc.KERNELS.items()):
        ivs = [LOOSE22 if i < k.loose_in else STRICT for i in range(k.n_in)]
        out.append(LimbEntry(f"{name}.plain", _with_consts(_plain_body(k)),
                             [(1,) + k.tail] * k.n_in, ivs,
                             f"{k.loose_in} loose inputs < 2^22, the rest semi-strict", "int64"))
    return out


def _plain_body(k) -> Callable:
    return lambda *a: k._plain(a[-1], *a[:-1])


def all_entries() -> List[LimbEntry]:
    return limb_entries() + fused_entries()


def analyze_entry(entry: LimbEntry) -> LimbReport:
    import torch

    dtype = getattr(torch, entry.dtype)
    args = [torch.zeros(s, dtype=dtype) for s in entry.shapes]
    return analyze(entry.fn, args, entry.in_intervals)


def _rel(path: str, repo: str) -> str:
    return os.path.relpath(path, repo) if path.startswith(repo + os.sep) else path


def audit_plain(entries: Optional[Sequence[LimbEntry]] = None, repo: str = REPO,
                reports: Optional[Dict[str, LimbReport]] = None) -> List[Violation]:
    """The rule over the plain versions: a value proven past the exact
    range, or an entry not proven whole; ``reports`` (when given)
    receives each entry's report by name."""
    out: List[Violation] = []
    for entry in all_entries() if entries is None else entries:
        rep = analyze_entry(entry)
        if reports is not None:
            reports[entry.name] = rep
        if rep.coverage < 1.0:
            f, line, op = rep.first_unbounded
            out.append(Violation(
                RULE, _rel(f, repo) or entry.name, line,
                f"{entry.name}: {rep.digit_nodes - rep.bounded_nodes} of {rep.digit_nodes} "
                f"digit nodes not bounded, the first `{op}` (an op the analyzer does not "
                f"know): the entry is not proven under its contract ({entry.contract})"))
        for f in rep.findings:
            out.append(Violation(
                RULE, _rel(f.file, repo) or entry.name, f.line,
                f"{entry.name}: `{f.op}` proven to reach [{f.lo:.6g}, {f.hi:.6g}] under the "
                f"entry's contract ({entry.contract}): past the exact +/-{f.bound:.6g}, where "
                f"float32 digits round and the kernels' any-order sums stop being the plain "
                f"version's"))
    return out


# ---------------------------------------------------------------------------
# the kernel headers: the 2^24 obligations held by the audit build
# ---------------------------------------------------------------------------

_FC = os.path.join("lodestar_tpu_torch", "ops", "fused_core.py")
_FL = os.path.join("lodestar_tpu_torch", "ops", "limbs.py")
_FOLD_IN = ((_FC, "_carry"), (_FL, "_carry_passes"), (_FL, "_pad_minus"), (_FL, "_pad_right"))
#: each obligation of ``field_coop.cuh``'s ``lcb`` and the steps of the
#: plain versions (file, function) that form the same values: the
#: obligation's largest value is held at or below their proven interval
PLAIN_STEPS = {
    "fold.input<10>": _FOLD_IN,
    "fold.input<12>": _FOLD_IN,
    "fold.input<13>": _FOLD_IN,
    "fold.input<22>": _FOLD_IN,
    "fold.input<24>": _FOLD_IN,
    "carry.pass": ((_FC, "_carry"), (_FL, "_carry_passes"), (_FC, "_ripple")),
    "reduce.sum": ((_FC, "m_fold"), (_FL, "_fold_tail")),
    "mul.operand": ((_FC, "m_fq2_mul"), (_FC, "m_fq2_sqr"), (_FC, "m_mul")),
    "mul.column": ((_FL, "skew_sum"),),
    "canon.barrett": ((_FC, "_canon"), (_FC, "_ripple")),
    "canon.qp": ((_FC, "_canon"),),
    "canon.ripple": ((_FC, "_ripple"), (_FC, "_cond_sub")),
}
HEADER = os.path.join("lodestar_tpu_torch", "ops", "kernels", "field_coop.cuh")


def fold_limit(name: str) -> float:
    """The largest value an obligation may reach: 2^BITS - 1 for a fold
    input, else below 2^24."""
    if name.startswith("fold.input<"):
        return float((1 << int(name[len("fold.input<"):-1])) - 1)
    return EXACT - 1


def header_obligations(rows: int = 37, seeds: Sequence[int] = (1, 2),
                       mutation: Optional[Tuple[str, str, str]] = None,
                       kernels: Optional[Sequence[str]] = None) -> Dict[str, Interval]:
    """The least and largest value each obligation of the kernel headers
    reached, the cooperative bodies (``kernels``: all) run by the audit
    build (``-DLC_BOUND_AUDIT``; ``mutation`` as ``kernel_audit.host_build``'s)
    on rows at the digit bounds and on seeded rows within the contracts."""
    import numpy as np

    from . import kernel_audit as ka
    from ..ops import fused_core as fc
    from ..ops import fused_ladder, library_fuse, tower_kernels  # noqa: F401 - the kernels

    lib = ctypes.CDLL(ka.host_build(["-O2", "-DLC_BOUND_AUDIT"], mutation))
    lib.host_bound_count.restype = ctypes.c_int
    lib.host_bound_name.restype = ctypes.c_char_p
    lib.host_bound_name.argtypes = [ctypes.c_int]
    n = lib.host_bound_count()
    lib.host_bound_reset()
    for name in ka.COOP if kernels is None else kernels:
        k = fc.KERNELS[name]
        for seed in seeds:
            rng = np.random.default_rng(seed)
            for make in (ka.edge_inputs, ka.kernel_inputs):
                ka.run_host(lib, name, make(k, rows, rng))
    lo, hi = (ctypes.c_longlong * n)(), (ctypes.c_longlong * n)()
    lib.host_bound_read(lo, hi)
    return {lib.host_bound_name(i).decode(): (float(lo[i]), float(hi[i])) for i in range(n)}


def _obligation_line(name: str) -> int:
    """The line of obligation ``name``'s entry in the header's names table."""
    with open(os.path.join(REPO, HEADER), encoding="utf-8") as f:
        text = f.read()
    ids = text[text.index("enum Id {"):text.index("COUNT\n")]
    names = text[text.index("NAMES[COUNT] = {"):]
    names = names[:names.index("};")]
    order = re.findall(r'"([^"]+)"', names)
    entry = re.findall(r"^\s*(\w+),", ids, re.M)[order.index(name)]
    return text[:text.index(f"  {entry},")].count("\n") + 1


def audit_headers(steps: Dict[Tuple[str, str], Interval],
                  reached: Optional[Dict[str, Interval]] = None,
                  repo: str = REPO) -> List[Violation]:
    """Each obligation: reached, within [0, its limit], and at or below the
    interval proven for the same step of the plain versions (``steps``:
    the plain analysis' (file, function) -> interval, files repo-relative)."""
    reached = header_obligations() if reached is None else reached
    out: List[Violation] = []
    for name, (lo, hi) in reached.items():
        line = _obligation_line(name)
        problems = []
        if lo > hi:
            problems.append("never reached by the audit build's bodies")
        else:
            limit = fold_limit(name)
            if lo < 0 or hi > limit:
                problems.append(f"reached [{lo:.0f}, {hi:.0f}], outside [0, {limit:.0f}]")
            plain = [steps[s] for s in PLAIN_STEPS.get(name, ()) if s in steps]
            if not plain:
                problems.append("no proven step of the plain versions to hold it against")
            elif hi > max(iv[1] for iv in plain):
                problems.append(f"reached {hi:.0f}, above the plain versions' proven "
                                f"{max(iv[1] for iv in plain):.0f} for the same step")
        for p in problems:
            out.append(Violation(RULE, HEADER, line, f"obligation {name}: {p}"))
    return out


def plain_steps(reports: Dict[str, LimbReport], repo: str = REPO) -> Dict[Tuple[str, str], Interval]:
    """The per-step intervals of the plain analysis' reports, merged, files
    repo-relative."""
    out: Dict[Tuple[str, str], Interval] = {}
    for rep in reports.values():
        for (f, func), iv in rep.steps.items():
            key = (_rel(f, repo), func)
            out[key] = _union(out.get(key, iv), iv)
    return out


def audit_limb_overflow(repo: str = REPO, with_headers: bool = True) -> List[Violation]:
    """The rule: the plain versions' proofs, then the kernel headers'
    obligations held against them."""
    reports: Dict[str, LimbReport] = {}
    out = audit_plain(repo=repo, reports=reports)
    if with_headers:
        out += audit_headers(plain_steps(reports, repo), repo=repo)
    return out
