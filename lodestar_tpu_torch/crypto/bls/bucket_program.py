"""One device program of the verifier at one bucket: a CUDA graph on a card.

The port's counterpart of the JAX verifier's per-bucket executables
(``TpuBlsVerifier._fn``, ``_jit``, ``_memo_key`` and
``DeviceExecutor.compiled``).  A ``BucketProgram`` is one program at one
key (card, bucket, fused, host_final_exp).  It holds static input buffers
shaped like ``pack()``'s 7-tuple at its bucket and the program's static
outputs: the Miller product's loose digits (6, 2, 50) and the verdict
bits ok in the split mode, the verdict in the full-device mode.

On a card the program is captured once into a ``torch.cuda.CUDAGraph``,
after one eager run that builds the kernel library and fills the constant
caches; a batch is then one replay.  ``run(packed)`` copies the batch's
arrays into pinned staging of its own, then host-to-device into the
static inputs, replays the graph, copies the static outputs into pinned
outputs of the batch's own and records an event after the copies.  All of
it is enqueued on the card's current stream under the card's lock: the
stream orders one batch's copies out before the next batch's copies in,
and the lock keeps two threads from interleaving their copies and
replays.  The card's graphs may share one memory pool, because each
batch's outputs leave the pool before the lock is released.

A capture that fails raises; the batch never runs eagerly in its place.
With ``capture_error_mode="thread_local"`` the other threads of the
process (the pool's workers, the sharded tier) go on allocating and
launching while one thread captures.

On the CPU (``device="cpu"``, the tests' path) nothing is captured: each
run calls the program eagerly on the static inputs, with the kernels'
plain versions, through the same copies in and out.

``MeshProgram`` is the sharded tier's counterpart (the JAX mesh
pseudo-executor's ``compiled[(n, host_final_exp, fused)]``): one graph
per shard for its local body, captured on the shard's own stream into
the shard's own pool (logical shards of one card replay at once, so
their graphs must not share a pool), and one graph on shard 0 for the
combine, whose ring copies shard 0's stream issues.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops import fused_core as fc
from ...ops import limbs as fl
from ...ops import sharded_verify as sv
from ...ops.ring_gather import enable_issuer_peers


def input_specs(bucket: int):
    """(shape, dtype) of each of ``pack()``'s seven arrays at ``bucket``:
    pk_x, pk_y, sig_x, sig_y, msg_u, the coefficient bits and the mask."""
    nl = fl.NLIMBS
    f32 = torch.float32
    return (((bucket, nl), f32), ((bucket, nl), f32), ((bucket, 2, nl), f32),
            ((bucket, 2, nl), f32), ((bucket, 2, 2, nl), f32), ((bucket, 64), f32),
            ((bucket,), torch.bool))


def _tensors(out) -> Tuple[torch.Tensor, ...]:
    """A program's result as its output tensors: (f's digits, ok) or
    (verdict,)."""
    if isinstance(out, torch.Tensor):
        return (out,)
    return tuple(o.a if isinstance(o, fc.LV) else o for o in out)


def _capture(device, stream, pool, fn: Callable, *args):
    """``fn(*args)`` captured on ``stream`` into a new CUDA graph in
    ``pool``: (graph, fn's result, the launch record, host seconds of the
    capture and of the instantiation).  A capture that fails raises;
    ``thread_local`` lets other threads go on allocating and launching
    meanwhile."""
    with torch.cuda.device(device), torch.cuda.stream(stream), \
            fc.recording_launches() as record:
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn(*args)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:  # the capture's own error is raised below  # lint: disable=bls-silent-except
                pass
            raise
        t1 = time.perf_counter()
        graph.capture_end()  # instantiates the graph
    return graph, out, record, {"capture": t1 - t0, "instantiate": time.perf_counter() - t1}


def _stage(packed: Sequence[np.ndarray], inputs: Sequence[torch.Tensor], pin: bool,
           bucket: int) -> Tuple[torch.Tensor, ...]:
    """A batch's arrays as host tensors of its own (pinned for a card),
    shaped as ``inputs``."""
    if len(packed) != len(inputs):
        raise ValueError(f"expected the {len(inputs)} packed arrays, got {len(packed)}")
    staged = []
    for a, dst in zip(packed, inputs):
        src = torch.from_numpy(np.ascontiguousarray(a))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"bucket {bucket}: packed array of shape "
                             f"{tuple(src.shape)}, expected {tuple(dst.shape)}")
        host = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=pin)
        host.copy_(src)
        staged.append(host)
    return tuple(staged)


class BucketProgram:
    """``entry`` (a device program of the 7 packed tensors) at ``bucket`` on
    ``device``, run under ``lock``, the card's.  On a card it is captured
    here, into ``pool`` (a graph pool handle; None: a pool of its own): the
    caller holds ``lock`` while it constructs one."""

    def __init__(self, device, bucket: int, entry: Callable, lock: threading.Lock,
                 pool=None):
        self.device = torch.device(device)
        self.bucket = bucket
        self._entry = entry
        self._lock = lock
        self.inputs = tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                            for shape, dtype in input_specs(bucket))
        #: the static outputs (on a card, the graph's; on the CPU, made by
        #: the first run)
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: {kernel name: {rows: launches}} of one run, recorded by the capture
        self.launch_rows: Dict[str, Dict[int, int]] = {}
        #: host seconds of the eager run, the capture and the instantiation
        self.seconds: Dict[str, float] = {}
        if self.device.type == "cuda":
            self._capture(pool)

    def _capture(self, pool) -> None:
        dev = self.device
        with torch.cuda.device(dev):
            t0 = time.perf_counter()
            self._entry(*self.inputs)  # builds the kernels, fills the constant caches
            t1 = time.perf_counter()
            current = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)  # a capture cannot run on the default stream
            side.wait_stream(current)
            graph, out, record, seconds = _capture(dev, side, pool, self._entry, *self.inputs)
            current.wait_stream(side)
        self.graph, self.outputs, self.launch_rows = graph, _tensors(out), record
        self.seconds = {"eager": t1 - t0, **seconds}

    def _stage(self, packed: Sequence[np.ndarray]) -> Tuple[torch.Tensor, ...]:
        return _stage(packed, self.inputs, self.device.type == "cuda", self.bucket)

    def run(self, packed: Sequence[np.ndarray]):
        """Enqueue one packed batch; returns (its outputs on the host, the
        event after their copies, or None on the CPU).  The outputs are
        the batch's own (pinned on a card): a later batch does not
        overwrite them.  On a card the host-side buffers are allocated
        before the lock is taken, and the caching host allocator does not
        hand out a pinned buffer again before the copies that use it are
        done."""
        staged = self._stage(packed)
        cuda = self.device.type == "cuda"
        host = (tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in self.outputs)
                if cuda else None)
        with self._lock:
            if cuda:
                with torch.cuda.device(self.device):
                    for dst, src in zip(self.inputs, staged):
                        dst.copy_(src, non_blocking=True)
                    self.graph.replay()
                    fc.add_launches(self.launch_rows)
                    for h, o in zip(host, self.outputs):
                        h.copy_(o, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
                return host, ready
            for dst, src in zip(self.inputs, staged):
                dst.copy_(src)
            out = _tensors(self._entry(*self.inputs))
            if self.outputs is None:
                self.outputs = tuple(torch.empty_like(o, device="cpu") for o in out)
            for dst, o in zip(self.outputs, out):
                dst.copy_(o)
            return tuple(o.clone() for o in self.outputs), None


class MeshProgram:
    """The sharded tier at ``bucket`` over ``mesh`` (``sharded_verify.Mesh``,
    its shards' devices and streams): ``fused`` / ``combine`` / ``full`` as
    in ``sharded_verify.ShardedProgram``, run under ``locks``, the locks of
    every card the mesh spans in card-index order (the caller holds them
    while it constructs one).  ``pools``: a graph pool per shard (None: a
    pool of its own each).

    On a card: one eager run (``_warm``: it fills each card's constant
    caches; the kernel library is loaded before), then shard s's local body is
    captured on its own stream at its static inputs (``bucket // n`` lanes)
    into its pool, and the combine on shard 0's stream into shard 0's,
    every ring copy issued by that stream into static buffers made first
    (``combine_buffers``).  A batch (``run``) is pinned staging of each
    slice, its copy into the shard's inputs and its graph's replay on the
    shard's stream, an event recorded after each; shard 0's stream waits
    for all of them, replays the combine, copies the outputs to pinned
    memory of the batch's own and records the event that is the sync.
    Before a shard's copies, its stream waits for shard 0's, so a batch
    does not overwrite the partials the previous batch's combine reads.
    Each replay adds every graph's launch record, so a replayed batch
    counts the eager one's launches.  On the CPU nothing is captured: the
    pieces run eagerly through the same copies."""

    def __init__(self, mesh: "sv.Mesh", bucket: int, fused: bool, combine: str, full: bool,
                 locks: Sequence[threading.Lock], pools: Optional[Sequence] = None):
        sv._check_combine(combine)
        if bucket % mesh.n:
            raise ValueError(f"bucket {bucket} does not split over {mesh.n} shards")
        self.mesh = mesh
        self.bucket = bucket
        self.fused, self.combine, self.full = fused, combine, full
        self._locks = list(locks)
        self._body = sv.local_body(fused)
        width = bucket // mesh.n
        #: per shard, its static inputs (its slice of ``pack()``'s arrays)
        self.inputs = [tuple(torch.zeros(shape, dtype=dtype, device=d)
                             for shape, dtype in input_specs(width)) for d in mesh.devices]
        #: the combine's static outputs on shard 0 (on a card, its graph's)
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        #: the shards' graphs, then the combine's (empty on the CPU)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        #: {kernel name: {rows: launches}} of one run, all graphs together
        self.launch_rows: Dict[str, Dict[int, int]] = {}
        #: host seconds of the eager run, the captures and the
        #: instantiations (summed over the graphs)
        self.seconds: Dict[str, float] = {}
        if mesh.cuda:
            self._capture_all(pools or [None] * mesh.n)

    def _run_eager(self):
        """Every shard's local body on its static inputs, then the combine
        (the CPU's run)."""
        parts = self.mesh.map(lambda s, ins: self._body(*ins), self.inputs)
        fs, bits = (list(x) for x in zip(*parts))
        return sv.finish(self.mesh, self.fused, self.combine, self.full, fs, bits)

    def _warm(self) -> None:
        """The eager run before the captures, which fills each card's
        constant caches: the local body once per card (its first shard's;
        logical shards share the card's caches), then the combine on those
        partials, each card's standing in for its other shards."""
        mesh = self.mesh
        first = {}
        for s, d in enumerate(mesh.devices):
            first.setdefault(d, s)
        outs = {}
        for d, s in first.items():
            with mesh.context(s):
                outs[d] = self._body(*self.inputs[s])
        for d in first:
            torch.cuda.synchronize(d)
        fs, bits = ([outs[d][k] for d in mesh.devices] for k in (0, 1))
        sv.finish(mesh, self.fused, self.combine, self.full, fs, bits)
        for d in first:
            torch.cuda.synchronize(d)

    def _capture_all(self, pools) -> None:
        mesh = self.mesh
        t0 = time.perf_counter()
        self._warm()
        t1 = time.perf_counter()
        totals = {"capture": 0.0, "instantiate": 0.0}

        def add(graph, record, sec):
            self.graphs.append(graph)
            for name, by_rows in record.items():
                mine = self.launch_rows.setdefault(name, {})
                for rows, n in by_rows.items():
                    mine[rows] = mine.get(rows, 0) + n
            for k in totals:
                totals[k] += sec[k]

        fs, bits = [], []
        for s in range(mesh.n):
            graph, (f, b), record, sec = _capture(mesh.devices[s], mesh.streams[s], pools[s],
                                                  self._body, *self.inputs[s])
            add(graph, record, sec)
            fs.append(f)
            bits.append(b)
        issuer = mesh.streams[0]
        enable_issuer_peers(issuer.device, mesh.devices)
        buffers = sv.combine_buffers(mesh, self.combine)
        graph, out, record, sec = _capture(mesh.devices[0], issuer, pools[0], sv.finish, mesh,
                                           self.fused, self.combine, self.full, fs, bits,
                                           buffers, issuer)
        add(graph, record, sec)
        # the graphs read and write these: they live as long as the program
        self._static = (fs, bits, buffers)
        self.outputs = _tensors(out)
        self.seconds = {"eager": t1 - t0, **totals}

    def run(self, packed: Sequence[np.ndarray]):
        """Enqueue one packed batch; returns (its outputs on the host, the
        event after their copies, or None on the CPU), as
        ``BucketProgram.run``.  ``mesh.enqueue_walls`` gets each shard's
        host seconds (its copies and replay)."""
        mesh = self.mesh
        cuda = mesh.cuda
        staged = [_stage(sl, ins, cuda, self.bucket)
                  for sl, ins in zip(mesh.split(packed), self.inputs)]
        host = (tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in self.outputs)
                if cuda else None)
        with contextlib.ExitStack() as held:
            for lock in self._locks:
                held.enter_context(lock)
            if not cuda:
                for ins, st in zip(self.inputs, staged):
                    for dst, src in zip(ins, st):
                        dst.copy_(src)
                out = _tensors(self._run_eager())
                if self.outputs is None:
                    self.outputs = tuple(torch.empty_like(o) for o in out)
                for dst, o in zip(self.outputs, out):
                    dst.copy_(o)
                return tuple(o.clone() for o in self.outputs), None
            first = mesh.streams[0]
            done, walls = [], []
            for s in range(mesh.n):
                t0 = time.perf_counter()
                with mesh.context(s):
                    if s:
                        mesh.streams[s].wait_stream(first)
                    for dst, src in zip(self.inputs[s], staged[s]):
                        dst.copy_(src, non_blocking=True)
                    self.graphs[s].replay()
                    ev = torch.cuda.Event()
                    ev.record(mesh.streams[s])
                    done.append(ev)
                walls.append(time.perf_counter() - t0)
            with mesh.context(0):
                for ev in done[1:]:
                    first.wait_event(ev)
                self.graphs[-1].replay()
                fc.add_launches(self.launch_rows)
                for h, o in zip(host, self.outputs):
                    h.copy_(o, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(first)
            mesh.enqueue_walls = walls
        return host, ready
