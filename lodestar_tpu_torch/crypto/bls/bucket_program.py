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
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops import fused_core as fc
from ...ops import limbs as fl


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
            graph = torch.cuda.CUDAGraph()
            current = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)  # a capture cannot run on the default stream
            side.wait_stream(current)
            with torch.cuda.stream(side), fc.recording_launches() as record:
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    outputs = _tensors(self._entry(*self.inputs))
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:  # the capture's own error is raised below
                        pass
                    raise
                t2 = time.perf_counter()
                graph.capture_end()  # instantiates the graph
            current.wait_stream(side)
            t3 = time.perf_counter()
        self.graph, self.outputs, self.launch_rows = graph, outputs, record
        self.seconds = {"eager": t1 - t0, "capture": t2 - t1, "instantiate": t3 - t2}

    def _stage(self, packed: Sequence[np.ndarray]) -> Tuple[torch.Tensor, ...]:
        """The batch's arrays as host tensors of its own (pinned on a card)."""
        if len(packed) != len(self.inputs):
            raise ValueError(f"expected the {len(self.inputs)} packed arrays, got {len(packed)}")
        pin = self.device.type == "cuda"
        staged = []
        for a, dst in zip(packed, self.inputs):
            src = torch.from_numpy(np.ascontiguousarray(a))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"bucket {self.bucket}: packed array of shape "
                                 f"{tuple(src.shape)}, expected {tuple(dst.shape)}")
            host = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=pin)
            host.copy_(src)
            staged.append(host)
        return tuple(staged)

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
