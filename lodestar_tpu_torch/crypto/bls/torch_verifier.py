"""TorchBlsVerifier: batched BLS signature-set verification on CUDA cards.

The port's verifier boundary (``verify_signature_sets(sets) -> bool``, and
``verify_signature_sets_async(sets, deadline=None) -> PendingVerdict`` for
the scheduling layer, ``chain/bls_pool``).  The host packs a batch into
digit arrays padded to the smallest bucket of ``buckets`` that fits it
(``pack``; a batch above the largest is verified in chunks of that size),
and the device runs one of two programs:

- ``fused=True`` (the default): the fused program (``ops/fused_verify``);
- ``fused=False``: the XLA-graph program (``ops/batch_verify``), which the
  JAX package runs on every backend but a TPU.

With ``host_final_exp=True`` (the default, as in the JAX package) the
split dispatch: the device returns the Miller product f and the verdict
bits ok, and the host finishes with the C final exponentiation
(``native/fastbls``).  With ``host_final_exp=False`` the final
exponentiation runs on the card too, and the device returns the verdict.

On a card each (card, bucket, program, mode) is one CUDA graph
(``bucket_program.BucketProgram``, the counterpart of the JAX verifier's
per-bucket executables): captured at its first batch, or ahead of time by
``warmup(buckets)`` / ``warmup_async``, and replayed for every batch.
Making a program walks the JAX verifier's materialization ladder, with
the kernel library in place of its executables: the library comes from
this process, else the durable store (``aot/store.py``: ``aot_store=``,
or the process-wide store that ``LODESTAR_TPU_TORCH_AOT_STORE`` turns
on), else ``build/``, else nvcc, and is then saved to the store; the
graph is captured from it.  ``load_only=True`` (the rolling-restart
contract) refuses to build: a library the store cannot serve raises
``AotStoreMiss`` and no nvcc process starts.  Every build, load and
capture is recorded in the compile ledger
(``observatory.COMPILE_LEDGER``) by entry, bucket and device.  The
outputs are copied to pinned host memory behind the replay and an event
is recorded after the copies; waiting on that event is the sync, so that
a verdict does not wait for batches enqueued after it on the same stream.
The card's graphs share one memory pool and one lock.

Placement and health, as the JAX verifier's self-healing pool
(``docs/chaos.md``): each entry of ``devices`` is a ``DeviceExecutor``
(a card that repeats gives distinct executors, which share the card's
graphs, lock and pool), and a per-card batch goes to the least loaded
eligible executor, round-robin among equals.  Each executor keeps a
health record, healthy -> suspect -> quarantined -> probing: after
``quarantine_threshold`` consecutive failures it gets no batch until an
exponential backoff has passed, then one probe batch re-admits it or
doubles the backoff.  A batch whose sync fails (``PendingVerdict.result``)
frees its slot, is recorded against its executor, and its packed payload
is replayed once more on another executor (``bls.requeue``; the same card
program, never the CPU: ``devices`` may not put cards beside other
devices; never the mesh), walking further executors while
they last.  An enqueue failure frees the slot, is recorded and raises; it
is not requeued.  Every dispatch is journaled (``forensics.JOURNAL``),
held in the in-flight table (``forensics.INFLIGHT``) until its verdict is
read, and traced when ``tracing.TRACER`` is on; ``metrics`` takes the
JAX registry's counters and gauges; entering quarantine writes one
rate-limited diagnostic bundle (``forensics.RECORDER``).

There is no other path to fall back to: the JAX verifier's degrade ladder
(fused -> XLA-graph program, sharded -> per-card) and its host-native
rung are not ported.  Where the JAX verifier would return the native
verdict, this one raises the failure: with one executor the original
error, after a requeue that failed too the requeue's error, and the
caller (the pool's per-job retry) owns the jobs.  Executors on one card
share its CUDA context, so a real sticky CUDA error fails them all:
requeue survives a lost card only across distinct cards.

With ``devices=[...]`` and ``sharded=True`` (or ``LODESTAR_TPU_SHARDED``
on: the tier is opt-in, as the JAX verifier's is off a TPU pool) the
verifier has two tiers, as the JAX verifier's pool does: a batch whose
bucket is at least ``sharded_min_batch`` and divisible by the shard count
rides the sharded tier (``ops/sharded_verify``, one batch split over
every shard; its health record is the mesh pseudo-executor's, named
``mesh{n}`` for n executors as in the JAX verifier); any other batch
runs whole on one executor.  The tier's program is one
``bucket_program.MeshProgram`` per bucket (a graph per shard, one for the
combine), made at a bucket's first batch or by ``warmup_sharded`` and
``warmup``'s mesh pass.
``sharded_active`` tells the pool that the tier can take a batch, so that
it merges batches up to the mesh's bucket.

``close()`` releases what the verifier holds (the per-bucket graphs and
their pools, the sharded tier's programs and its streams, the point
cache); a verify after it raises.  The kernel
libraries stay loaded: every verifier in the process shares them.
"""

from __future__ import annotations

import contextlib
import logging
import os
import secrets
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import resolve_device
from ...aot.store import capability_tag
from ...chaos import CHAOS, DeviceLostError
from ...forensics.journal import JOURNAL
from ...forensics.watchdog import INFLIGHT
from ...native import fastbls
from ...ops import limbs as fl
from ...ops.batch_verify import miller_product_kernel, verify_signature_sets_kernel
from ...ops.fused_verify import miller_product_fused, verify_signature_sets_fused
from ...ops.htc import hash_to_field_limbs
from ...observatory.compile_ledger import COMPILE_LEDGER
from ...ops.kernels import _build
from ...ops.sharded_verify import COMBINES, Mesh, mesh_device_name
from ...tracing import TRACER, current_batch_id
from .bucket_program import BucketProgram, MeshProgram
from .curve import g2_from_bytes, to_affine_batch
from .verifier import PointCache, SignatureSet, SingleSignatureSet, get_aggregated_pubkey

logger = logging.getLogger(__name__)

# Padding buckets: the smallest that fits the batch is used.  128 is the
# node's MAX_SIGNATURE_SETS_PER_JOB; larger buckets amortize sync batches.
DEFAULT_BUCKETS = (4, 16, 64, 128, 256)


def entry_name(fused: bool, host_final_exp: bool) -> str:
    """The compile-ledger label of a per-card program, as the JAX
    verifier's ``_entry_name``."""
    if fused:
        return "fused_split" if host_final_exp else "fused_full"
    return "xla_split" if host_final_exp else "xla_full"


def mesh_entry_name(host_final_exp: bool) -> str:
    """The compile-ledger label of the sharded tier's program, as the JAX
    verifier's ``_mesh_entry_name`` (paired with the ``mesh{n}`` device
    label: one entry, never n per-card rows)."""
    return "sharded_split" if host_final_exp else "sharded_full"


def sharded_default(n_devices: int) -> bool:
    """The sharded tier when the caller leaves it to the verifier, as the
    JAX verifier's ``_sharded_default``: ``LODESTAR_TPU_SHARDED``, when
    set, decides (``0``, ``false`` and ``no`` mean off, any other value
    on); otherwise the tier is opt-in."""
    env = os.environ.get("LODESTAR_TPU_SHARDED")
    if env is not None:
        return env not in ("0", "false", "no")
    if n_devices < 2:
        return False
    # The JAX verifier turns the tier on by default on a pool of several TPU
    # chips.  Its CUDA counterpart waits for a ``python3 chip_smoke.py
    # --sharded-only`` run across distinct cards that beats one card: so far
    # the tier has run only over logical shards of one card, which share it.
    return False


def fq12_blob(digits) -> bytes:
    """(6, 2, 50) digits of any looseness -> the C library's Fq12 blob: the
    12 components reduced mod p, 48 big-endian bytes each, in tower order."""
    arr = np.asarray(digits, dtype=np.float64)
    return b"".join((fl.limbs_to_int(arr[i, j]) % fl.P_INT).to_bytes(48, "big")
                    for i in range(6) for j in range(2))


class PendingVerdict:
    """A dispatched batch whose verdict has not been read back.

    Construction never blocks: the device work is enqueued, and
    ``result()`` is the only synchronisation (the device readback and, on
    the split path, the host final exponentiation).  ``result()`` is
    idempotent: the verdict, or the failure, is kept and given again.

    ``release``, the executor's in-flight slot and the batch's entry in
    the in-flight table, is returned exactly once, when the first
    ``result()`` ends, whether it returns or raises.  A failed sync (a
    lost card, an injected fault) releases the slot FIRST, then hands the
    batch to the verifier's recovery, which replays the same packed
    payload on another executor (``bls.requeue``) or raises; a verdict
    read records the executor's success."""

    __slots__ = ("_verifier", "_f", "_ok", "_ready", "_out", "_value", "_parts",
                 "_release", "_packed", "_executor", "_attempt", "_fault", "_exc",
                 "device", "deadline")

    def __init__(self, verifier=None, f=None, ok=None, ready=None, out=None, value=None,
                 parts=None, release: Optional[Callable[[], None]] = None,
                 device: Optional[str] = None, deadline: Optional[float] = None,
                 packed=None, executor=None, attempt: int = 0, fault=None):
        self._verifier = verifier
        self._f = f
        self._ok = ok
        self._ready = ready
        self._out = out
        self._value = value
        self._parts = parts
        self._release = release
        self._packed = packed      # the dispatched payload (a requeue replays it)
        self._executor = executor  # the DeviceExecutor the batch landed on
        self._attempt = attempt    # requeue generation (0: first placement)
        self._fault = fault        # an armed chaos FaultSpec riding this verdict
        self._exc: Optional[Exception] = None
        #: the executor the batch runs on (a card, ``mesh{n}``), or None (chunked)
        self.device = device
        #: the tightest job deadline riding the batch (``time.monotonic()``)
        self.deadline = deadline

    def done_hint(self) -> bool:
        """True once the verdict is kept (no sync performed)."""
        return self._value is not None

    def _release_once(self) -> None:
        release, self._release = self._release, None
        if release is not None:
            release()

    def _compute(self) -> bool:
        """The sync itself (no keeping, no release): the one place an
        injected device fault surfaces, where a real one would."""
        fault, self._fault = self._fault, None  # consumed: never fires again
        if fault is not None:
            if fault.seam == "device.wedge" and fault.wedge_s > 0:
                # the wedge window: the batch ages in the in-flight table
                # (the watchdog's evidence) before the loss surfaces
                time.sleep(fault.wedge_s)
            raise DeviceLostError(fault.error or f"injected {fault.seam} on {self.device}")
        if self._parts is not None:
            # read every chunk, so that each returns its slot, then report
            results, error = [], None
            for part in self._parts:
                try:
                    results.append(part.result())
                except Exception as e:  # noqa: BLE001 - re-raised below  # lint: disable=bls-silent-except
                    error = error or e
            if error is not None:
                raise error
            return all(results)
        if self._f is not None:
            return self._verifier._host_final_exp_verdict(self._f, self._ok, self._ready)
        # the full-device verdict: the sync is the read; the span plays
        # the final exponentiation's part on this path's timeline
        t0_ns = TRACER.now()
        if self._ready is not None:
            self._ready.synchronize()
        value = bool(self._out)
        if TRACER.enabled:
            TRACER.add_span("bls.final_exp", "bls", t0_ns, cid=current_batch_id(),
                            on_device=True)
        return value

    def result(self) -> bool:
        if self._value is not None:
            return self._value
        if self._exc is not None:
            raise self._exc
        try:
            value = self._compute()
        except Exception as e:
            # free the slot BEFORE recovery: the replay must see this
            # executor's in-flight count already decremented
            self._release_once()
            v = self._verifier
            if v is not None and self._executor is not None:
                try:
                    self._value = v._recover_failed_batch(self, e)
                    return self._value
                except Exception as terminal:
                    self._exc = terminal
                    raise
            self._exc = e
            raise
        else:
            self._value = value
            if self._verifier is not None and self._executor is not None:
                self._verifier._record_executor_success(self._executor)
            return value
        finally:
            self._release_once()


# -- executor health (the self-healing pool, docs/chaos.md) -----------------
#
# Per-executor state machine driven by verdict outcomes:
#
#     healthy --failure--> suspect --(failures >= threshold)--> quarantined
#        ^                    |                                     |
#        |<----success--------+          (backoff expires)          v
#        |<------------ probe success ------------------------- probing
#                              probe failure: re-quarantined, backoff doubled
#
# A quarantined executor receives no placements until its backoff expires;
# it is then re-admitted with ONE probe batch — success restores it to the
# rotation (backoff reset), failure doubles the backoff and re-quarantines.
# Numeric values are exported as lodestar_bls_device_health{device}.

HEALTHY, SUSPECT, PROBING, QUARANTINED = (
    "healthy", "suspect", "probing", "quarantined"
)
HEALTH_STATE_VALUES = {HEALTHY: 0, SUSPECT: 1, PROBING: 2, QUARANTINED: 3}


class ExecutorHealth:
    """Mutable health record of one DeviceExecutor.  All writes happen
    under the verifier's ``_sched_lock`` (the same lock that owns the
    in-flight counters the placement reads)."""

    __slots__ = ("state", "failures", "quarantines", "quarantined_until",
                 "backoff_s", "last_error", "changed_monotonic")

    def __init__(self, backoff_s: float):
        self.state = HEALTHY
        self.failures = 0        # consecutive failures (reset on success)
        self.quarantines = 0     # lifetime quarantine entries
        self.quarantined_until = 0.0  # monotonic instant the backoff expires
        self.backoff_s = backoff_s    # next quarantine duration (doubles)
        self.last_error = None
        self.changed_monotonic = 0.0

    def snapshot(self, now: Optional[float] = None) -> Dict[str, object]:
        if now is None:
            now = time.monotonic()
        return {
            "state": self.state,
            "failures": self.failures,
            "quarantines": self.quarantines,
            "backoff_s": round(self.backoff_s, 3),
            "readmission_in_s": (
                round(max(0.0, self.quarantined_until - now), 3)
                if self.state == QUARANTINED else None
            ),
            "last_error": self.last_error,
        }


class DeviceExecutor:
    """One entry of the verifier's ``devices``: the card its batches run on
    (its programs are the card's, ``TorchBlsVerifier.programs``, shared by
    every executor of the card), an in-flight batch counter the placement
    reads, and the health record the self-healing pool steers around.
    ``device`` is None for the mesh pseudo-executor.  ``placed``: the
    executor has taken a batch (``device_inflight`` lists those)."""

    __slots__ = ("device", "index", "name", "inflight", "health", "placed")

    def __init__(self, device, index: int, backoff_s: float, name: str):
        self.device = device
        self.index = index
        self.name = name
        self.inflight = 0
        self.health = ExecutorHealth(backoff_s)
        self.placed = False


def executor_names(devices: Sequence[torch.device]) -> List[str]:
    """Unique, stable executor names: a card's first executor is named as
    the card (``cuda:0``), its later ones ``cuda:0#1``, ``cuda:0#2``, ..."""
    seen: Dict[torch.device, int] = {}
    names = []
    for d in devices:
        k = seen.get(d, 0)
        seen[d] = k + 1
        names.append(str(d) if k == 0 else f"{d}#{k}")
    return names


class TorchBlsVerifier:
    """Verifies signature sets on ``device`` (the card unless the caller
    asks for ``"cpu"``, which runs the kernels' plain versions), or on the
    shards of ``devices``.

    ``fused``: the fused program (True) or the XLA-graph program (False).
    ``host_final_exp``: the split dispatch, the final exponentiation on the
    host (True, the default), or the whole verification on the device.
    ``rng``: a ``numpy.random.Generator`` for the RLC coefficients, for
    reproducible runs; None (the default) draws them from ``secrets``.
    ``devices``: one executor each (a card may repeat), and the shards of
    the sharded tier, in mesh order (None: the single ``device``); cards
    beside other devices are refused.
    ``sharded``: the tier on or off (None:
    ``sharded_default``, off unless ``LODESTAR_TPU_SHARDED`` says on).
    ``sharded_min_batch``: the smallest bucket the tier takes (None: the
    largest bucket).
    ``sharded_combine``: ``"all_gather"`` or ``"ring"``.
    ``buckets``: the padding buckets (the smallest that fits a batch is
    used; a batch above the largest is chunked at it).
    ``point_cache_size``: the entries of the pack's point cache.
    ``quarantine_threshold``: consecutive failures before an executor is
    quarantined; ``quarantine_backoff_s``: its first backoff, doubled by
    each failed probe up to ``quarantine_backoff_max_s`` (the JAX
    verifier's parameters and defaults).  ``metrics``: a ``metrics.Metrics``
    registry the verifier (and the compile ledger) report to (None: none).
    ``aot_store``: a ``aot.KernelLibraryStore`` (None: the process-wide
    one, on when configured or when ``LODESTAR_TPU_TORCH_AOT_STORE`` is
    set).  ``load_only``: never build the kernel library (the
    rolling-restart contract): a store miss raises ``AotStoreMiss``.

    Several host threads may pack and dispatch at once (the pool keeps
    batches in flight from worker threads): the coefficient draws, the
    placement, the programs and the counters take locks."""

    def __init__(self, device="cuda", rng: Optional[np.random.Generator] = None,
                 fused: bool = True, devices: Optional[Sequence] = None,
                 sharded: Optional[bool] = None, sharded_min_batch: Optional[int] = None,
                 sharded_combine: str = "all_gather", host_final_exp: bool = True,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, point_cache_size: int = 8192,
                 quarantine_threshold: int = 2, quarantine_backoff_s: float = 1.0,
                 quarantine_backoff_max_s: float = 60.0, metrics=None, aot_store=None,
                 load_only: bool = False):
        if not buckets:
            raise ValueError("buckets: at least one bucket")
        self.buckets = tuple(sorted(buckets))
        self.point_cache = PointCache(point_cache_size)
        self.rng = rng
        self.fused = fused
        self.host_final_exp = host_final_exp
        if devices is None:
            self.devices = [resolve_device(device)]
        elif not devices:
            raise ValueError("devices: at least one device")
        else:
            self.devices = [resolve_device(d) for d in devices]
        # a requeue replays a batch on another executor: a card beside a
        # CPU entry would move a card's failed batch to the plain versions
        kinds = {d.type for d in self.devices}
        if "cuda" in kinds and len(kinds) > 1:
            raise ValueError(f"devices: cards beside other devices {self.devices}: "
                             "a card's batch never runs off the cards")
        self.device = self.devices[0]
        self.sharded = sharded_default(len(self.devices)) if sharded is None else bool(sharded)
        self.sharded_min_batch = (self.buckets[-1] if sharded_min_batch is None
                                  else sharded_min_batch)
        if self.sharded and sharded_combine not in COMBINES:
            raise ValueError(f"sharded_combine must be one of {COMBINES}, got {sharded_combine!r}")
        self.sharded_combine = sharded_combine
        # the sharded tier's shards and their streams, shared by its
        # per-bucket programs, and a graph pool per shard; as in the JAX
        # verifier the tier needs two executors: one executor builds no
        # mesh, whatever ``sharded`` says (``self.sharded`` keeps it)
        tiered = self.sharded and len(self.devices) >= 2
        self._mesh = Mesh(self.devices) if tiered else None
        self._mesh_pools: Optional[list] = None
        #: the sharded tier's programs by ("mesh", bucket, fused, host_final_exp)
        self.mesh_programs: Dict[tuple, MeshProgram] = {}
        self.aot_store = aot_store
        self.load_only = load_only
        #: the shard count of the sharded tier (0 when it is off)
        self.mesh_devices = len(self.devices) if tiered else 0
        #: batches the sharded tier verified
        self.sharded_batches = 0
        #: split dispatches finished on the host
        self.host_final_exps = 0
        # the counters of the JAX verifier: batches dispatched and their
        # live sets; per pack, the padding lanes, a rejected batch, and the
        # point cache's hits and misses
        self.dispatches = 0
        self.sets_verified = 0
        self.padding_wasted = 0
        self.pack_rejected = 0
        self.pack_cache_hits = 0
        self.pack_cache_misses = 0
        #: failed batches replayed on another executor
        self.batches_requeued = 0
        self.metrics = metrics
        if metrics is not None:
            COMPILE_LEDGER.configure(metrics=metrics)
        # the self-healing pool's parameters: consecutive failures before
        # quarantine, the first backoff, and the doubling cap
        self.quarantine_threshold = max(1, quarantine_threshold)
        self.quarantine_backoff_s = quarantine_backoff_s
        self.quarantine_backoff_max_s = quarantine_backoff_max_s
        # one bundle per reason per cooldown: a persistently sick card must
        # not fill the scratch disk
        self._dump_cooldown_s = 60.0
        self._last_dump_by_reason: Dict[str, float] = {}
        #: host seconds, summed over batches: packing, enqueueing the device
        #: program (and, split, the copies of ok and f to the host), the
        #: sync (on the event after those copies, or on the verdict), the
        #: read of f's host copy and the C final exponentiation; and
        #: ``warmup``'s
        self.stage_seconds: Dict[str, float] = dict.fromkeys(
            ("pack", "dispatch", "sync", "readback", "final_exp", "warmup"), 0.0)
        # the per-card tier: the distinct cards of ``devices``, in order, and
        # one executor per entry of ``devices``
        self._cards = list(dict.fromkeys(self.devices))
        self._executors = [
            DeviceExecutor(d, i, quarantine_backoff_s, name)
            for i, (d, name) in enumerate(zip(self.devices, executor_names(self.devices)))
        ]
        # the sharded tier's pseudo-executor: its slot and health record;
        # not in the placement rotation (a mesh batch spans every shard)
        self._mesh_ex = DeviceExecutor(None, -1, quarantine_backoff_s,
                                       mesh_device_name(len(self._executors)))
        self._rr = 0  # the round-robin tie-break cursor
        #: the per-card programs by (card, bucket, fused, host_final_exp)
        self.programs: Dict[tuple, BucketProgram] = {}
        # one lock and one graph pool per card, shared by its programs
        self._card_locks: Dict[torch.device, threading.Lock] = {}
        self._graph_pools: Dict[torch.device, tuple] = {}
        self._sched_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._rng_lock = threading.Lock()
        self._closed = False

    def close(self) -> None:
        """Release the per-bucket graphs and their pools (after the cards
        have finished the batches in flight), the sharded tier's programs
        and its streams, and the point cache; a verify or dispatch after
        this raises.  Verdicts already dispatched can still be read.  The
        kernel libraries stay loaded: every verifier in the process shares
        them."""
        self._closed = True
        with contextlib.ExitStack() as held:
            for lock in self._mesh_locks():
                held.enter_context(lock)
            if self._mesh is not None and self._mesh.cuda:
                for card in self._cards:
                    torch.cuda.synchronize(card)
            self.mesh_programs.clear()
            self._mesh_pools = None
            self._mesh = None
        for card, lock in list(self._card_locks.items()):
            with lock:
                if card.type == "cuda" and card in self._graph_pools:
                    torch.cuda.synchronize(card)
                for key in [k for k in self.programs if k[0] == card]:
                    del self.programs[key]
                self._graph_pools.pop(card, None)
        self.point_cache.clear()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("TorchBlsVerifier: closed")

    @property
    def n_devices(self) -> int:
        """The distinct cards batches are placed on (the pool keeps
        ``pipeline_depth`` batches in flight per card)."""
        return len(self._cards)

    @property
    def n_executors(self) -> int:
        """The executors batches are placed on, one per entry of
        ``devices`` (the JAX verifier's ``n_devices``)."""
        return len(self._executors)

    def device_inflight(self) -> Dict[str, int]:
        """Batches in flight per executor that has taken a batch (and on
        the mesh), a snapshot."""
        with self._sched_lock:
            return {ex.name: ex.inflight for ex in (*self._executors, self._mesh_ex)
                    if ex.placed}

    def executor_health(self) -> Dict[str, Dict[str, object]]:
        """Each executor's health snapshot (and the mesh's, when the
        sharded tier is on over two executors or more): the diagnostic
        bundles read it."""
        now = time.monotonic()
        with self._sched_lock:
            out = {ex.name: ex.health.snapshot(now) for ex in self._executors}
            if self.sharded and self.n_executors > 1:
                out[self._mesh_ex.name] = self._mesh_ex.health.snapshot(now)
            return out

    def _add_stage(self, stage: str, seconds: float) -> None:
        with self._stats_lock:
            self.stage_seconds[stage] += seconds

    def verify_signature_sets(self, sets: Sequence[SignatureSet]) -> bool:
        """True iff every set verifies."""
        return self.verify_signature_sets_async(sets).result()

    def verify_signature_sets_async(self, sets: Sequence[SignatureSet],
                                    deadline: Optional[float] = None) -> PendingVerdict:
        """Pack and enqueue without waiting for the device; the handle's
        ``result()`` is the only sync.  Batches above the largest bucket
        are verified in chunks of that size, every chunk enqueued before
        any verdict is read; when a chunk's pack or enqueue raises, the
        chunks already enqueued are read, so that each returns its slot.

        ``deadline`` (absolute ``time.monotonic()``, optional) is the
        tightest job deadline riding the batch: the pool sheds expired jobs
        before packing, so here it is informational, recorded in the
        journal and the in-flight table (``dispatch``)."""
        if not sets:
            raise ValueError("verify_signature_sets: empty batch of signature sets")
        self._check_open()
        largest = self.buckets[-1]
        if len(sets) > largest:
            parts = []
            try:
                for i in range(0, len(sets), largest):
                    parts.append(self.verify_signature_sets_async(sets[i : i + largest],
                                                                  deadline))
            except BaseException:
                for part in parts:
                    try:
                        part.result()
                    except Exception:  # noqa: BLE001 - the enqueue failure is raised  # lint: disable=bls-silent-except
                        pass
                raise
            return PendingVerdict(parts=parts, deadline=deadline)
        t0 = time.perf_counter()
        packed = self.pack(sets)
        self._add_stage("pack", time.perf_counter() - t0)
        if packed is None:
            return PendingVerdict(value=False, deadline=deadline)  # malformed bytes or infinity
        return self.dispatch(packed, deadline=deadline)

    def _sharded_size_ok(self, bucket: int) -> bool:
        return (self.sharded and self.n_executors >= 2 and bucket >= self.sharded_min_batch
                and bucket % len(self.devices) == 0)

    def sharded_eligible(self, bucket: int) -> bool:
        """A bucket rides the sharded tier: the tier is on over two
        executors or more, the bucket is at least ``sharded_min_batch`` and
        splits evenly over the shards, and
        the mesh is eligible as an executor is (a quarantined mesh sits
        out its backoff, then one idle probe batch decides)."""
        if not self._sharded_size_ok(bucket):
            return False
        now = time.monotonic()
        with self._sched_lock:
            return self._eligible_locked(self._mesh_ex, now)

    @property
    def sharded_active(self) -> bool:
        """The sharded tier can take a batch: the verifier is open and some
        bucket is of the tier's size.  The pool reads it, on every fill, to
        grow its merge cap to the mesh's bucket."""
        return self._mesh is not None and any(map(self._sharded_size_ok, self.buckets))

    @property
    def shard_enqueue_walls(self) -> List[float]:
        """Host seconds each shard took to enqueue its slice of the last
        sharded batch (empty when the tier is off or has not run)."""
        return list(self._mesh.enqueue_walls) if self._mesh is not None else []

    # -- placement -----------------------------------------------------------

    def _eligible_locked(self, ex: DeviceExecutor, now: float) -> bool:
        """Placement eligibility under ``_sched_lock``: healthy and suspect
        executors always; a quarantined one only once its backoff expired
        AND it is idle (the re-admission probe is ONE batch); a probing one
        only while idle."""
        h = ex.health
        if h.state in (HEALTHY, SUSPECT):
            return True
        if h.state == QUARANTINED:
            return now >= h.quarantined_until and ex.inflight == 0
        return ex.inflight == 0  # PROBING: one batch at a time

    @staticmethod
    def _maybe_probe_locked(ex: DeviceExecutor, now: float) -> bool:
        """QUARANTINED -> PROBING (the caller holds ``_sched_lock``), for
        the per-card placement and the mesh alike."""
        h = ex.health
        if h.state == QUARANTINED and now >= h.quarantined_until:
            h.state = PROBING
            h.changed_monotonic = now
            return True
        return False

    def _note_probe_transition(self, ex: DeviceExecutor) -> None:
        """The probe transition's journal event and health metric, written
        outside ``_sched_lock``."""
        JOURNAL.record("bls.health", device=ex.name, state=PROBING,
                       failures=ex.health.failures,
                       backoff_s=round(ex.health.backoff_s, 3))
        self._set_health_metric(ex)

    def _acquire_executor(self, exclude: Optional[DeviceExecutor] = None) -> DeviceExecutor:
        """Take a slot on the least loaded eligible executor, a rotating
        cursor breaking ties; quarantined executors are skipped until their
        backoff expires, then re-admitted by one probe batch.  ``exclude``
        keeps a requeue off the executor that just failed it.  When no
        executor is eligible, the one whose re-admission is soonest takes
        the batch: a sick pool keeps serving.  The pick and the in-flight
        increment happen under one lock."""
        now = time.monotonic()
        probing = False
        with self._sched_lock:
            k = len(self._executors)
            if k == 1:
                ex = self._executors[0]
            else:
                eligible = [e for e in self._executors
                            if e is not exclude and self._eligible_locked(e, now)]
                if not eligible:
                    rest = [e for e in self._executors if e is not exclude]
                    ex = min(rest or self._executors,
                             key=lambda e: e.health.quarantined_until)
                else:
                    start = self._rr
                    self._rr = (self._rr + 1) % k
                    n_el = len(eligible)
                    ex = min((eligible[(start + i) % n_el] for i in range(n_el)),
                             key=lambda e: e.inflight)
            probing = self._maybe_probe_locked(ex, now)
            ex.inflight += 1
            ex.placed = True
            inflight = ex.inflight
        if probing:
            self._note_probe_transition(ex)
        if self.metrics:
            self.metrics.bls_device_inflight.labels(device=ex.name).set(inflight)
        return ex

    def _acquire_mesh(self) -> DeviceExecutor:
        """The mesh pseudo-executor's slot: the same quarantine -> probe
        transition, no placement choice."""
        now = time.monotonic()
        with self._sched_lock:
            ex = self._mesh_ex
            probing = self._maybe_probe_locked(ex, now)
            ex.inflight += 1
            ex.placed = True
            inflight = ex.inflight
        if probing:
            self._note_probe_transition(ex)
        if self.metrics:
            self.metrics.bls_device_inflight.labels(device=ex.name).set(inflight)
        return ex

    def _release_executor(self, ex: DeviceExecutor) -> None:
        with self._sched_lock:
            ex.inflight -= 1
            inflight = ex.inflight
        if self.metrics:
            self.metrics.bls_device_inflight.labels(device=ex.name).set(inflight)

    # -- executor health -----------------------------------------------------

    def _set_health_metric(self, ex: DeviceExecutor) -> None:
        if self.metrics:
            self.metrics.bls_device_health.labels(device=ex.name).set(
                HEALTH_STATE_VALUES.get(ex.health.state, 0))

    def _record_executor_failure(self, ex: DeviceExecutor, error) -> None:
        """One failure on ``ex``: healthy -> suspect on the first,
        quarantined once ``quarantine_threshold`` consecutive failures
        accumulate; a failed probe re-quarantines with the backoff doubled
        (capped).  Entering quarantine writes one rate-limited bundle."""
        now = time.monotonic()
        quarantined = False
        with self._sched_lock:
            h = ex.health
            h.failures += 1
            h.last_error = f"{type(error).__name__}: {error}"[:200]
            if h.state == PROBING:
                # a failed probe: the card is still sick
                h.backoff_s = min(self.quarantine_backoff_max_s, h.backoff_s * 2)
                h.state = QUARANTINED
                h.quarantined_until = now + h.backoff_s
                h.quarantines += 1
                quarantined = True
            elif h.failures >= self.quarantine_threshold and h.state != QUARANTINED:
                h.state = QUARANTINED
                h.quarantined_until = now + h.backoff_s
                h.quarantines += 1
                quarantined = True
            elif h.state == HEALTHY:
                h.state = SUSPECT
            state, failures, backoff = h.state, h.failures, h.backoff_s
            h.changed_monotonic = now
        JOURNAL.record(
            "bls.health", level="WARNING" if quarantined else "INFO",
            device=ex.name, state=state, failures=failures,
            backoff_s=round(backoff, 3), error=str(error)[:200],
        )
        self._set_health_metric(ex)
        if quarantined:
            logger.warning("executor %s quarantined after %d failure(s); probe in %.2fs (%s)",
                           ex.name, failures, backoff, error)
            if self.metrics:
                self.metrics.bls_device_quarantines_total.labels(device=ex.name).inc()
            self._maybe_dump(
                f"quarantine-{ex.name}", metric_reason="quarantine",
                extra={"quarantine": {
                    "device": ex.name, "failures": failures,
                    "backoff_s": round(backoff, 3),
                    "error": str(error)[:300],
                    "health": self.executor_health(),
                }},
            )

    def _record_executor_success(self, ex: DeviceExecutor) -> None:
        """A verdict read on ``ex`` (True or False: the card did its job):
        the failure streak ends; a successful probe re-admits the executor
        with its backoff reset.  A QUARANTINED executor is not re-admitted
        here (the success is a batch placed before the quarantine, or a
        placement while the whole pool was sick): only the probe does."""
        if ex.health.state == HEALTHY:
            return  # the hot path: one attribute read, no lock
        with self._sched_lock:
            h = ex.health
            if h.state in (HEALTHY, QUARANTINED):
                return
            prev = h.state
            h.state = HEALTHY
            h.failures = 0
            h.backoff_s = self.quarantine_backoff_s
            h.quarantined_until = 0.0
            h.changed_monotonic = time.monotonic()
        JOURNAL.record("bls.health", device=ex.name, state=HEALTHY,
                       readmitted=prev in (PROBING, QUARANTINED))
        self._set_health_metric(ex)
        if prev in (PROBING, QUARANTINED):
            logger.info("executor %s re-admitted (probe verdict read)", ex.name)

    def _maybe_dump(self, reason: str, extra=None, metric_reason=None):
        """A best-effort diagnostic bundle, one per reason per
        ``_dump_cooldown_s``."""
        now = time.monotonic()
        with self._stats_lock:
            last = self._last_dump_by_reason.get(reason, -1e18)
            if now - last < self._dump_cooldown_s:
                return None
            self._last_dump_by_reason[reason] = now
        try:
            from ...forensics.recorder import RECORDER

            return RECORDER.dump(reason, extra=extra, metric_reason=metric_reason)
        except Exception as e:  # noqa: BLE001 - evidence is best-effort
            JOURNAL.record("bls.dump_failed", level="WARNING", reason=reason,
                           error=str(e)[:200])
            return None

    def _recover_failed_batch(self, pending: PendingVerdict, exc: Exception) -> bool:
        """A dispatched batch's sync raised: record the failure against its
        executor, then replay the SAME packed payload on another executor
        (``bls.requeue``: the pack is not paid again), walking further
        executors while its replay fails and one is left.  A requeue
        replays the card program on an executor: never on the CPU, never
        on the mesh.  With no executor left it raises: ``exc``, the
        batch's own failure."""
        ex = pending._executor
        self._record_executor_failure(ex, exc)
        cid = current_batch_id()
        packed, attempt = pending._packed, pending._attempt
        if packed is not None and self.n_executors > 1 and attempt + 1 < self.n_executors:
            with self._stats_lock:
                self.batches_requeued += 1
            if self.metrics:
                self.metrics.bls_batch_requeues_total.inc()
            t0_ns = TRACER.now()
            JOURNAL.record("bls.requeue", level="WARNING", cid=cid, from_device=ex.name,
                           attempt=attempt + 1, error=str(exc)[:200])
            try:
                replay = self.dispatch(packed, deadline=pending.deadline,
                                       _attempt=attempt + 1, _exclude=ex)
            except Exception as e2:
                JOURNAL.record("bls.requeue_failed", level="ERROR", cid=cid,
                               error=str(e2)[:200])
                raise
            if TRACER.enabled:
                TRACER.add_span("bls.requeue", "bls", t0_ns, cid=cid,
                                from_device=ex.name, to_device=replay.device)
            return replay.result()
        raise exc

    def _entry(self) -> Callable:
        """The per-card device program of this verifier's program and mode."""
        if self.host_final_exp:
            return miller_product_fused if self.fused else miller_product_kernel
        return verify_signature_sets_fused if self.fused else verify_signature_sets_kernel

    def _kernels(self, card, load_only: Optional[bool] = None) -> None:
        """The kernel library, before a program on ``card`` is made: from
        this process, the store, ``build/`` or nvcc (``_build.load``);
        with ``load_only`` the store or ``AotStoreMiss``.  The CPU runs
        the plain versions and needs none."""
        if card.type == "cuda":
            _build.load(store=self.aot_store,
                        load_only=self.load_only if load_only is None else load_only,
                        capability=capability_tag(card))

    @staticmethod
    def _note_capture(program, entry: str, bucket: int, device: str) -> None:
        """A program's graphs made on a card: its eager, capture and
        instantiation seconds into the compile ledger (on the CPU nothing
        is captured, and nothing is noted)."""
        if program.seconds:
            COMPILE_LEDGER.note("capture", sum(program.seconds.values()), entry=entry,
                                bucket=bucket, device=device,
                                **{f"{k}_s": v for k, v in program.seconds.items()})

    def _program(self, card, bucket: int, load_only: Optional[bool] = None) -> BucketProgram:
        """The card's program at ``bucket``, made (on a card: run once and
        captured) at first use, under the card's lock."""
        key = (card, bucket, self.fused, self.host_final_exp)
        program = self.programs.get(key)
        if program is None:
            self._kernels(card, load_only)
            lock = self._card_lock(card)
            with lock:
                program = self.programs.get(key)
                if program is None:
                    self._check_open()
                    pool = None
                    if card.type == "cuda":
                        pool = self._graph_pools.get(card)
                        if pool is None:
                            pool = self._graph_pools[card] = torch.cuda.graph_pool_handle()
                    program = BucketProgram(card, bucket, self._entry(), lock, pool)
                    self._note_capture(program, entry_name(self.fused, self.host_final_exp),
                                       bucket, str(card))
                    self.programs[key] = program
        return program

    def _card_lock(self, card) -> threading.Lock:
        with self._sched_lock:
            return self._card_locks.setdefault(card, threading.Lock())

    def _mesh_locks(self) -> List[threading.Lock]:
        """The locks of every card the mesh spans, in card-index order."""
        if self._mesh is None:
            return []
        cards = sorted(self._cards, key=lambda d: (d.type, -1 if d.index is None else d.index))
        return [self._card_lock(c) for c in cards]

    def _mesh_program_for(self, bucket: int, load_only: Optional[bool] = None) -> MeshProgram:
        """The sharded tier's program at ``bucket`` (key ("mesh", bucket,
        fused, host_final_exp)), made at first use (on a card: run once
        and captured, a graph per shard and one for the combine) under the
        locks of every card it spans."""
        key = ("mesh", bucket, self.fused, self.host_final_exp)
        program = self.mesh_programs.get(key)
        if program is None:
            for card in self._cards:
                self._kernels(card, load_only)
            with contextlib.ExitStack() as held:
                locks = self._mesh_locks()
                for lock in locks:
                    held.enter_context(lock)
                program = self.mesh_programs.get(key)
                if program is None:
                    self._check_open()
                    mesh = self._mesh
                    if mesh.cuda and self._mesh_pools is None:
                        # a pool per shard: logical shards replay at once
                        self._mesh_pools = [torch.cuda.graph_pool_handle() for _ in mesh.devices]
                    program = MeshProgram(mesh, bucket, self.fused, self.sharded_combine,
                                          not self.host_final_exp, locks, self._mesh_pools)
                    self._note_capture(program, mesh_entry_name(self.host_final_exp), bucket,
                                       self._mesh_ex.name)
                    self.mesh_programs[key] = program
        return program

    def _warmup_sharded_tier(self, buckets: Sequence[int], load_only: bool) -> int:
        """The mesh pass: the sharded tier's program for every bucket of
        ``buckets`` that rides it (the JAX verifier's ``_sharded_buckets``),
        each in a compile-ledger window under the mesh's label (``hit``
        when it was made already).  A failure raises: the port has no
        per-card tier to degrade the mesh to.  Returns the programs made
        or found."""
        if self._mesh is None:  # the tier is off, or one executor
            return 0
        warmed = 0
        entry, name = mesh_entry_name(self.host_final_exp), self._mesh_ex.name
        for b in buckets:
            if not self._sharded_size_ok(b):
                continue
            if CHAOS.armed and not load_only:
                CHAOS.maybe_raise("bls.compile", where="warmup", device=name, bucket=b,
                                  fused=self.fused, sharded=True)
            with COMPILE_LEDGER.attribute(entry, bucket=b, device=name):
                self._mesh_program_for(b, load_only)
            warmed += 1
        return warmed

    def warmup_sharded(self, buckets: Optional[Sequence[int]] = None,
                       load_only: Optional[bool] = None) -> float:
        """Make only the sharded tier's programs, one per eligible bucket
        of ``buckets`` (None: the verifier's), ledgered under the single
        ``mesh{n}`` label, as the JAX verifier's ``warmup_sharded``.
        Returns its wall seconds."""
        self._check_open()
        if load_only is None:
            load_only = self.load_only
        t0 = time.perf_counter()
        warmed = self._warmup_sharded_tier(
            tuple(self.buckets if buckets is None else buckets), load_only)
        dt = time.perf_counter() - t0
        JOURNAL.record("bls.warmup", seconds=round(dt, 3), sharded=True, mesh_programs=warmed,
                       devices=self.n_executors, load_only=load_only or None)
        return dt

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               load_only: Optional[bool] = None) -> float:
        """Make the active program's graph for every bucket of ``buckets``
        (None: the verifier's) on every card, then, as the JAX verifier
        does, the sharded tier's programs (``warmup_sharded``'s pass): the
        kernel library is loaded (or, unless ``load_only``, built), each
        program runs once and is captured.  ``load_only`` (None: the
        verifier's): a library the store cannot serve raises
        ``AotStoreMiss``.  Adds its wall seconds to
        ``stage_seconds["warmup"]`` and returns them.  On the CPU there is
        nothing to capture."""
        self._check_open()
        if load_only is None:
            load_only = self.load_only
        t0 = time.perf_counter()
        bucket_list = tuple(self.buckets if buckets is None else buckets)
        for bucket in bucket_list:
            for card in self._cards:
                if CHAOS.armed and not load_only:
                    CHAOS.maybe_raise("bls.compile", where="warmup", device=str(card),
                                      bucket=bucket, fused=self.fused)
                self._program(card, bucket, load_only)
        # the mesh's programs after the per-card ones, as in the JAX verifier
        self._warmup_sharded_tier(bucket_list, load_only)
        dt = time.perf_counter() - t0
        self._add_stage("warmup", dt)
        if TRACER.enabled:
            TRACER.instant("bls.warmup_done", cat="bls", seconds=round(dt, 3),
                           devices=self.n_executors)
        JOURNAL.record("bls.warmup", seconds=round(dt, 3), devices=self.n_executors,
                       fused=self.fused, load_only=load_only or None)
        return dt

    def warmup_async(self, buckets: Optional[Sequence[int]] = None) -> threading.Thread:
        """``warmup(buckets)`` on a daemon thread, which it returns: a node
        serves batches while the graphs are made (a batch whose graph is
        not made yet makes it first)."""
        t = threading.Thread(target=self.warmup, args=(buckets,), daemon=True,
                             name="torch-bls-warmup")
        t.start()
        return t

    def dispatch(self, packed, deadline: Optional[float] = None, _attempt: int = 0,
                 _exclude: Optional[DeviceExecutor] = None) -> PendingVerdict:
        """Enqueue one packed batch on the mesh or on the least loaded
        eligible executor (one replay of its card's program at the batch's
        bucket); returns at once with its ``PendingVerdict``.  The batch
        holds its in-flight slot and its entry in the in-flight table until
        the verdict's first ``result()`` ends.  An enqueue that raises
        frees the slot, is recorded against the executor (not the mesh's)
        and raises.  ``deadline``: the batch's tightest job deadline
        (``verify_signature_sets_async``).  ``_attempt`` / ``_exclude``:
        a requeue's generation and the executor that just failed it; a
        requeue never rides the mesh."""
        self._check_open()
        bucket = packed[0].shape[0]
        if _attempt == 0 and _exclude is None and self.sharded_eligible(bucket):
            return self._dispatch_mesh(packed, deadline)
        live = int(np.count_nonzero(packed[6]))
        with self._stats_lock:
            self.dispatches += 1
            self.sets_verified += live
        t0_ns = TRACER.now()
        ex = self._acquire_executor(exclude=_exclude)
        t_disp = time.perf_counter()
        try:
            # chaos seam: an injected failure where the program is enqueued
            if CHAOS.armed:
                CHAOS.maybe_raise("bls.compile", where="dispatch", device=ex.name,
                                  bucket=bucket, fused=self.fused)
            outs, ready = self._program(ex.device, bucket).run(packed)
        except BaseException as e:
            self._release_executor(ex)
            if isinstance(e, Exception):
                self._record_executor_failure(ex, e)
            raise
        if self.host_final_exp:
            f, ok = outs
            out = None
        else:
            (out,) = outs
            f = ok = None
        return self._enqueued(ex, packed, deadline, _attempt, t0_ns, t_disp, live,
                              dict(f=f, ok=ok, out=out, ready=ready))

    def _dispatch_mesh(self, packed, deadline: Optional[float]) -> PendingVerdict:
        """One batch over every shard of the sharded tier, on the mesh
        pseudo-executor's slot.  An enqueue failure frees the slot and
        raises, recorded nowhere (it is the tier's, not a card's); a sync
        failure is the mesh's, and the batch is requeued on one executor."""
        bucket = packed[0].shape[0]
        live = int(np.count_nonzero(packed[6]))
        t0_ns = TRACER.now()
        ex = self._acquire_mesh()
        t_disp = time.perf_counter()
        try:
            if CHAOS.armed:
                CHAOS.maybe_raise("bls.compile", where="dispatch", device=ex.name,
                                  bucket=bucket, fused=self.fused, sharded=True)
            outs, ready = self._mesh_program_for(bucket).run(packed)
            if self.host_final_exp:
                f, ok = outs
                out = None
            else:
                (out,) = outs
                f = ok = None
        except BaseException:
            self._release_executor(ex)
            raise
        with self._stats_lock:
            self.dispatches += 1
            self.sets_verified += live
            self.sharded_batches += 1
        if self.metrics:
            self.metrics.bls_sharded_batches_total.inc()
        return self._enqueued(ex, packed, deadline, 0, t0_ns, t_disp, live,
                              dict(f=f, ok=ok, out=out, ready=ready),
                              sharded=True, mesh_devices=len(self.devices))

    def _enqueued(self, ex: DeviceExecutor, packed, deadline, attempt: int, t0_ns: int,
                  t_disp: float, live: int, outputs: dict, **mesh) -> PendingVerdict:
        """An enqueued batch's records and its ``PendingVerdict``: the
        dispatch stage's seconds, the ``bls.dispatch`` span and journal
        event, the in-flight table entry (resolved by the exactly-once
        release that returns the slot), and the chaos draws of a lost or
        wedged card."""
        bucket = packed[0].shape[0]
        dt = time.perf_counter() - t_disp
        self._add_stage("dispatch", dt)
        if self.metrics:
            self.metrics.bls_verifier_stage_duration_seconds.labels(stage="dispatch").observe(dt)
        cid = current_batch_id()
        if TRACER.enabled:
            TRACER.add_span("bls.dispatch", "bls", t0_ns, cid=cid, bucket=bucket,
                            fused=self.fused, device=ex.name,
                            devices_total=self.n_executors, **mesh)
        # the deadline's headroom (seconds; negative: already expired) rides
        # the journal and the in-flight entry, so that a stall bundle says
        # whether the wedged work was still worth anything
        headroom = None if deadline is None else round(deadline - time.monotonic(), 3)
        if JOURNAL.enabled:
            JOURNAL.record("bls.dispatch", cid=cid, device=ex.name, bucket=bucket, sets=live,
                           fused=self.fused, inflight=ex.inflight,
                           devices_total=self.n_executors, deadline_headroom_s=headroom,
                           attempt=attempt or None, **mesh)
        token = INFLIGHT.register(cid=cid, device=ex.name, bucket=bucket, sets=live,
                                  deadline_s=headroom)

        def release():
            INFLIGHT.resolve(token)
            self._release_executor(ex)

        # chaos seams: an armed plan can lose this card mid-flight (the sync
        # raises) or wedge it (the sync blocks, then raises); drawn here,
        # per placement; disarmed, one attribute read
        fault = None
        if CHAOS.armed:
            fault = (CHAOS.fire("device.loss", device=ex.name, bucket=bucket, cid=cid)
                     or CHAOS.fire("device.wedge", device=ex.name, bucket=bucket, cid=cid))
        return PendingVerdict(verifier=self, release=release, device=ex.name,
                              deadline=deadline, packed=packed, executor=ex,
                              attempt=attempt, fault=fault, **outputs)

    def _host_final_exp_verdict(self, f, ok, ready=None) -> bool:
        """The split dispatch's host stage: wait for ``ready``, the event
        after the batch's copies to the host (the sync; on the CPU there is
        none), read ok first, then f's digits (the program's host copies), reduce
        each component mod p and run the C final exponentiation and is-one
        check.  The ``bls.final_exp`` span covers all of it, the sync
        included, as the JAX verifier's does."""
        t0 = time.perf_counter()
        t0_ns = TRACER.now()
        try:
            if ready is not None:
                ready.synchronize()
            live = bool(ok)
            t1 = time.perf_counter()
            self._add_stage("sync", t1 - t0)
            if not live:
                return False
            arr = f.detach().to("cpu").numpy()
            t2 = time.perf_counter()
            verdict = fastbls.final_exp_is_one(fq12_blob(arr))
            t3 = time.perf_counter()
            with self._stats_lock:
                self.stage_seconds["readback"] += t2 - t1
                self.stage_seconds["final_exp"] += t3 - t2
                self.host_final_exps += 1
            if self.metrics:
                self.metrics.bls_pool_final_exp_seconds.observe(t3 - t0)
                self.metrics.bls_verifier_stage_duration_seconds.labels(
                    stage="final_exp").observe(t3 - t0)
            return verdict
        finally:
            if TRACER.enabled:
                TRACER.add_span("bls.final_exp", "bls", t0_ns, cid=current_batch_id())

    def _coefficients(self, b: int) -> np.ndarray:
        """b fresh odd 64-bit RLC coefficients."""
        if self.rng is None:
            coeffs = np.frombuffer(secrets.token_bytes(8 * b), dtype=np.uint64)
        else:
            with self._rng_lock:  # a Generator is not safe across threads
                coeffs = self.rng.integers(0, np.iinfo(np.uint64).max, size=b,
                                           dtype=np.uint64, endpoint=True)
        return coeffs | np.uint64(1)

    def _bucket(self, n: int) -> int:
        """The smallest bucket that fits n sets (the largest above it)."""
        return next((b for b in self.buckets if n <= b), self.buckets[-1])

    def pack(self, sets: Sequence[SignatureSet]):
        """Host packing: the 7-tuple (pk_x, pk_y, sig_x, sig_y, msg_u, bits,
        mask) of numpy arrays padded to the bucket, or None when a set is
        malformed (bad bytes, a key or signature at infinity).

        Affine coordinates come from ``point_cache`` or, on a miss, from one
        batch inversion per coordinate family.  Signatures are decompressed
        without a subgroup check: the device does that check, batched.

        Counts, as the JAX verifier does: the point cache's hits and misses
        (each key and signature looked up, also in a batch that is then
        rejected), a rejected batch, and a packed batch's padding lanes."""
        cache_counts = [0, 0]  # hits, misses
        t0 = time.perf_counter()
        t0_ns = TRACER.now()
        try:
            packed = self._pack(sets, cache_counts)
        finally:
            hits, misses = cache_counts
            with self._stats_lock:
                self.pack_cache_hits += hits
                self.pack_cache_misses += misses
            if self.metrics:
                self.metrics.bls_verifier_stage_duration_seconds.labels(stage="pack").observe(
                    time.perf_counter() - t0)
                if hits:
                    self.metrics.bls_pack_cache_hits_total.inc(hits)
                if misses:
                    self.metrics.bls_pack_cache_misses_total.inc(misses)
            if TRACER.enabled:
                TRACER.add_span("bls.pack", "bls", t0_ns, cid=current_batch_id(),
                                sets=len(sets), cache_hits=hits)
        with self._stats_lock:
            if packed is None:
                self.pack_rejected += 1
            else:
                self.padding_wasted += packed[0].shape[0] - len(sets)
        if self.metrics:
            if packed is None:
                self.metrics.bls_pack_rejected_total.inc()
            else:
                self.metrics.bls_pool_pack_seconds.observe(time.perf_counter() - t0)
        return packed

    def _pack(self, sets: Sequence[SignatureSet], cache_counts: List[int]):
        n = len(sets)
        if n > self.buckets[-1]:
            raise ValueError(f"pack: {n} sets exceed the largest bucket {self.buckets[-1]}")
        b = self._bucket(n)
        cache = self.point_cache
        pk_vals: List[Optional[tuple]] = [None] * n
        sig_vals: List[Optional[tuple]] = [None] * n
        pk_miss: List[tuple] = []  # (index, jacobian point, cache key | None)
        sig_miss: List[tuple] = []
        msgs: List[bytes] = []
        for i, s in enumerate(sets):
            if isinstance(s, SingleSignatureSet):
                pk_key = s.pubkey._raw
                if pk_key is not None:
                    pk_key = b"P" + pk_key
            else:
                pk_key = b"A" + b"".join(m.to_bytes() for m in s.pubkeys)
            hit = cache.get(pk_key) if pk_key is not None else None
            cache_counts[hit is None] += 1
            if hit is not None:
                pk_vals[i] = hit
            else:
                pk = get_aggregated_pubkey(s)
                if pk.is_infinity():
                    return None
                pk_miss.append((i, pk.point, pk_key))
            raw = s.signature
            hit = cache.get(b"S" + raw)
            cache_counts[hit is None] += 1
            if hit is not None:
                sig_vals[i] = hit
            else:
                try:
                    sig_pt = g2_from_bytes(raw, subgroup_check=False)
                except ValueError:  # pack() counts the rejected batch  # lint: disable=bls-silent-except
                    return None
                if sig_pt.is_infinity():
                    return None
                sig_miss.append((i, sig_pt, b"S" + raw))
            msgs.append(s.signing_root)
        for missed, vals in ((pk_miss, pk_vals), (sig_miss, sig_vals)):
            aff = to_affine_batch([pt for _, pt, _ in missed])
            for (i, _pt, key), (x, y) in zip(missed, aff):
                if hasattr(x, "n"):  # Fq (G1 pubkey)
                    val = (x.n, y.n)
                else:  # Fq2 (G2 signature)
                    val = (x.c0, x.c1, y.c0, y.c1)
                vals[i] = val
                if key is not None:
                    cache.put(key, val)
        pk_limbs = fl.ints_to_limbs([c for v in pk_vals for c in v]).reshape(n, 2, fl.NLIMBS)
        sig_limbs = fl.ints_to_limbs([c for v in sig_vals for c in v]).reshape(n, 2, 2, fl.NLIMBS)
        pk_x = np.zeros((b, fl.NLIMBS), dtype=fl.NP_DTYPE)
        pk_y = np.zeros((b, fl.NLIMBS), dtype=fl.NP_DTYPE)
        sig_x = np.zeros((b, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
        sig_y = np.zeros((b, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
        pk_x[:n], pk_y[:n] = pk_limbs[:, 0], pk_limbs[:, 1]
        sig_x[:n], sig_y[:n] = sig_limbs[:, 0], sig_limbs[:, 1]
        # padding lanes copy lane 0 (valid coordinates keep the algebra
        # non-degenerate; the mask keeps them out of the verdict)
        if b > n:
            pk_x[n:], pk_y[n:] = pk_x[0], pk_y[0]
            sig_x[n:], sig_y[n:] = sig_x[0], sig_y[0]
            msgs += [b""] * (b - n)
        msg_u = hash_to_field_limbs(msgs)
        coeffs = self._coefficients(b)
        bits = (
            (coeffs[:, None] >> np.arange(64, dtype=np.uint64)[None, :]) & np.uint64(1)
        ).astype(fl.NP_DTYPE)
        mask = np.zeros(b, dtype=bool)
        mask[:n] = True
        return (pk_x, pk_y, sig_x, sig_y, msg_u, bits, mask)
