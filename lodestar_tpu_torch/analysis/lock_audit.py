"""The lock audit of the port: instrumented locks and a deterministic
interleaving harness over its BLS hot path.

The port of ``lodestar_tpu/analysis/lock_audit.py`` (its ``LockAuditor``,
``AuditLock`` and guarded containers are copied as they are).  The surface
is the port's: ``BlsBatchPool._flush`` fans pack, dispatch and result work
out to ``asyncio.to_thread`` workers, which mutate ``TorchBlsVerifier``'s
counters and ``stage_seconds`` (``_stats_lock``), its executors' in-flight
slots and health records (``_sched_lock``), its coefficient generator
(``_rng_lock``), the card programs and the mesh program (the card locks,
the mesh's taken in card-index order), the ``PointCache`` LRU (its lock),
the kernels' launch counters (``fused_core.LaunchCounter._lock``) and the
ring's peer table (``ring_gather._peer_lock``, taken only between cards).

Detection is deterministic: guarded state checks, at every write, that
the writing thread holds the owning lock, so the first unguarded write is
flagged on its first execution; the threads exist to drive every path and
to feed the lock-order recorder, which reports cycles (rules
``lock-unguarded-mutation`` and ``lock-order-inversion``).

``audit_bls_pipeline`` is the harness: a real ``TorchBlsVerifier`` over two
CPU executors and a 2-shard mesh (buckets 2 and 4, the mesh from 4) whose
programs do no arithmetic: the per-card program's entry and the mesh
program's eager run are stubs (a verdict of True and one counted launch),
so the card locks, the mesh's locks and the copies around them run as
they do for a real batch, as ``tests/test_torch_health.py``'s parity
harness stubs the programs.  A real ``BlsBatchPool``, real packing of
real signatures, worker threads with direct dispatch, a tiny switch
interval.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .report import Violation


# ---------------------------------------------------------------------------
# auditor core
# ---------------------------------------------------------------------------


class LockAuditor:
    """Violation sink + lock-order graph for one audit run."""

    def __init__(self):
        self.violations: List[Violation] = []
        self._edges: Dict[Tuple[str, str], str] = {}
        self._meta = threading.Lock()
        self._tls = threading.local()

    # -- held-lock stack (per thread) --------------------------------------

    def _stack(self) -> List["AuditLock"]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_acquire(self, lock: "AuditLock") -> None:
        st = self._stack()
        with self._meta:
            for held in st:
                if held is not lock:
                    self._edges.setdefault(
                        (held.name, lock.name),
                        f"{held.name} -> {lock.name} "
                        f"(thread {threading.current_thread().name})",
                    )
        st.append(lock)

    def on_release(self, lock: "AuditLock") -> None:
        st = self._stack()
        if lock in st:
            st.remove(lock)

    # -- findings ----------------------------------------------------------

    def record(self, rule: str, target: str, message: str) -> None:
        with self._meta:
            self.violations.append(
                Violation(rule, f"lock-audit:{target}", 0, message)
            )

    def unguarded(self, target: str, what: str, lock_name: str) -> None:
        self.record(
            "lock-unguarded-mutation",
            target,
            f"{what} mutated on thread "
            f"{threading.current_thread().name} without holding {lock_name}",
        )

    def lock_order_violations(self) -> List[Violation]:
        """Cycles in the acquisition graph = lock-order inversions."""
        with self._meta:
            edges = dict(self._edges)
        graph: Dict[str, List[str]] = collections.defaultdict(list)
        for a, b in edges:
            graph[a].append(b)
        out: List[Violation] = []
        seen_cycles = set()
        state: Dict[str, int] = {}  # 0 unvisited / 1 in-stack / 2 done

        def dfs(node: str, path: List[str]):
            state[node] = 1
            path.append(node)
            for nxt in graph.get(node, ()):
                if state.get(nxt, 0) == 1:
                    cycle = tuple(path[path.index(nxt):] + [nxt])
                    key = frozenset(cycle)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(
                            Violation(
                                "lock-order-inversion",
                                "lock-audit:" + cycle[0],
                                0,
                                "lock acquisition cycle "
                                + " -> ".join(cycle)
                                + " — two threads taking these in opposite "
                                "order deadlock",
                            )
                        )
                elif state.get(nxt, 0) == 0:
                    dfs(nxt, path)
            path.pop()
            state[node] = 2

        for node in list(graph):
            if state.get(node, 0) == 0:
                dfs(node, [])
        return out

    def all_violations(self) -> List[Violation]:
        return list(self.violations) + self.lock_order_violations()


class AuditLock:
    """Instrumented ``threading.Lock``: drop-in for guard checks and
    acquisition-order recording.  NOT reentrant (same as threading.Lock)."""

    def __init__(self, auditor: LockAuditor, name: str):
        self.auditor = auditor
        self.name = name
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self.auditor.on_acquire(self)
        return got

    def release(self) -> None:
        self._owner = None
        self.auditor.on_release(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> "AuditLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# ---------------------------------------------------------------------------
# guarded containers + attribute guards
# ---------------------------------------------------------------------------


class GuardedOrderedDict(collections.OrderedDict):
    """OrderedDict flagging any mutation (or LRU read-reorder) performed
    without the owning AuditLock held."""

    def __init__(self, auditor, lock, target, items=()):
        # populate BEFORE arming the guard: OrderedDict.__init__ routes
        # every pre-existing item through our __setitem__, and a warm
        # cache being instrumented must not read as unguarded mutation
        super().__init__(items)
        self._aud = (auditor, lock, target)

    def _check(self, what: str) -> None:
        aud = getattr(self, "_aud", None)
        if aud is None:
            return
        auditor, lock, target = aud
        if not lock.held_by_current_thread():
            auditor.unguarded(target, what, lock.name)

    def __setitem__(self, key, value):
        self._check("item set")
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check("item del")
        super().__delitem__(key)

    def get(self, key, default=None):
        self._check("LRU get")
        return super().get(key, default)

    def move_to_end(self, key, last=True):
        self._check("move_to_end")
        super().move_to_end(key, last)

    def popitem(self, last=True):
        self._check("popitem")
        return super().popitem(last)


class GuardedDict(dict):
    """dict flagging unguarded mutation (reads stay free: GIL-atomic)."""

    def __init__(self, auditor, lock, target, items=()):
        super().__init__(items)  # arm the guard only after pre-population
        self._aud = (auditor, lock, target)

    def __setitem__(self, key, value):
        aud = getattr(self, "_aud", None)
        if aud is not None:
            auditor, lock, target = aud
            if not lock.held_by_current_thread():
                auditor.unguarded(target, f"[{key!r}] set", lock.name)
        super().__setitem__(key, value)


# id(obj) -> (auditor, lock, target, guarded attr names); populated by the
# instrument_* helpers, consulted by the audited __setattr__ overrides
_ATTR_GUARDS: Dict[int, Tuple[LockAuditor, AuditLock, str, frozenset]] = {}


def _audited_setattr(obj, name: str, value) -> None:
    guard = _ATTR_GUARDS.get(id(obj))
    if guard is not None:
        auditor, lock, target, attrs = guard
        if name in attrs and not lock.held_by_current_thread():
            auditor.unguarded(target, f".{name} write", lock.name)


def _make_audited_class(base: type) -> type:
    """Subclass with a guard-checking __setattr__; __slots__ = () keeps the
    instance layout identical so live instances can be re-classed."""

    class Audited(base):
        __slots__ = ()

        def __setattr__(self, name, value):
            _audited_setattr(self, name, value)
            super().__setattr__(name, value)

    Audited.__name__ = f"Audited{base.__name__}"
    return Audited


# ---------------------------------------------------------------------------
# instrumentation of the port's hot-path objects
# ---------------------------------------------------------------------------

#: verifier counters the pool's worker threads write at once: every write
#: under ``TorchBlsVerifier._stats_lock`` (the JAX set without the three
#: fallback counters, which the port does not have: it raises instead)
VERIFIER_GUARDED_ATTRS = frozenset(
    {
        "dispatches",
        "sets_verified",
        "padding_wasted",
        "host_final_exps",
        "pack_rejected",
        "pack_cache_hits",
        "pack_cache_misses",
        "batches_requeued",
        "sharded_batches",
    }
)
#: an executor's slot accounting and its health record, under ``_sched_lock``
EXECUTOR_GUARDED_ATTRS = frozenset({"inflight", "placed"})
HEALTH_GUARDED_ATTRS = frozenset(
    {"state", "failures", "quarantines", "quarantined_until", "backoff_s", "last_error",
     "changed_monotonic"})
POINT_CACHE_GUARDED_ATTRS = frozenset({"hits", "misses"})
LAUNCH_GUARDED_ATTRS = frozenset({"launches"})


def instrument_point_cache(cache, auditor: LockAuditor, target: str = "PointCache"):
    from ..crypto.bls.verifier import PointCache

    lock = AuditLock(auditor, f"{target}._lock")
    cache._lock = lock
    cache._data = GuardedOrderedDict(auditor, lock, f"{target}._data", cache._data)
    cache.__class__ = _make_audited_class(PointCache)
    _ATTR_GUARDS[id(cache)] = (auditor, lock, target, POINT_CACHE_GUARDED_ATTRS)
    return cache


def instrument_verifier(verifier, auditor: LockAuditor, target: str = "TorchBlsVerifier"):
    """Swap the verifier's locks for AuditLocks (the card locks made now,
    named by card, in the order ``_card_lock`` would make them) and wrap
    every shared mutable surface: the counters and ``stage_seconds``, the
    executors' slots and health records (the mesh's too), and the pack's
    ``PointCache``."""
    from ..crypto.bls.torch_verifier import DeviceExecutor, ExecutorHealth, TorchBlsVerifier

    sched = AuditLock(auditor, f"{target}._sched_lock")
    stats = AuditLock(auditor, f"{target}._stats_lock")
    verifier._sched_lock = sched
    verifier._stats_lock = stats
    verifier._rng_lock = AuditLock(auditor, f"{target}._rng_lock")
    verifier._card_locks = {card: AuditLock(auditor, f"{target}.card[{card}]")
                            for card in verifier._cards}
    verifier.stage_seconds = GuardedDict(
        auditor, stats, f"{target}.stage_seconds", verifier.stage_seconds
    )
    audited_exec = _make_audited_class(DeviceExecutor)
    audited_health = _make_audited_class(ExecutorHealth)
    for ex in (*verifier._executors, verifier._mesh_ex):
        ex.__class__ = audited_exec
        _ATTR_GUARDS[id(ex)] = (auditor, sched, f"{target}.DeviceExecutor[{ex.name}]",
                                EXECUTOR_GUARDED_ATTRS)
        ex.health.__class__ = audited_health
        _ATTR_GUARDS[id(ex.health)] = (auditor, sched, f"{target}.ExecutorHealth[{ex.name}]",
                                       HEALTH_GUARDED_ATTRS)
    verifier.__class__ = _make_audited_class(TorchBlsVerifier)
    _ATTR_GUARDS[id(verifier)] = (auditor, stats, target, VERIFIER_GUARDED_ATTRS)
    instrument_point_cache(verifier.point_cache, auditor, f"{target}.point_cache")
    return verifier


@contextlib.contextmanager
def audited_process_state(auditor: LockAuditor):
    """The process-wide locks, instrumented for the block and restored
    after: every kernel's launch counter (its ``_lock`` and ``launches``)
    and the ring's ``_peer_lock``."""
    from ..ops import fused_core as fc
    from ..ops import ring_gather as rg

    saved = [(k, k.__class__, k._lock) for k in fc.COUNTED.values()]
    peer = rg._peer_lock
    classes: Dict[type, type] = {}
    try:
        for k, cls, _ in saved:
            k._lock = AuditLock(auditor, f"LaunchCounter[{k.name}]._lock")
            k.__class__ = classes.setdefault(cls, _make_audited_class(cls))
            _ATTR_GUARDS[id(k)] = (auditor, k._lock, f"LaunchCounter[{k.name}]",
                                   LAUNCH_GUARDED_ATTRS)
        rg._peer_lock = AuditLock(auditor, "ring_gather._peer_lock")
        yield
    finally:
        rg._peer_lock = peer
        for k, cls, lock in saved:
            _ATTR_GUARDS.pop(id(k), None)
            k.__class__ = cls
            k._lock = lock


def release_instrumentation(*objs) -> None:
    for obj in objs:
        _ATTR_GUARDS.pop(id(obj), None)


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def _make_sets(n: int, start: int = 0):
    from ..crypto.bls.api import interop_secret_key
    from ..crypto.bls.verifier import SingleSignatureSet

    out = []
    for i in range(start, start + n):
        sk = interop_secret_key(i % 64)
        msg = bytes([i % 256, (i // 256) % 256]) * 16
        out.append(
            SingleSignatureSet(
                pubkey=sk.to_public_key(),
                signing_root=msg,
                signature=sk.sign(msg).to_bytes(),
            )
        )
    return out


def _stub_entry(*inputs):
    """A card program's stand-in: one counted launch (as a replay adds its
    launches), the verdict True, no arithmetic."""
    from ..ops import fused_core as fc

    fc.K_FOLD.count_launch(inputs[0].shape[0])
    import torch

    return torch.tensor(True)


def _stub_verifier(point_cache_size: int = 64, mesh: bool = True):
    """A real TorchBlsVerifier (real pack, placement, programs, locks and
    counters) over two CPU executors and, with ``mesh``, a 2-shard mesh for
    bucket 4, whose programs' arithmetic is stubbed (``_stub_entry``)."""
    from ..crypto.bls.torch_verifier import TorchBlsVerifier

    v = TorchBlsVerifier(devices=["cpu", "cpu"], buckets=(2, 4), fused=False,
                         host_final_exp=False, sharded=mesh, sharded_min_batch=4,
                         point_cache_size=point_cache_size, rng=np.random.default_rng(0))
    v._entry = lambda: _stub_entry
    make_mesh_program = v._mesh_program_for

    def mesh_program_for(bucket, load_only=None):
        program = make_mesh_program(bucket, load_only)
        program._run_eager = lambda: _stub_entry(*program.inputs[0])
        return program

    v._mesh_program_for = mesh_program_for
    return v


def audit_bls_pipeline(
    jobs: int = 6,
    sets_per_job: int = 2,
    threads: int = 4,
    point_cache_size: int = 64,
    verifier_mutator=None,
    mesh: bool = True,
) -> List[Violation]:
    """Drive the instrumented BLS hot path end to end and return every
    lock-discipline violation observed.

    Two phases over ONE instrumented verifier, as the JAX audit's:

    1. The asyncio pool path: a real ``BlsBatchPool`` (pipeline_depth=2,
       flush_threshold=4) flushing concurrent jobs through ``to_thread``
       workers; merged batches of 3-4 sets ride the mesh, smaller ones the
       per-card programs.
    2. Barrier-synced worker threads doing direct pack / dispatch / result
       cycles (bucket 2, the two executors) plus PointCache put/get
       hammering, with a tiny interpreter switch interval.

    ``verifier_mutator`` (tests): called with the verifier after
    instrumentation, to strip a lock and prove the audit turns red.
    ``mesh=False``: no mesh (the JAX harness's shape: one tier)."""
    import asyncio
    import time

    from ..ops import fused_core as fc

    auditor = LockAuditor()
    v = _stub_verifier(point_cache_size, mesh)
    instrument_verifier(v, auditor)
    if verifier_mutator is not None:
        verifier_mutator(v)
    guard_ids = ([v, v.point_cache] + list(v._executors) + [v._mesh_ex]
                 + [ex.health for ex in (*v._executors, v._mesh_ex)])
    launches = fc.K_FOLD.launches

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with audited_process_state(auditor):
            # -- phase 1: the pool path (flush -> dispatch -> executor) ----
            from ..chain.bls_pool import BlsBatchPool

            async def pool_run():
                pool = BlsBatchPool(
                    v, pipeline_depth=2, flush_threshold=4, max_buffer_wait=0.001
                )
                results = await asyncio.gather(
                    *(
                        pool.verify_signature_sets(_make_sets(sets_per_job, i * 7))
                        for i in range(jobs)
                    )
                )
                pool.close()
                return results

            asyncio.run(pool_run())

            # -- phase 2: barrier-synced direct dispatch + cache hammer ----
            barrier = threading.Barrier(threads)
            errors: List[BaseException] = []

            def worker(wid: int):
                try:
                    sets = _make_sets(sets_per_job, 100 + wid * 3)
                    barrier.wait(timeout=30)
                    for rep in range(3):
                        pending = v.verify_signature_sets_async(sets)
                        for i in range(6):
                            key = b"K" + bytes([wid, rep, i % 2])
                            v.point_cache.put(key, (wid, rep))
                            v.point_cache.get(key)
                        pending.result()
                except BaseException as e:  # noqa: BLE001 - report, don't hang
                    errors.append(e)

            ts = [
                threading.Thread(target=worker, args=(i,), name=f"lock-audit-{i}")
                for i in range(threads)
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            if errors or any(t.is_alive() for t in ts):
                auditor.record(
                    "lock-audit-error", "harness",
                    f"worker raised: {errors[0]!r}" if errors else "a worker did not finish",
                )
            time.sleep(0)  # let released workers finish metric writes
    finally:
        sys.setswitchinterval(old_interval)
        release_instrumentation(*guard_ids)
        fc.K_FOLD.launches = launches
        v.close()

    # dedupe: one finding per (rule, target, first line of message class)
    seen = set()
    out: List[Violation] = []
    for viol in auditor.all_violations():
        key = (viol.rule, viol.path, viol.message.split(" on thread ")[0])
        if key in seen:
            continue
        seen.add(key)
        out.append(viol)
    return out
