"""TorchBlsVerifier: batched BLS signature-set verification on CUDA cards.

The port's verifier boundary (``verify_signature_sets(sets) -> bool``, and
``verify_signature_sets_async(sets) -> PendingVerdict`` for the scheduling
layer, ``chain/bls_pool``).  The host packs a batch into digit arrays
padded to the smallest bucket of ``buckets`` that fits it (``pack``; a
batch above the largest is verified in chunks of that size), and the
device runs one of two programs:

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
``warmup(buckets)`` / ``warmup_async``, and replayed for every batch.  The
outputs are copied to pinned host memory behind the replay and an event
is recorded after the copies; waiting on that event is the sync, so that
a verdict does not wait for batches enqueued after it on the same stream.
The card's graphs share one memory pool and one lock.

With ``devices=[...]`` (a card may repeat: logical shards) and
``sharded=True`` (or ``LODESTAR_TPU_SHARDED`` on: the tier is opt-in, as
the JAX verifier's is off a TPU pool) the verifier has two tiers, as the
JAX verifier's pool does: a batch whose bucket is at least
``sharded_min_batch`` and divisible by the shard count rides the sharded
tier (``ops/sharded_verify``, one batch split over every shard);
any other batch runs whole on one card, the least loaded (batches in
flight), round-robin among equals.  A failed launch or sync raises; there
is no other path or tier to fall back to, and no batch is requeued.
``sharded_active`` tells the pool that the tier can take a batch, so that
it merges batches up to the mesh's bucket.

``close()`` releases what the verifier holds (the per-bucket graphs and
their pools, the sharded tier's program and its streams, the point
cache); a verify after it raises.  The kernel
libraries stay loaded: every verifier in the process shares them.
"""

from __future__ import annotations

import os
import secrets
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import resolve_device
from ...native import fastbls
from ...ops import limbs as fl
from ...ops.batch_verify import miller_product_kernel, verify_signature_sets_kernel
from ...ops.fused_core import LV
from ...ops.fused_verify import miller_product_fused, verify_signature_sets_fused
from ...ops.htc import hash_to_field_limbs
from ...ops.sharded_verify import miller_product_sharded, verify_signature_sets_sharded
from .bucket_program import BucketProgram
from .curve import g2_from_bytes, to_affine_batch
from .verifier import PointCache, SignatureSet, SingleSignatureSet, get_aggregated_pubkey

# Padding buckets: the smallest that fits the batch is used.  128 is the
# node's MAX_SIGNATURE_SETS_PER_JOB; larger buckets amortize sync batches.
DEFAULT_BUCKETS = (4, 16, 64, 128, 256)
#: the in-flight key of the sharded tier's batches (one program over the mesh)
MESH = "mesh"


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


def _stage_readback(f, ok):
    """The sharded tier's (f's digits, ok, event): on a card, ok and f's
    digits (an LV's loose digits on the fused program) are copied to
    pinned host memory on the stream that made them, and the event is
    recorded after the copies; on the CPU they are returned as they are,
    with no event."""
    digits = f.a if isinstance(f, LV) else f
    if digits.device.type != "cuda":
        return digits, ok, None
    host = []
    for t in (digits, ok):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(digits.device))
    return host[0], host[1], ready


class PendingVerdict:
    """A dispatched batch whose verdict has not been read back.

    Construction never blocks: the device work is enqueued, and
    ``result()`` is the only synchronisation (the device readback and, on
    the split path, the host final exponentiation).  ``result()`` is
    idempotent: the verdict, or the failure, is kept and given again.
    ``release``, the verifier's in-flight slot, is returned exactly once,
    when the first ``result()`` ends, whether it returns or raises."""

    __slots__ = ("_verifier", "_f", "_ok", "_ready", "_out", "_value", "_parts",
                 "_release", "_exc", "device")

    def __init__(self, verifier=None, f=None, ok=None, ready=None, out=None, value=None,
                 parts=None, release: Optional[Callable[[], None]] = None,
                 device: Optional[str] = None):
        self._verifier = verifier
        self._f = f
        self._ok = ok
        self._ready = ready
        self._out = out
        self._value = value
        self._parts = parts
        self._release = release
        self._exc: Optional[Exception] = None
        #: where the batch runs: a card, ``MESH``, or None (chunked)
        self.device = device

    def _release_once(self) -> None:
        release, self._release = self._release, None
        if release is not None:
            release()

    def _compute(self) -> bool:
        if self._parts is not None:
            # read every chunk, so that each returns its slot, then report
            results, error = [], None
            for part in self._parts:
                try:
                    results.append(part.result())
                except Exception as e:  # noqa: BLE001 - re-raised below
                    error = error or e
            if error is not None:
                raise error
            return all(results)
        if self._f is not None:
            return self._verifier._host_final_exp_verdict(self._f, self._ok, self._ready)
        if self._ready is not None:
            self._ready.synchronize()
        return bool(self._out)

    def result(self) -> bool:
        if self._value is not None:
            return self._value
        if self._exc is not None:
            raise self._exc
        try:
            self._value = self._compute()
            return self._value
        except Exception as e:
            self._exc = e
            raise
        finally:
            self._release_once()


class TorchBlsVerifier:
    """Verifies signature sets on ``device`` (the card unless the caller
    asks for ``"cpu"``, which runs the kernels' plain versions), or on the
    shards of ``devices``.

    ``fused``: the fused program (True) or the XLA-graph program (False).
    ``host_final_exp``: the split dispatch, the final exponentiation on the
    host (True, the default), or the whole verification on the device.
    ``rng``: a ``numpy.random.Generator`` for the RLC coefficients, for
    reproducible runs; None (the default) draws them from ``secrets``.
    ``devices``: the shards of the sharded tier, in mesh order (None: the
    single ``device``).  ``sharded``: the tier on or off (None:
    ``sharded_default``, off unless ``LODESTAR_TPU_SHARDED`` says on).
    ``sharded_min_batch``: the smallest bucket the tier takes (None: the
    largest bucket).
    ``sharded_combine``: ``"all_gather"`` or ``"ring"``.
    ``buckets``: the padding buckets (the smallest that fits a batch is
    used; a batch above the largest is chunked at it).
    ``point_cache_size``: the entries of the pack's point cache.

    Several host threads may pack and dispatch at once (the pool keeps
    batches in flight from worker threads): the coefficient draws, the
    placement, the programs and the counters take locks."""

    def __init__(self, device="cuda", rng: Optional[np.random.Generator] = None,
                 fused: bool = True, devices: Optional[Sequence] = None,
                 sharded: Optional[bool] = None, sharded_min_batch: Optional[int] = None,
                 sharded_combine: str = "all_gather", host_final_exp: bool = True,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, point_cache_size: int = 8192):
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
        self.device = self.devices[0]
        self.sharded = sharded_default(len(self.devices)) if sharded is None else bool(sharded)
        self.sharded_min_batch = (self.buckets[-1] if sharded_min_batch is None
                                  else sharded_min_batch)
        entry = miller_product_sharded if host_final_exp else verify_signature_sets_sharded
        self._mesh_program = entry(self.devices, fused, sharded_combine) if self.sharded else None
        #: the shard count of the sharded tier (0 when it is off)
        self.mesh_devices = len(self.devices) if self.sharded else 0
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
        #: host seconds, summed over batches: packing, enqueueing the device
        #: program (and, split, the copies of ok and f to the host), the
        #: sync (on the event after those copies, or on the verdict), the
        #: read of f's host copy and the C final exponentiation; and
        #: ``warmup``'s
        self.stage_seconds: Dict[str, float] = dict.fromkeys(
            ("pack", "dispatch", "sync", "readback", "final_exp", "warmup"), 0.0)
        # the per-card tier: the distinct cards of ``devices``, in order
        self._cards = list(dict.fromkeys(self.devices))
        self._next_card = 0  # the round-robin tie-break cursor
        self._inflight: Dict[object, int] = {}
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
        have finished the batches in flight), the sharded tier's program
        (its streams) and the point cache; a verify or dispatch after this
        raises.  Verdicts already dispatched can still be read.  The kernel
        libraries stay loaded: every verifier in the process shares them."""
        self._closed = True
        for card, lock in list(self._card_locks.items()):
            with lock:
                if card.type == "cuda" and card in self._graph_pools:
                    torch.cuda.synchronize(card)
                for key in [k for k in self.programs if k[0] == card]:
                    del self.programs[key]
                self._graph_pools.pop(card, None)
        self._mesh_program = None
        self.point_cache.clear()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("TorchBlsVerifier: closed")

    @property
    def n_devices(self) -> int:
        """The distinct cards batches are placed on."""
        return len(self._cards)

    def device_inflight(self) -> Dict[str, int]:
        """Batches in flight per card (and on the mesh), a snapshot."""
        with self._sched_lock:
            return {str(k): n for k, n in self._inflight.items()}

    def _add_stage(self, stage: str, seconds: float) -> None:
        with self._stats_lock:
            self.stage_seconds[stage] += seconds

    def verify_signature_sets(self, sets: Sequence[SignatureSet]) -> bool:
        """True iff every set verifies."""
        return self.verify_signature_sets_async(sets).result()

    def verify_signature_sets_async(self, sets: Sequence[SignatureSet]) -> PendingVerdict:
        """Pack and enqueue without waiting for the device; the handle's
        ``result()`` is the only sync.  Batches above the largest bucket
        are verified in chunks of that size, every chunk enqueued before
        any verdict is read; when a chunk's pack or enqueue raises, the
        chunks already enqueued are read, so that each returns its slot."""
        if not sets:
            raise ValueError("verify_signature_sets: empty batch of signature sets")
        self._check_open()
        largest = self.buckets[-1]
        if len(sets) > largest:
            parts = []
            try:
                for i in range(0, len(sets), largest):
                    parts.append(self.verify_signature_sets_async(sets[i : i + largest]))
            except BaseException:
                for part in parts:
                    try:
                        part.result()
                    except Exception:  # noqa: BLE001 - the enqueue failure is raised
                        pass
                raise
            return PendingVerdict(parts=parts)
        t0 = time.perf_counter()
        packed = self.pack(sets)
        self._add_stage("pack", time.perf_counter() - t0)
        if packed is None:
            return PendingVerdict(value=False)  # malformed bytes or infinity
        return self.dispatch(packed)

    def sharded_eligible(self, bucket: int) -> bool:
        """A bucket rides the sharded tier: the tier is on, the bucket is at
        least ``sharded_min_batch`` and splits evenly over the shards."""
        return (self.sharded and bucket >= self.sharded_min_batch
                and bucket % len(self.devices) == 0)

    @property
    def sharded_active(self) -> bool:
        """The sharded tier can take a batch: the verifier is open and some
        bucket is eligible.  The pool reads it, on every fill, to grow its
        merge cap to the mesh's bucket."""
        return self._mesh_program is not None and any(map(self.sharded_eligible, self.buckets))

    @property
    def shard_enqueue_walls(self) -> List[float]:
        """Host seconds each shard took to enqueue its slice of the last
        sharded batch (empty when the tier is off or has not run)."""
        return list(self._mesh_program.mesh.enqueue_walls) if self._mesh_program else []

    def _acquire(self, key=None):
        """Take an in-flight slot: on ``key`` (the mesh), or on the least
        loaded card, the rotating cursor breaking ties.  Returns the key."""
        with self._sched_lock:
            if key is None:
                k = len(self._cards)
                start = self._next_card % k
                self._next_card += 1
                key = min((self._cards[(start + i) % k] for i in range(k)),
                          key=lambda d: self._inflight.get(d, 0))
            self._inflight[key] = self._inflight.get(key, 0) + 1
        return key

    def _release(self, key) -> None:
        with self._sched_lock:
            self._inflight[key] -= 1

    def _entry(self) -> Callable:
        """The per-card device program of this verifier's program and mode."""
        if self.host_final_exp:
            return miller_product_fused if self.fused else miller_product_kernel
        return verify_signature_sets_fused if self.fused else verify_signature_sets_kernel

    def _program(self, card, bucket: int) -> BucketProgram:
        """The card's program at ``bucket``, made (on a card: run once and
        captured) at first use, under the card's lock."""
        key = (card, bucket, self.fused, self.host_final_exp)
        program = self.programs.get(key)
        if program is None:
            lock = self._card_locks.setdefault(card, threading.Lock())
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
                    self.programs[key] = program
        return program

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> float:
        """Make the active program's graph for every bucket of ``buckets``
        (None: the verifier's) on every card: the kernel library is built,
        each program runs once and is captured.  Adds its wall seconds to
        ``stage_seconds["warmup"]`` and returns them.  On the CPU there is
        nothing to capture."""
        self._check_open()
        t0 = time.perf_counter()
        for bucket in (self.buckets if buckets is None else buckets):
            for card in self._cards:
                self._program(card, bucket)
        dt = time.perf_counter() - t0
        self._add_stage("warmup", dt)
        return dt

    def warmup_async(self, buckets: Optional[Sequence[int]] = None) -> threading.Thread:
        """``warmup(buckets)`` on a daemon thread, which it returns: a node
        serves batches while the graphs are made (a batch whose graph is
        not made yet makes it first)."""
        t = threading.Thread(target=self.warmup, args=(buckets,), daemon=True,
                             name="torch-bls-warmup")
        t.start()
        return t

    def dispatch(self, packed) -> PendingVerdict:
        """Enqueue one packed batch on the mesh or on the least loaded card
        (one replay of the card's program at the batch's bucket); returns
        at once with its ``PendingVerdict``.  The batch holds its in-flight
        slot until the verdict's first ``result()`` ends."""
        self._check_open()
        t0 = time.perf_counter()
        bucket = packed[0].shape[0]
        mesh = self.sharded_eligible(bucket)
        live = int(np.count_nonzero(packed[6]))
        with self._stats_lock:
            self.dispatches += 1
            self.sets_verified += live
        key = self._acquire(MESH if mesh else None)
        try:
            if mesh:
                with self._stats_lock:
                    self.sharded_batches += 1
                out = self._mesh_program(*packed)
                if self.host_final_exp:
                    f, ok, ready = _stage_readback(*out)
                else:
                    ready = None
            else:
                outs, ready = self._program(key, bucket).run(packed)
                if self.host_final_exp:
                    f, ok = outs
                else:
                    (out,) = outs
        except BaseException:
            self._release(key)
            raise
        self._add_stage("dispatch", time.perf_counter() - t0)
        common = dict(verifier=self, ready=ready, release=lambda: self._release(key),
                      device=str(key))
        if self.host_final_exp:
            return PendingVerdict(f=f, ok=ok, **common)
        return PendingVerdict(out=out, **common)

    def _host_final_exp_verdict(self, f, ok, ready=None) -> bool:
        """The split dispatch's host stage: wait for ``ready``, the event
        after the batch's copies to the host (the sync; on the CPU there is
        none), read ok first, then f's digits (``_stage_readback``), reduce
        each component mod p and run the C final exponentiation and is-one
        check."""
        t0 = time.perf_counter()
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
        return verdict

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
        try:
            packed = self._pack(sets, cache_counts)
        finally:
            with self._stats_lock:
                self.pack_cache_hits += cache_counts[0]
                self.pack_cache_misses += cache_counts[1]
        with self._stats_lock:
            if packed is None:
                self.pack_rejected += 1
            else:
                self.padding_wasted += packed[0].shape[0] - len(sets)
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
                except ValueError:
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
