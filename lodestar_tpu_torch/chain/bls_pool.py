"""BlsBatchPool: asynchronous accumulation of signature sets into merged
device dispatches (the port of ``lodestar_tpu/chain/bls_pool.py``).

Reference: BlsMultiThreadWorkerPool (chain/bls/multithread/index.ts:98).
One device program verifies a whole merged batch, so the pool's job is
temporal: merge concurrent small jobs (gossip validation pushes 1-3 sets
each, attestation.ts:138) into dispatch-sized batches.

- Buffer up to ``max_buffer_wait`` seconds or ``flush_threshold`` sets,
  then flush (MAX_BUFFER_WAIT_MS / MAX_BUFFERED_SIGS, multithread/index.ts:
  41-57).
- A failed merged batch is retried per job, so one bad gossip message
  cannot poison its batchmates (worker.ts:78-88).
- Pipelining: the flusher keeps up to ``pipeline_depth`` merged batches in
  flight per card (``verifier.n_devices``); while the verifier's sharded
  tier is active (``sharded_active``) a merged batch may hold
  ``flush_threshold`` sets per shard (``mesh_devices``).  Against a verifier with
  ``verify_signature_sets_async`` (``TorchBlsVerifier``), batch N+1 is
  packed and its device program enqueued on a worker thread while batch N
  computes and batch N-1's host final exponentiation runs; other verifiers
  get the same window through thread-pool concurrency.
- Scheduling under overload: priority lanes (``SignatureSetPriority``:
  the queue drains block proposals first); deadline shedding (a job past
  its ``time.monotonic()`` deadline is dropped before packing, its future
  resolved with ``VerificationDroppedError``, never a silent False);
  overflow eviction (``utils/queue``: the oldest job of the
  lowest lane goes); backpressure (``overloaded`` turns on at
  ``high_water`` pending sets and off at half of it).  Every drop is
  counted in ``dropped_sets`` by (reason, lane), in sets.

A merged batch carries its jobs' tightest deadline to
``verify_signature_sets_async(merged, deadline=...)`` when the verifier
takes one (``TorchBlsVerifier`` records it in its journal and in-flight
table).

Not ported: the pool's journal events and trace spans, the
profiler-window hook, the overload diagnostic bundle and the metrics.
What the JAX pool exported as trace spans and gauges the port keeps as
plain attributes: ``batch_retries``, ``inflight_peak`` and
``batch_spans``, the (pack start, verdict) host instants of recent
batches.
"""

from __future__ import annotations

import asyncio
import collections
import inspect
import logging
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..crypto.bls.verifier import (
    DEFAULT_PRIORITY,
    IBlsVerifier,
    SignatureSet,
    SignatureSetPriority,
    VerificationDroppedError,
)
from ..utils.queue import JobItemQueue, QueueError

logger = logging.getLogger(__name__)


def _lane_name(lane) -> str:
    return SignatureSetPriority(lane).name.lower()


class BlsBatchPool:
    """IBlsVerifier-compatible asynchronous facade over a device verifier."""

    def __init__(
        self,
        verifier: IBlsVerifier,
        *,
        max_buffer_wait: float = 0.02,
        flush_threshold: int = 128,
        max_queue_length: int = 8192,
        pipeline_depth: int = 2,
        high_water: Optional[int] = None,
    ):
        self.verifier = verifier
        self.max_buffer_wait = max_buffer_wait
        self.flush_threshold = flush_threshold
        self.pipeline_depth = max(1, pipeline_depth)
        self.batch_retries = 0
        self.inflight_peak = 0
        #: (pack start, verdict read) of the latest merged batches, host
        #: ``time.monotonic()`` seconds
        self.batch_spans: Deque[Tuple[float, float]] = collections.deque(maxlen=4096)
        # high-water in pending sets; hysteresis releases at half, so a
        # queue oscillating around the mark does not flap the signal
        self.high_water = high_water if high_water else max_queue_length // 2
        self.low_water = max(1, self.high_water // 2)
        self.overloaded = False
        #: dropped sets by (reason, lane name)
        self.dropped_sets: Dict[Tuple[str, str], int] = {}
        # the flusher is the queue's only consumer, through drain_batch;
        # size_fn=len: one job is a list of sets, pending_size counts sets
        self._queue: JobItemQueue[List[SignatureSet], bool] = JobItemQueue(
            max_length=max_queue_length, size_fn=len)
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._flush_task: Optional[asyncio.Task] = None
        self._flushing = False
        self._closed = False
        # the verifier's capabilities are fixed: probe once, not per flush.
        # The deadline goes only to an entry that takes one, as in the JAX
        # pool: a verifier without it (a test stub) keeps its signature
        self._use_async = hasattr(verifier, "verify_signature_sets_async")
        self._accepts_deadline = False
        if self._use_async:
            try:
                self._accepts_deadline = "deadline" in inspect.signature(
                    verifier.verify_signature_sets_async).parameters
            except (TypeError, ValueError):  # no signature to read
                self._accepts_deadline = False

    # -- public API (chain.bls.verifySignatureSets analog) -------------------

    async def verify_signature_sets(
        self,
        sets: Sequence[SignatureSet],
        batchable: bool = True,
        priority: Optional[SignatureSetPriority] = None,
        deadline: Optional[float] = None,
    ) -> bool:
        """Verify a job of sets; batchable jobs may wait up to
        ``max_buffer_wait`` to share a dispatch with concurrent jobs.

        ``priority`` selects the lane (default: the untagged lane).
        ``deadline`` is an absolute ``time.monotonic()`` instant; a job
        still buffered past it is shed with ``VerificationDroppedError``.
        An empty job raises."""
        if self._closed:
            raise RuntimeError("pool closed")
        sets = list(sets)
        if not sets:
            raise ValueError("verify_signature_sets: empty batch of signature sets")
        lane = DEFAULT_PRIORITY if priority is None else SignatureSetPriority(priority)
        if not batchable:
            return await asyncio.to_thread(self.verifier.verify_signature_sets, sets)
        loop = asyncio.get_running_loop()
        fut_result = loop.create_task(
            self._queue.push(sets, priority=int(lane), deadline=deadline)
        )
        # the push task enqueues on its first step; check the buffer after
        loop.call_soon(self._buffered_sets_changed)
        try:
            return await fut_result
        except QueueError as e:
            if e.code == "QUEUE_MAX_LENGTH":
                # this job was the overflow victim: evicted from the lowest
                # lane, or everything buffered outranked it
                self._count_drop("overflow", lane, len(sets))
                raise VerificationDroppedError("overflow", lane) from e
            if e.code == "QUEUE_ABORTED":
                # close() aborted the queue while this job was buffered
                self._count_drop("shutdown", lane, len(sets))
                raise VerificationDroppedError("shutdown", lane) from e
            raise

    def pending_sets(self) -> int:
        """Buffered signature sets (kept by the queue, O(1))."""
        return self._queue.pending_size

    def close(self) -> None:
        self._closed = True
        if self._flush_handle:
            self._flush_handle.cancel()
        self._queue.abort()

    def _count_drop(self, reason: str, lane, n_sets: int) -> None:
        key = (reason, _lane_name(lane))
        self.dropped_sets[key] = self.dropped_sets.get(key, 0) + n_sets

    # -- backpressure ----------------------------------------------------------

    def _update_backpressure(self) -> None:
        pending = self.pending_sets()
        if not self.overloaded and pending >= self.high_water:
            self.overloaded = True
            logger.warning("bls pool backpressure on: %d pending sets (high water %d)",
                           pending, self.high_water)
        elif self.overloaded and pending <= self.low_water:
            self.overloaded = False
            logger.info("bls pool backpressure off: %d pending sets (low water %d)",
                        pending, self.low_water)

    # -- flushing -------------------------------------------------------------

    def _flush_window(self) -> Tuple[int, int]:
        """(batches in flight at most, sets a merged batch at most):
        ``pipeline_depth`` batches per card, each near ``flush_threshold``.
        While the verifier's sharded tier is active the merge cap grows by
        its shard count (``mesh_devices``: the port's ``n_devices`` counts
        distinct cards, 1 for logical shards of one card), so that a storm
        fills mesh-wide batches; the window stays, so light traffic still
        drains into small batches for the per-card tier.  Read again on
        every fill: a tier that goes away drops the cap back."""
        n_dev = max(1, getattr(self.verifier, "n_devices", 1))
        max_size = max(self.flush_threshold, 1)
        if getattr(self.verifier, "sharded_active", False):
            max_size *= max(1, getattr(self.verifier, "mesh_devices", n_dev))
        return self.pipeline_depth * n_dev, max_size

    def _buffered_sets_changed(self) -> None:
        self._update_backpressure()
        if self.pending_sets() >= self.flush_threshold:
            self._schedule_flush(0.0)
        elif self._flush_handle is None:
            self._schedule_flush(self.max_buffer_wait)

    def _schedule_flush(self, delay: float) -> None:
        loop = asyncio.get_running_loop()
        if self._flush_handle is not None:
            self._flush_handle.cancel()
        self._flush_handle = loop.call_later(delay, self._spawn_flush)

    def _spawn_flush(self) -> None:
        self._flush_handle = None
        if not self._flushing:
            # a strong reference: the loop holds tasks weakly
            self._flush_task = asyncio.get_running_loop().create_task(self._flush())

    def _shed_expired(self, drained: List[Tuple]) -> List[Tuple]:
        """Drop drained jobs whose deadline passed, before any pack work is
        spent on them: each future gets ``VerificationDroppedError``; the
        live jobs are returned as (item, future, lane, deadline)."""
        now = time.monotonic()
        live: List[Tuple] = []
        for item, fut, lane, deadline in drained:
            if deadline is None or now <= deadline:
                live.append((item, fut, lane, deadline))
                continue
            lane_p = SignatureSetPriority(lane)
            self._count_drop("deadline", lane_p, len(item))
            if not fut.done():
                fut.set_exception(VerificationDroppedError("deadline", lane_p))
        return live

    async def _dispatch(self, merged: List[SignatureSet], deadline: Optional[float] = None):
        """Pack and enqueue one merged batch on a worker thread; returns the
        task that reads its verdict (on a worker thread too).  ``deadline``,
        the batch's tightest job deadline, rides along when the verifier
        takes one."""
        if self._use_async:
            # returns once the device program is enqueued, not finished
            kwargs = {"deadline": deadline} if self._accepts_deadline else {}
            pending = await asyncio.to_thread(self.verifier.verify_signature_sets_async,
                                              merged, **kwargs)
            return asyncio.create_task(asyncio.to_thread(pending.result))
        return asyncio.create_task(
            asyncio.to_thread(self.verifier.verify_signature_sets, merged))

    async def _flush(self) -> None:
        """Pipelined drain: keep up to ``pipeline_depth * n_devices`` merged
        batches in flight.  The fill half sheds expired jobs, then packs
        and enqueues the next batch while the drain half reads the oldest
        batch's verdict, so the host final exponentiation of batch N runs
        beside the device work of batch N+1.  Batches drain lane-ordered."""
        self._flushing = True
        inflight: collections.deque = collections.deque()
        try:
            while len(self._queue) or inflight:
                window, max_size = self._flush_window()
                # fill the window; max_size keeps each merged batch near
                # flush_threshold under a backlog, so that the block lane
                # rides the next batch (one oversized job still drains
                # alone and is chunked by the verifier)
                while len(self._queue) and len(inflight) < window:
                    drained = self._queue.drain_batch(max_items=1024, max_size=max_size)
                    if not drained:
                        break
                    drained = self._shed_expired(drained)
                    if not drained:
                        self._update_backpressure()
                        continue  # the whole drain was expired backlog
                    merged = [s for item, _fut, _lane, _dl in drained for s in item]
                    deadlines = [dl for _item, _fut, _lane, dl in drained if dl is not None]
                    self._update_backpressure()
                    t_fill = time.monotonic()  # a batch is busy from its pack
                    try:
                        verdict = await self._dispatch(merged,
                                                       min(deadlines) if deadlines else None)
                    except Exception as e:  # noqa: BLE001 - the jobs are retried one by one
                        # a pack or enqueue failure must not strand the
                        # drained jobs: a failed verdict sends them through
                        # the per-job retry below
                        logger.warning("dispatch enqueue failed: %s; will retry per job", e)
                        verdict = asyncio.get_running_loop().create_future()
                        verdict.set_result(False)
                    inflight.append((drained, verdict, t_fill))
                    self.inflight_peak = max(self.inflight_peak, len(inflight))
                if not inflight:
                    return
                # drain the oldest batch
                jobs, verdict, t_fill = inflight.popleft()
                try:
                    ok = await verdict
                except Exception as e:  # noqa: BLE001 - the jobs are retried one by one
                    logger.warning("merged dispatch raised: %s; retrying per job", e)
                    ok = False
                self.batch_spans.append((t_fill, time.monotonic()))
                if ok:
                    for item, fut, lane, _dl in jobs:
                        if not fut.done():  # a cancelled pusher gets nothing
                            fut.set_result(True)
                    continue
                # the merged batch failed: verify each job on its own, so
                # that innocent jobs still pass (worker.ts:78-88)
                self.batch_retries += 1
                logger.debug("merged batch of %d jobs failed; retrying individually", len(jobs))
                for item, fut, lane, _dl in jobs:
                    if fut.done():
                        continue
                    if self._closed:
                        # shutdown mid-retry: resolve, typed, never strand
                        lane_p = SignatureSetPriority(lane)
                        self._count_drop("shutdown", lane_p, len(item))
                        fut.set_exception(VerificationDroppedError("shutdown", lane_p))
                        continue
                    try:
                        one = await asyncio.to_thread(self.verifier.verify_signature_sets, item)
                    except Exception as e:  # noqa: BLE001 - handed to the job's caller
                        if not fut.done():
                            fut.set_exception(e)
                        continue
                    if not fut.done():  # the pusher may have been cancelled meanwhile
                        fut.set_result(one)
        finally:
            self._flushing = False
            self._update_backpressure()
            if len(self._queue):
                self._buffered_sets_changed()
