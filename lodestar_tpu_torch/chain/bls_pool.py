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
  counted in ``dropped_sets`` by (reason, lane), in sets, in
  ``bls_pool_dropped_total{reason,lane}`` and in the journal, and a
  shed-rate spike across ``overload_shed_threshold`` sets within
  ``overload_window_s`` writes one rate-limited "overload" diagnostic
  bundle with per-lane shed counts and the queue depth at the trigger.

A merged batch carries its jobs' tightest deadline to
``verify_signature_sets_async(merged, deadline=...)`` when the verifier
takes one (``TorchBlsVerifier`` records it in its journal and in-flight
table).

Observability, as in the JAX pool: each merged batch gets a correlation
id (``tracing.set_batch``) that the verifier's ``bls.pack``,
``bls.dispatch`` and ``bls.final_exp`` spans carry; the pool records
``bls.queue_wait`` per job, ``bls.shed`` per shed job and ``pool.batch``
per batch when ``tracing.TRACER`` is on, journals ``pool.flush``,
``pool.shed``, ``pool.drop``, ``pool.backpressure`` and
``pool.overload``, and reports the JAX pool's metrics to ``metrics``.
Every flush ends at the profile window's flush boundary
(``observatory.xprof.notify_flush``).  The port also keeps
``batch_spans``, the (pack start, verdict) host instants of recent
batches, beside ``batch_retries`` and ``inflight_peak``.
"""

from __future__ import annotations

import asyncio
import collections
import inspect
import logging
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .. import tracing
from ..crypto.bls.verifier import (
    DEFAULT_PRIORITY,
    IBlsVerifier,
    SignatureSet,
    SignatureSetPriority,
    VerificationDroppedError,
)
from ..forensics.journal import JOURNAL
from ..observatory.xprof import notify_flush as _xprof_notify_flush
from ..tracing import TRACER
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
        overload_shed_threshold: int = 256,
        overload_window_s: float = 10.0,
        overload_cooldown_s: float = 60.0,
        metrics=None,
    ):
        self.verifier = verifier
        self.max_buffer_wait = max_buffer_wait
        self.flush_threshold = flush_threshold
        self.pipeline_depth = max(1, pipeline_depth)
        self.metrics = metrics
        # a stage-split verifier observes its pack / final-exp histograms
        # on the same registry
        if metrics is not None and getattr(verifier, "metrics", "no") is None:
            verifier.metrics = metrics
        self.batch_retries = 0
        self.batch_sets_success = 0
        self.inflight_peak = 0
        self._next_batch_id = 0  # the correlation id of a batch's spans
        #: (pack start, verdict read) of the latest merged batches, host
        #: ``time.monotonic()`` seconds
        self.batch_spans: Deque[Tuple[float, float]] = collections.deque(maxlen=4096)
        # high-water in pending sets; hysteresis releases at half, so a
        # queue oscillating around the mark does not flap the signal
        self.high_water = high_water if high_water else max_queue_length // 2
        self.low_water = max(1, self.high_water // 2)
        self.overloaded = False
        self.overload_shed_threshold = overload_shed_threshold
        self.overload_window_s = overload_window_s
        self.overload_cooldown_s = overload_cooldown_s
        self._last_overload_bundle = -1e18
        self._shed_window: Deque[Tuple[float, int]] = collections.deque()
        self._shed_window_sum = 0  # running sum: O(1) per drop
        self._overload_task: Optional[asyncio.Task] = None
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
            except (TypeError, ValueError):  # no signature to read  # lint: disable=bls-silent-except
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
        """One bookkeeping seam for EVERY shed/evicted/shutdown set: the
        metric, the journal, ``dropped_sets``, and the overload-bundle rate
        window."""
        name = _lane_name(lane)
        key = (reason, name)
        self.dropped_sets[key] = self.dropped_sets.get(key, 0) + n_sets
        if self.metrics:
            self.metrics.bls_pool_dropped_total.labels(
                reason=reason, lane=name
            ).inc(n_sets)
        # every drop leaves journal evidence: deadline sheds are batched
        # into one pool.shed event by _shed_expired; the push-time reasons
        # (overflow eviction, shutdown) are recorded here per drop
        if reason != "deadline" and JOURNAL.enabled:
            JOURNAL.record("pool.drop", reason=reason, lane=name, sets=n_sets)
        if not self.overload_shed_threshold:
            return  # bundles disabled: don't grow the rate window either
        now = time.monotonic()
        self._shed_window.append((now, n_sets))
        self._shed_window_sum += n_sets
        self._maybe_overload_bundle(now)

    def _maybe_overload_bundle(self, now: float) -> None:
        """Cross the shed-rate threshold -> ONE diagnostic bundle (rate
        limited by ``overload_cooldown_s``) so a storm leaves triageable
        evidence: per-lane shed counts and the queue depth at trigger."""
        if not self.overload_shed_threshold:
            return
        window = self._shed_window
        while window and now - window[0][0] > self.overload_window_s:
            self._shed_window_sum -= window.popleft()[1]
        shed = self._shed_window_sum
        if shed < self.overload_shed_threshold:
            return
        if now - self._last_overload_bundle < self.overload_cooldown_s:
            return
        if self._overload_task is not None and not self._overload_task.done():
            return  # one dump at a time, whatever the cooldown says
        self._last_overload_bundle = now
        extra = {
            "overload": {
                "shed_window_sets": shed,
                "window_s": self.overload_window_s,
                "dropped_by_lane": self._dropped_by("lane"),
                "dropped_by_reason": self._dropped_by("reason"),
                "queue_depth_jobs": len(self._queue),
                "pending_sets": self.pending_sets(),
                "backpressure": self.overloaded,
            }
        }
        JOURNAL.record(
            "pool.overload", level="ERROR", shed_window_sets=shed,
            pending_sets=self.pending_sets(),
        )

        def _dump() -> None:
            from ..forensics.recorder import RECORDER

            try:
                RECORDER.dump("overload", extra=extra, metric_reason="overload")
            except Exception:  # a broken dump path must never hit the flusher
                logger.exception("overload bundle failed")

        # bundle writing is file I/O: keep it off the event loop; strong
        # ref so the task survives (the loop holds tasks weakly)
        self._overload_task = asyncio.get_running_loop().create_task(
            asyncio.to_thread(_dump)
        )

    def _dropped_by(self, axis: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (reason, lane), n in self.dropped_sets.items():
            k = reason if axis == "reason" else lane
            out[k] = out.get(k, 0) + n
        return out

    # -- backpressure ----------------------------------------------------------

    def _update_backpressure(self) -> None:
        pending = self.pending_sets()
        if not self.overloaded and pending >= self.high_water:
            self.overloaded = True
            if self.metrics:
                self.metrics.bls_pool_backpressure.set(1)
            JOURNAL.record(
                "pool.backpressure", level="WARNING", on=True,
                pending_sets=pending, high_water=self.high_water,
            )
            logger.warning("bls pool backpressure on: %d pending sets (high water %d)",
                           pending, self.high_water)
        elif self.overloaded and pending <= self.low_water:
            self.overloaded = False
            if self.metrics:
                self.metrics.bls_pool_backpressure.set(0)
            JOURNAL.record(
                "pool.backpressure", on=False, pending_sets=pending,
                low_water=self.low_water,
            )
            logger.info("bls pool backpressure off: %d pending sets (low water %d)",
                        pending, self.low_water)

    def _publish_lane_gauges(self) -> None:
        if not self.metrics:
            return
        lengths = self._queue.lane_lengths()
        for lane in SignatureSetPriority:
            self.metrics.bls_pool_lane_pending.labels(
                lane=lane.name.lower()
            ).set(lengths.get(int(lane), 0))

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
        if self.metrics:
            self.metrics.bls_pool_queue_length.set(self.pending_sets())
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

    def _shed_expired(self, drained: List[Tuple], cid: int) -> List[Tuple]:
        """Drop drained jobs whose deadline passed, before any pack work is
        spent on them: each future gets ``VerificationDroppedError``, each
        job a ``bls.shed`` span, the batch one ``pool.shed`` journal event;
        the live jobs are returned as (item, future, t_enqueue, lane,
        deadline)."""
        now = time.monotonic()
        live: List[Tuple] = []
        shed_by_lane: Dict[str, int] = {}
        for item, fut, t_enq, lane, deadline in drained:
            if deadline is None or now <= deadline:
                live.append((item, fut, t_enq, lane, deadline))
                continue
            lane_p = SignatureSetPriority(lane)
            self._count_drop("deadline", lane_p, len(item))
            shed_by_lane[_lane_name(lane)] = shed_by_lane.get(_lane_name(lane), 0) + len(item)
            if TRACER.enabled:
                TRACER.add_span("bls.shed", "pool", int(t_enq * 1e9), int(now * 1e9),
                                cid=cid, lane=_lane_name(lane), reason="deadline",
                                sets=len(item))
            if not fut.done():
                fut.set_exception(VerificationDroppedError("deadline", lane_p))
        if shed_by_lane and JOURNAL.enabled:
            JOURNAL.record("pool.shed", level="WARNING", cid=cid, reason="deadline",
                           sets=sum(shed_by_lane.values()), by_lane=shed_by_lane)
        return live

    async def _dispatch(self, merged: List[SignatureSet], deadline: Optional[float] = None):
        """Pack and enqueue one merged batch on a worker thread; returns
        (the task that reads its verdict, on a worker thread too; the
        executor the verifier placed it on, or None).  ``deadline``, the
        batch's tightest job deadline, rides along when the verifier takes
        one."""
        if self._use_async:
            # returns once the device program is enqueued, not finished
            kwargs = {"deadline": deadline} if self._accepts_deadline else {}
            pending = await asyncio.to_thread(self.verifier.verify_signature_sets_async,
                                              merged, **kwargs)
            return (asyncio.create_task(asyncio.to_thread(pending.result)),
                    getattr(pending, "device", None))
        return asyncio.create_task(
            asyncio.to_thread(self.verifier.verify_signature_sets, merged)), None

    async def _flush(self) -> None:
        """Pipelined drain: keep up to ``pipeline_depth * n_devices`` merged
        batches in flight.  The fill half sheds expired jobs, then packs
        and enqueues the next batch while the drain half reads the oldest
        batch's verdict, so the host final exponentiation of batch N runs
        beside the device work of batch N+1.  Batches drain lane-ordered."""
        self._flushing = True
        inflight: collections.deque = collections.deque()
        flush_t0 = time.monotonic()
        busy = 0.0  # summed pack-start -> verdict walls (the overlap ratio)
        sets_done = 0  # sets resolved this flush (the throughput gauges)
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
                    cid = self._next_batch_id
                    self._next_batch_id += 1
                    drained = self._shed_expired(drained, cid)
                    if not drained:
                        self._update_backpressure()
                        continue  # the whole drain was expired backlog
                    now = time.monotonic()
                    jobs: List[Tuple] = []
                    merged: List[SignatureSet] = []
                    deadlines = []
                    for item, fut, t_enq, lane, deadline in drained:
                        jobs.append((item, fut, lane, t_enq))
                        merged.extend(item)
                        if deadline is not None:
                            deadlines.append(deadline)
                        if self.metrics:
                            # the JAX registry's deprecated laneless alias too
                            self.metrics.bls_pool_queue_wait_seconds.observe(now - t_enq)
                            self.metrics.bls_queue_wait_seconds.labels(
                                lane=_lane_name(lane)).observe(now - t_enq)
                        if TRACER.enabled:
                            TRACER.add_span("bls.queue_wait", "queue", int(t_enq * 1e9),
                                            int(now * 1e9), cid=cid, sets=len(item),
                                            lane=_lane_name(lane))
                    self._update_backpressure()
                    self._publish_lane_gauges()
                    if self.metrics:
                        self.metrics.bls_pool_dispatches_total.inc()
                        self.metrics.bls_pool_batch_size.observe(len(merged))
                    if JOURNAL.enabled:
                        JOURNAL.record("pool.flush", cid=cid, jobs=len(jobs), sets=len(merged),
                                       inflight=len(inflight), window=window)
                    # the correlation id rides the contextvar into to_thread
                    # and create_task (both copy the current context), so the
                    # verifier's spans pick it up
                    t_fill = time.monotonic()  # a batch is busy from its pack
                    token = tracing.set_batch(cid)
                    try:
                        verdict, device = await self._dispatch(
                            merged, min(deadlines) if deadlines else None)
                    except Exception as e:  # noqa: BLE001 - the jobs are retried one by one
                        # a pack or enqueue failure must not strand the
                        # drained jobs: a failed verdict sends them through
                        # the per-job retry below
                        logger.warning("dispatch enqueue failed: %s; will retry per job", e)
                        verdict = asyncio.get_running_loop().create_future()
                        verdict.set_result(False)
                        device = None
                    finally:
                        tracing.reset_batch(token)
                    inflight.append((jobs, merged, verdict, t_fill, time.monotonic(), cid, device))
                    self.inflight_peak = max(self.inflight_peak, len(inflight))
                    if self.metrics:
                        self.metrics.bls_pool_inflight_depth.set(len(inflight))
                if not inflight:
                    return
                # drain the oldest batch
                jobs, merged, verdict, t_fill, t0, cid, device = inflight.popleft()
                try:
                    ok = await verdict
                except Exception as e:  # noqa: BLE001 - the jobs are retried one by one
                    logger.warning("merged dispatch raised: %s; retrying per job", e)
                    ok = False
                t_done = time.monotonic()
                self.batch_spans.append((t_fill, t_done))
                busy += t_done - t_fill
                sets_done += len(merged)
                if TRACER.enabled:
                    TRACER.add_span("pool.batch", "pool", int(t_fill * 1e9), int(t_done * 1e9),
                                    cid=cid, sets=len(merged), jobs=len(jobs), ok=bool(ok),
                                    inflight_left=len(inflight), device=device)
                if self.metrics:
                    self.metrics.bls_pool_dispatch_seconds.observe(t_done - t0)
                    self.metrics.bls_pool_inflight_depth.set(len(inflight))
                if ok:
                    self.batch_sets_success += len(merged)
                    for item, fut, lane, t_enq in jobs:
                        # e2e observes delivered verdicts only: a pusher
                        # cancelled mid-flight received none
                        if not fut.done():
                            fut.set_result(True)
                            self._observe_e2e(lane, t_done - t_enq)
                    continue
                # the merged batch failed: verify each job on its own, so
                # that innocent jobs still pass (worker.ts:78-88)
                self.batch_retries += 1
                logger.debug("merged batch of %d jobs failed; retrying individually", len(jobs))
                for item, fut, lane, t_enq in jobs:
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
                        self._observe_e2e(lane, time.monotonic() - t_enq)
        finally:
            self._flushing = False
            self._update_backpressure()
            self._publish_lane_gauges()
            self._publish_flush_metrics(busy, time.monotonic() - flush_t0, sets_done)
            # the profile window's flush boundary: a no-op until a capture
            # is configured, never raises; outside the metrics guard, so
            # that a pool without metrics still drives windows
            _xprof_notify_flush()
            if len(self._queue):
                self._buffered_sets_changed()

    def _observe_e2e(self, lane, seconds: float) -> None:
        """End-to-end verify latency (enqueue -> verdict resolved) per
        lane, on the SLO bucket ladder."""
        if self.metrics:
            self.metrics.bls_e2e_verify_seconds.labels(lane=_lane_name(lane)).observe(seconds)

    def _publish_flush_metrics(self, busy: float, wall: float, sets_done: int = 0) -> None:
        """End-of-flush snapshots: the overlap ratio this flush achieved,
        the verifier's ``stage_seconds`` and the pool's ``inflight_peak``,
        the flush's sets per second per card and over the whole mesh, and
        the tracer's and journal's dropped counts."""
        if not self.metrics:
            return
        self.metrics.bls_pool_inflight_depth.set(0)
        self.metrics.bls_pool_inflight_peak.set(self.inflight_peak)
        if busy > 0 and wall > 0:
            self.metrics.bls_pool_overlap_ratio.set(busy / wall)
        if sets_done and wall > 0:
            n_dev = max(1, getattr(self.verifier, "n_devices", 1))
            self.metrics.bls_sets_per_sec_per_chip.set(sets_done / wall / n_dev)
            self.metrics.bls_sets_per_sec_mesh.set(sets_done / wall)
        stage_seconds = getattr(self.verifier, "stage_seconds", None)
        if stage_seconds:
            for stage, secs in stage_seconds.items():
                self.metrics.bls_verifier_stage_seconds.labels(stage=stage).set(secs)
        self.metrics.tracing_spans_dropped_total.set(TRACER.dropped)
        self.metrics.forensics_journal_dropped_total.set(JOURNAL.dropped)
