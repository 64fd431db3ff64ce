"""Bounded async job queue with priority lanes: the batch-accumulation
point of ``chain/bls_pool`` (the port of ``lodestar_tpu/utils/queue.py``,
cut to what the pool uses).

Reference: packages/beacon-node/src/util/queue/itemQueue.ts (JobItemQueue)
and errors.ts (QueueError codes).  A producer ``push``es a job and awaits
its result; the consumer pulls pending jobs in bulk with ``drain_batch``
and resolves their futures itself, so that concurrent jobs are verified
in one device dispatch.  The JAX queue's own job scheduling
(``process_fn``, ``max_concurrency``), LIFO order, the other overflow
policies and its metrics counters have no user in the port.

Jobs carry a ``priority`` lane (lower value = drained first: the
reference keeps a separate gossip queue per topic with blocks ahead of
attestations; this queue collapses that onto lanes) and an optional
``deadline`` the consumer may shed against.  On overflow the oldest
pending job of the lowest lane is evicted, but only when its lane is no
more important than the incoming job's; otherwise the new job is the one
dropped (``overflow="evict_low"``): a storm of unaggregated attestations
can never evict a buffered block proposal, and a storm-lane push full of
its own kind sheds its own oldest.

Eviction resolves the victim's future with QUEUE_MAX_LENGTH and loops
until a live job was actually evicted (a future already done, a cancelled
pusher, frees its slot but drops nothing).

``size_fn`` (required) maintains ``pending_size``, an O(1) sum of
``size_fn(item)`` over every pending job, updated at push, drain, evict
and abort, so that a consumer whose items are batches (the BLS pool: one
job = a list of signature sets) reads its buffered-set total without
walking the lanes.
"""

from __future__ import annotations

import asyncio
import collections
import enum
import time
from typing import Any, Callable, Deque, Dict, Generic, List, Optional, Tuple, TypeVar

from .errors import LodestarError

T = TypeVar("T")
R = TypeVar("R")


class QueueErrorCode(str, enum.Enum):
    QUEUE_ABORTED = "QUEUE_ABORTED"
    QUEUE_MAX_LENGTH = "QUEUE_MAX_LENGTH"


class QueueError(LodestarError):
    def __init__(self, code: QueueErrorCode):
        super().__init__({"code": code.value})


#: internal entry shape: (item, future, t_enqueue, deadline)
_Entry = Tuple[Any, "asyncio.Future", float, Optional[float]]


class JobItemQueue(Generic[T, R]):
    def __init__(self, *, max_length: int, size_fn: Callable[[T], int]):
        self.max_length = max_length
        self._size_fn = size_fn
        self.pending_size = 0  # O(1) running sum of size_fn over pending jobs
        # one deque per priority lane, drained lowest-key-first
        self._lanes: Dict[int, Deque[_Entry]] = {}
        self._len = 0
        self._aborted = False
        # True after a fruitless full corpse sweep with no queue mutation
        # since: repeat refusals then skip the O(n) rescan
        self._sweep_clean = False

    def __len__(self) -> int:
        return self._len

    def lane_lengths(self) -> Dict[int, int]:
        """Pending job count per non-empty lane (the pool's lane gauges;
        O(lanes), not O(jobs))."""
        return {lane: len(dq) for lane, dq in self._lanes.items() if dq}

    # -- internal lane bookkeeping -------------------------------------------

    def _append(self, lane: int, entry: _Entry) -> None:
        dq = self._lanes.get(lane)
        if dq is None:
            dq = self._lanes[lane] = collections.deque()
        dq.append(entry)
        self._len += 1
        self._sweep_clean = False
        self.pending_size += self._size_fn(entry[0])

    def _account_removed(self, entry: _Entry) -> None:
        self._len -= 1
        self._sweep_clean = False
        self.pending_size -= self._size_fn(entry[0])

    def _evict_one(self, incoming_priority: int) -> bool:
        """Evict toward a free slot.  Returns True when a slot was freed (a
        live victim dropped or a done future reaped), False when the
        incoming job must pay.  The caller loops until there is room or
        this returns False."""
        if self._len == 0:
            return False
        # a cancelled pusher's corpse at any lane head: reaping it frees a
        # slot without dropping anyone, so it goes before the lane rule
        for dq in self._lanes.values():
            if dq and dq[0][1].done():
                self._account_removed(dq.popleft())
                return True
        victim_lane = max(k for k, dq in self._lanes.items() if dq)
        if victim_lane < incoming_priority:
            # everything pending outranks the incoming job: one full sweep
            # for buried corpses before the live incoming job pays
            # (memoized until the queue changes)
            if self._sweep_clean:
                return False
            for dq in self._lanes.values():
                for i, entry in enumerate(dq):
                    if entry[1].done():
                        del dq[i]
                        self._account_removed(entry)
                        return True
            self._sweep_clean = True
            return False
        entry = self._lanes[victim_lane].popleft()  # oldest of the lowest lane
        self._account_removed(entry)
        if not entry[1].done():
            entry[1].set_exception(QueueError(QueueErrorCode.QUEUE_MAX_LENGTH))
        return True

    # -- producer API ---------------------------------------------------------

    async def push(self, item: T, *, priority: int = 0, deadline: Optional[float] = None) -> R:
        """Enqueue and await the consumer's result.

        ``priority`` is the lane (lower = drained first).  ``deadline`` is
        an absolute ``time.monotonic()`` instant carried with the job for
        the consumer to shed against; the queue itself never expires jobs.
        On overflow a dropped pending job's future resolves with
        QUEUE_MAX_LENGTH, a dropped incoming job raises it here."""
        if self._aborted:
            raise QueueError(QueueErrorCode.QUEUE_ABORTED)
        while self._len + 1 > self.max_length:
            if not self._evict_one(priority):
                raise QueueError(QueueErrorCode.QUEUE_MAX_LENGTH)
        fut: "asyncio.Future[R]" = asyncio.get_running_loop().create_future()
        self._append(priority, (item, fut, time.monotonic(), deadline))
        return await fut

    # -- consumer API ---------------------------------------------------------

    def drain_batch(self, max_items: int, max_size: int) -> List[Tuple]:
        """Pull up to ``max_items`` pending jobs in lane order, as
        (item, future, t_enqueue, priority, deadline) records (t_enqueue:
        the push's ``time.monotonic()``, from which the pool derives each
        job's queue wait); the caller resolves the futures.  ``max_size``
        caps the
        drain at an accumulated item size: it stops before the job that
        would cross it (always taking at least one), so that merged batches
        stay dispatch-sized under a backlog."""
        out: List[Tuple] = []
        size = 0
        while self._len and len(out) < max_items:
            lane = min(k for k, dq in self._lanes.items() if dq)
            dq = self._lanes[lane]
            if out and size + self._size_fn(dq[0][0]) > max_size:
                break
            entry = dq.popleft()
            self._account_removed(entry)
            item, fut, t_enq, deadline = entry
            if fut.done():  # the pusher was cancelled: nothing to resolve,
                continue    # and a corpse must not eat max_size budget
            size += self._size_fn(item)
            out.append((item, fut, t_enq, lane, deadline))
        return out

    def abort(self) -> None:
        self._aborted = True
        for dq in self._lanes.values():
            while dq:
                entry = dq.popleft()
                self._account_removed(entry)
                if not entry[1].done():
                    entry[1].set_exception(QueueError(QueueErrorCode.QUEUE_ABORTED))
