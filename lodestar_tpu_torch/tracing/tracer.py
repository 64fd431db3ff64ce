"""SpanTracer: a lightweight, thread-safe span recorder for the BLS hot
path (and anything else that wants a timeline); the port's copy of the
JAX package's ``tracing/tracer.py``.

Design constraints, in order:

1. **Near-zero overhead when disabled.**  Every instrumentation site is
   gated on the single attribute read ``TRACER.enabled`` (a plain bool) —
   no timestamp is taken, no object allocated, no lock touched.  The hot
   path performs no per-set work beyond that constant-time check.
2. **Bounded memory.**  Spans land in a fixed-size ring buffer
   (``collections.deque(maxlen=capacity)``); old spans are evicted, never
   accumulated.  ``dropped`` counts evictions so a dump can say how much
   history it is missing.
3. **Thread safety.**  Spans are recorded from the asyncio loop, from
   ``asyncio.to_thread`` workers (pack / final exp), and from the warmup
   daemon thread.  A single short lock guards the deque append + the
   thread-name map; timestamps are taken OUTSIDE the lock.

Timestamps are ``time.monotonic_ns()`` so spans recorded on different
threads share one clock and can be merged into one timeline.  Durations
are end-start in ns.  Correlation: every span carries an optional ``cid``
(the merged-batch id the BLS pool assigns) so queue-wait / pack /
dispatch / final-exp spans of one batch can be grouped, and overlap
between batch N and N+1 read directly off the timeline.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional


class Span:
    """One recorded interval (or instant, when ``dur_ns == 0`` and
    ``instant`` is True)."""

    __slots__ = ("name", "cat", "ts_ns", "dur_ns", "cid", "tid", "args", "instant")

    def __init__(self, name: str, cat: str, ts_ns: int, dur_ns: int,
                 cid: Optional[int], tid: int, args: Optional[Dict[str, Any]],
                 instant: bool = False):
        self.name = name
        self.cat = cat
        self.ts_ns = ts_ns
        self.dur_ns = dur_ns
        self.cid = cid
        self.tid = tid
        self.args = args
        self.instant = instant

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "cat": self.cat,
            "ts_us": self.ts_ns / 1e3,
            "dur_us": self.dur_ns / 1e3,
            "tid": self.tid,
        }
        if self.cid is not None:
            d["cid"] = self.cid
        if self.args:
            d["args"] = self.args
        if self.instant:
            d["instant"] = True
        return d


class SpanTracer:
    """Fixed-capacity span ring buffer.  Disabled by default."""

    def __init__(self, capacity: int = 8192):
        self.enabled = False
        self._lock = threading.Lock()
        self._buf: "collections.deque[Span]" = collections.deque(maxlen=capacity)
        self._thread_names: Dict[int, str] = {}
        self.dropped = 0

    # -- lifecycle -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def enable(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self._buf.maxlen:
                self._buf = collections.deque(self._buf, maxlen=max(1, capacity))
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._thread_names.clear()
            self.dropped = 0

    # -- recording -----------------------------------------------------------

    def now(self) -> int:
        """Start-timestamp helper: monotonic ns when enabled, else 0 so
        the disabled path never calls the clock."""
        return time.monotonic_ns() if self.enabled else 0

    def add_span(self, name: str, cat: str, t0_ns: int, t1_ns: Optional[int] = None,
                 cid: Optional[int] = None, instant: bool = False,
                 **args: Any) -> None:
        """Record [t0_ns, t1_ns] (t1 defaults to now, or to t0 for an
        instant).  No-op when disabled — callers may still gate on
        ``enabled`` to skip building ``args``."""
        if not self.enabled:
            return
        if t1_ns is None:
            t1_ns = t0_ns if instant else time.monotonic_ns()
        span = Span(name, cat, t0_ns, max(0, t1_ns - t0_ns), cid,
                    threading.get_ident(), args or None, instant)
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(span)
            tid = span.tid
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name

    def instant(self, name: str, cat: str = "mark", cid: Optional[int] = None,
                **args: Any) -> None:
        """Zero-duration marker (slot boundaries, mode degradations)."""
        if not self.enabled:
            return
        self.add_span(name, cat, time.monotonic_ns(), cid=cid, instant=True,
                      **args)

    @contextmanager
    def span(self, name: str, cat: str, cid: Optional[int] = None,
             **args: Any) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self.add_span(name, cat, t0, cid=cid, **args)

    # -- reading -------------------------------------------------------------

    def spans(self) -> List[Span]:
        """Snapshot (oldest first)."""
        with self._lock:
            return list(self._buf)

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._thread_names)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
