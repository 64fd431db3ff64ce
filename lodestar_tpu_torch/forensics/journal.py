"""EventJournal: the always-on black-box recorder of the flight recorder
(the port's copy of the JAX package's ``forensics/journal.py``, without
its ``jax.monitoring`` listener and compile sinks).

Where the span tracer (``lodestar_tpu_torch/tracing``) answers "where did
batch N spend its time" and is OFF by default, the journal answers "what
was the node DOING when it died" and is ON by default: a fixed-size ring
of structured events — dispatch placement decisions, executor health
transitions, requeues, bundle writes, injected faults and every
WARNING/ERROR log record routed through ``JournalHandler`` — cheap enough
to leave running in production (one dict append under a short lock per
*event*, never per signature set), bounded no matter how long the process
lives, and readable after the fact from a diagnostic bundle
(``forensics/bundle``).

Discipline mirrors ``SpanTracer``:

- ``enabled`` is a plain bool read before any work (default True — the
  journal is the always-on half of the observability stack);
- bounded memory via ``collections.deque(maxlen=capacity)``; ``dropped``
  counts evictions so a dump can say how much history it is missing
  (surfaced as ``lodestar_forensics_journal_dropped_total``);
- thread safety via one short lock (events come from the asyncio loop,
  ``asyncio.to_thread`` workers, the warmup daemon, and the watchdog);
- timestamps are ``time.monotonic_ns()`` for ordering against spans,
  PLUS a wall-clock second for post-mortem correlation with external
  logs.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ..tracing import current_batch_id

#: event fields every consumer may rely on (``tools/inspect_bundle.py``
#: validates each journal line against this set)
REQUIRED_EVENT_KEYS = ("seq", "ts_ns", "wall", "kind", "level")

_LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL")


class EventJournal:
    """Fixed-capacity structured event ring.  Enabled by default."""

    def __init__(self, capacity: int = 4096):
        self.enabled = True
        self._lock = threading.Lock()
        self._buf: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=capacity
        )
        self.dropped = 0
        self._seq = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    @property
    def seq(self) -> int:
        """Next sequence number — a watermark: every event recorded after
        reading this carries ``seq >=`` the returned value."""
        with self._lock:
            return self._seq

    def configure(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self._buf.maxlen:
                self._buf = collections.deque(self._buf, maxlen=max(1, capacity))

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0
            self._seq = 0

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, level: str = "INFO",
               cid: Optional[int] = None, **fields: Any) -> None:
        """Append one event.  ``cid`` defaults to the merged-batch
        correlation id of the calling context (the same ContextVar the
        span tracer rides), so journal events line up with spans without
        the caller threading ids around."""
        if not self.enabled:
            return
        if cid is None:
            cid = current_batch_id()
        ev: Dict[str, Any] = {
            "ts_ns": time.monotonic_ns(),
            "wall": round(time.time(), 3),
            "kind": kind,
            "level": level if level in _LEVELS else "INFO",
        }
        if cid is not None:
            ev["cid"] = cid
        for k, v in fields.items():
            if v is not None:
                ev[k] = v
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(ev)

    # -- reading -------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot, oldest first."""
        with self._lock:
            return [dict(e) for e in self._buf]

    def tail(self, n: int) -> List[Dict[str, Any]]:
        with self._lock:
            if n >= len(self._buf):
                return [dict(e) for e in self._buf]
            return [dict(e) for e in list(self._buf)[-n:]]

    def last_error(self) -> Optional[Dict[str, Any]]:
        """Most recent ERROR/CRITICAL event ('what broke last'), or
        None."""
        with self._lock:
            for ev in reversed(self._buf):
                if ev.get("level") in ("ERROR", "CRITICAL"):
                    return dict(ev)
        return None

    def to_jsonl(self, n: Optional[int] = None) -> str:
        events = self.tail(n) if n is not None else self.events()
        return "".join(json.dumps(e, default=str) + "\n" for e in events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


#: process-wide singleton — the black box every subsystem records into
JOURNAL = EventJournal()


class JournalHandler(logging.Handler):
    """logging.Handler that mirrors WARNING+ records into the journal, so
    'the last errors before death' survive in every diagnostic bundle
    even when stderr was truncated or lost.  Attach it to a logger with
    ``logging.getLogger("lodestar_tpu_torch").addHandler(JournalHandler())``."""

    def __init__(self, journal: EventJournal = JOURNAL,
                 level: int = logging.WARNING):
        super().__init__(level)
        self.journal = journal

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.journal.record(
                "log",
                level=record.levelname,
                logger=record.name,
                msg=record.getMessage(),
            )
        except Exception:  # a broken journal must never break logging
            pass
