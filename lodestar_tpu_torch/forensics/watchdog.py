"""In-flight dispatch table + stall watchdog (the port's copy of the JAX
package's ``forensics/watchdog.py``).

``TorchBlsVerifier.dispatch`` registers every enqueued batch in the
process-wide ``INFLIGHT`` table; the first ``PendingVerdict.result()``
resolves it (the same exactly-once release path that returns the
executor slot).  The table is therefore an always-current answer to
"which batches are on which device right now" — every diagnostic bundle
snapshots it, and the ``Watchdog`` thread scans it for entries that have
been in flight past a deadline.

A stall is the silent failure mode of an asynchronous device pipeline:
a CUDA graph replay returns as soon as it is enqueued, so a wedged card
produces no exception anywhere — the verdict simply never resolves and
the pool's flusher blocks forever.  The watchdog
turns that silence into evidence: a journal ERROR event, a
``lodestar_bls_watchdog_stalls_total{device}`` increment, and one
automatic diagnostic bundle naming the stalled cid and device.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .journal import JOURNAL, EventJournal


class InflightTable:
    """Registry of dispatched-but-unresolved batches.  All operations are
    O(entries-in-flight) or better; the table is tiny (pipeline_depth x
    n_devices entries) so snapshotting it in a crash path is safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, Dict[str, Any]] = {}
        self._next = 0

    def register(self, cid: Optional[int] = None, device: Optional[str] = None,
                 bucket: Optional[int] = None, sets: Optional[int] = None,
                 deadline_s: Optional[float] = None) -> int:
        """Record one enqueued batch; returns the token ``resolve`` takes.
        ``deadline_s`` is the batch's remaining QoS-deadline headroom at
        dispatch time (negative = already expired) — it rides every
        snapshot so a stall bundle can say whether the wedged work still
        mattered."""
        entry = {
            "cid": cid,
            "device": device,
            "bucket": bucket,
            "sets": sets,
            "deadline_s": deadline_s,
            "t0_ns": time.monotonic_ns(),
            "stalled": False,
        }
        with self._lock:
            token = self._next
            self._next += 1
            self._entries[token] = entry
        return token

    def resolve(self, token: int) -> None:
        with self._lock:
            self._entries.pop(token, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def snapshot(self, now_ns: Optional[int] = None) -> List[Dict[str, Any]]:
        """Current in-flight batches with ages (oldest first)."""
        if now_ns is None:
            now_ns = time.monotonic_ns()
        with self._lock:
            entries = [(tok, dict(e)) for tok, e in self._entries.items()]
        out = []
        for tok, e in sorted(entries, key=lambda te: te[1]["t0_ns"]):
            e["token"] = tok
            e["age_s"] = round((now_ns - e.pop("t0_ns")) / 1e9, 3)
            out.append(e)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- watchdog support ----------------------------------------------------

    def flag_stalled(self, deadline_s: float,
                     now_ns: Optional[int] = None) -> List[Dict[str, Any]]:
        """Mark entries older than ``deadline_s`` as stalled and return
        the NEWLY flagged ones (each entry trips at most once, so one
        wedge yields one stall event + one bundle, not one per scan)."""
        if now_ns is None:
            now_ns = time.monotonic_ns()
        limit_ns = int(deadline_s * 1e9)
        fresh: List[Dict[str, Any]] = []
        with self._lock:
            for tok, e in self._entries.items():
                if not e["stalled"] and now_ns - e["t0_ns"] > limit_ns:
                    e["stalled"] = True
                    snap = dict(e)
                    snap["token"] = tok
                    snap["age_s"] = round((now_ns - snap.pop("t0_ns")) / 1e9, 3)
                    fresh.append(snap)
        return fresh


#: process-wide singleton the verifier registers into
INFLIGHT = InflightTable()


class Watchdog:
    """Daemon thread flagging in-flight batches unresolved past a
    deadline.  ``on_stall(entries)`` is the dump hook (the
    ``FlightRecorder`` passes its bundle writer); metric and journal
    emission happen here so the hook can stay dump-only."""

    def __init__(self, deadline_s: float = 30.0,
                 interval_s: Optional[float] = None,
                 inflight: InflightTable = INFLIGHT,
                 journal: EventJournal = JOURNAL,
                 metrics=None,
                 on_stall: Optional[Callable[[List[Dict[str, Any]]], Any]] = None):
        self.deadline_s = deadline_s
        self.interval_s = interval_s if interval_s is not None else max(
            0.05, deadline_s / 4.0
        )
        self.inflight = inflight
        self.journal = journal
        self.metrics = metrics
        self.on_stall = on_stall
        self.stalls = 0  # cumulative stalled-entry count
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def check_once(self) -> List[Dict[str, Any]]:
        """One scan (the thread loop body, callable directly in tests):
        journal + count + metric every newly stalled entry, then fire the
        dump hook once for the batch of them."""
        stalled = self.inflight.flag_stalled(self.deadline_s)
        if not stalled:
            return stalled
        self.stalls += len(stalled)
        for e in stalled:
            self.journal.record(
                "watchdog.stall", level="ERROR", cid=e.get("cid"),
                device=e.get("device"), bucket=e.get("bucket"),
                sets=e.get("sets"), age_s=e.get("age_s"),
                deadline_s=self.deadline_s,
            )
            if self.metrics is not None:
                self.metrics.bls_watchdog_stalls_total.labels(
                    device=str(e.get("device"))
                ).inc()
        if self.on_stall is not None:
            try:
                self.on_stall(stalled)
            except Exception:  # the dump path must never kill the scanner
                pass
        return stalled

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:
                pass

    def start(self) -> "Watchdog":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="forensics-watchdog"
        )
        self._thread.start()
        self.journal.record(
            "watchdog.start", deadline_s=self.deadline_s,
            interval_s=round(self.interval_s, 3),
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def state(self) -> Dict[str, Any]:
        return {
            "running": self.running,
            "deadline_s": self.deadline_s,
            "interval_s": round(self.interval_s, 3),
            "stalls": self.stalls,
        }
