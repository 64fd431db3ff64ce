"""Device telemetry sampler: per-executor card memory and occupancy, live
(the port's copy of the JAX package's ``observatory/device_sampler.py``).

- Card memory per executor per tick, from the caching allocator's
  counters (``torch.cuda.memory_stats``; a CPU executor has none and gets
  no memory row, as a JAX CPU device returns ``None``), exposed as
  ``lodestar_bls_device_hbm_bytes{device,kind}``;
- occupancy from the forensics ``InflightTable`` (the record of which
  batches are on which executor that the watchdog scans): an executor is
  *busy* at a tick when it has >= 1 unresolved batch, and
  ``lodestar_bls_device_busy_ratio{device}`` is the busy fraction over a
  sliding window of ticks;
- a ``telemetry.sample`` journal event every ``journal_every`` ticks, so
  diagnostic bundles carry the memory/occupancy history before a death;
- self-accounted overhead: every tick measures its own wall time and
  ``overhead_ratio()`` reports sampler work / elapsed.

Differences from the JAX sampler: its rows are the verifier's executors
(``cuda:0``, ``cuda:0#1``, ...: the names the verifier registers its
batches under in the in-flight table), not bare devices; two executors of
one card share that card's reading, taken once a tick.  The memory
reader is injectable (``reader``: a card -> a ``memory_stats``-shaped
dict or None).  The default reader maps the allocator's counters onto
the JAX kinds: ``allocated_bytes.all.current`` -> ``bytes_in_use``,
``allocated_bytes.all.peak`` -> ``peak_bytes_in_use``,
``reserved_bytes.all.current`` -> ``bytes_reserved``, and the card's
total memory (read once a card) -> ``bytes_limit``;
``largest_free_block_bytes`` has no counterpart and is absent.  A tick
never synchronises a card and never allocates on one.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..forensics.journal import JOURNAL, EventJournal
from ..forensics.watchdog import INFLIGHT, InflightTable

#: memory kinds worth publishing (bounded label cardinality; the JAX
#: sampler's names)
HBM_KINDS = (
    "bytes_in_use",
    "peak_bytes_in_use",
    "bytes_limit",
    "bytes_reserved",
    "largest_free_block_bytes",
)

#: the caching allocator's counters behind each kind
_TORCH_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
}


class CudaMemoryReader:
    """The default reader: a card's allocator counters as the JAX kinds,
    None for a device that is not a card.  The card's total memory is read
    once a card.  ``torch.cuda.memory_stats`` reads host-side counters: no
    sync, no allocation."""

    def __init__(self):
        self._limits: Dict[Any, int] = {}

    def __call__(self, device) -> Optional[Dict[str, int]]:
        if getattr(device, "type", None) != "cuda":
            return None
        import torch

        stats = torch.cuda.memory_stats(device)
        out = {kind: int(stats.get(key, 0)) for kind, key in _TORCH_KEYS.items()}
        limit = self._limits.get(device)
        if limit is None:
            limit = self._limits[device] = int(
                torch.cuda.get_device_properties(device).total_memory)
        out["bytes_limit"] = limit
        return out


class DeviceSampler:
    """Background per-executor telemetry.  ``tick()`` is callable directly
    (tests, one-shot probes); ``start()`` runs it on a daemon thread.

    ``executors``: objects with ``name`` and ``device`` (the verifier's
    ``DeviceExecutor``s; None: rows come from the in-flight table alone).
    ``reader``: a device -> memory dict or None (default
    ``CudaMemoryReader()``)."""

    def __init__(self, interval_s: float = 5.0,
                 executors: Optional[Sequence[Any]] = None,
                 metrics=None,
                 inflight: InflightTable = INFLIGHT,
                 journal: EventJournal = JOURNAL,
                 window: int = 60,
                 journal_every: int = 12,
                 reader: Optional[Callable[[Any], Optional[Dict[str, Any]]]] = None):
        self.interval_s = max(0.05, interval_s)
        self.metrics = metrics
        self.inflight = inflight
        self.journal = journal
        self.window = max(1, window)
        self.journal_every = max(1, journal_every)
        self._executors = list(executors or ())
        self.reader = reader or CudaMemoryReader()
        # guards _busy/_last_hbm: tick() runs on the daemon thread while
        # snapshot() is read by bundle writers
        self._lock = threading.Lock()
        self._busy: Dict[str, "collections.deque[int]"] = {}
        self._last_hbm: Dict[str, Dict[str, int]] = {}
        self.ticks = 0
        self.work_seconds = 0.0  # sampler's own wall time, summed per tick
        self._started_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one sample ----------------------------------------------------------

    def _read(self, device, cache: Dict[Any, Any]):
        """One reading per device per tick (executors of one card share
        it); a reader that raises gives no row, never an error."""
        if device is None:
            return None
        if device not in cache:
            try:
                cache[device] = self.reader(device)
            except Exception:
                cache[device] = None
        return cache[device]

    def tick(self) -> Dict[str, Any]:
        """One sample: read the cards' memory + the in-flight table,
        update the busy windows, publish gauges, journal every Nth tick.
        Returns the sample (the ``snapshot()`` shape, minus history)."""
        t0 = time.perf_counter()
        self.ticks += 1
        inflight_by_device: Dict[str, int] = {}
        for e in self.inflight.snapshot():
            d = str(e.get("device"))
            inflight_by_device[d] = inflight_by_device.get(d, 0) + 1
        sample: Dict[str, Any] = {"devices": {}, "ticks": self.ticks}
        names: List[str] = [ex.name for ex in self._executors]
        devices = [ex.device for ex in self._executors]
        # a batch registered as "default" belongs to the first executor's
        # row (the JAX sampler's remap of an unpinned executor)
        if "default" in inflight_by_device and names:
            inflight_by_device[names[0]] = (
                inflight_by_device.get(names[0], 0)
                + inflight_by_device.pop("default")
            )
        # a name the in-flight table mentions but no executor has still
        # gets a row
        for extra in inflight_by_device:
            if extra not in names and extra != "None":
                names.append(extra)
        readings: Dict[Any, Any] = {}
        for name, dev in list(zip(names, devices)) + [
            (n, None) for n in names[len(devices):]
        ]:
            stats = self._read(dev, readings)
            busy_now = 1 if inflight_by_device.get(name, 0) > 0 else 0
            with self._lock:
                wins = self._busy.setdefault(
                    name, collections.deque(maxlen=self.window)
                )
                wins.append(busy_now)
                ratio = sum(wins) / len(wins)
            row: Dict[str, Any] = {
                "busy": bool(busy_now),
                "busy_ratio": round(ratio, 4),
                "inflight": inflight_by_device.get(name, 0),
            }
            if stats:
                hbm = {
                    k: int(stats[k]) for k in HBM_KINDS
                    if isinstance(stats.get(k), (int, float))
                }
                if hbm:
                    row["hbm"] = hbm
                    with self._lock:
                        self._last_hbm[name] = hbm
            sample["devices"][name] = row
            if self.metrics is not None:
                self.metrics.bls_device_busy_ratio.labels(device=name).set(ratio)
                for kind, val in row.get("hbm", {}).items():
                    self.metrics.bls_device_hbm_bytes.labels(
                        device=name, kind=kind
                    ).set(val)
        if self.ticks % self.journal_every == 0 and self.journal.enabled:
            self.journal.record(
                "telemetry.sample",
                devices={
                    n: {
                        "busy_ratio": r["busy_ratio"],
                        "inflight": r["inflight"],
                        "hbm_in_use": r.get("hbm", {}).get("bytes_in_use"),
                    }
                    for n, r in sample["devices"].items()
                },
            )
        self.work_seconds += time.perf_counter() - t0
        return sample

    # -- reading -------------------------------------------------------------

    def busy_ratio(self, name: str) -> Optional[float]:
        with self._lock:
            wins = self._busy.get(name)
            return round(sum(wins) / len(wins), 4) if wins else None

    def overhead_ratio(self) -> Optional[float]:
        """Sampler work seconds / elapsed wall seconds since start() —
        the measured cost of leaving the sampler on."""
        if self._started_at is None:
            return None
        elapsed = time.monotonic() - self._started_at
        return round(self.work_seconds / elapsed, 6) if elapsed > 0 else None

    def snapshot(self) -> Dict[str, Any]:
        """Current telemetry view (bundles)."""
        with self._lock:
            devices = {
                name: {
                    "busy_ratio": (
                        round(sum(wins) / len(wins), 4) if wins else None
                    ),
                    "hbm": self._last_hbm.get(name),
                }
                for name, wins in list(self._busy.items())
            }
        return {
            "running": self.running,
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "window_ticks": self.window,
            "overhead_ratio": self.overhead_ratio(),
            "devices": devices,
        }

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # telemetry must never take the node down
                pass

    def start(self) -> "DeviceSampler":
        if self.running:
            return self
        self._stop.clear()
        self._started_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="observatory-sampler"
        )
        self._thread.start()
        if self.journal.enabled:
            self.journal.record(
                "telemetry.start", interval_s=self.interval_s,
                window=self.window,
            )
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


#: process-wide sampler slot (the CLI wires one in; None until then)
SAMPLER: Optional[DeviceSampler] = None


def start_sampler(interval_s: float = 5.0, **kw) -> DeviceSampler:
    """Create/replace and start the process-wide sampler."""
    global SAMPLER
    if SAMPLER is not None:
        SAMPLER.stop()
    SAMPLER = DeviceSampler(interval_s=interval_s, **kw)
    return SAMPLER.start()


def stop_sampler() -> None:
    global SAMPLER
    if SAMPLER is not None:
        SAMPLER.stop()
        SAMPLER = None
