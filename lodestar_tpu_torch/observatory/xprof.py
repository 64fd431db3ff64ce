"""On-demand device-profile windows merged with the span timeline (the
port's copy of the JAX package's ``observatory/xprof.py``).

``torch.profiler`` answers what the cards did; the SpanTracer answers
what the node *meant* — but they live in different files on different
clocks.  :class:`ProfileCapture` brackets N dispatch flushes with a
profiler window, parses the Chrome trace it leaves behind (stdlib-only:
the ``.trace.json`` under ``plugins/profile``), remaps the profiler
timebase onto the tracer's monotonic clock, and merges both into ONE
Perfetto-loadable Chrome trace: host spans at pid 0 (the
``tracing.export`` convention), device processes at
``DEVICE_PID_BASE + index``, and the clock mapping recorded in
``otherData.device_clock`` so ``tools/check_trace.py --require-device``
can audit the merge.

Windows are armed two ways (both land here):

- ``--profile-window N`` / ``--torch-profile DIR`` on the CLI (the latter
  also brackets the blocking warmup via :meth:`ProfileCapture.run_window`);
- a sampled cadence (``sample_every``): every Mth pool flush auto-arms a
  short window, with the capture's own wall cost accumulated in
  ``work_seconds`` so ``overhead_ratio()`` *measures* the always-on cost.

``BlsBatchPool._flush`` calls :func:`notify_flush` (module level, no-op
until :func:`configure_capture` wires a capture) at the end of every
flush; the flush boundary is what "N flushes" counts.  Finishing a
window (stop + parse + merge + attribution) runs on a daemon thread so
the event loop never blocks on profile IO.

What differs from the JAX module:

- ``_default_start`` / ``_default_stop`` drive ``torch.profiler`` (CUDA
  activity on a machine with a card, CPU activity without one) and export
  its Chrome trace to ``<dir>/plugins/profile/<run>/<host>.trace.json``,
  the JAX layout, so the parser and the merge read it unchanged.  A torch
  profiler can only be stopped on the thread that started it, while a
  window starts on whichever thread arms it and finishes on the
  ``xprof-finish`` thread; so both run on one daemon thread that owns the
  profiler (``_ProfilerOwner``, started at the first window).  The
  card's activity is recorded whatever thread launches the work.
- ``parse_profile_dir`` keeps only device events as device evidence: an
  event of a category (torch's ``cat``) counts only when the category is
  ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, so host ``cuda_runtime``,
  ``cpu_op``, ``ac2g`` and ``overhead`` events never count as device
  events; complete events that name no category (trace-viewer dumps) and
  metadata are kept as the JAX parser keeps them.  One host event stays:
  the profiler's own window span (category ``Trace``, a non-numeric pid,
  which the merge skips), so that ``ClockMap``, which anchors the earliest
  event at the host instant after the start, is anchored at the window's
  start and not at the first kernel, which may come long after it.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import queue
import socket
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..forensics.journal import JOURNAL
from ..tracing import TRACER
from ..tracing.export import to_chrome_trace
from . import attribution

#: merged-trace pid convention: host spans keep pid 0, device processes
#: are renumbered DEVICE_PID_BASE + device_index (one process per source
#: pid of the profiler dump, metadata-named)
DEVICE_PID_BASE = 1000

#: default clock-skew budget: how far (µs) the remapped device events may
#: overrun the host-side capture window before the merge is rejected
DEFAULT_TOLERANCE_US = 50_000.0


# -- trace-viewer ingestion (stdlib only) -----------------------------------


def find_trace_files(profile_dir: str) -> List[str]:
    """The trace dumps under a profiler output dir —
    ``<dir>/plugins/profile/<run>/<host>.trace.json.gz`` per the
    TensorBoard layout, with a recursive fallback for layout drift."""
    pats = [
        os.path.join(profile_dir, "plugins", "profile", "*", "*.trace.json.gz"),
        os.path.join(profile_dir, "plugins", "profile", "*", "*.trace.json"),
    ]
    out: List[str] = []
    for pat in pats:
        out.extend(glob.glob(pat))
    if not out:
        for ext in ("*.trace.json.gz", "*.trace.json"):
            out.extend(
                glob.glob(os.path.join(profile_dir, "**", ext), recursive=True)
            )
    return sorted(set(out))


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """traceEvents of one trace-viewer dump (gzip or plain JSON)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:  # type: ignore[operator]
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    return [ev for ev in events if isinstance(ev, dict)]


#: torch.profiler categories of the card's own activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: the category of the profiler's own window span (the clock anchor)
WINDOW_CATEGORY = "Trace"


def is_device_event(ev: Dict[str, Any]) -> bool:
    """Metadata, a complete event of a device category, or a complete
    event that names no category (a trace-viewer dump's device event);
    plus the profiler's window span, the clock anchor (see the module
    docstring).  Host events of torch's categories are not."""
    ph = ev.get("ph")
    if ph == "M":
        return True
    if ph not in (None, "X"):
        return False
    cat = ev.get("cat")
    return cat is None or cat in DEVICE_CATEGORIES or cat == WINDOW_CATEGORY


def parse_profile_dir(profile_dir: str) -> Dict[str, Any]:
    """Every device event under ``profile_dir``: ``{"events", "files"}``
    (files that fail to parse are skipped and named, not fatal —
    partial device evidence beats none)."""
    events: List[Dict[str, Any]] = []
    files: List[str] = []
    skipped: List[str] = []
    for path in find_trace_files(profile_dir):
        try:
            events.extend(ev for ev in load_trace_events(path) if is_device_event(ev))
            files.append(path)
        except (OSError, ValueError):
            skipped.append(path)
    return {"events": events, "files": files, "skipped": skipped}


# -- clock mapping ----------------------------------------------------------


class ClockMap:
    """profiler-timebase µs -> tracer monotonic µs.

    The anchor: the earliest profiler event is assumed to start at the
    host monotonic instant recorded right after ``start_trace``
    returned.  ``skew_us`` is how far the remapped device events overrun
    the host-side capture window ``[host_start, host_stop]`` — a bounded
    anchor error on a healthy capture, and the failure signal
    ``check_trace --require-device`` gates on."""

    def __init__(self, host_start_ns: int, host_stop_ns: int,
                 device_min_us: float, device_max_us: float):
        self.host_start_us = host_start_ns / 1e3
        self.host_stop_us = host_stop_ns / 1e3
        self.device_min_us = device_min_us
        self.device_max_us = device_max_us
        self.offset_us = self.host_start_us - device_min_us

    def remap(self, ts_us: float) -> float:
        return ts_us + self.offset_us

    @property
    def skew_us(self) -> float:
        device_span = self.device_max_us - self.device_min_us
        host_span = self.host_stop_us - self.host_start_us
        return max(0.0, device_span - host_span)


# -- merge ------------------------------------------------------------------


def merge_host_device(
    tracer,
    device_events: List[Dict[str, Any]],
    clock: Optional[ClockMap],
    tolerance_us: float = DEFAULT_TOLERANCE_US,
    profile_meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One Chrome trace: the tracer's host spans (pid 0) plus the
    profiler's device events remapped onto the host clock, renumbered to
    ``DEVICE_PID_BASE + index`` per source process and metadata-named.
    ``otherData.device_clock`` records the mapping for the validator."""
    doc = to_chrome_trace(tracer)
    events = doc["traceEvents"]

    by_pid: Dict[int, List[Dict[str, Any]]] = {}
    names: Dict[int, str] = {}
    for ev in device_events:
        try:
            pid = int(ev.get("pid", 0) or 0)
        except (TypeError, ValueError):
            continue
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                names[pid] = str((ev.get("args") or {}).get("name", ""))
            continue
        by_pid.setdefault(pid, []).append(ev)

    for idx, src_pid in enumerate(sorted(by_pid)):
        pid = DEVICE_PID_BASE + idx
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": names.get(src_pid) or f"device-{src_pid}"},
            }
        )
        for ev in by_pid[src_pid]:
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            try:
                tid = int(ev.get("tid", 0) or 0)
            except (TypeError, ValueError):
                tid = 0
            out: Dict[str, Any] = {
                "name": str(ev.get("name", "")),
                "cat": str(ev.get("cat", "device")),
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "ts": clock.remap(float(ts)) if clock else float(ts),
            }
            dur = ev.get("dur")
            out["dur"] = float(dur) if isinstance(dur, (int, float)) and dur >= 0 else 0.0
            if isinstance(ev.get("args"), dict):
                out["args"] = ev["args"]
            events.append(out)

    other = doc.setdefault("otherData", {})
    other["device_clock"] = {
        "offset_us": round(clock.offset_us, 3) if clock else 0.0,
        "skew_us": round(clock.skew_us, 3) if clock else 0.0,
        "tolerance_us": tolerance_us,
        "host_window_us": (
            [round(clock.host_start_us, 3), round(clock.host_stop_us, 3)]
            if clock
            else None
        ),
    }
    if profile_meta:
        other["profile"] = profile_meta
    return doc


# -- the capture controller -------------------------------------------------


class _ProfilerOwner:
    """One daemon thread that starts, stops and exports every window's
    ``torch.profiler.profile`` (a torch profiler is stopped only on the
    thread that started it).  ``call`` hands it a command and waits for
    it; the command's exception is raised to the caller."""

    def __init__(self):
        self._commands: "queue.Queue" = queue.Queue()
        self._prof = None
        self._dir: Optional[str] = None
        threading.Thread(target=self._run, daemon=True, name="xprof-profiler").start()

    def _run(self) -> None:
        while True:
            fn, arg, done = self._commands.get()
            try:
                done.put((None, fn(arg)))
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                done.put((e, None))

    def call(self, fn, arg=None):
        done: "queue.Queue" = queue.Queue(maxsize=1)
        self._commands.put((fn, arg, done))
        err, out = done.get()
        if err is not None:
            raise err
        return out

    def start(self, profile_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity

        if self._prof is not None:
            raise RuntimeError("xprof: a profiler window is already open")
        cuda = torch.cuda.is_available()
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        prof.__enter__()
        self._prof, self._dir = prof, profile_dir

    def stop(self, _arg=None) -> str:
        """Stop the open window and export it in the JAX layout; returns
        the file's path."""
        prof, run_dir = self._prof, self._dir
        if prof is None:
            raise RuntimeError("xprof: no profiler window is open")
        self._prof = self._dir = None
        prof.__exit__(None, None, None)
        out = os.path.join(run_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"{socket.gethostname()}.trace.json")
        prof.export_chrome_trace(path)
        return path


_OWNER: Optional[_ProfilerOwner] = None
_OWNER_LOCK = threading.Lock()


def _owner() -> _ProfilerOwner:
    global _OWNER
    with _OWNER_LOCK:
        if _OWNER is None:
            _OWNER = _ProfilerOwner()
        return _OWNER


def _default_start(profile_dir: str) -> None:
    owner = _owner()
    owner.call(owner.start, profile_dir)


def _default_stop() -> None:
    owner = _owner()
    owner.call(owner.stop)


class ProfileCapture:
    """Arm/capture/merge controller for on-demand profile windows.

    ``start_fn(dir)`` / ``stop_fn()`` default to ``torch.profiler``; tests
    and stub pools inject fakes that write synthetic trace-viewer
    fixtures.  All state transitions are lock-guarded: ``notify_flush``
    runs on the event loop, ``_finish`` on a daemon thread, CLI
    arming on arbitrary threads."""

    def __init__(
        self,
        profile_dir: Optional[str] = None,
        *,
        tracer=TRACER,
        start_fn: Optional[Callable[[str], None]] = None,
        stop_fn: Optional[Callable[[], None]] = None,
        metrics=None,
        journal=JOURNAL,
        sample_every: int = 0,
        sample_flushes: int = 2,
        tolerance_us: float = DEFAULT_TOLERANCE_US,
    ):
        self.profile_dir = profile_dir or tempfile.mkdtemp(prefix="lodestar-xprof-")
        self.tracer = tracer
        self.metrics = metrics
        self.journal = journal
        self.sample_every = max(0, int(sample_every))
        self.sample_flushes = max(1, int(sample_flushes))
        self.tolerance_us = tolerance_us
        self._start_fn = start_fn or _default_start
        self._stop_fn = stop_fn or _default_stop
        self._lock = threading.Lock()
        self._state = "idle"  # idle | capturing | finishing
        self._remaining = 0
        self._window_flushes = 0
        self._host_start_ns = 0
        self._flushes_seen = 0
        self.windows = 0
        self.work_seconds = 0.0
        self._started_at = time.monotonic()
        self._last: Optional[Dict[str, Any]] = None
        self._last_error: Optional[str] = None
        self._idle = threading.Event()
        self._idle.set()

    # -- arming -------------------------------------------------------------

    def request_window(self, flushes: int = 2) -> Dict[str, Any]:
        """Arm a capture of the next ``flushes`` pool flushes (starts the
        profiler immediately; a window already open is left running and
        reported, never restarted — a profiler is not reentrant)."""
        t0 = time.perf_counter()
        with self._lock:
            if self._state == "idle":
                self._begin_locked(max(1, int(flushes)))
                armed = True
            else:
                armed = False
            out = {
                "armed": armed,
                "state": self._state,
                "flushes_remaining": self._remaining,
            }
            self.work_seconds += time.perf_counter() - t0
        return out

    def _begin_locked(self, flushes: int) -> None:
        run_dir = os.path.join(self.profile_dir, f"window-{self.windows}")
        self._start_fn(run_dir)
        self._run_dir = run_dir
        self._host_start_ns = time.monotonic_ns()
        self._state = "capturing"
        self._remaining = flushes
        self._window_flushes = flushes
        self._idle.clear()
        if self.journal.enabled:
            self.journal.record("xprof.window_start", flushes=flushes,
                                dir=run_dir)

    def notify_flush(self) -> None:
        """Pool-flush boundary hook (BlsBatchPool._flush).  Cheap when
        idle: one lock round and two integer updates; never raises (the
        flusher must not die for telemetry)."""
        t0 = time.perf_counter()
        try:
            finish = False
            with self._lock:
                self._flushes_seen += 1
                if self._state == "capturing":
                    self._remaining -= 1
                    if self._remaining <= 0:
                        self._state = "finishing"
                        finish = True
                elif (
                    self._state == "idle"
                    and self.sample_every
                    and self._flushes_seen % self.sample_every == 0
                ):
                    self._begin_locked(self.sample_flushes)
                self.work_seconds += time.perf_counter() - t0
            if finish:
                threading.Thread(
                    target=self._finish, daemon=True, name="xprof-finish"
                ).start()
        except Exception:  # noqa: BLE001 — telemetry never kills the flusher
            pass

    def run_window(self, fn: Callable[[], Any], label: str = "window") -> Any:
        """Bracket a blocking callable (the CLI warmup) with one profile
        window, finishing synchronously; returns ``fn()``'s value."""
        with self._lock:
            if self._state != "idle":
                return fn()  # a live window already covers this work
            self._begin_locked(flushes=0)
            self._state = "finishing"
        try:
            return fn()
        finally:
            self._finish(label=label)

    # -- finishing ----------------------------------------------------------

    def _finish(self, label: str = "flush-window") -> None:
        t0 = time.perf_counter()
        host_stop_ns = time.monotonic_ns()
        merged: Optional[Dict[str, Any]] = None
        summary: Dict[str, Any] = {}
        err: Optional[str] = None
        try:
            self._stop_fn()
            parsed = parse_profile_dir(self._run_dir)
            dev = [
                ev
                for ev in parsed["events"]
                if isinstance(ev.get("ts"), (int, float)) and ev.get("ph") != "M"
            ]
            clock = None
            if dev:
                tmin = min(float(e["ts"]) for e in dev)
                tmax = max(
                    float(e["ts"])
                    + (e.get("dur") if isinstance(e.get("dur"), (int, float)) else 0.0)
                    for e in dev
                )
                clock = ClockMap(self._host_start_ns, host_stop_ns, tmin, tmax)
            meta = {
                "label": label,
                "flushes": self._window_flushes,
                "files": [os.path.basename(p) for p in parsed["files"]],
                "device_events": len(dev),
            }
            merged = merge_host_device(
                self.tracer, parsed["events"], clock,
                tolerance_us=self.tolerance_us, profile_meta=meta,
            )
            report = attribution.attribute_spans(
                self.tracer.spans(),
                device_events=[
                    ev for ev in merged["traceEvents"]
                    if isinstance(ev.get("pid"), int)
                    and ev["pid"] >= DEVICE_PID_BASE
                    and ev.get("ph") == "X"
                ],
            )
            breakdown = attribution.mesh_scaling_loss(report["batches"])
            attribution.publish(self.metrics, report, breakdown)
            summary = {
                "label": label,
                "device_events": len(dev),
                "files": parsed["files"],
                "skipped": parsed["skipped"],
                "skew_us": round(clock.skew_us, 3) if clock else 0.0,
                "offset_us": round(clock.offset_us, 3) if clock else 0.0,
                "batches": len(report["batches"]),
                "overlap_ratio": report["overlap_ratio"],
                "scaling_loss": breakdown,
            }
        except Exception as e:  # noqa: BLE001 — fault-isolated like bundles
            err = f"{type(e).__name__}: {e}"
        with self._lock:
            self._state = "idle"
            self.windows += 1
            self._last_error = err
            if merged is not None:
                self._last = {"trace": merged, "summary": summary}
            self.work_seconds += time.perf_counter() - t0
            self._idle.set()
        if self.journal.enabled:
            self.journal.record(
                "xprof.window_done", label=label, error=err,
                batches=summary.get("batches"),
                device_events=summary.get("device_events"),
            )

    def finalize(self) -> Optional[Dict[str, Any]]:
        """Shutdown path: close a still-open window synchronously (its
        partial data is real) and return the last window, if any."""
        with self._lock:
            open_window = self._state == "capturing"
            if open_window:
                self._state = "finishing"
        if open_window:
            self._finish(label="shutdown")
        return self.last_window()

    # -- reading ------------------------------------------------------------

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no window is open/finishing (tests, CLI shutdown)."""
        return self._idle.wait(timeout)

    def last_window(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._last

    def write_merged(self, path: str) -> Optional[str]:
        last = self.last_window()
        if last is None:
            return None
        with open(path, "w") as f:
            json.dump(last["trace"], f)
        return path

    def overhead_ratio(self) -> Optional[float]:
        elapsed = time.monotonic() - self._started_at
        return round(self.work_seconds / elapsed, 6) if elapsed > 0 else None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            last_summary = self._last["summary"] if self._last else None
            return {
                "state": self._state,
                "profile_dir": self.profile_dir,
                "flushes_seen": self._flushes_seen,
                "flushes_remaining": self._remaining,
                "windows": self.windows,
                "sample_every": self.sample_every,
                "overhead_ratio": self.overhead_ratio(),
                "last_error": self._last_error,
                "last_window": last_summary,
            }


#: process-wide capture slot (the CLI wires one in; None until then)
CAPTURE: Optional[ProfileCapture] = None


def configure_capture(**kw) -> ProfileCapture:
    """Create/replace the process-wide ProfileCapture (idle windows of a
    replaced capture are abandoned — the profiler was theirs to stop)."""
    global CAPTURE
    CAPTURE = ProfileCapture(**kw)
    return CAPTURE


def get_capture() -> Optional[ProfileCapture]:
    return CAPTURE


def notify_flush() -> None:
    """Module-level flush hook for BlsBatchPool: constant-time no-op
    until a capture is configured."""
    cap = CAPTURE
    if cap is not None:
        cap.notify_flush()
