"""FlightRecorder: the wiring hub of the forensics subsystem (the port's
copy of the JAX package's ``forensics/recorder.py``, without its
``jax.monitoring`` listener: the port's compile ledger records its
builds and captures itself).

One process-wide ``RECORDER`` object owns the configuration (bundle
directory, metrics, pool/verifier references) and the dump triggers:

- ``dump(reason)``            on-demand bundle (the verifier's quarantine
                              bundles, the pool's overload bundle, tests)
- SIGTERM / SIGUSR2           ``install_signal_handlers`` (SIGUSR2 dumps
                              and continues — the classic "what are you
                              doing right now" poke; SIGTERM dumps, then
                              chains to the previous handler / default
                              so shutdown semantics are unchanged)
- unhandled exception         ``install_excepthook`` (bundle named after
                              the exception type, then the previous hook
                              runs so the traceback still prints)
- hard faults                 ``install_faulthandler`` points the stdlib
                              faulthandler at ``<dir>/faulthandler.log``
                              so segfault-class deaths leave stacks next
                              to the bundles

``install()`` is the one-call CLI entry (``cli.configure_forensics``).
- watchdog stall              automatic bundle via ``start_watchdog``
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import tempfile
import threading
from typing import Any, Dict, List, Optional

from ..tracing import TRACER
from .bundle import prune_bundles, write_bundle
from .journal import JOURNAL
from .watchdog import INFLIGHT, Watchdog

log = logging.getLogger("lodestar_tpu_torch.forensics")

DEFAULT_DIR_ENV = "LODESTAR_TPU_FORENSICS_DIR"


def default_forensics_dir() -> str:
    return os.environ.get(DEFAULT_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "lodestar-tpu-torch-forensics"
    )


class FlightRecorder:
    def __init__(self):
        self.journal = JOURNAL
        self.inflight = INFLIGHT
        self._dir: Optional[str] = None
        self.metrics = None
        self.pool = None
        self.verifier = None
        self.watchdog: Optional[Watchdog] = None
        self.bundles_written = 0
        self.keep_bundles = 16  # dump() prunes the dir beyond this
        # reentrant: a SIGTERM arriving while THIS thread is mid-dump runs
        # the handler on the same frame — a plain Lock would deadlock the
        # shutdown
        self._dump_lock = threading.RLock()
        self._prev_handlers: Dict[int, Any] = {}
        self._prev_excepthook = None
        self._faulthandler_file = None

    # -- configuration -------------------------------------------------------

    @property
    def dir(self) -> str:
        return self._dir or default_forensics_dir()

    def configure(self, forensics_dir: Optional[str] = None, metrics=None,
                  pool=None, verifier=None) -> "FlightRecorder":
        if forensics_dir is not None:
            self._dir = forensics_dir
        if metrics is not None:
            self.metrics = metrics
        if pool is not None:
            self.pool = pool
            if verifier is None:
                verifier = getattr(pool, "verifier", None)
        if verifier is not None:
            self.verifier = verifier
        return self

    def publish_metrics(self) -> None:
        """Refresh the drop-visibility gauges (also set at every pool
        flush — this covers nodes whose pool is idle)."""
        if self.metrics is None:
            return
        self.metrics.tracing_spans_dropped_total.set(TRACER.dropped)
        self.metrics.forensics_journal_dropped_total.set(self.journal.dropped)

    # -- dumping -------------------------------------------------------------

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None,
             metric_reason: Optional[str] = None) -> str:
        """Write one bundle and return its path.  Serialized: concurrent
        triggers (watchdog, signal, on-demand) queue rather than interleave.
        ``metric_reason`` bounds the Prometheus label when ``reason``
        carries variable text (the verifier passes "quarantine" for its
        ``quarantine-<executor>`` bundles)."""
        with self._dump_lock:
            self.publish_metrics()
            path = write_bundle(
                self.dir, reason,
                journal=self.journal, tracer=TRACER, inflight=self.inflight,
                metrics_registry=getattr(self.metrics, "reg", None),
                pool=self.pool, verifier=self.verifier, extra=extra,
            )
            self.bundles_written += 1
            if self.metrics is not None:
                self.metrics.forensics_bundles_written_total.labels(
                    reason=metric_reason or reason
                ).inc()
            self.journal.record("forensics.bundle", reason=reason, path=path)
            log.warning("forensics bundle (%s) -> %s", reason, path)
            # bounded disk: repeated triggers (watchdog storms) must never
            # fill the volume the node runs on
            prune_bundles(self.dir, self.keep_bundles)
            return path

    # -- watchdog ------------------------------------------------------------

    def start_watchdog(self, deadline_s: float,
                       interval_s: Optional[float] = None) -> Watchdog:
        if self.watchdog is not None:
            self.watchdog.stop()

        def on_stall(entries: List[Dict[str, Any]]) -> None:
            self.dump("watchdog", extra={"watchdog_stalled": entries})

        self.watchdog = Watchdog(
            deadline_s=deadline_s, interval_s=interval_s,
            inflight=self.inflight, journal=self.journal,
            metrics=self.metrics, on_stall=on_stall,
        )
        return self.watchdog.start()

    def stop_watchdog(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()

    # -- crash triggers ------------------------------------------------------

    def install_signal_handlers(self, signals=(signal.SIGTERM, signal.SIGUSR2)) -> None:
        """Main-thread only (signal module requirement).  SIGUSR2: dump
        and keep running.  Anything else (SIGTERM): dump, then chain to
        the previous disposition so the process still dies."""
        for signum in signals:
            prev = signal.getsignal(signum)
            self._prev_handlers[signum] = prev

            def handler(num, frame, _prev=prev):
                try:
                    self.dump(signal.Signals(num).name.lower())
                except Exception:
                    pass
                if num == signal.SIGUSR2:
                    return
                if _prev is signal.SIG_IGN:
                    # the process ignored this signal before we hooked it;
                    # dumping must not change that survival semantic
                    return
                if callable(_prev) and _prev is not signal.SIG_DFL:
                    _prev(num, frame)
                else:
                    signal.signal(num, signal.SIG_DFL)
                    os.kill(os.getpid(), num)

            signal.signal(signum, handler)

    def uninstall_signal_handlers(self) -> None:
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()

    def install_excepthook(self) -> None:
        if self._prev_excepthook is not None:
            return
        self._prev_excepthook = sys.excepthook

        def hook(exc_type, exc, tb):
            try:
                self.journal.record(
                    "crash", level="CRITICAL",
                    exc=f"{exc_type.__name__}: {exc}",
                )
                self.dump(f"crash-{exc_type.__name__}")
            except Exception:
                pass
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = hook

    def install_faulthandler(self) -> Optional[str]:
        import faulthandler

        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, "faulthandler.log")
            self._faulthandler_file = open(path, "a")
            faulthandler.enable(file=self._faulthandler_file)
            return path
        except OSError:
            return None

    def install(self, watchdog_deadline_s: Optional[float] = None) -> "FlightRecorder":
        """The CLI's one call: crash hooks, signal handlers, faulthandler,
        and (optionally) the watchdog.  The JAX recorder's
        ``install_jax_monitoring`` has no counterpart: the port's compile
        ledger (``observatory.COMPILE_LEDGER``) records every build, load
        and capture itself."""
        self.install_excepthook()
        self.install_faulthandler()
        try:
            self.install_signal_handlers()
        except ValueError:
            pass  # not the main thread; crash hooks still active
        if watchdog_deadline_s:
            self.start_watchdog(watchdog_deadline_s)
        self.journal.record("forensics.installed", dir=self.dir,
                            watchdog_deadline_s=watchdog_deadline_s)
        return self


#: process-wide singleton (the CLI installs it; tests configure+restore)
RECORDER = FlightRecorder()
