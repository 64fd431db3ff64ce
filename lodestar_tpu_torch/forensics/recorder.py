"""FlightRecorder: the wiring hub of the forensics subsystem (the port's
copy of the JAX package's ``forensics/recorder.py``, without its
``jax.monitoring`` listener and its crash hooks: the signal handlers,
excepthook and faulthandler wait for a runtime that installs them).

One process-wide ``RECORDER`` object owns the configuration (bundle
directory, metrics, pool/verifier references) and the dump triggers:

- ``dump(reason)``            on-demand bundle (the verifier's quarantine
                              bundles, tests)
- watchdog stall              automatic bundle via ``start_watchdog``
"""

from __future__ import annotations

import logging
import os
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
        # reentrant: a dump that triggers another on the same thread
        # (a journal handler, a metric) must not deadlock
        self._dump_lock = threading.RLock()

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
        triggers (watchdog + on-demand) queue rather than interleave.
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


#: process-wide singleton (a node installs it; tests configure+restore)
RECORDER = FlightRecorder()
