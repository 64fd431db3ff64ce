"""Stage salvage: heartbeat bundles from spawn children (the port's copy
of the JAX package's ``forensics/salvage.py``).

A harness that runs a stage in a child process with a hard wall-clock
bound SIGKILLs the child on timeout, and all evidence dies with it.  The
fix is a heartbeat: each stage child periodically snapshots a diagnostic
bundle to a scratch directory keyed by stage name, keeping only the
newest few, and the parent reads the last-known bundle back (matched by
the child's pid) when the stage dies.  ``python -m
lodestar_tpu_torch.tools.inspect_bundle`` then answers what the child was
doing — last build or capture event, in-flight batches, last errors —
instead of nothing.

The JAX heartbeat also installs a ``jax.monitoring`` listener; the port
has none, so its heartbeat journals only ``bench.stage_start``: the
compile ledger already journals the port's library builds and graph
captures.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Optional

from . import bundle as bundle_mod
from .journal import JOURNAL

BASE_DIR_ENV = "BENCH_FORENSICS_DIR"
INTERVAL_ENV = "BENCH_HEARTBEAT_S"
DEFAULT_INTERVAL_S = 5.0
KEEP_BUNDLES = 2


def base_dir() -> str:
    return os.environ.get(BASE_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "lodestar-tpu-forensics", "bench"
    )


def stage_dir(stage: str) -> str:
    safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in stage)
    return os.path.join(base_dir(), safe)


class Heartbeat:
    """Daemon thread writing a bundle snapshot for one stage every
    ``interval_s`` (first snapshot immediately, so even a fast-dying
    child leaves evidence)."""

    def __init__(self, stage: str, interval_s: Optional[float] = None):
        self.stage = stage
        self.dir = stage_dir(stage)
        if interval_s is None:
            interval_s = float(os.environ.get(INTERVAL_ENV, DEFAULT_INTERVAL_S))
        self.interval_s = max(0.05, interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> Optional[str]:
        try:
            path = bundle_mod.write_bundle(
                self.dir, "heartbeat", journal=JOURNAL,
                extra={"stage": self.stage},
            )
            bundle_mod.prune_bundles(self.dir, KEEP_BUNDLES)
            return path
        except OSError:
            return None

    def _run(self) -> None:
        self.beat()
        while not self._stop.wait(self.interval_s):
            self.beat()

    def start(self) -> "Heartbeat":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"forensics-heartbeat-{self.stage}",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)


def start_heartbeat(stage: str, interval_s: Optional[float] = None) -> Heartbeat:
    """Child-side entry: journal the stage's start and start the snapshot
    loop.  Never raises — a broken scratch disk must not fail the stage
    it is trying to protect."""
    JOURNAL.record("bench.stage_start", stage=stage, pid=os.getpid())
    hb = Heartbeat(stage, interval_s)
    try:
        return hb.start()
    except Exception:
        return hb


def latest_stage_bundle(stage: str, pid: Optional[int] = None) -> Optional[str]:
    """Parent-side reader: newest complete bundle the (possibly dead)
    child left for this stage, or None.  Pass the child's ``pid`` so a
    child killed before its first heartbeat (e.g. wedged inside the torch
    import) yields None rather than a stale bundle from a previous run
    being mis-attributed to this failure."""
    return bundle_mod.latest_bundle(stage_dir(stage), pid=pid)
