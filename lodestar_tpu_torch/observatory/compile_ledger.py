"""Compile ledger: the persistent record of what materializing a program
costs (the port's copy of ``lodestar_tpu/observatory/compile_ledger.py``).

The port has no compiler events to listen to (the JAX ledger rides
``jax.monitoring``); its costs are recorded where they are paid:

- ``build``: nvcc built the kernel library (``ops/kernels/_build.py``);
- ``build_cache``: a library built earlier was loaded from ``build/``;
- ``aot_load``: the durable store (``aot/store.py``) served the library;
- ``capture``: a CUDA graph was made (its eager run, capture and
  instantiation; ``crypto/bls/bucket_program.py``);
- ``hit``: an attribution window in which nothing was noted, the program
  was already live in this process.

**Attribution**: ``attribute(entry, bucket, device)`` wraps a program's
materialization (the verifier's warmup); a cost noted inside
(``note``) lands on the window's key, and a window with none records
``hit``.  Outside any window ``note`` records under the key it is given.
Keys are ``(entry, bucket, device, torch version)``; the entries are the
JAX verifier's labels (``fused_split`` / ``fused_full`` / ``xla_split`` /
``xla_full`` per card, ``sharded_split`` / ``sharded_full`` under the mesh
label ``mesh{n}``) and ``kernels`` for the library (device: the card's
compute capability).

**Persistence**: per-key stats in ``compile_ledger.json``, beside the
kernel libraries it describes (``ops/kernels/_build.py`` configures it
into its build directory at the first library load unless the caller
configured a directory or path first), read-modify-written atomically by
``flush`` after every recorded cost.

**Metrics**: ``lodestar_bls_compile_seconds{entry,kind}`` when a
``metrics.Metrics`` registry is configured.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

LEDGER_FILENAME = "compile_ledger.json"
SCHEMA_VERSION = 1

KINDS = ("build", "build_cache", "aot_load", "capture", "hit")


def _torch_version() -> str:
    try:
        import torch

        return torch.__version__
    except Exception:  # pragma: no cover - torch is the port's runtime
        return "none"


class _Attribution(threading.local):
    """Per-thread current attribution window (a program is made on the
    thread that asked for it, so thread-local is exact)."""

    def __init__(self):
        self.active = False
        self.kind = None
        self.seconds = 0.0
        self.detail: Dict[str, Any] = {}


class CompileLedger:
    """Aggregated build / load / capture / in-process-hit accounting,
    keyed by ``(entry, bucket, device, torch version)``."""

    def __init__(self, path: Optional[str] = None, metrics=None):
        self.enabled = True
        self._path = path
        self.metrics = metrics
        self._lock = threading.Lock()
        self._ctx = _Attribution()
        #: merged view of everything loaded from disk (baseline)
        self._persisted: Dict[str, Dict[str, Any]] = {}
        #: deltas recorded by THIS process since the last flush
        self._session: Dict[str, Dict[str, Any]] = {}
        #: everything THIS process recorded (never cleared by flush)
        self._session_total: Dict[str, Dict[str, Any]] = {}
        # flush is load-merge-replace; one at a time or concurrent
        # flushers lose each other's deltas
        self._flush_lock = threading.Lock()

    # -- configuration -------------------------------------------------------

    @property
    def path(self) -> Optional[str]:
        return self._path

    def configure(self, cache_dir: Optional[str] = None,
                  path: Optional[str] = None, metrics=None) -> "CompileLedger":
        """Point the ledger at its file (``path`` wins over
        ``cache_dir/compile_ledger.json``) and load the on-disk baseline.
        Idempotent."""
        if path is not None:
            self._path = path
        elif cache_dir is not None:
            self._path = os.path.join(cache_dir, LEDGER_FILENAME)
        if metrics is not None:
            self.metrics = metrics
        if self._path:
            with self._lock:
                self._persisted = self._load(self._path)
        return self

    # -- attribution ---------------------------------------------------------

    @contextmanager
    def attribute(self, entry: str, bucket: Optional[int] = None,
                  device: Optional[str] = None):
        """Attribute every cost noted on this thread inside the ``with`` to
        (entry, bucket, device); a window with none records ``hit``."""
        if not self.enabled:
            yield
            return
        ctx = self._ctx
        if ctx.active:  # nested attribution: the outer window owns costs
            yield
            return
        ctx.active, ctx.kind, ctx.seconds, ctx.detail = True, None, 0.0, {}
        try:
            yield
        finally:
            ctx.active = False
            kind = ctx.kind or "hit"
            self.record(entry, bucket, device, kind, ctx.seconds, **ctx.detail)

    def note(self, kind: str, seconds: float, entry: Optional[str] = None,
             bucket: Optional[int] = None, device: Optional[str] = None,
             **detail: Any) -> None:
        """A cost of ``kind``: the current window's, or, outside any
        window, recorded under the given key.  ``detail`` (for a capture,
        its eager, capture and instantiation seconds) rides the journal
        event."""
        if not self.enabled:
            return
        ctx = self._ctx
        if ctx.active:
            ctx.kind = kind
            ctx.seconds += seconds
            ctx.detail.update(detail)
        else:
            self.record(entry or "other", bucket, device, kind, seconds, **detail)

    # -- recording -----------------------------------------------------------

    @staticmethod
    def key(entry: str, bucket: Optional[int], device: Optional[str],
            torch_version: Optional[str] = None) -> str:
        return "|".join((
            entry, f"b{bucket if bucket is not None else '?'}",
            str(device if device is not None else "?"),
            f"torch{torch_version or _torch_version()}",
        ))

    def record(self, entry: str, bucket: Optional[int], device: Optional[str],
               kind: str, seconds: float, **detail: Any) -> None:
        if not self.enabled:
            return
        key = self.key(entry, bucket, device)
        with self._lock:
            for store in (self._session, self._session_total):
                rec = store.setdefault(key, {
                    "entry": entry, "bucket": bucket, "device": device,
                    "torch": _torch_version(), "kinds": {},
                })
                k = rec["kinds"].setdefault(
                    kind, {"count": 0, "total_s": 0.0, "last_s": 0.0, "max_s": 0.0}
                )
                k["count"] += 1
                k["total_s"] = round(k["total_s"] + seconds, 3)
                k["last_s"] = round(seconds, 3)
                k["max_s"] = round(max(k["max_s"], seconds), 3)
                k["last_wall"] = round(time.time(), 3)
        if self.metrics is not None:
            self.metrics.bls_compile_seconds.labels(entry=entry, kind=kind).observe(seconds)
        if kind != "hit":
            # builds, loads and captures are rare and expensive: journal
            # them; in-process hits are counted in the stats only
            from ..forensics.journal import JOURNAL

            JOURNAL.record(
                "compile.ledger", entry=entry, bucket=bucket, device=device,
                compile_kind=kind, seconds=round(seconds, 3),
                **{k: round(v, 3) if isinstance(v, float) else v for k, v in detail.items()},
            )
            self.flush()

    # -- persistence ---------------------------------------------------------

    @staticmethod
    def _load(path: str) -> Dict[str, Dict[str, Any]]:
        try:
            with open(path) as f:
                data = json.load(f)
            if data.get("schema") == SCHEMA_VERSION:
                return data.get("records", {})
        except OSError:
            pass  # no ledger yet: the normal first-run state
        except ValueError as e:
            # a corrupt ledger is survivable (start from empty records)
            # but must be diagnosable
            try:
                from ..forensics.journal import JOURNAL

                JOURNAL.record("cache.corrupt", level="WARNING", path=path,
                               error=str(e)[:200])
            except Exception:
                pass
        return {}

    @staticmethod
    def _merge(base: Dict[str, Dict[str, Any]],
               delta: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
        out = {k: json.loads(json.dumps(v)) for k, v in base.items()}
        for key, rec in delta.items():
            dst = out.setdefault(key, {
                "entry": rec["entry"], "bucket": rec["bucket"],
                "device": rec["device"], "torch": rec["torch"], "kinds": {},
            })
            for kind, s in rec["kinds"].items():
                d = dst["kinds"].setdefault(
                    kind, {"count": 0, "total_s": 0.0, "last_s": 0.0, "max_s": 0.0},
                )
                d["count"] += s["count"]
                d["total_s"] = round(d["total_s"] + s["total_s"], 3)
                d["last_s"] = s["last_s"]
                d["max_s"] = round(max(d["max_s"], s["max_s"]), 3)
                if "last_wall" in s:
                    d["last_wall"] = s["last_wall"]
        return out

    def flush(self) -> Optional[str]:
        """Fold this process's deltas into the on-disk ledger (re-read +
        merge + atomic replace), under one flush lock.  Best-effort:
        persistence trouble never breaks a dispatch."""
        if not self._path:
            return None
        with self._flush_lock:
            with self._lock:
                session, self._session = self._session, {}
            if not session:
                return self._path
            try:
                on_disk = self._load(self._path)
                merged = self._merge(on_disk, session)
                os.makedirs(os.path.dirname(self._path), exist_ok=True)
                tmp = f"{self._path}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"schema": SCHEMA_VERSION, "records": merged}, f)
                os.replace(tmp, self._path)
                with self._lock:
                    self._persisted = merged
            except OSError:
                with self._lock:  # keep the deltas for the next attempt
                    self._session = self._merge(session, self._session)
        return self._path

    # -- reading -------------------------------------------------------------

    def to_dict(self) -> Dict[str, Dict[str, Any]]:
        """Merged view: on-disk baseline + this process's session."""
        with self._lock:
            return self._merge(self._persisted, self._session)

    @staticmethod
    def _by_entry(records: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        by_entry: Dict[str, Dict[str, Any]] = {}
        for rec in records.values():
            e = by_entry.setdefault(rec["entry"], {})
            for kind, s in rec["kinds"].items():
                d = e.setdefault(kind, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                d["count"] += s["count"]
                d["total_s"] = round(d["total_s"] + s["total_s"], 3)
                d["max_s"] = round(max(d["max_s"], s["max_s"]), 3)
        return by_entry

    def session_summary(self) -> Dict[str, Any]:
        """Per-(entry, kind) totals of THIS process's records only."""
        with self._lock:
            session = json.loads(json.dumps(self._session_total))
        return self._by_entry(session)

    def summary(self) -> Dict[str, Any]:
        """Condensed per-(entry, kind) totals of the merged view."""
        records = self.to_dict()
        return {"path": self._path, "keys": len(records), "by_entry": self._by_entry(records)}

    def clear(self) -> None:
        with self._lock:
            self._session = {}
            self._session_total = {}
            self._persisted = {}


#: process-wide singleton
COMPILE_LEDGER = CompileLedger()
