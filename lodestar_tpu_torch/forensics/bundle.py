"""Diagnostic bundle writer: one directory that answers "what was this
node doing when it died" (the port's copy of the JAX package's
``forensics/bundle.py``, same layout and manifest schema).

A bundle is written on demand (``RECORDER.dump``), on a watchdog stall,
when an executor enters quarantine, on SIGTERM/SIGUSR2 and on an
unhandled exception once the recorder's hooks are installed.  Layout
(``tools/inspect_bundle.py`` validates and summarizes it):

    bundle-<reason>-<pid>-<seq>/
      manifest.json    schema, reason, wall time, file list, counts,
                       stalled-batch table (written LAST — a manifest
                       implies every listed file landed)
      journal.jsonl    event-journal tail, one JSON object per line
      trace.json       Chrome trace-event dump of the span tracer
      inflight.json    in-flight batch table + per-executor counts, the
                       executors' health + verifier/pool counters
      metrics.prom     Prometheus text exposition (when a registry is wired)
      topology.json    the cards torch sees (only when CUDA is already
                       initialized — a crash path must never initialize
                       it)
      profile.json     the profiler window's capture state: open/last
                       window, attribution summary, measured overhead
      config.json      argv, python/torch versions, LODESTAR*/TORCH*/CUDA*
                       env

Every section is individually fault-isolated: a broken producer records
an error string in the manifest instead of aborting the dump — partial
evidence beats none, and the writer must be safe to call from signal
handlers and excepthooks.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from ..chaos import CHAOS
from ..tracing import TRACER, to_chrome_trace
from .journal import JOURNAL
from .watchdog import INFLIGHT

BUNDLE_SCHEMA = 1
MANIFEST_NAME = "manifest.json"

_SEQ = itertools.count()


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=str)


def _pool_stats(pool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for attr in ("inflight_peak", "pipeline_depth", "batch_retries",
                 "batch_sets_success"):
        if hasattr(pool, attr):
            out[attr] = getattr(pool, attr)
    if hasattr(pool, "pending_sets"):
        out["pending_sets"] = pool.pending_sets()
    return out


def _verifier_stats(verifier) -> Dict[str, Any]:
    """The verifier's counters (those it has: the port's has no fallback
    counters), in-flight batches per executor and the executors' health."""
    out: Dict[str, Any] = {"type": type(verifier).__name__}
    for attr in ("dispatches", "sets_verified", "fused_fallbacks",
                 "pack_rejected", "n_devices", "batches_requeued",
                 "native_fallbacks", "sharded_batches", "host_final_exps"):
        if hasattr(verifier, attr):
            out[attr] = getattr(verifier, attr)
    if hasattr(verifier, "device_inflight"):
        out["device_inflight"] = verifier.device_inflight()
    if hasattr(verifier, "executor_health"):
        # the health state machine — the chaos triage section of
        # tools/inspect_bundle.py reads this
        out["health"] = verifier.executor_health()
    if hasattr(verifier, "stage_seconds"):
        out["stage_seconds"] = {
            k: round(v, 4) for k, v in dict(verifier.stage_seconds).items()
        }
    return out


def _topology() -> Dict[str, Any]:
    """The cards torch sees, WITHOUT initializing CUDA: before anything in
    the process has, this reports that instead of paying for (or hanging
    in) a CUDA initialization inside a crash path."""
    out: Dict[str, Any] = {
        "torch_imported": "torch" in sys.modules,
        "env_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
    }
    if "torch" not in sys.modules:
        return out
    try:
        import torch

        out["torch_version"] = torch.__version__
        out["cuda_version"] = torch.version.cuda
        out["cuda_initialized"] = torch.cuda.is_initialized()
        if out["cuda_initialized"]:
            out["devices"] = [
                {"id": i, "platform": "cuda", "kind": torch.cuda.get_device_name(i)}
                for i in range(torch.cuda.device_count())
            ]
    except Exception as e:  # noqa: BLE001
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _profile_state() -> Dict[str, Any]:
    """The profiler window's capture state: whether a profile window is
    open, the last window's summary (batch attribution + scaling loss),
    and the capture's measured overhead — lazy import so a crash path
    never pays for (or dies in) the observatory package."""
    from ..observatory.xprof import get_capture

    cap = get_capture()
    if cap is None:
        return {"configured": False}
    out: Dict[str, Any] = {"configured": True}
    out.update(cap.snapshot())
    return out


def _config() -> Dict[str, Any]:
    env = {
        k: v for k, v in sorted(os.environ.items())
        if k.startswith(("LODESTAR", "TORCH", "CUDA"))
    }
    out: Dict[str, Any] = {
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "cwd": os.getcwd(),
        "env": env,
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        out["torch"] = getattr(torch, "__version__", None)
    return out


def write_bundle(
    base_dir: str,
    reason: str,
    *,
    journal=JOURNAL,
    tracer=TRACER,
    inflight=INFLIGHT,
    metrics_registry=None,
    pool=None,
    verifier=None,
    extra: Optional[Dict[str, Any]] = None,
    journal_tail: int = 2048,
) -> str:
    """Write one diagnostic bundle under ``base_dir`` and return its
    directory path.  Never raises past directory creation — per-section
    failures land in ``manifest["errors"]``."""
    reason_slug = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)
    name = f"bundle-{reason_slug}-{os.getpid()}-{next(_SEQ)}"
    path = os.path.join(base_dir, name)
    os.makedirs(path, exist_ok=True)

    files: List[str] = []
    errors: Dict[str, str] = {}

    def section(fname: str, producer) -> None:
        try:
            # chaos seam: an armed plan can fail any section's IO — the
            # per-section isolation below is exactly what it exercises
            if CHAOS.armed:
                CHAOS.maybe_raise("forensics.io", section=fname)
            producer(os.path.join(path, fname))
            files.append(fname)
        except Exception as e:  # noqa: BLE001
            errors[fname] = f"{type(e).__name__}: {e}"

    section("journal.jsonl",
            lambda p: open(p, "w").write(journal.to_jsonl(journal_tail)))
    section("trace.json", lambda p: _write_json(p, to_chrome_trace(tracer)))
    inflight_snapshot = inflight.snapshot()
    section(
        "inflight.json",
        lambda p: _write_json(p, {
            "inflight": inflight_snapshot,
            "pool": _pool_stats(pool) if pool is not None else None,
            "verifier": _verifier_stats(verifier) if verifier is not None else None,
        }),
    )
    if metrics_registry is not None:
        section("metrics.prom",
                lambda p: open(p, "wb").write(metrics_registry.expose()))
    section("topology.json", lambda p: _write_json(p, _topology()))
    section("profile.json", lambda p: _write_json(p, _profile_state()))
    section("config.json", lambda p: _write_json(p, _config()))

    manifest: Dict[str, Any] = {
        "schema": BUNDLE_SCHEMA,
        "reason": reason,
        "created_unix": round(time.time(), 3),
        "pid": os.getpid(),
        "files": files,
        "journal": {"events": len(journal), "dropped": journal.dropped,
                    "capacity": journal.capacity},
        "trace": {"spans": len(tracer), "dropped": tracer.dropped,
                  "enabled": tracer.enabled},
        "inflight": inflight_snapshot,
        "stalled": [e for e in inflight_snapshot if e.get("stalled")],
    }
    if CHAOS.armed or CHAOS.injected:
        # an armed (or previously-fired) fault plan is evidence: the
        # bundle must say which faults were induced, with which seed
        manifest["chaos"] = CHAOS.state()
    if extra:
        manifest.update(extra)
    if errors:
        manifest["errors"] = errors
    # manifest last: its presence marks the bundle complete/consistent
    _write_json(os.path.join(path, MANIFEST_NAME), manifest)
    return path


def prune_bundles(base_dir: str, keep: int) -> None:
    """Drop the oldest ``bundle-*`` directories beyond ``keep`` (so
    repeated triggers don't fill the scratch disk)."""
    try:
        entries = [
            os.path.join(base_dir, n)
            for n in os.listdir(base_dir)
            if n.startswith("bundle-") and os.path.isdir(os.path.join(base_dir, n))
        ]
    except OSError:
        return
    entries.sort(key=lambda p: os.path.getmtime(p), reverse=True)
    for stale in entries[keep:]:
        try:
            for fname in os.listdir(stale):
                os.unlink(os.path.join(stale, fname))
            os.rmdir(stale)
        except OSError:
            pass


def latest_bundle(base_dir: str, pid: Optional[int] = None) -> Optional[str]:
    """Newest bundle under ``base_dir`` that has a complete manifest.
    ``pid`` scopes the search to bundles written by that process, so a
    stale bundle from a previous run is never attributed to this one."""
    try:
        candidates = [
            os.path.join(base_dir, n)
            for n in os.listdir(base_dir)
            if n.startswith("bundle-")
        ]
    except OSError:
        return None
    best: Optional[str] = None
    best_mtime = -1.0
    for cand in candidates:
        manifest = os.path.join(cand, MANIFEST_NAME)
        try:
            with open(manifest) as f:
                meta = json.load(f)
            mtime = os.path.getmtime(manifest)
        except (OSError, ValueError):
            continue
        if pid is not None and meta.get("pid") != pid:
            continue
        if mtime > best_mtime:
            best, best_mtime = cand, mtime
    return best
