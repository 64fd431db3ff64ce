"""The port's command-line part: the BLS verifier's flags, the verifier and
pool they make, and the observability they turn on (the port's copy of
the BLS and observability part of the JAX package's ``cli.py``).

``add_bls_flags(parser)`` adds the JAX CLI's verifier, pool, tracing,
forensics, profile and telemetry flags under their names and defaults,
with three changes: the ``--bls-verifier`` choice ``tpu`` is ``torch``,
``--jax-profile`` is ``--torch-profile``, and ``--bls-cache-dir`` (the
JAX compilation cache) is gone.  A node's commands (``dev``, ``beacon``,
``validator``) wait for the chain modules they drive; a program that
verifies signature sets builds on these helpers::

    ap = argparse.ArgumentParser(); add_bls_flags(ap); args = ap.parse_args()
    configure_tracing(args)
    pool = make_pool(args, metrics=metrics)
    configure_forensics(args, metrics=metrics, pool=pool)
    ...
    finalize_profile(args); dump_trace(args.trace_dump)

``make_verifier`` never falls back: ``auto`` and ``torch`` make
``TorchBlsVerifier`` on the card and raise when there is none (the JAX
CLI's ``auto`` takes the native verifier off a TPU), ``native`` and
``python`` are explicit choices, and a ``load_only`` warmup that the
store cannot serve raises ``AotStoreMiss``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

logger = logging.getLogger(__name__)


def add_bls_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX CLI's BLS and observability flags (see the module
    docstring for the three changes); returns ``p``."""
    p.add_argument(
        "--bls-verifier",
        choices=("auto", "torch", "native", "python"),
        default="auto",
        help="signature verifier backend (auto and torch: the batched CUDA "
        "verifier on the card, an error without one; native: the C "
        "verifier; python: the bigint oracle)",
    )
    p.add_argument(
        "--bls-buckets", default="4,16,64,128,256",
        help="padding bucket sizes for the batched dispatch "
        "(comma-separated; one CUDA graph per bucket)",
    )
    p.add_argument(
        "--bls-pipeline-depth", type=int, default=2,
        help="merged batches kept in flight on the device pipeline "
        "(pack N+1 while N computes and N-1 finishes on the host)",
    )
    p.add_argument(
        "--bls-flush-threshold", type=int, default=128,
        help="buffered signature sets that trigger an immediate flush",
    )
    p.add_argument(
        "--bls-buffer-wait-ms", type=float, default=20.0,
        help="max time a batchable job waits to share a dispatch "
        "(MAX_BUFFER_WAIT_MS analog)",
    )
    p.add_argument(
        "--bls-warmup", choices=("background", "blocking", "off"),
        default="background",
        help="make every bucket's CUDA graph at startup so the first "
        "block import does not pay for it",
    )
    p.add_argument(
        "--bls-fused", choices=("auto", "on", "off"), default="auto",
        help="the fused program (auto and on: the fused program; off: the "
        "XLA-graph program)",
    )
    p.add_argument(
        "--bls-sharded", choices=("auto", "on", "off"), default="auto",
        help="the sharded tier: merged batches at the bucket ladder's top "
        "end ride one batch split over every --bls-devices executor, "
        "final exponentiation once per batch (auto: "
        "LODESTAR_TPU_SHARDED, else off)",
    )
    p.add_argument(
        "--bls-sharded-min-batch", type=int, default=0,
        help="smallest merged batch the sharded tier takes "
        "(0 = the largest --bls-buckets entry)",
    )
    p.add_argument(
        "--bls-aot-store", default=None, metavar="DIR",
        help="durable store of built kernel libraries, kept across "
        "restarts (default: $LODESTAR_TPU_TORCH_AOT_STORE, else off)",
    )
    p.add_argument(
        "--bls-warmup-load-only", action="store_true",
        help="rolling-restart mode: warmup never builds — the kernel "
        "library comes from the store, or the warmup raises AotStoreMiss "
        "(forces a blocking warmup)",
    )
    p.add_argument(
        "--bls-devices", type=int, default=1,
        help="device executors in the BLS pool: 1 = one card (default), "
        "N = the first N cards, 0 = every card; the scheduler places "
        "whole merged batches least-loaded",
    )
    p.add_argument(
        "--bls-max-queue-length", type=int, default=8192,
        help="verification jobs the pool queue holds before the overflow "
        "policy evicts the oldest job of the lowest QoS lane",
    )
    p.add_argument(
        "--bls-high-water", type=int, default=0,
        help="pending signature sets that flip the pool into backpressure "
        "(released at half).  0 = half of --bls-max-queue-length",
    )
    p.add_argument(
        "--bls-overload-bundle-threshold", type=int, default=256,
        help="shed sets within a 10s window that trigger ONE rate-limited "
        "'overload' diagnostic bundle with per-lane shed counts "
        "(0 disables)",
    )
    p.add_argument(
        "--bls-point-cache-size", type=int, default=8192,
        help="entries in the pack-stage LRU of decompressed/affine points "
        "keyed by compressed bytes (0 disables)",
    )
    p.add_argument(
        "--bls-quarantine-threshold", type=int, default=2,
        help="consecutive verdict/dispatch failures on one device executor "
        "before it is quarantined out of the placement rotation",
    )
    p.add_argument(
        "--bls-quarantine-backoff-s", type=float, default=1.0,
        help="first quarantine duration; a failed re-admission probe "
        "doubles it (capped at 60s), a successful probe resets it",
    )
    p.add_argument(
        "--trace-dump", default=None, metavar="PATH",
        help="enable hot-path span tracing and write a Chrome trace-event "
        "JSON (open in Perfetto / chrome://tracing) to PATH on shutdown",
    )
    p.add_argument(
        "--trace-buffer-size", type=int, default=8192,
        help="span ring-buffer capacity when tracing is enabled "
        "(old spans are evicted, never accumulated)",
    )
    p.add_argument(
        "--torch-profile", default=None, metavar="DIR",
        help="device-profile capture root: torch.profiler brackets the "
        "(blocking) BLS warmup AND a steady-state dispatch window "
        "(--profile-window flushes, default 4), and the merged host+device "
        "Chrome trace lands in DIR/merged_trace.json on shutdown",
    )
    p.add_argument(
        "--profile-window", type=int, default=0, metavar="N",
        help="arm a device-profile window over the next N BLS pool flushes "
        "at startup (0 = none; with --torch-profile the default becomes 4)",
    )
    p.add_argument(
        "--forensics-dir", default=None, metavar="DIR",
        help="diagnostic bundle directory (default: "
        "$LODESTAR_TPU_FORENSICS_DIR or <tmp>/lodestar-tpu-torch-forensics); "
        "bundles are written on crash, SIGTERM/SIGUSR2, watchdog stall, "
        "quarantine and overload",
    )
    p.add_argument(
        "--watchdog-deadline-s", type=float, default=30.0,
        help="flag any dispatched BLS batch still unresolved after this many "
        "seconds: journal ERROR + bls_watchdog_stalls_total{device} + one "
        "automatic bundle (0 disables the watchdog)",
    )
    p.add_argument(
        "--log-format", choices=("text", "json"), default=None,
        help="stderr log line format; json emits one object per line "
        "stamped with the batch correlation id (default: text)",
    )
    p.add_argument(
        "--telemetry-interval-s", type=float, default=5.0,
        help="device telemetry sampler period: per-executor card memory "
        "and busy-ratio gauges + periodic journal events (0 disables; runs "
        "only with the torch verifier)",
    )
    return p


# -- the verifier and the pool ------------------------------------------------


def _buckets(args):
    return tuple(int(b) for b in str(getattr(args, "bls_buckets", "4,16,64,128,256")).split(",")
                 if b)


def _devices(n_dev: int, device):
    """``--bls-devices`` as the verifier's ``devices`` (None: one
    executor on ``device``): the first n cards, or every card for 0; on
    the CPU (``device="cpu"``, the tests) n logical CPU executors."""
    if n_dev < 0:
        raise SystemExit(f"--bls-devices: expected 0 (all) or a positive count, got {n_dev}")
    if n_dev == 1:
        return None
    import torch

    if torch.device(device).type == "cpu":
        return ["cpu"] * max(1, n_dev)
    local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = local if n_dev == 0 else local[:n_dev]
    logger.info("bls executor pool: %d of %d cards", len(devices), len(local))
    return devices


def make_verifier(args, device=None):
    """The verifier selection seam (the JAX CLI's ``_make_verifier``):
    ``auto`` and ``torch`` give ``TorchBlsVerifier`` on the card (on
    ``device`` when given: the tests pass ``"cpu"``) and raise when there
    is none; ``native`` gives ``FastBlsVerifier`` and ``python`` the
    oracle.  Nothing falls back.  The warmup follows ``--bls-warmup``;
    ``--torch-profile`` brackets it with one profile window (and makes it
    blocking), and a ``--bls-warmup-load-only`` warmup raises
    ``AotStoreMiss`` when the store cannot serve the library."""
    choice = getattr(args, "bls_verifier", "auto")
    if choice in ("auto", "torch"):
        from .aot import AOT_STORE
        from .crypto.bls.torch_verifier import TorchBlsVerifier

        aot_path = getattr(args, "bls_aot_store", None)
        aot_store = AOT_STORE.configure(aot_path) if aot_path else None
        load_only = bool(getattr(args, "bls_warmup_load_only", False))
        buckets = _buckets(args)
        fused = getattr(args, "bls_fused", "auto") != "off"
        sharded_flag = getattr(args, "bls_sharded", "auto")
        sharded = None if sharded_flag == "auto" else sharded_flag == "on"
        v = TorchBlsVerifier(
            device="cuda" if device is None else device,
            buckets=buckets, fused=fused,
            devices=_devices(getattr(args, "bls_devices", 1),
                             "cuda" if device is None else device),
            sharded=sharded,
            sharded_min_batch=getattr(args, "bls_sharded_min_batch", 0) or None,
            point_cache_size=getattr(args, "bls_point_cache_size", 8192),
            quarantine_threshold=getattr(args, "bls_quarantine_threshold", 2),
            quarantine_backoff_s=getattr(args, "bls_quarantine_backoff_s", 1.0),
            aot_store=aot_store,
            load_only=load_only,
        )
        warm = getattr(args, "bls_warmup", "background")
        profile_dir = getattr(args, "torch_profile", None)
        capture = None
        if profile_dir:
            # one ProfileCapture owns the session: the warmup window here,
            # the steady-state window configure_profile arms, all merged
            # against the span tracer's clock
            from .observatory import xprof

            capture = xprof.configure_capture(profile_dir=profile_dir)
        if load_only and warm != "off":
            # a load-only warmup decides whether the node can serve: block
            if capture is not None:
                dt = capture.run_window(lambda: v.warmup(load_only=True), label="warmup-load")
            else:
                dt = v.warmup(load_only=True)
            logger.info("bls load-only warmup: %d buckets in %.1fs", len(buckets), dt)
        elif capture is not None and warm != "off":
            # a device profile of the graphs' making and first runs; the
            # warmup blocks so that the window closes on real work
            dt = capture.run_window(v.warmup, label="warmup")
            logger.info("bls warmup under torch.profiler: %d buckets in %.1fs -> %s",
                        len(buckets), dt, profile_dir)
        elif warm == "blocking":
            dt = v.warmup()
            logger.info("bls warmup: %d buckets in %.1fs", len(buckets), dt)
        elif warm == "background":
            v.warmup_async()
        logger.info("bls verifier: batched CUDA verifier (host final exp)")
        return v
    if choice == "native":
        from .crypto.bls.native_verifier import FastBlsVerifier

        logger.info("bls verifier: native C (native/fastbls.c)")
        return FastBlsVerifier()
    if choice == "python":
        from .crypto.bls.verifier import PyBlsVerifier

        logger.info("bls verifier: pure-python oracle")
        return PyBlsVerifier()
    raise SystemExit(f"--bls-verifier: unknown choice {choice!r}")


def make_pool(args, metrics=None, device=None):
    """Verifier + batch pool with the pipeline's and the overload
    policy's flags applied."""
    from .chain.bls_pool import BlsBatchPool

    return BlsBatchPool(
        make_verifier(args, device=device),
        max_buffer_wait=getattr(args, "bls_buffer_wait_ms", 20.0) / 1e3,
        flush_threshold=getattr(args, "bls_flush_threshold", 128),
        pipeline_depth=getattr(args, "bls_pipeline_depth", 2),
        max_queue_length=getattr(args, "bls_max_queue_length", 8192),
        high_water=getattr(args, "bls_high_water", 0) or None,
        overload_shed_threshold=getattr(args, "bls_overload_bundle_threshold", 256),
        metrics=metrics,
    )


# -- observability --------------------------------------------------------------


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts (unix seconds), level, logger, msg,
    cid in a batch context, exc on exceptions (the JAX logger's
    ``--log-format json``)."""

    def format(self, record: logging.LogRecord) -> str:
        from .tracing import current_batch_id

        out = {"ts": round(record.created, 3), "level": record.levelname,
               "logger": record.name, "msg": record.getMessage()}
        cid = current_batch_id()
        if cid is not None:
            out["cid"] = cid
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def _set_log_format(fmt: str) -> None:
    """The port's loggers to stderr, one line a record, as text or JSON."""
    log = logging.getLogger("lodestar_tpu_torch")
    handler = next((h for h in log.handlers if getattr(h, "_lodestar_stderr", False)), None)
    if handler is None:
        handler = logging.StreamHandler(sys.stderr)
        handler._lodestar_stderr = True
        log.addHandler(handler)
        if log.level == logging.NOTSET:
            log.setLevel(logging.INFO)
    handler.setFormatter(JsonFormatter() if fmt == "json" else logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))


def configure_tracing(args) -> None:
    """Enable the span tracer when --trace-dump asks for it.  Called
    before the pool is built so that the warmup and the first dispatches
    land in the buffer."""
    dump = getattr(args, "trace_dump", None)
    if dump:
        from . import tracing

        tracing.enable(getattr(args, "trace_buffer_size", 8192))
        logger.info("span tracing on (buffer %d); dump -> %s", tracing.TRACER.capacity, dump)


def configure_forensics(args, metrics=None, pool=None) -> None:
    """Flight-recorder bring-up: log format, bundle directory, crash and
    signal hooks, faulthandler, the in-flight stall watchdog, then the
    observatory (``configure_observatory``)."""
    from .forensics import RECORDER

    fmt = getattr(args, "log_format", None)
    if fmt:
        _set_log_format(fmt)
    RECORDER.configure(forensics_dir=getattr(args, "forensics_dir", None),
                       metrics=metrics, pool=pool)
    deadline = getattr(args, "watchdog_deadline_s", 30.0)
    RECORDER.install(watchdog_deadline_s=deadline if deadline > 0 else None)
    logger.info("flight recorder on: bundles -> %s (watchdog %s)", RECORDER.dir,
                f"{deadline:.1f}s" if deadline > 0 else "off")
    configure_observatory(args, metrics=metrics, pool=pool)


def configure_observatory(args, metrics=None, pool=None) -> None:
    """Performance-observatory bring-up: hand the compile ledger its
    metrics registry and start the device telemetry sampler over the
    verifier's executors (only when the verifier drives cards: a native
    or python run has none), then the profile window
    (``configure_profile``)."""
    from .observatory import COMPILE_LEDGER, start_sampler

    if metrics is not None:
        COMPILE_LEDGER.configure(metrics=metrics)
    interval = getattr(args, "telemetry_interval_s", 5.0)
    verifier = getattr(pool, "verifier", None)
    if interval and interval > 0 and hasattr(verifier, "_executors"):
        start_sampler(interval_s=interval, metrics=metrics, executors=verifier._executors)
        logger.info("device telemetry sampler on (every %.1fs)", interval)
    configure_profile(args, metrics=metrics)


def configure_profile(args, metrics=None) -> None:
    """Steady-state profile-window bring-up: --torch-profile alone arms a
    4-flush window; --profile-window N sets the count and also works
    alone (the capture directory under the temporary default)."""
    from .observatory import xprof

    profile_dir = getattr(args, "torch_profile", None)
    window = getattr(args, "profile_window", 0) or (4 if profile_dir else 0)
    if not profile_dir and not window:
        return
    cap = xprof.get_capture()  # make_verifier may have configured it
    if cap is None:
        cap = xprof.configure_capture(profile_dir=profile_dir, metrics=metrics)
    else:
        cap.metrics = metrics
    if window:
        cap.request_window(window)
        logger.info("profile window armed: next %d pool flushes -> %s", window,
                    cap.profile_dir)


def finalize_profile(args) -> Optional[str]:
    """Shutdown: close a still-open window and write the merged
    host+device Chrome trace to ``<profile dir>/merged_trace.json``;
    returns its path (None when no window was captured)."""
    if not (getattr(args, "torch_profile", None) or getattr(args, "profile_window", 0)):
        return None
    from .observatory import xprof

    cap = xprof.get_capture()
    if cap is None:
        return None
    cap.wait_idle(timeout=10.0)
    if cap.finalize() is None:
        return None
    path = cap.write_merged(os.path.join(cap.profile_dir, "merged_trace.json"))
    logger.info("wrote merged host+device trace to %s", path)
    return path


def dump_trace(path) -> None:
    if not path:
        return
    from . import tracing

    tracing.write_chrome_trace(tracing.TRACER, path)
    logger.info("wrote %d spans (%d dropped) to %s", len(tracing.TRACER),
                tracing.TRACER.dropped, path)
