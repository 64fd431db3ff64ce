"""The port's command line: the node's ``dev`` and ``beacon`` commands,
the ``validator`` client, the ``lightclient``, keystore management
(``account create|list``) and ``init`` (an rc file of flag values), and
the BLS verifier's flags, the verifier and pool they make, and the
observability they turn on (the port's copy of the JAX package's
``cli.py``).

Entry: ``python -m lodestar_tpu_torch.cli <cmd> [flags]``.  ``dev`` and
``beacon`` verify through ``BlsBatchPool`` over ``TorchBlsVerifier`` on
the card by default; ``--bls-verifier native`` runs them on the host's C
verifier.  ``validator`` and ``lightclient`` talk to a node over its REST
API, and a ``validator``'s duties are verified by that node's verifier.

``add_bls_flags(parser)`` adds the JAX CLI's verifier, pool, tracing,
forensics, profile and telemetry flags under their names and defaults,
with three changes: the ``--bls-verifier`` choice ``tpu`` is ``torch``,
``--jax-profile`` is ``--torch-profile``, and ``--bls-cache-dir`` (the
JAX compilation cache) is gone.  A program that verifies signature sets
builds on these helpers, as the node's commands do::

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
import asyncio
import json
import logging
import os
import sys
from typing import Optional

logger = logging.getLogger("lodestar_tpu_torch.cli")


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
    if getattr(args, "tpu_bls", False):
        choice = "torch"
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


# -- the node's commands ---------------------------------------------------------


def _hex_bytes(value: str, length: int, flag: str) -> bytes:
    """A CLI hex argument (0x optional), refused at start-up when it is not
    hex or not ``length`` bytes long."""
    raw = value[2:] if value.startswith("0x") else value
    try:
        out = bytes.fromhex(raw)
    except ValueError:
        raise SystemExit(f"{flag}: not valid hex: {value!r}")
    if len(out) != length:
        raise SystemExit(
            f"{flag}: expected {length} bytes ({length * 2} hex chars), got {len(out)}"
        )
    return out


def _preset(name: str):
    from .params import MAINNET, MINIMAL

    return {"mainnet": MAINNET, "minimal": MINIMAL}[name]


def _chain_config(args):
    from .config.chain_config import ChainConfig

    kw = dict(
        PRESET_BASE=args.preset,
        MIN_GENESIS_TIME=0,
        SHARD_COMMITTEE_PERIOD=0 if args.preset == "minimal" else 256,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=args.validators or 16,
    )
    if args.altair_epoch is not None:
        kw["ALTAIR_FORK_EPOCH"] = args.altair_epoch
    if args.bellatrix_epoch is not None:
        kw["BELLATRIX_FORK_EPOCH"] = args.bellatrix_epoch
    return ChainConfig(**kw)


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's commands and flags (the BLS and observability ones of
    ``dev``, ``beacon`` and ``init`` from ``add_bls_flags``)."""
    ap = argparse.ArgumentParser(prog="lodestar-tpu-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
        p.add_argument("--db", help="sqlite db path (default: in-memory)")
        p.add_argument("--rest-port", type=int, default=9596)
        p.add_argument("--metrics", action="store_true")
        p.add_argument("--listen-port", type=int, default=9000)
        p.add_argument("--connect", action="append", default=[],
                       help="peer host:port to dial (repeatable)")
        p.add_argument("--altair-epoch", type=int, default=None)
        p.add_argument("--bellatrix-epoch", type=int, default=None)
        p.add_argument("--validators", type=int, default=16)
        p.add_argument("--config", help="JSON rc file of persisted flag values "
                       "(explicit CLI flags win)")
        add_bls_flags(p)

    dev = sub.add_parser("dev", help="single-process interop chain (cmds/dev)")
    common(dev)
    dev.add_argument("--slots", type=int, default=32, help="slots to run (0 = forever)")
    dev.add_argument("--tpu-bls", action="store_true",
                     help="alias for --bls-verifier torch (the JAX CLI's flag)")

    beacon = sub.add_parser("beacon", help="beacon node (cmds/beacon)")
    common(beacon)
    beacon.add_argument("--genesis-state", help="SSZ genesis state file")
    beacon.add_argument("--discovery-port", type=int, default=None,
                        help="UDP discovery port (0 = ephemeral; omit to disable)")
    beacon.add_argument("--bootnode", action="append", default=[],
                        help="discovery bootstrap host:udp_port (repeatable)")
    beacon.add_argument(
        "--checkpoint-sync-url",
        help="trusted beacon REST URL to fetch the finalized state from "
        "(initBeaconState.ts:104-136); backfill then earns history backwards",
    )
    beacon.add_argument("--execution-url",
                        help="Engine API JSON-RPC endpoint (execution/engine/http.ts)")
    beacon.add_argument("--jwt-secret",
                        help="file holding the hex-encoded engine jwt secret")
    beacon.add_argument("--builder-url",
                        help="MEV builder REST endpoint (execution/builder/http.ts)")
    beacon.add_argument("--builder-pubkey",
                        help="hex BLS pubkey pinning the builder identity; "
                        "bids signed by any other key are refused")
    beacon.add_argument("--suggested-fee-recipient", default="0x" + "00" * 20,
                        help="node-default fee recipient when a proposer sent "
                        "no preparation")

    vc = sub.add_parser("validator", help="validator client (cmds/validator)")
    vc.add_argument("--beacon-url", default="http://127.0.0.1:9596")
    vc.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    vc.add_argument("--interop-indices", default="0..15",
                    help="interop key range, e.g. 0..15")
    vc.add_argument("--slashing-protection-db", help="EIP-3076 JSON path")
    vc.add_argument("--keystores-dir",
                    help="directory of EIP-2335 keystore-*.json files "
                    "(overrides --interop-indices; cmds/account import flow)")
    vc.add_argument("--keystores-password-file",
                    help="file holding the shared keystore password")
    vc.add_argument("--remote-signer-url",
                    help="web3signer-compatible remote signer URL "
                    "(validatorStore.ts SignerType.Remote)")
    vc.add_argument("--fee-recipient", default="0x" + "00" * 20,
                    help="suggested fee recipient, sent via "
                    "prepareBeaconProposer each epoch")
    vc.add_argument("--gas-limit", type=int, default=30_000_000)
    vc.add_argument("--builder", action="store_true",
                    help="prefer blinded (MEV builder) block production")
    vc.add_argument("--dev-signing", action="store_true",
                    help="DEV/INTEROP ONLY: use the variable-time native "
                    "signing ladder (fb_sign) instead of the default "
                    "constant-time-safe path — its timing leaks the key, "
                    "acceptable only for published interop secrets")

    init_cmd = sub.add_parser("init", help="persist flag values to an rc file (cmds/init)")
    common(init_cmd)
    init_cmd.add_argument("--out", default="lodestar-tpu.rc.json")

    acct = sub.add_parser("account", help="keystore management (cmds/account)")
    acct_sub = acct.add_subparsers(dest="account_cmd", required=True)
    acct_create = acct_sub.add_parser("create", help="generate EIP-2335 keystores")
    acct_create.add_argument("--out-dir", required=True)
    acct_create.add_argument("--password-file", required=True)
    acct_create.add_argument("--count", type=int, default=1)
    acct_create.add_argument("--kdf", choices=("scrypt", "pbkdf2"), default="pbkdf2")
    acct_list = acct_sub.add_parser("list", help="list keystore pubkeys")
    acct_list.add_argument("--keystores-dir", required=True)

    lc = sub.add_parser("lightclient", help="light client (cmds/lightclient)")
    lc.add_argument("--beacon-url", default="http://127.0.0.1:9596")
    lc.add_argument("--checkpoint-root", required=False,
                    help="trusted block root (default: the node's finalized root)")
    lc.add_argument("--preset", choices=["mainnet", "minimal"], default="minimal")
    lc.add_argument("--poll-seconds", type=float, default=12.0)
    lc.add_argument("--max-polls", type=int, default=0, help="0 = forever")
    return ap


async def run_dev(args) -> int:
    """A single-process interop chain that produces a block a slot, with
    the network listener and the REST API; prints the head as JSON when
    ``--slots`` ends it (or SIGINT, with ``--slots 0``)."""
    from .api import RestApiServer
    from .chain.handlers import GossipHandlers
    from .chain.light_client import LightClientServer
    from .db.beacon import BeaconDb
    from .db.controller import MemoryDbController, SqliteDbController
    from .metrics import create_metrics
    from .network import Network
    from .node.dev_chain import DevChain

    preset = _preset(args.preset)
    cfg = _chain_config(args)
    configure_tracing(args)
    metrics = create_metrics() if args.metrics else None
    pool = make_pool(args, metrics=metrics)
    configure_forensics(args, metrics=metrics, pool=pool)
    controller = SqliteDbController(args.db) if args.db else MemoryDbController()
    db = BeaconDb(preset, controller)
    dev = DevChain(preset, cfg, args.validators, pool, db=db)
    handlers = GossipHandlers(dev.chain)
    lc_server = LightClientServer(preset, dev.chain)
    network = Network(preset, dev.chain, handlers)
    await network.listen(args.listen_port)
    for target in args.connect:
        host, _, port = target.partition(":")
        await network.connect(host, int(port))
    rest = RestApiServer(preset, dev.chain, network=network,
                         metrics_registry=metrics.reg if metrics else None)
    rest.gossip_handlers = handlers
    rest.light_client_server = lc_server
    await rest.listen(args.rest_port)
    logger.info("dev chain: %d validators, %s preset; p2p port %s, rest port %s",
                args.validators, args.preset, network.port, rest.port)
    n = args.slots if args.slots else 1 << 62
    try:
        await dev.run(n)
    except asyncio.CancelledError:
        # SIGINT on a node that runs forever: report the head and close
        logger.info("dev chain stopped")
    state = dev.chain.head_state()
    print(
        json.dumps(
            {
                "head_slot": int(state.slot),
                "justified_epoch": int(state.current_justified_checkpoint.epoch),
                "finalized_epoch": int(state.finalized_checkpoint.epoch),
            }
        ),
        flush=True,
    )
    await network.close()
    await rest.close()
    pool.close()
    return 0


async def run_beacon(args) -> int:
    """A (non-producing) beacon node: a db-resumed, checkpoint or genesis
    state, the network listener and the REST API; it range-syncs from its
    peers, then follows gossip until SIGINT.  Reference:
    cmds/beacon/handler.ts + initBeaconState.ts:104-136."""
    from .api import RestApiServer
    from .chain.beacon_chain import BeaconChain
    from .chain.handlers import GossipHandlers
    from .db.beacon import BeaconDb
    from .db.controller import MemoryDbController, SqliteDbController
    from .network import Network
    from .state_transition import interop_genesis_state
    from .sync import RangeSync

    preset = _preset(args.preset)
    cfg = _chain_config(args)
    configure_tracing(args)
    controller = SqliteDbController(args.db) if args.db else MemoryDbController()
    db = BeaconDb(preset, controller)
    anchor_block_root = None
    if args.checkpoint_sync_url:
        from .node.checkpoint_sync import fetch_checkpoint_state

        genesis, anchor_block, anchor_block_root = await fetch_checkpoint_state(
            preset, cfg, args.checkpoint_sync_url
        )
        db.block.put(anchor_block_root, anchor_block)
        db.archive_block(anchor_block, anchor_block_root)
    elif args.genesis_state:
        from .types import get_types

        with open(args.genesis_state, "rb") as f:
            raw = f.read()
        genesis = get_types(preset).phase0.BeaconState.deserialize(raw)
    else:
        resumed = db.last_archived_state()
        genesis = resumed or interop_genesis_state(preset, cfg, args.validators, 1)
    from .metrics import create_metrics

    metrics = create_metrics()
    pool = make_pool(args, metrics=metrics)
    configure_forensics(args, metrics=metrics, pool=pool)
    execution_engine = None
    if args.execution_url:
        from urllib.parse import urlparse as _urlparse

        from .execution.engine import ExecutionEngineHttp, jwt_supplier_from_secret

        jwt_supplier = None
        if args.jwt_secret:
            with open(args.jwt_secret) as f:
                secret = f.read().strip().replace("0x", "")
            jwt_supplier = jwt_supplier_from_secret(bytes.fromhex(secret))
        eu = _urlparse(args.execution_url)
        execution_engine = ExecutionEngineHttp(
            eu.hostname or "127.0.0.1", eu.port or 8551, jwt_supplier=jwt_supplier
        )
    builder = None
    if args.builder_url:
        from urllib.parse import urlparse as _urlparse

        from .execution.builder import ExecutionBuilderHttp

        bu = _urlparse(args.builder_url)
        builder = ExecutionBuilderHttp(
            bu.hostname or "127.0.0.1", bu.port or 18550,
            pubkey=_hex_bytes(args.builder_pubkey, 48, "--builder-pubkey")
            if args.builder_pubkey else None,
        )
    chain = BeaconChain(
        preset, cfg, genesis, pool, db=db, metrics=metrics,
        execution_engine=execution_engine, builder=builder,
        default_fee_recipient=_hex_bytes(
            args.suggested_fee_recipient, 20, "--suggested-fee-recipient"
        ),
    )
    handlers = GossipHandlers(chain)
    network = Network(preset, chain, handlers, metrics=metrics)
    await network.listen(args.listen_port)
    for target in args.connect:
        host, _, port = target.partition(":")
        peer = await network.connect(host, int(port))
        logger.info("connected to %s (head slot %s)", target, peer.status.head_slot)
    rest = RestApiServer(preset, chain, network=network,
                         metrics_registry=metrics.reg, metrics=metrics)
    rest.gossip_handlers = handlers
    await rest.listen(args.rest_port)
    logger.info("beacon node: p2p port %s, rest port %s", network.port, rest.port)
    if args.discovery_port is not None:
        import secrets as _secrets

        from .crypto.bls.api import SecretKey as _SK
        from .crypto.bls.fields import R as _R

        identity = _SK.from_bytes(
            (int.from_bytes(_secrets.token_bytes(32), "big") % (_R - 1) + 1).to_bytes(32, "big")
        )
        boots = []
        for b in args.bootnode:
            bh, _, bp = b.partition(":")
            boots.append((bh, int(bp)))
        await network.enable_discovery(identity, args.discovery_port, bootstrap=boots)
    backfill_task = None
    if anchor_block_root is not None:
        from .sync.backfill import BackfillSync

        backfill = BackfillSync(
            preset, cfg, db, pool, genesis, anchor_block_root,
            network.peer_manager, metrics=metrics,
        )
        backfill_task = asyncio.create_task(backfill.run())
    sync = RangeSync(
        preset, chain, network.peer_manager, metrics=metrics,
        report_peer=network.report_peer,
    )
    try:
        imported = await sync.run_to_head()
        if backfill_task is not None:
            stored = await backfill_task
            logger.info("backfill stored %d historical blocks", stored)
        logger.info("synced %d blocks; following gossip (ctrl-c to stop)", imported)
        while True:
            await asyncio.sleep(3600)
    except (KeyboardInterrupt, asyncio.CancelledError):
        logger.info("beacon node stopped")
    await network.close()
    await rest.close()
    pool.close()
    return 0


def _api_client(beacon_url: str):
    """The REST client of ``--beacon-url`` (``http://host:port``)."""
    from .api.client import ApiClient

    url = beacon_url.rstrip("/")
    host = url.split("//")[-1].split(":")[0]
    port = int(url.rsplit(":", 1)[-1])
    return ApiClient(host, port)


def _command_config(args):
    """The chain config of the ``validator`` and ``lightclient`` commands:
    the JAX commands' (no fork epochs, so the default schedule)."""
    from .config.chain_config import ChainConfig

    return ChainConfig(PRESET_BASE=args.preset, MIN_GENESIS_TIME=0,
                       SHARD_COMMITTEE_PERIOD=0,
                       MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16)


async def run_validator(args) -> int:
    """The validator client: interop keys (or keystores, or a remote
    signer) signing every duty through slashing protection, one slot after
    the node's head at a time, until SIGINT, which stops the head tracker
    and folds the protection's write-ahead log into its file.  Reference:
    cmds/validator/handler.ts."""
    from .crypto.bls.api import interop_secret_key
    from .validator import ChainHeaderTracker, SlashingProtection, ValidatorClient, ValidatorStore

    preset = _preset(args.preset)
    cfg = _command_config(args)
    api = _api_client(args.beacon_url)
    pending_secrets = {}
    if args.keystores_dir:
        from .crypto.bls.api import SecretKey
        from .validator.keystore import load_keystores_dir

        password = ""
        if args.keystores_password_file:
            with open(args.keystores_password_file) as f:
                password = f.read().strip()
        loaded = load_keystores_dir(args.keystores_dir, password)
        if not loaded:
            logger.error("no keystores found in %s", args.keystores_dir)
            return 1
        # indices resolve over the API (services/indices.ts:17); a pubkey
        # not active yet stays pending and is retried every 8 slots, so it
        # signs from the slot it activates
        keys = {}
        pending_secrets = {pk: SecretKey.from_bytes(sec) for pk, sec in loaded.items()}

        async def resolve_pending(store=None):
            for pk in list(pending_secrets):
                try:
                    info = await api.get(f"/eth/v1/beacon/states/head/validators/0x{pk.hex()}")
                    idx = int(info["data"]["index"])
                except Exception:  # noqa: BLE001 - not active yet: retried
                    continue
                sk = pending_secrets.pop(pk)
                keys[idx] = sk
                if store is not None:
                    store.keys[idx] = sk
                    store.pubkeys[idx] = pk
                logger.info("validator 0x%s... resolved to index %d", pk.hex()[:12], idx)

        await resolve_pending()
        if pending_secrets:
            logger.warning("%d keystore pubkeys not yet active; will retry", len(pending_secrets))
        logger.info("loaded %d keystore validators", len(keys))
    else:
        lo, _, hi = args.interop_indices.partition("..")
        keys = {i: interop_secret_key(i) for i in range(int(lo), int(hi) + 1)}
    # every accepted record goes to the write-ahead log before its
    # signature leaves the store: a killed process loses no history
    protection = SlashingProtection(persist_path=args.slashing_protection_db)
    genesis = await api.get("/eth/v1/beacon/genesis")
    gvr = bytes.fromhex(genesis["data"]["genesis_validators_root"][2:])
    remote_signer, remote_keys = None, {}
    if args.remote_signer_url:
        from .validator.remote_signer import RemoteSignerClient

        remote_signer = RemoteSignerClient(args.remote_signer_url)
        for pk in remote_signer.public_keys():
            try:
                info = await api.get(f"/eth/v1/beacon/states/head/validators/0x{pk.hex()}")
                remote_keys[int(info["data"]["index"])] = pk
            except Exception:  # noqa: BLE001 - not active yet
                logger.warning("remote key 0x%s... not yet active", pk.hex()[:12])
        logger.info("remote signer: %d keys from %s", len(remote_keys), args.remote_signer_url)
    store = ValidatorStore(preset, cfg, keys, protection, genesis_validators_root=gvr,
                           remote_signer=remote_signer, remote_keys=remote_keys,
                           dev_signing=args.dev_signing)
    vc = ValidatorClient(preset, cfg, store, api,
                         fee_recipient=_hex_bytes(args.fee_recipient, 20, "--fee-recipient"),
                         gas_limit=args.gas_limit, builder_enabled=args.builder)
    tracker = ChainHeaderTracker(api)
    tracker.start()
    vc.header_tracker = tracker
    logger.info("validator client: %d keys against %s", len(keys), args.beacon_url)
    slot = 1
    try:
        while True:
            syncing = await api.get("/eth/v1/node/syncing")
            slot = max(slot, int(syncing["data"]["head_slot"]) + 1)
            if pending_secrets and slot % 8 == 0:
                await resolve_pending(store)
            # wait up to a third of a slot for the head event before attesting
            await vc.run_slot(slot, head_wait_s=cfg.SECONDS_PER_SLOT / 3)
            slot += 1
    except (KeyboardInterrupt, asyncio.CancelledError):
        logger.info("validator client stopped")
    finally:
        await tracker.stop()
        protection.close()  # fold the write-ahead log into the interchange file
    return 0


async def run_lightclient(args) -> int:
    """Follow the chain as a light client over the REST API, printing its
    optimistic and finalized slots as JSON each poll
    (cmds/lightclient/handler.ts)."""
    import time

    from .api.serde import from_json
    from .light_client import LightClient

    preset = _preset(args.preset)
    cfg = _command_config(args)
    api = _api_client(args.beacon_url)
    genesis = await api.get("/eth/v1/beacon/genesis")
    gvr = bytes.fromhex(genesis["data"]["genesis_validators_root"][2:])
    genesis_time = int(genesis["data"].get("genesis_time", 0))
    root = args.checkpoint_root
    if not root:
        fc = await api.get("/eth/v1/beacon/states/head/finality_checkpoints")
        root = fc["data"]["finalized"]["root"]
    boot = await api.get(f"/eth/v1/beacon/light_client/bootstrap/{root}")
    client = LightClient(preset, cfg, from_json(boot["data"]), gvr)
    logger.info("light client bootstrapped at slot %d", client.finalized_header.slot)
    polls = 0
    slots_per_period = preset.SLOTS_PER_EPOCH * preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    while args.max_polls == 0 or polls < args.max_polls:
        polls += 1
        # the clock's per-period hook: the participation watermarks rotate
        # even when no update crosses the period boundary
        if genesis_time:
            client.process_slot(max(0, int(time.time() - genesis_time) // cfg.SECONDS_PER_SLOT))
        try:
            # from the period of the finalized header, so the loop follows
            # the chain instead of refetching period 0
            period = int(client.finalized_header.slot) // slots_per_period
            ups = await api.get(
                f"/eth/v1/beacon/light_client/updates?start_period={period}&count=4")
            for u in ups["data"]:
                client.process_update(from_json(u))
            print(json.dumps({"optimistic_slot": int(client.optimistic_header.slot),
                              "finalized_slot": int(client.finalized_header.slot)}), flush=True)
        except Exception as e:  # noqa: BLE001 - a failed poll is retried
            logger.warning("update poll failed: %s", e)
        if args.max_polls and polls >= args.max_polls:
            break
        await asyncio.sleep(args.poll_seconds)
    return 0


def run_account(args) -> int:
    """Keystore management (cmds/account): ``create`` writes ``--count``
    EIP-2335 keystores of fresh keys, ``list`` prints each keystore's
    pubkey and file name."""
    import secrets

    from .crypto.bls.fields import R
    from .validator.keystore import create_keystore

    if args.account_cmd == "create":
        with open(args.password_file) as f:
            password = f.read().strip()
        os.makedirs(args.out_dir, exist_ok=True)
        for _ in range(args.count):
            secret = (int.from_bytes(secrets.token_bytes(32), "big") % (R - 1) + 1).to_bytes(32, "big")
            ks = create_keystore(secret, password, kdf=args.kdf)
            path = os.path.join(args.out_dir, f"keystore-{ks['pubkey'][:12]}.json")
            with open(path, "w") as f:
                json.dump(ks, f, indent=2)
            print(f"wrote {path}")
        return 0
    for name in sorted(os.listdir(args.keystores_dir)):
        if name.endswith(".json"):
            with open(os.path.join(args.keystores_dir, name)) as f:
                ks = json.load(f)
            print(f"0x{ks.get('pubkey', '?')}  {name}")
    return 0


def run_init(args) -> int:
    """Write the resolved flag values to an rc file
    (cmds/init/handler.ts persistOptionsAndConfig)."""
    payload = {k: v for k, v in vars(args).items()
               if k not in ("cmd", "out", "config") and not callable(v)}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    print(f"wrote {args.out}")
    return 0


def _apply_config_file(args, argv) -> None:
    """Overlay persisted rc values: an rc value applies unless the same
    flag was given on the command line."""
    path = getattr(args, "config", None)
    if not path:
        return
    with open(path) as f:
        persisted = json.load(f)
    explicit = set()
    for tok in argv or sys.argv[1:]:
        if tok.startswith("--"):
            explicit.add(tok[2:].split("=", 1)[0].replace("-", "_"))
    for key, value in persisted.items():
        if key in ("cmd", "out", "config") or key in explicit:
            continue
        if hasattr(args, key):
            setattr(args, key, value)


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        _apply_config_file(args, argv)
    except (OSError, ValueError) as e:
        print(f"bad --config file: {e}", file=sys.stderr)
        return 2
    if args.cmd == "account":
        return run_account(args)
    if args.cmd == "init":
        return run_init(args)
    run = {"dev": run_dev, "beacon": run_beacon, "validator": run_validator,
           "lightclient": run_lightclient}[args.cmd]
    if getattr(args, "log_format", None) is None:
        _set_log_format("text")
    try:
        return asyncio.run(run(args))
    finally:
        # in the finally: a SIGINT on a node that runs forever still
        # writes the trace and the merged profile
        dump_trace(getattr(args, "trace_dump", None))
        finalize_profile(args)


if __name__ == "__main__":
    raise SystemExit(main())
