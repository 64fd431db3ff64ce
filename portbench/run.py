"""The benchmark of the port, one run of one cell per process.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  The last
line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last: each compared number beside its limit); the last lines
of standard error are the same numbers.  Without a card, or with fewer
cards than the cell asks for, it exits 3 and prints no result; when a
module of ``jax``, ``jaxlib``, ``flax`` or ``lodestar_tpu`` is loaded at
the end, it exits 4 and prints no result.

    python3 portbench/run.py --sweep <config> --rates 100,150,200 --seed <n> --seconds <s>

runs the configuration's mix at each offered rate (sets/s) in turn over
one warmed verifier, and prints a line per rate: job latency p50 / p95,
how the backlog moved over the window, the generator's lateness.

Every cache stays inside the checkout: the port's kernel library in
``build/lodestar_tpu_torch/``, its durable store, the frozen C library and
the deserialized key bank under ``portbench/``.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
ENV = {
    "LODESTAR_TPU_TORCH_AOT_STORE": os.path.join(CACHE, "aot_store"),
    "LODESTAR_TPU_FORENSICS_DIR": os.path.join(CACHE, "forensics"),
    "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
    "CUDA_CACHE_PATH": os.path.join(CACHE, "nv"),
    "USE_FLAX": "0",
    "USE_JAX": "0",
}


#: seconds after which a run is taken as hung (a run has 360)
HANG_S = 345


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description="the port's benchmark: one run of one cell")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=48.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", metavar="CONFIG")
    ap.add_argument("--rates", default="", help="--sweep: offered sets/s, comma-separated")
    args = ap.parse_args(argv)
    if bool(args.workload) == bool(args.sweep):
        ap.error("give one of --workload and --sweep")
    return args


def sweep(args) -> int:
    from portbench import harness, stats, traffic

    bench = traffic.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next(c for c in bench["configs"] if c["name"] == args.sweep)
    cfg = traffic.load_json(os.path.join(ROOT, entry["file"]))
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    verifier = TorchBlsVerifier(device="cuda:0")
    verifier.warmup(harness.WARM_BUCKETS)
    log(f"sweep {args.sweep}: warmed in {time.monotonic() - T_START:.1f} s; "
        f"deployment {traffic.deployment_sets_per_s(cfg):.1f} sets/s")
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            cell = harness.Cell(f"sweep.{rate:g}", cfg, {"sets_per_s": rate}, 1)
            res = harness.run_cell(cell, args.seed + i, args.seconds, False, time.monotonic(),
                                   harness.WORKERS, verifier=verifier, check=False)
            b = res.extra["backlog"]
            q = max(1, len(b) // 4)
            first = sum(x[1] for x in b[:q]) / q
            last = sum(x[1] for x in b[-q:]) / q
            lat = res.extra["latencies"]
            print(json.dumps({
                "config": args.sweep, "sets_per_s": rate,
                "job_p50_ms": 1e3 * stats.nearest_rank(lat, 50),
                "job_p95_ms": 1e3 * stats.nearest_rank(lat, 95),
                "failed": res.line["failed"], "jobs": res.extra["jobs"],
                "sets": res.extra["sets"],
                "outstanding_sets_first_quarter": first,
                "outstanding_sets_last_quarter": last,
                "outstanding_sets_max": max((x[1] for x in b), default=0),
                "late_p95_ms": res.extra["late_p95_ms"],
                "stage_seconds": res.extra["stage_end"],
            }), flush=True)
    finally:
        verifier.close()
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    for k, v in ENV.items():
        os.environ[k] = v
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from portbench import guard, harness

    chips = 1
    if args.workload:
        chips = harness.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} NVIDIA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 3
    if args.sweep:
        return sweep(args)
    # a run that has not ended by then dumps every thread's stack and exits
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    cell = harness.load_cell(ROOT, args.workload)
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START,
                           harness.WORKERS)
    x = res.extra
    log(f"card: {harness.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"{cell.name} seed {args.seed}: {x['jobs']} jobs, {x['sets']} sets, "
        f"{x['expected_false']} job(s) the reference rejects, {x['dropped']} dropped; "
        f"set-up {x['setup_s']:.3f} s (data {x['data_s']:.3f} s), "
        f"reference {x['reference_s']:.3f} s ({x['pyref_sets']} sets again in pure Python)")
    log(f"job tail (not a metric of the line): p95 {x['job_p95_ms']:.3f} ms")
    if "failed_batches" in x:
        log(f"failed batches [sets, bucket]: {json.dumps(x['failed_batches'])}")
    log(f"generator lateness: p95 {x['late_p95_ms']:.3f} ms, max {x['late_max_ms']:.3f} ms")
    if "device_trace" in x:
        dt = x["device_trace"]
        log("device sub-window: " + json.dumps({k: v for k, v in dt.items() if k != "batches"}))
        log("batches: " + json.dumps(dt.get("batches", [])[:40]))
    found = guard.forbidden_modules()
    if found:
        log(f"no result: forbidden modules loaded: {', '.join(found)}")
        return 4
    harness.report(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
