"""One run of one cell: set-up, the open-loop window through the port's
pool, the check against the plain reference, and the result line.

Set-up builds the data before the verifier: the schedule from the seed
(``traffic.schedule``), its signatures in a pool of worker processes (the
frozen C library, ``bank``), and the sets as the port's handlers build
them: ``SingleSignatureSet`` / ``AggregatedSignatureSet`` over the bank's
``PublicKey`` objects, each deserialized once, as a node's
``index2pubkey`` holds them.  Then one ``TorchBlsVerifier`` on ``cuda:0``
and one ``BlsBatchPool`` over it, both with the port's defaults; the
verifier's graphs at every bucket the window can reach, and one burst of
warm-up jobs through the pool (their own keys and roots).

The window offers each job at its due instant, on the lane and with the
deadline the port's gossip handlers give it, and times it from that
instant to its verdict.  Once it closes, jobs still in flight get a grace
period, the card's memory peak is read, the pool and verifier are closed,
and the reference (``bank.verify_tasks``, each set's pairing equation
alone, from the secret keys) gives every job's verdict in the worker pool.
A sample of the window's sets drawn from the seed (every tampered set,
some of the blocks', the rest at random) is checked again by the
pure-Python pairing (``pyref/check.py``), which shares no code with the
port: a set on which the two references disagree fails the run.

With ``trace`` the port's span tracer is on for the whole window and a
``torch.profiler`` sub-window covers its last ``PROFILE_S`` seconds, up to
its close (the profiler itself is stopped once every job has answered);
the span readers take spans that ended before the sub-window, the device
readers the sub-window itself (``devtrace``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import pickle
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import bank, traffic
from .stats import nearest_rank

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
#: the pool's buckets a window can reach: merged gossip up to the pool's
#: 128 sets, a block's 131 sets alone
WARM_BUCKETS = (4, 16, 64, 128, 256)
#: seconds a job may still take after the window closes
GRACE_S = 60.0
#: seconds of the traced run's profiler sub-window, ending at the close
PROFILE_S = 3.0
#: the warm-up burst: offered sets/s of its schedule over one slot
WARM_SETS_PER_S = 40.0
#: sets of a window checked again by the pure-Python pairing, about
#: 0.35 s each on one core
PYREF_SETS = 196
#: of which drawn from the blocks' sets
PYREF_BLOCK_SETS = 8
#: worker processes that sign and run the reference: the host's cores, at
#: most 8, less one for the run's own process
WORKERS = max(1, min(8, os.cpu_count() or 2) - 1)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int


def end_to_end(cell: str, root: str = ROOT) -> List[str]:
    """The end-to-end metrics ``cell`` reports, by ``BENCHMARK.json``: every
    one that lists no cells, or lists this one."""
    bench = traffic.load_json(os.path.join(root, "BENCHMARK.json"))
    return [m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def load_cell(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, with its
    configuration's file and its traffic file."""
    bench = traffic.load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(workload, traffic.load_json(os.path.join(root, cfg["file"])),
                traffic.load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
                int(w["chips"]))


# -- inputs -------------------------------------------------------------------


def sign_jobs(jobs: Sequence[traffic.Job], seed: int, pool, workers: int) -> None:
    """Sign every set of ``jobs`` in ``pool``; a tampered set gets +-D.
    Each job gets ``signatures``, one per set."""
    tasks = [(s.keys, s.root) for job in jobs for s in job.sets]
    sigs = bank.run_chunked(pool, bank.sign_tasks, tasks, 4 * workers)
    d = bank.sign(*traffic.tamper_point_seed(seed))
    offsets = {1: d, -1: bank.negate_signature(d),
               2: bank.sign(*traffic.tamper_point_seed(seed, "E"))}
    it = iter(sigs)
    for job in jobs:
        job.signatures = []
        for s in job.sets:
            sig = next(it)
            if s.tamper:
                sig = bank.add_signatures([sig, offsets[s.tamper]])
            job.signatures.append(sig)


def _set_tasks(jobs: Sequence[traffic.Job]) -> list:
    return [(s.keys, s.root, sig) for job in jobs for s, sig in zip(job.sets, job.signatures)]


def reference_verdicts(jobs: Sequence[traffic.Job], pool, workers: int
                       ) -> tuple:
    """(each job's verdict by the plain reference: every set's equation
    holds; each set's verdict, in the jobs' order)."""
    per_set = bank.run_chunked(pool, bank.verify_tasks, _set_tasks(jobs), 4 * workers)
    it = iter(per_set)
    return [all([next(it) for _ in job.sets]) for job in jobs], per_set


def pyref_sample(jobs: Sequence[traffic.Job], seed: int, n: int) -> List[int]:
    """Indices (in the jobs' order of sets) of the sets the pure-Python
    pairing checks again: every tampered set, ``PYREF_BLOCK_SETS`` of the
    blocks' sets, the rest drawn from all other sets, by the seed."""
    import numpy as np

    flat = [(job.topic, s) for job in jobs for s in job.sets]
    tampered = [i for i, (_, s) in enumerate(flat) if s.tamper]
    rng = np.random.default_rng([seed % 2**63, 0x707972])
    blocks = [i for i, (t, s) in enumerate(flat) if t == traffic.BLOCK and not s.tamper]
    rest = [i for i, (t, s) in enumerate(flat) if t != traffic.BLOCK and not s.tamper]
    n_blocks = min(len(blocks), PYREF_BLOCK_SETS, max(0, n - len(tampered)))
    n_rest = min(len(rest), max(0, n - len(tampered) - n_blocks))
    picked = (list(rng.choice(blocks, size=n_blocks, replace=False)) if n_blocks else []) + (
        list(rng.choice(rest, size=n_rest, replace=False)) if n_rest else [])
    return sorted(tampered + [int(i) for i in picked])


def _port_digest() -> str:
    import lodestar_tpu_torch.crypto.bls as pkg

    h = hashlib.sha256()
    d = os.path.dirname(pkg.__file__)
    for name in ("api.py", "curve.py", "fields.py"):
        with open(os.path.join(d, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def program_keys(n: int, pool, workers: int) -> list:
    """The bank's keys as the port's ``PublicKey`` objects, each
    deserialized (``PublicKey.from_bytes``, no subgroup check: a node checks
    each key once, when it first enters its cache).  Kept in ``.cache/``,
    by the bank's size and a hash of the port's key code, after the
    first run of a checkout."""
    from lodestar_tpu_torch.crypto.bls.api import PublicKey

    path = os.path.join(CACHE, f"bank-{n}-{_port_digest()}.pickle")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    raws = bank.run_chunked(pool, bank.public_keys, list(range(n)), 4 * workers)
    keys = [PublicKey.from_bytes(r, validate=False) for r in raws]
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(keys, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return keys


def program_sets(job: traffic.Job, keys: list) -> list:
    from lodestar_tpu_torch.crypto.bls.verifier import (AggregatedSignatureSet,
                                                         SingleSignatureSet)

    out = []
    for s, sig in zip(job.sets, job.signatures):
        if len(s.keys) == 1:
            out.append(SingleSignatureSet(pubkey=keys[s.keys[0]], signing_root=s.root,
                                          signature=sig))
        else:
            out.append(AggregatedSignatureSet(pubkeys=[keys[k] for k in s.keys],
                                              signing_root=s.root, signature=sig))
    return out


# -- the window ---------------------------------------------------------------


@dataclasses.dataclass
class Outcome:
    kind: str  # "verdict", "dropped", "raised" or "missing"
    verdict: Optional[bool] = None
    t_done: Optional[float] = None


async def _offer(pool, jobs, sets, seconds, sps, on_open: Callable, on_close: Callable):
    """Offer ``jobs`` open loop; returns (window open instant, close
    instant, outcomes, generator lateness per job, backlog samples)."""
    from lodestar_tpu_torch.crypto.bls.verifier import (SignatureSetPriority,
                                                         VerificationDroppedError)

    loop = asyncio.get_running_loop()
    outcomes = [Outcome("missing") for _ in jobs]
    lateness = [0.0] * len(jobs)
    samples: List[tuple] = []
    inflight = [0]

    async def one(i, job, due_abs):
        lateness[i] = loop.time() - due_abs
        deadline = (time.monotonic() + sps) if job.topic in traffic.DEADLINE_TOPICS else None
        inflight[0] += len(job.sets)
        try:
            ok = await pool.verify_signature_sets(
                sets[i], priority=SignatureSetPriority[job.lane], deadline=deadline)
            outcomes[i] = Outcome("verdict", bool(ok), loop.time())
        except VerificationDroppedError:
            outcomes[i] = Outcome("dropped", None, loop.time())
        except Exception as e:  # noqa: BLE001 - a job that raises is counted, not fatal
            log(f"job {i} ({job.topic}) raised: {e!r}")
            outcomes[i] = Outcome("raised", None, loop.time())
        finally:
            inflight[0] -= len(job.sets)

    async def sampler(t_end):
        while loop.time() < t_end:
            samples.append((loop.time(), inflight[0], pool.pending_sets()))
            await asyncio.sleep(0.25)

    t0 = loop.time() + 0.01
    on_open(t0)
    sample_task = asyncio.ensure_future(sampler(t0 + seconds))
    tasks = []
    for i, job in enumerate(jobs):
        due_abs = t0 + job.due
        delay = due_abs - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(one(i, job, due_abs)))
    rest = t0 + seconds - loop.time()
    if rest > 0:
        await asyncio.sleep(rest)
    t_close = loop.time()
    on_close(t_close)
    await sample_task
    if tasks:
        await asyncio.wait(tasks, timeout=GRACE_S)
    for t in tasks:  # a job past the grace is counted missing
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    return t0, t_close, outcomes, lateness, samples


async def _warm_pool(pool, sets_list, lanes):
    from lodestar_tpu_torch.crypto.bls.verifier import SignatureSetPriority

    await asyncio.gather(*[pool.verify_signature_sets(s, priority=SignatureSetPriority[lane])
                           for s, lane in zip(sets_list, lanes)])


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: no reading"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class RunResult:
    line: dict
    checks: Dict[str, Dict[str, float]]
    correct: bool
    extra: dict


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             workers: int, verifier=None, device: str = "cuda:0",
             check: bool = True, pyref_sets: int = PYREF_SETS) -> RunResult:
    """One run.  ``verifier``: None builds the port's ``TorchBlsVerifier`` on
    ``device``, warms it and closes it at the end; one given is used as it
    is and left open (another verifier in the program's place, or the
    sweep's, warmed once for all its rates).  ``check=False`` leaves the
    reference out (``correct`` is then None); ``pyref_sets`` is the size of
    the sample the pure-Python pairing checks again."""
    import torch

    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool

    cfg, mix = cell.config, cell.mix
    sps = cfg["seconds_per_slot"]
    jobs = traffic.schedule(cfg, mix, seed, seconds)
    warm_jobs = traffic.schedule(cfg, {"sets_per_s": WARM_SETS_PER_S}, seed + 1, sps,
                                 start_slot=10)
    for job in warm_jobs:  # the warm-up's roots are its own
        job.sets = [dataclasses.replace(s, root=hashlib.sha256(b"warm" + s.root).digest(),
                                        tamper=0) for s in job.sets]
    pool_w = bank.worker_pool(workers)
    try:
        sign_jobs(warm_jobs + jobs, seed, pool_w, workers)
        keys = program_keys(cfg["validator_keys"], pool_w, workers)
    finally:
        pool_w.shutdown(wait=True)
    sets = [program_sets(job, keys) for job in jobs]
    warm_sets = [program_sets(job, keys) for job in warm_jobs]
    t_data = time.monotonic()
    log(f"{cell.name}: data ready at {t_data - t_start:.1f} s")

    own = verifier is None
    if own:
        from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

        verifier = TorchBlsVerifier(device=device)
        verifier.warmup(WARM_BUCKETS)
    on_card = getattr(getattr(verifier, "device", None), "type", None) == "cuda"
    log(f"{cell.name}: verifier ready at {time.monotonic() - t_start:.1f} s")
    dev = verifier.device if on_card else None
    pool = BlsBatchPool(verifier)
    prof_state: dict = {}
    tracer = None
    if trace:
        from lodestar_tpu_torch import tracing

        from . import devtrace

        tracer = tracing.enable(capacity=2_000_000)
        if on_card:
            devtrace.warm_profiler(dev)

    async def main():
        await _warm_pool(pool, warm_sets, [j.lane for j in warm_jobs])
        if on_card:
            torch.cuda.synchronize(dev)
        if tracer is not None:
            tracer.clear()
        prof_state["stage0"] = dict(getattr(verifier, "stage_seconds", {}) or {})
        prof_state["final_exps0"] = getattr(verifier, "host_final_exps", 0)

        def on_open(t0):
            prof_state["setup_s"] = time.monotonic() - t_start
            log(f"{cell.name}: window opens at {prof_state['setup_s']:.1f} s")
            if trace and on_card:
                loop = asyncio.get_running_loop()
                loop.call_at(t0 + max(0.0, seconds - PROFILE_S), start_profile)

        def start_profile():
            prof_state["stage1"] = dict(verifier.stage_seconds)
            prof_state["final_exps1"] = verifier.host_final_exps
            prof_state["profile"] = devtrace.Profile(dev)
            prof_state["profile"].start()
            log(f"{cell.name}: profiler on at {time.monotonic() - t_start:.1f} s")

        def on_close(_t):
            log(f"{cell.name}: window closes at {time.monotonic() - t_start:.1f} s")
            if "profile" in prof_state:
                prof_state["profile"].close_window()

        return await _offer(pool, jobs, sets, seconds, sps, on_open, on_close)

    try:
        t0, t_close, outcomes, lateness, samples = asyncio.run(main())
        memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    finally:
        pool.close()
        if "profile" in prof_state:
            # stopped once every job has its verdict: a profiler stopped
            # while another thread launches a graph can deadlock
            prof_state["profile"].stop()
            log(f"{cell.name}: profiler off at {time.monotonic() - t_start:.1f} s")
        if own:
            verifier.close()
    spans = list(tracer.spans()) if tracer is not None else []
    if tracer is not None:
        from lodestar_tpu_torch import tracing

        tracing.disable()
    stage_end = dict(getattr(verifier, "stage_seconds", {}) or {})
    final_exps_end = getattr(verifier, "host_final_exps", 0)
    del pool, sets, warm_sets, keys
    if own:
        del verifier
        if on_card:
            torch.cuda.empty_cache()

    t_ref = time.monotonic()
    log(f"{cell.name}: jobs answered at {t_ref - t_start:.1f} s")
    disagree = 0
    sample: List[int] = []
    if check:
        from .pyref import check as pyref_check

        pool_w = bank.worker_pool(workers)
        try:
            expected, per_set = reference_verdicts(jobs, pool_w, workers)
            sample = pyref_sample(jobs, seed, pyref_sets)
            tasks = _set_tasks(jobs)
            again = bank.run_chunked(pool_w, pyref_check.verify_tasks,
                                     [tasks[i] for i in sample], workers)
        finally:
            pool_w.shutdown(wait=True)
        disagree = sum(per_set[i] != a for i, a in zip(sample, again))
    else:
        expected = [None] * len(jobs)
    ref_s = time.monotonic() - t_ref

    t_giveup = t_close + GRACE_S
    latencies = []
    failed = wrong = unanswered = dropped = 0
    for job, out, exp in zip(jobs, outcomes, expected):
        due = t0 + job.due
        if out.kind == "verdict":
            latencies.append(out.t_done - due)
            wrong += exp is not None and out.verdict != exp
        else:
            failed += 1
            latencies.append(max(t_giveup, out.t_done or 0.0) - due)
            if out.kind == "dropped":
                dropped += 1
            else:
                unanswered += 1
    checks = {"wrong_verdicts": {"value": wrong, "limit": 0},
              "unanswered_jobs": {"value": unanswered, "limit": 0},
              "reference_disagreements": {"value": disagree, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) if check else None
    n_false = sum(1 for e in expected if e is False)
    extra = {
        "setup_s": prof_state.get("setup_s"), "data_s": t_data - t_start,
        "reference_s": ref_s, "jobs": len(jobs), "sets": sum(len(j.sets) for j in jobs),
        "expected_false": n_false, "dropped": dropped, "pyref_sets": len(sample),
        "tampered_signatures": [sig for job in jobs for s, sig in zip(job.sets, job.signatures)
                                if s.tamper],
        "job_p95_ms": 1e3 * (nearest_rank(latencies, 95) or 0.0),
        "late_p95_ms": 1e3 * (nearest_rank(lateness, 95) or 0.0),
        "late_max_ms": 1e3 * max(lateness, default=0.0),
        "backlog": samples, "stage_end": stage_end, "latencies": latencies,
    }
    metrics: Dict[str, dict] = {}
    if not trace:
        metrics = {
            "job_p50_ms": {"value": 1e3 * nearest_rank(latencies, 50), "unit": "ms"},
            "setup_s": {"value": prof_state["setup_s"], "unit": "s"},
        }
        metrics = {k: v for k, v in metrics.items() if k in end_to_end(cell.name)}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    line = {"correct": correct, "attempted": len(jobs), "failed": failed,
            "metrics": metrics, "device": device_info}
    if trace:
        from . import metrics as readers

        prof = prof_state.get("profile")
        stage1 = prof_state.get("stage1", stage_end)
        ctx = readers.Context(
            spans=spans,
            span_cutoff_ns=(prof.t_start_ns - prof.offset_ns) if prof else None,
            stage_delta={k: v - prof_state["stage0"].get(k, 0.0) for k, v in stage1.items()},
            final_exps_delta=prof_state.get("final_exps1", final_exps_end)
            - prof_state["final_exps0"],
            device=prof.summary(spans) if prof else None)
        if ctx.device is not None:
            line["device"]["busy_s"] = ctx.device["busy_s"]
            line["device"]["window_s"] = ctx.device["window_s"]
            line["breakdown"] = ctx.device["breakdown"]
            extra["device_trace"] = {k: v for k, v in ctx.device.items() if k != "breakdown"}
        line["metrics"] = readers.read_all(ctx, cell.name)
        extra["failed_batches"] = failed_batches(spans)
        log(f"{cell.name}: trace read at {time.monotonic() - t_start:.1f} s")
    return RunResult(line, checks, correct, extra)


def bucket_of(n_sets: int) -> int:
    """The port's bucket for a batch of ``n_sets``: the smallest of
    ``WARM_BUCKETS`` that holds it."""
    return next((b for b in WARM_BUCKETS if n_sets <= b), WARM_BUCKETS[-1])


def failed_batches(spans) -> List[list]:
    """[sets, bucket] of each merged batch whose verdict was False, from the
    pool's ``pool.batch`` spans: where the tampered jobs landed."""
    return [[sp.args["sets"], bucket_of(sp.args["sets"])] for sp in spans
            if sp.name == "pool.batch" and sp.args and sp.args.get("ok") is False]


def report(result: RunResult) -> None:
    """The compared numbers beside their limits, last on standard error,
    and the result's line, last on standard output, ``checks`` its last
    key."""
    for name, c in result.checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    line = dict(result.line)
    line["checks"] = result.checks
    print(json.dumps(line), flush=True)
