"""Chaos campaign: every fault class, one live pool, zero undiagnosable deaths.

The port's copy of the repo's ``tools/chaos_campaign.py``.  It runs a
seeded, deterministic campaign of the fault taxonomy against a live
``BlsBatchPool`` -> ``TorchBlsVerifier`` and asserts, per fault class:

- **diagnosable**: every induced fault yields a diagnostic bundle that
  the port's ``tools/inspect_bundle.py`` validates (watchdog stall,
  quarantine entry, salvage heartbeat, ...);
- **nothing lost**: every submitted verification job resolves — a real
  verdict, a typed ``VerificationDroppedError``, or an injected fault's
  typed error; ``verdicts_lost`` (stranded futures) must be 0;
- **self-healing**: the failing executor is quarantined, re-admitted
  after its backoff probe, and post-fault throughput recovers to within
  10% of the pre-fault baseline.

Scenarios (all driven from ONE seed; repro = rerun with the same seed):

    device_loss     the sync raises on one executor, twice -> requeue,
                    quarantine, probe re-admission, trace passes
                    check_trace --require-pipeline with bls.requeue spans
    sharded_loss    a loss on the mesh during a sharded batch -> the
                    packed payload requeued on one executor, the mesh
                    quarantined and re-admitted
    device_wedge    the sync blocks past the watchdog deadline ->
                    watchdog bundle naming cid+device, then recovery
    compile_fault   a ``bls.compile`` fault at warmup or at dispatch
                    raises: no degrade ladder, nothing answered on the
                    host; the faulted jobs resolve as typed errors, the
                    executor is quarantined, later jobs land on the
                    other executor
    cache_corrupt   the compile-ledger file corrupted on disk ->
                    survivable + journaled (cache.corrupt)
    aot_corrupt     the kernel-library store: corrupt entry ->
                    aot.corrupt + quarantine; truncated manifest ->
                    survivable; torch/CUDA version skew -> aot.skew +
                    eviction; prewarmer SIGKILLed mid-write -> orphan
                    temp ignored, manifest consistent, stale lock broken
    bench_kill      a child SIGKILLed mid-stage -> its salvage heartbeat
                    bundle recovered, matched by pid
    forensics_io    a bundle section writer raises -> per-section
                    isolation (error in manifest, bundle still valid)

The command runs device_loss, device_wedge, compile_fault and
sharded_loss on the card's real graphs (``--device cuda``, the default):
``TorchBlsVerifier(devices=[cuda:0] * 2)`` at bucket 4, the sharded tier
over 2 logical shards of the card at bucket 4 (so that the ring hop
runs), warmed first; the report then carries each kernel's launches over
the campaign's batches (the warmups' launches left out).  Without a card
those scenarios fail: nothing falls back to the host.  ``--device cpu``
is a host rehearsal: the verifier's bucket programs are stubs
(``stub_verifier``), so only the scheduler, health machine, requeue
path, forensics and accounting run (``run_campaign(device=None)``, as
the CPU tests call it).

Usage:
    python -m lodestar_tpu_torch.tools.chaos_campaign --json
    python -m lodestar_tpu_torch.tools.chaos_campaign --seed 7 --json
    python -m lodestar_tpu_torch.tools.chaos_campaign --device cpu --fast

Exit 0 when every scenario holds; 1 otherwise (failures listed).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from .. import tracing
from ..chaos import CHAOS, FaultInjected, FaultPlan, corrupt_file
from ..crypto.bls.verifier import VerificationDroppedError
from ..forensics import salvage
from ..forensics.bundle import latest_bundle
from ..forensics.journal import JOURNAL
from ..forensics.recorder import RECORDER
from . import inspect_bundle as _inspect_bundle

#: the repository root (a child process puts it on its path)
REPO = _inspect_bundle.REPO

#: the card scenarios' bucket: the smallest, which the sharded tier over
#: two shards still admits
CARD_BUCKET = 4


# ---------------------------------------------------------------------------
# verifier construction: real verifier, real scheduler, real
# spans/journal/health — stub bucket programs on the CPU, the card's
# graphs with --device cuda
# ---------------------------------------------------------------------------


class _SlowVerdict:
    """bool() blocks until ready_at — the device-readback stand-in."""

    def __init__(self, ready_at: float, value: bool = True):
        self._ready_at = ready_at
        self._value = value

    def __bool__(self) -> bool:
        rem = self._ready_at - time.monotonic()
        if rem > 0:
            time.sleep(rem)
        return self._value


class _StubProgram:
    """A bucket program's stand-in (per card or over the mesh): its verdict
    True, ``device_s`` after the enqueue."""

    def __init__(self, device_s: float):
        self.device_s = device_s

    def run(self, packed):
        return (_SlowVerdict(time.monotonic() + self.device_s),), None


def make_sets(n: int, start: int = 0, key_mod: int = 8) -> List[Any]:
    from ..crypto.bls.api import interop_secret_key
    from ..crypto.bls.verifier import SingleSignatureSet

    out = []
    for i in range(start, start + n):
        sk = interop_secret_key(i % key_mod)
        msg = bytes([i % 256, (i // 256) % 256]) * 16
        out.append(
            SingleSignatureSet(
                pubkey=sk.to_public_key(),
                signing_root=msg,
                signature=sk.sign(msg).to_bytes(),
            )
        )
    return out


def stub_verifier(n_devices: int = 4, device_s: float = 0.01,
                  backoff_s: float = 0.25, threshold: int = 2,
                  sharded: bool = False, bucket: int = 4):
    """A real ``TorchBlsVerifier`` over ``n_devices`` CPU executors (one
    when 1) whose bucket programs are stubs (``_program`` and, when
    ``sharded``, ``_mesh_program_for``), so the mesh tier routes
    ``bucket``-sized merged batches with no device work."""
    from ..crypto.bls.torch_verifier import TorchBlsVerifier

    v = TorchBlsVerifier(
        device="cpu", devices=["cpu"] * n_devices if n_devices > 1 else None,
        fused=False, host_final_exp=False, buckets=(bucket,),
        quarantine_threshold=threshold, quarantine_backoff_s=backoff_s,
        sharded=sharded, sharded_min_batch=bucket if sharded else None,
    )
    program = _StubProgram(device_s)
    v._program = lambda card, b, load_only=None: program
    if sharded:
        v._mesh_program_for = lambda b, load_only=None: program
    return v


def card_verifier(device: str = "cuda", n_devices: int = 2, backoff_s: float = 0.25,
                  threshold: int = 2, sharded: bool = False, bucket: int = CARD_BUCKET):
    """The card's real programs: the split fused ``TorchBlsVerifier`` over
    ``n_devices`` executors of one card at ``bucket`` (with ``sharded``,
    the tier over as many logical shards at that bucket), its graphs
    warmed."""
    from ..crypto.bls.torch_verifier import TorchBlsVerifier

    v = TorchBlsVerifier(
        device=device, devices=[device] * n_devices, buckets=(bucket,),
        quarantine_threshold=threshold, quarantine_backoff_s=backoff_s,
        sharded=sharded, sharded_min_batch=bucket if sharded else None,
    )
    v.warmup()
    return v


class Bench:
    """What one campaign's device scenarios run on: stub programs on the
    CPU (``device=None``), or the card's graphs."""

    def __init__(self, device: Optional[str] = None):
        self.device = device
        #: each kernel's launches in the card verifiers' warmups, which the
        #: report's ``launches`` leaves out
        self.warmup_launches: Dict[str, int] = {}

    @property
    def card(self) -> bool:
        return self.device is not None

    def verifier(self, n_devices: int = 4, **kw):
        if not self.card:
            return stub_verifier(n_devices=n_devices, **kw)
        from ..ops import fused_core

        before = {n: k.launches for n, k in fused_core.COUNTED.items()}
        v = card_verifier(self.device, n_devices=2, **kw)
        for n, k in fused_core.COUNTED.items():
            self.warmup_launches[n] = (self.warmup_launches.get(n, 0)
                                       + k.launches - before.get(n, 0))
        return v

    @property
    def watchdog(self):
        """(deadline, scan interval, wedge) seconds: a card batch takes
        ~0.1 s and several queue behind one card, so its watchdog and
        wedge are longer than the stubs'."""
        return (0.8, 0.1, 2.0) if self.card else (0.12, 0.04, 0.45)


# ---------------------------------------------------------------------------
# job runner with full verdict accounting
# ---------------------------------------------------------------------------


async def run_jobs(pool, n_jobs: int, sets_per_job: int = 2,
                   spacing_s: float = 0.0, grace_s: float = 20.0) -> Dict[str, Any]:
    """Submit n_jobs and account for EVERY outcome.  ``verdicts_lost``
    is the stranded-future count — the number this whole campaign exists
    to keep at zero.  An injected fault's typed error (``FaultInjected``)
    is an accounted outcome (``faulted``); any other error is listed."""
    outcomes = {"ok": 0, "false": 0, "dropped": 0, "faulted": 0}
    errors: List[str] = []

    async def one(i: int) -> None:
        try:
            ok = await pool.verify_signature_sets(
                make_sets(sets_per_job, start=i * sets_per_job)
            )
            outcomes["ok" if ok else "false"] += 1
        except VerificationDroppedError:
            outcomes["dropped"] += 1
        except FaultInjected:
            outcomes["faulted"] += 1
        except Exception as e:  # noqa: BLE001 — the harness accounts, never dies
            errors.append(f"{type(e).__name__}: {e}")

    t0 = time.monotonic()
    tasks = []
    for i in range(n_jobs):
        tasks.append(asyncio.create_task(one(i)))
        if spacing_s:
            await asyncio.sleep(spacing_s)
    done, pending = await asyncio.wait(tasks, timeout=grace_s)
    for t in pending:
        t.cancel()
    wall = time.monotonic() - t0
    return {
        "jobs": n_jobs,
        "outcomes": outcomes,
        "errors": errors,
        "verdicts_lost": len(pending),
        "sets_per_s": round(n_jobs * sets_per_job / wall, 1) if wall else None,
        "wall_s": round(wall, 3),
    }


def _journal_since(seq_floor: int) -> List[Dict[str, Any]]:
    return [e for e in JOURNAL.events() if e["seq"] >= seq_floor]


def _first(events: List[Dict[str, Any]],
           pred: Callable[[Dict[str, Any]], bool]) -> Optional[Dict[str, Any]]:
    for e in events:
        if pred(e):
            return e
    return None


async def _heal(pool, verifier, deadline_s: float = 8.0):
    """Keep offering light traffic until every executor is healthy again
    (the backoff probe needs real placements to ride).  Returns
    ``(healed, stats)`` — the probe traffic's own verdicts count toward
    the campaign accounting too (a future stranded DURING healing is
    still a stranded future)."""
    stats = {"verdicts_lost": 0, "false": 0, "errors": []}
    t_end = time.monotonic() + deadline_s

    def all_healthy() -> bool:
        return {h["state"] for h in verifier.executor_health().values()} == {"healthy"}

    while time.monotonic() < t_end:
        if all_healthy():
            return True, stats
        r = await run_jobs(pool, 2, spacing_s=0.0, grace_s=5.0)
        stats["verdicts_lost"] += r["verdicts_lost"]
        stats["false"] += r["outcomes"]["false"]
        stats["errors"] += r["errors"]
        await asyncio.sleep(0.05)
    return all_healthy(), stats


def _pool(verifier, flush_threshold: int = 8):
    from ..chain.bls_pool import BlsBatchPool

    return BlsBatchPool(verifier, max_buffer_wait=0.002, flush_threshold=flush_threshold,
                        pipeline_depth=2)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def _validated_bundle(inspect_bundle, bundle_dir: Optional[str],
                      result: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Validate one bundle and fold the outcome into the scenario result."""
    if not bundle_dir:
        result.setdefault("failures", []).append("no bundle written")
        return None
    errs = inspect_bundle.validate(bundle_dir)
    if errs:
        result.setdefault("failures", []).append(
            f"bundle {bundle_dir} invalid: {errs[:3]}"
        )
        return None
    result.setdefault("bundles", []).append(bundle_dir)
    return inspect_bundle.summarize(bundle_dir)


def _pipeline_ok(check_trace, path: str) -> bool:
    """``check_trace PATH --require-pipeline 2``, its OK line kept off
    stdout (``--json`` prints the report there)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return check_trace.main([path, "--require-pipeline", "2"]) == 0


def _finish(res: Dict[str, Any], failures: List[str]) -> Dict[str, Any]:
    if failures:
        res.setdefault("failures", []).extend(failures)
    res["ok"] = not res.get("failures")
    return res


def scenario_device_loss(seed: int, out_dir: str, inspect_bundle,
                         check_trace, fast: bool, bench: Bench) -> Dict[str, Any]:
    res: Dict[str, Any] = {"name": "device_loss"}
    v = bench.verifier(backoff_s=0.25)
    pool = _pool(v)
    RECORDER.configure(forensics_dir=out_dir, pool=pool, verifier=v)
    tracing.TRACER.clear()
    tracing.enable(16384)
    target = v._executors[1].name
    seq0 = JOURNAL.seq
    # a card batch takes ~0.1 s, so on the card the two rates the recovery
    # ratio compares are taken over 96 jobs (~6 s each): over 24 they span
    # ~1.6 s, a few batches, and read 0.92-1.07 in runs alone
    n = 8 if fast else (96 if bench.card else 24)

    async def main():
        baseline = await run_jobs(pool, n)
        CHAOS.install(
            FaultPlan(seed).add("device.loss", match={"device": target}, count=2)
        )
        under_fault = await run_jobs(pool, 12 if fast else 24)
        healed, heal_stats = await _heal(pool, v)
        recovered = await run_jobs(pool, n)
        return baseline, under_fault, healed, heal_stats, recovered

    try:
        baseline, under_fault, healed, heal_stats, recovered = asyncio.run(main())
    finally:
        # a mid-scenario raise must not leak an armed plan, an open pool,
        # or an enabled tracer into the NEXT scenario's assertions
        CHAOS.disarm()
        pool.close()
        tracing.TRACER.disable()

    events = _journal_since(seq0)
    inject = _first(events, lambda e: e.get("kind") == "chaos.inject")
    quarantine = _first(
        events,
        lambda e: e.get("kind") == "bls.health"
        and e.get("state") == "quarantined" and e.get("device") == target,
    )
    readmit = _first(
        events,
        lambda e: e.get("kind") == "bls.health" and e.get("readmitted"),
    )
    requeues = [e for e in events if e.get("kind") == "bls.requeue"]
    runs = (baseline, under_fault, recovered)

    res["baseline_sets_per_s"] = baseline["sets_per_s"]
    res["recovered_sets_per_s"] = recovered["sets_per_s"]
    res["verdicts_lost"] = sum(r["verdicts_lost"] for r in runs) + heal_stats["verdicts_lost"]
    res["errors"] = [e for r in runs for e in r["errors"]] + heal_stats["errors"]
    res["requeued_batches"] = len(requeues)
    failures: List[str] = []
    if res["verdicts_lost"]:
        failures.append(f"{res['verdicts_lost']} stranded futures")
    if res["errors"] or any(r["outcomes"]["faulted"] for r in runs):
        failures.append(f"untyped or unrecovered errors: {res['errors'][:3]}")
    if sum(r["outcomes"]["false"] for r in runs) + heal_stats["false"]:
        failures.append("a lost device produced a False verdict")
    if not requeues:
        failures.append("no bls.requeue event — the failed batch was not requeued")
    if quarantine is None:
        failures.append(f"{target} was never quarantined")
    if readmit is None or not healed:
        failures.append(f"{target} was never re-admitted")
    if inject is not None and quarantine is not None:
        res["time_to_quarantine_s"] = round(
            (quarantine["ts_ns"] - inject["ts_ns"]) / 1e9, 3
        )
    if inject is not None and readmit is not None:
        res["time_to_recover_s"] = round(
            (readmit["ts_ns"] - inject["ts_ns"]) / 1e9, 3
        )
    if baseline["sets_per_s"] and recovered["sets_per_s"]:
        ratio = recovered["sets_per_s"] / baseline["sets_per_s"]
        res["throughput_recovery_ratio"] = round(ratio, 3)
        if ratio < 0.9:
            failures.append(
                f"throughput recovered to only {ratio:.0%} of baseline"
            )

    summary = _validated_bundle(inspect_bundle, latest_bundle(out_dir), res)
    if summary is not None:
        ch = summary.get("chaos") or {}
        if (ch.get("last_fault") or {}).get("seam") != "device.loss":
            failures.append("bundle chaos section missing the injected fault")

    # the requeued cid must still pass the pipeline gate (check_trace
    # accepts bls.requeue and demands the re-dispatch)
    trace_path = os.path.join(out_dir, "device_loss_trace.json")
    tracing.write_chrome_trace(tracing.TRACER, trace_path)
    if not _pipeline_ok(check_trace, trace_path):
        failures.append("trace with requeued batches failed --require-pipeline")
    res["trace"] = trace_path
    v.close()
    return _finish(res, failures)


def scenario_sharded_loss(seed: int, out_dir: str, inspect_bundle,
                          check_trace, fast: bool, bench: Bench) -> Dict[str, Any]:
    """device.loss DURING a mesh-spanning sharded batch.  The verdict must
    still resolve (the same packed payload requeued onto one executor —
    zero verdicts lost), the mesh health record must quarantine and later
    re-admit via the backoff probe, and the trace — mesh dispatch spans
    included — must pass check_trace's pipeline + mesh rules."""
    res: Dict[str, Any] = {"name": "sharded_loss"}
    # the stubs: the JAX campaign's 4 executors at bucket 8; the card: 2
    # logical shards at bucket 4
    bucket = CARD_BUCKET if bench.card else 8
    v = bench.verifier(backoff_s=0.25, threshold=1, sharded=True, bucket=bucket)
    per_job = bucket // 2
    pool = _pool(v, flush_threshold=bucket)
    RECORDER.configure(forensics_dir=out_dir, pool=pool, verifier=v)
    tracing.TRACER.clear()
    tracing.enable(16384)
    target = v._mesh_ex.name
    seq0 = JOURNAL.seq
    n = 8 if fast else 16

    async def main():
        baseline = await run_jobs(pool, n, sets_per_job=per_job)
        CHAOS.install(
            FaultPlan(seed).add("device.loss", match={"device": target}, count=1)
        )
        under_fault = await run_jobs(pool, n, sets_per_job=per_job)
        healed, heal_stats = await _heal(pool, v)
        recovered = await run_jobs(pool, n, sets_per_job=per_job)
        return baseline, under_fault, healed, heal_stats, recovered

    try:
        baseline, under_fault, healed, heal_stats, recovered = asyncio.run(main())
    finally:
        CHAOS.disarm()
        pool.close()
        tracing.TRACER.disable()

    events = _journal_since(seq0)
    quarantine = _first(
        events,
        lambda e: e.get("kind") == "bls.health"
        and e.get("state") == "quarantined" and e.get("device") == target,
    )
    readmit = _first(
        events,
        lambda e: e.get("kind") == "bls.health" and e.get("readmitted")
        and e.get("device") == target,
    )
    requeues = [
        e for e in events
        if e.get("kind") == "bls.requeue" and e.get("from_device") == target
    ]
    mesh_dispatches = [
        e for e in events
        if e.get("kind") == "bls.dispatch" and e.get("sharded")
    ]
    runs = (baseline, under_fault, recovered)

    res["verdicts_lost"] = sum(r["verdicts_lost"] for r in runs) + heal_stats["verdicts_lost"]
    res["errors"] = [e for r in runs for e in r["errors"]] + heal_stats["errors"]
    res["mesh_batches"] = len(mesh_dispatches)
    res["requeued_batches"] = len(requeues)
    res["sharded_batches"] = v.sharded_batches
    failures: List[str] = []
    if res["verdicts_lost"]:
        failures.append(f"{res['verdicts_lost']} stranded futures")
    if res["errors"] or any(r["outcomes"]["faulted"] for r in runs):
        failures.append(f"untyped or unrecovered errors: {res['errors'][:3]}")
    if sum(r["outcomes"]["false"] for r in runs) + heal_stats["false"]:
        failures.append("a lost mesh produced a False verdict")
    if not mesh_dispatches:
        failures.append("no sharded bls.dispatch — the mesh tier never engaged")
    if not any(e.get("mesh_devices", 0) >= 2 for e in mesh_dispatches):
        failures.append("sharded dispatch events missing mesh_devices >= 2")
    if not requeues:
        failures.append(
            "no bls.requeue from the mesh — the failed sharded batch "
            "was not replayed on a survivor"
        )
    if quarantine is None:
        failures.append(f"{target} was never quarantined")
    if readmit is None or not healed:
        failures.append(f"{target} was never re-admitted")
    if v.sharded is not True:
        failures.append(
            "sharded tier disabled by a SYNC fault — sync faults must ride "
            "the health machine, not the tier's switch"
        )

    # the mesh dump must pass the pipeline gate INCLUDING the mesh rules
    # (mesh_devices present, devices_total honest)
    trace_path = os.path.join(out_dir, "sharded_loss_trace.json")
    tracing.write_chrome_trace(tracing.TRACER, trace_path)
    if not _pipeline_ok(check_trace, trace_path):
        failures.append("mesh trace failed --require-pipeline")
    res["trace"] = trace_path
    v.close()
    return _finish(res, failures)


def scenario_device_wedge(seed: int, out_dir: str, inspect_bundle,
                          check_trace, fast: bool, bench: Bench) -> Dict[str, Any]:
    res: Dict[str, Any] = {"name": "device_wedge"}
    deadline_s, interval_s, wedge_s = bench.watchdog
    v = bench.verifier(backoff_s=0.2, threshold=2)
    pool = _pool(v)
    RECORDER.configure(forensics_dir=out_dir, pool=pool, verifier=v)
    RECORDER.start_watchdog(deadline_s=deadline_s, interval_s=interval_s)
    target = v._executors[min(2, len(v._executors) - 1)].name
    seq0 = JOURNAL.seq
    CHAOS.install(
        FaultPlan(seed).add("device.wedge", match={"device": target},
                            count=1, wedge_s=wedge_s)
    )

    async def main():
        under_fault = await run_jobs(pool, 10 if fast else 20)
        healed, heal_stats = await _heal(pool, v)
        return under_fault, healed, heal_stats

    try:
        under_fault, healed, heal_stats = asyncio.run(main())
    finally:
        # never leak the short watchdog (or the pool) into later
        # scenarios — it would flag their normal in-flight batches and
        # write spurious bundles into their directories
        CHAOS.disarm()
        RECORDER.stop_watchdog()
        pool.close()

    events = _journal_since(seq0)
    stall = _first(events, lambda e: e.get("kind") == "watchdog.stall")
    failures: List[str] = []
    res["verdicts_lost"] = (
        under_fault["verdicts_lost"] + heal_stats["verdicts_lost"]
    )
    if res["verdicts_lost"]:
        failures.append(f"{res['verdicts_lost']} stranded futures")
    if under_fault["errors"] or heal_stats["errors"] or under_fault["outcomes"]["faulted"]:
        failures.append(
            f"untyped errors: {(under_fault['errors'] + heal_stats['errors'])[:3]}"
        )
    if under_fault["outcomes"]["false"] or heal_stats["false"]:
        failures.append("a wedged device produced a False verdict")
    if stall is None:
        failures.append("watchdog never flagged the wedged batch")
    elif stall.get("device") != target:
        failures.append(
            f"watchdog named {stall.get('device')}, wedge was on {target}"
        )
    if not healed:
        failures.append("pool did not return to all-healthy")
    summary = _validated_bundle(inspect_bundle, latest_bundle(out_dir), res)
    if summary is not None and summary.get("reason") != "watchdog":
        # the newest bundle may be the quarantine/requeue one — find the
        # watchdog bundle explicitly
        watchdog_bundles = [
            os.path.join(out_dir, n) for n in os.listdir(out_dir)
            if n.startswith("bundle-watchdog")
        ]
        if not watchdog_bundles:
            failures.append("no watchdog bundle written for the wedge")
        else:
            _validated_bundle(inspect_bundle, watchdog_bundles[0], res)
    v.close()
    return _finish(res, failures)


def scenario_compile_fault(seed: int, out_dir: str, inspect_bundle,
                           check_trace, fast: bool, bench: Bench) -> Dict[str, Any]:
    """The port's counterpart of the JAX campaign's ``compile_ladder``: the
    port has no degrade ladder, so a ``bls.compile`` fault raises.  At
    warmup, ``warmup()`` raises before any batch; at dispatch, the batch's
    jobs resolve as the fault's typed error (counted, never stranded, never
    answered on the host), its executor is quarantined and later jobs
    land on the other executor until the probe re-admits it."""
    from ..chaos import InjectedCompileError

    res: Dict[str, Any] = {"name": "compile_fault"}
    failures: List[str] = []
    v = bench.verifier(n_devices=2, threshold=1, backoff_s=1.0)
    pool = _pool(v)
    RECORDER.configure(forensics_dir=out_dir, pool=pool, verifier=v)
    first, second = (ex.name for ex in v._executors)
    seq0 = JOURNAL.seq
    d0 = v.dispatches

    # -- at warmup: raises, nothing dispatched -----------------------------
    CHAOS.install(FaultPlan(seed).add("bls.compile", match={"where": "warmup"}, count=1))
    try:
        v.warmup()
        res["warmup_raised"] = None
    except InjectedCompileError as e:
        res["warmup_raised"] = type(e).__name__
    CHAOS.disarm()
    if res["warmup_raised"] != "InjectedCompileError":
        failures.append(f"a warmup compile fault did not raise ({res['warmup_raised']})")
    if v.dispatches != d0:
        failures.append("a batch was dispatched by the faulted warmup")

    # -- at dispatch: one job on each executor's first placement faults ----
    async def main():
        # every dispatch faults until both executors have raised once: the
        # merged batch on one, its per-job retry on the other
        CHAOS.install(FaultPlan(seed).add("bls.compile", match={"where": "dispatch"},
                                          count=2))
        faulted = await run_jobs(pool, 1)
        CHAOS.disarm()
        healed_a, heal_a = await _heal(pool, v)
        # a fault on the first executor only: quarantined at once
        # (threshold 1), its batch's jobs retried on the second
        CHAOS.install(FaultPlan(seed + 1).add(
            "bls.compile", match={"where": "dispatch", "device": first}))
        direct = None
        try:
            # the placement's cursor may name either executor: dispatch
            # until the fault fires on ``first``
            for i in range(4):
                v.verify_signature_sets(make_sets(2, start=100 + 2 * i))
        except InjectedCompileError as e:
            direct = type(e).__name__
        during = await run_jobs(pool, 4)
        CHAOS.disarm()
        healed_b, heal_b = await _heal(pool, v, deadline_s=8.0)
        recovered = await run_jobs(pool, 4)
        return faulted, healed_a and healed_b, [heal_a, heal_b], direct, during, recovered

    try:
        faulted, healed, heals, direct, during, recovered = asyncio.run(main())
    finally:
        CHAOS.disarm()
        pool.close()

    events = _journal_since(seq0)
    injected = [e for e in events if e.get("kind") == "chaos.inject"
                and e.get("seam") == "bls.compile"]
    dispatch_devices = [e.get("device") for e in events if e.get("kind") == "bls.dispatch"]
    runs = (faulted, during, recovered)
    res["faults_injected"] = len(injected)
    res["faulted_jobs"] = faulted["outcomes"]["faulted"]
    res["direct_raised"] = direct
    res["verdicts_lost"] = (sum(r["verdicts_lost"] for r in runs)
                            + sum(h["verdicts_lost"] for h in heals))
    res["errors"] = [e for r in runs for e in r["errors"]] + [
        e for h in heals for e in h["errors"]]
    if res["verdicts_lost"]:
        failures.append(f"{res['verdicts_lost']} stranded futures")
    if res["errors"]:
        failures.append(f"untyped errors: {res['errors'][:3]}")
    if faulted["outcomes"] != {"ok": 0, "false": 0, "dropped": 0, "faulted": 1}:
        failures.append(f"the faulted job did not resolve as its typed error: "
                        f"{faulted['outcomes']}")
    if direct != "InjectedCompileError":
        failures.append(f"a dispatch fault on {first} did not raise ({direct})")
    if during["outcomes"]["ok"] != 4 or recovered["outcomes"]["ok"] != 4:
        failures.append(f"jobs after the fault did not verify: {during['outcomes']}, "
                        f"{recovered['outcomes']}")
    # between the last quarantine of ``first`` and its probe, every batch
    # lands on ``second``
    last_q = [e for e in events if e.get("kind") == "bls.health"
              and e.get("device") == first and e.get("state") == "quarantined"]
    if last_q:
        probe = _first([e for e in events if e["seq"] > last_q[-1]["seq"]],
                       lambda e: e.get("kind") == "bls.health"
                       and e.get("device") == first and e.get("state") == "probing")
        stop = probe["seq"] if probe is not None else JOURNAL.seq
        landed = {e.get("device") for e in events if e.get("kind") == "bls.dispatch"
                  and last_q[-1]["seq"] < e["seq"] < stop}
        res["landed_during_quarantine"] = sorted(landed)
        if landed - {second}:
            failures.append(f"a batch landed on quarantined {first}: {sorted(landed)}")
    if not last_q:
        failures.append(f"{first} was never quarantined")
    if not healed:
        failures.append("the executors were not re-admitted")
    names = {ex.name for ex in v._executors} | {v._mesh_ex.name}
    if set(dispatch_devices) - names:
        failures.append(f"a batch ran off the executors: {sorted(set(dispatch_devices))}")
    summary = _validated_bundle(inspect_bundle, latest_bundle(out_dir), res)
    if summary is not None:
        ch = summary.get("chaos") or {}
        if (ch.get("last_fault") or {}).get("seam") != "bls.compile":
            failures.append("bundle chaos section missing the compile fault")
    v.close()
    return _finish(res, failures)


def scenario_cache_corrupt(seed: int, out_dir: str, inspect_bundle,
                           check_trace, fast: bool, bench: Bench) -> Dict[str, Any]:
    res: Dict[str, Any] = {"name": "cache_corrupt"}
    from ..observatory.compile_ledger import CompileLedger

    seq0 = JOURNAL.seq
    failures: List[str] = []
    ledger_path = os.path.join(out_dir, "compile_ledger.json")
    ledger = CompileLedger().configure(path=ledger_path)
    ledger.record("kernels", None, "sm_90", "build", 2.0)  # flushed at once
    if not os.path.exists(ledger_path):
        failures.append("ledger never persisted (scenario setup)")
    else:
        # flip bytes until the JSON actually breaks (a 16-byte flip all
        # landing in string payloads could, in principle, still parse) —
        # each round is still seed-deterministic
        for attempt in range(4):
            offsets = corrupt_file(ledger_path, seed=seed + attempt)
            try:
                with open(ledger_path) as f:
                    json.load(f)
            except ValueError:
                break
        res["flipped_offsets"] = offsets[:8]
        # determinism: the same seed flips the same bytes
        probe = os.path.join(out_dir, "probe.bin")
        with open(probe, "wb") as f:
            f.write(b"A" * 256)
        first = corrupt_file(probe, seed=seed)
        with open(probe, "wb") as f:
            f.write(b"A" * 256)
        second = corrupt_file(probe, seed=seed)
        if first != second:
            failures.append("corrupt_file is not deterministic for a fixed seed")
        # survival: a fresh ledger over the corrupt file must come up
        # empty-but-alive, and must journal the corruption
        fresh = CompileLedger().configure(path=ledger_path)
        if fresh.to_dict():
            failures.append("corrupt ledger produced baseline records")
        events = _journal_since(seq0)
        if _first(events, lambda e: e.get("kind") == "cache.corrupt") is None:
            failures.append("no cache.corrupt journal event — corruption invisible")
    RECORDER.configure(forensics_dir=out_dir)
    bundle = RECORDER.dump("cache-corrupt", metric_reason="chaos")
    _validated_bundle(inspect_bundle, bundle, res)
    res["verdicts_lost"] = 0
    return _finish(res, failures)


#: the store's entry key parts for the scenario's stand-in payload (the
#: store copies and checksums a payload; it never opens one unasked)
_ENTRY, _DIGEST, _CAP = "kernels", "0123456789abcdef", "sm_90"

_MIDWRITE_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from lodestar_tpu_torch.aot.store import KernelLibraryStore
from lodestar_tpu_torch.chaos import CHAOS, FaultPlan
CHAOS.install(FaultPlan.from_json(sys.argv[2]))
KernelLibraryStore(path=sys.argv[3]).save("kernels", ("-Dmidwrite",), "0123456789abcdef",
                                          sys.argv[4], "sm_90")
sys.exit(7)  # the plan did not fire: the parent treats this as a failure
"""


def _payload(path: str, seed: int) -> str:
    """A stand-in library payload: 4 KiB of seeded bytes."""
    import random

    with open(path, "wb") as f:
        f.write(random.Random(seed).randbytes(4096))
    return path


def scenario_aot_corrupt(seed: int, out_dir: str, inspect_bundle,
                         check_trace, fast: bool, bench: Bench) -> Dict[str, Any]:
    res: Dict[str, Any] = {"name": "aot_corrupt", "verdicts_lost": 0}
    failures: List[str] = []
    from ..aot.store import KernelLibraryStore

    seq0 = JOURNAL.seq
    store_dir = os.path.join(out_dir, "aot_store")
    store = KernelLibraryStore(path=store_dir)
    payload = _payload(os.path.join(out_dir, "library.so"), seed)

    def save(st, extra):
        return st.save(_ENTRY, extra, _DIGEST, payload, _CAP)

    def load(st, extra):
        return st.load(_ENTRY, extra, _DIGEST, _CAP)

    # -- corrupt entry: checksum rejection + quarantine ----------------------
    key = save(store, ())
    if key is None:
        failures.append("store save failed (scenario setup)")
    else:
        fpath = os.path.join(store_dir, store.keys()[key]["file"])
        res["flipped_offsets"] = corrupt_file(fpath, seed=seed)[:8]
        fresh = KernelLibraryStore(path=store_dir)
        if load(fresh, ()) is not None:
            failures.append("corrupt store entry still loaded")
        if fresh.corrupt != 1:
            failures.append("corrupt entry not counted as corrupt")
        if not os.path.exists(fpath + ".quarantined"):
            failures.append("corrupt entry was not quarantined aside")

    # -- torch / CUDA version skew: eviction ----------------------------------
    mpath = os.path.join(store_dir, "manifest.json")
    for field in ("torch", "cuda"):
        extra = (f"-Dskew_{field}",)
        key2 = save(store, extra)
        if key2 is None:
            failures.append(f"store save failed ({field} skew setup)")
            continue
        with open(mpath) as f:
            doc = json.load(f)
        doc["entries"][key2][field] = "0.0.0-skewed"
        with open(mpath, "w") as f:
            json.dump(doc, f)
        skewed = KernelLibraryStore(path=store_dir)
        if load(skewed, extra) is not None:
            failures.append(f"{field}-skewed entry still loaded")
        if skewed.skew != 1:
            failures.append(f"{field}-skewed entry not counted as skew")
        if key2 in skewed.keys():
            failures.append(f"{field}-skewed entry not evicted from the manifest")

    # -- truncated manifest: survivable + journaled --------------------------
    save(store, ("-Dtruncated",))
    with open(mpath, "rb") as f:
        blob = f.read()
    with open(mpath, "wb") as f:
        f.write(blob[: max(1, len(blob) // 2)])
    truncated = KernelLibraryStore(path=store_dir)
    if truncated.keys() != {}:
        failures.append("truncated manifest produced entries")
    if save(truncated, ("-Dafter",)) is None or load(
            KernelLibraryStore(path=store_dir), ("-Dafter",)) is None:
        failures.append("the store did not serve a new entry after the truncation")

    # -- prewarmer killed mid-write (its own pristine store, so the
    # orphan/lock assertions are not confounded by the faults above) ---------
    kill_dir = os.path.join(out_dir, "aot_store_midwrite")
    plan = FaultPlan(seed).add("aot.midwrite", count=1)
    try:
        proc = subprocess.run([sys.executable, "-c", _MIDWRITE_CHILD, REPO, plan.to_json(),
                               kill_dir, payload], capture_output=True, text=True, timeout=120)
        res["midwrite_exitcode"] = proc.returncode
        if proc.returncode != -9:
            failures.append(f"midwrite child exitcode {proc.returncode}, expected -9: "
                            f"{proc.stderr[-300:]}")
    except subprocess.TimeoutExpired:
        failures.append("midwrite child never died (plan did not fire)")
    entries_dir = os.path.join(kill_dir, "entries")
    orphans = [
        n for n in (os.listdir(entries_dir) if os.path.isdir(entries_dir) else [])
        if ".tmp" in n
    ]
    res["orphan_temp_files"] = len(orphans)
    if not orphans:
        failures.append("no orphan temp file from the killed writer")
    if not os.path.exists(os.path.join(kill_dir, "store.lock")):
        failures.append("the killed writer left no lock behind")
    after_kill = KernelLibraryStore(path=kill_dir)
    if load(after_kill, ("-Dmidwrite",)) is not None:
        failures.append("half-written entry was loadable")
    if after_kill.corrupt:
        failures.append("orphan temp misclassified as corruption (must be a plain miss)")
    if after_kill.keys() != {}:
        failures.append("the killed writer's manifest row exists")
    # the dead child's writer lock must not wedge the next writer
    if save(after_kill, ()) is None:
        failures.append("stale writer lock from the killed child wedged the next save")
    if after_kill.verify()["orphans"] != orphans:
        failures.append("the sweep does not list the killed writer's temp file")

    # -- the node still verifies: a live pool over stub programs --------------
    v = stub_verifier(n_devices=2)
    pool = _pool(v)
    RECORDER.configure(forensics_dir=out_dir, pool=pool, verifier=v)
    try:
        recovered = asyncio.run(run_jobs(pool, 4 if fast else 8))
    finally:
        pool.close()
        v.close()
    res["verdicts_lost"] = recovered["verdicts_lost"]
    if recovered["verdicts_lost"]:
        failures.append(f"{recovered['verdicts_lost']} stranded futures")
    if recovered["outcomes"]["ok"] != recovered["jobs"] or recovered["errors"]:
        failures.append(
            f"post-fault verdicts wrong: {recovered['outcomes']}, "
            f"{recovered['errors'][:2]}"
        )

    # -- evidence: journal events + a triagable bundle (the midwrite kill's
    # chaos.inject lives in the CHILD's journal and dies with it — its
    # evidence is the -9 exit code + the orphan temp asserted above) --------
    events = _journal_since(seq0)
    for kind in ("aot.corrupt", "aot.skew"):
        if _first(events, lambda e, k=kind: e.get("kind") == k) is None:
            failures.append(f"no {kind} journal event — fault invisible")
    if _first(events, lambda e: e.get("kind") == "aot.lock_broken") is None:
        failures.append("no aot.lock_broken journal event for the dead writer's lock")
    bundle = RECORDER.dump("aot-corrupt", metric_reason="chaos")
    summary = _validated_bundle(inspect_bundle, bundle, res)
    if summary is not None:
        aot = summary.get("aot") or {}
        if not aot.get("last_corrupt"):
            failures.append("bundle aot triage missing the corrupt event")
        if not aot.get("last_skew"):
            failures.append("bundle aot triage missing the skew event")
        if not aot.get("store"):
            failures.append("bundle aot triage missing the store path")
    return _finish(res, failures)


_KILL_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
os.environ["BENCH_FORENSICS_DIR"] = sys.argv[4]
from lodestar_tpu_torch.chaos import CHAOS, FaultPlan
from lodestar_tpu_torch.forensics import salvage
CHAOS.install(FaultPlan.from_json(sys.argv[2]))
hb = salvage.Heartbeat(sys.argv[3], interval_s=30.0)
hb.beat()  # one synchronous snapshot so evidence exists before death
CHAOS.maybe_kill("bench.kill", stage=sys.argv[3])
hb.stop()  # the plan did not target us: exit clean (a scenario failure)
"""


def scenario_bench_kill(seed: int, out_dir: str, inspect_bundle,
                        check_trace, fast: bool, bench: Bench) -> Dict[str, Any]:
    """A stage child that heartbeats once, then dies the way a wedged
    stage does (SIGKILL from outside has the same observable shape as the
    seam's in-process one); its parent recovers the bundle by pid."""
    res: Dict[str, Any] = {"name": "bench_kill", "verdicts_lost": 0}
    failures: List[str] = []
    stage = "chaos_kill_stage"
    plan = FaultPlan(seed).add("bench.kill", count=1)
    proc = subprocess.Popen([sys.executable, "-c", _KILL_CHILD, REPO, plan.to_json(), stage,
                             out_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        _, err = proc.communicate(timeout=120)
        if proc.returncode != -9:
            failures.append(f"child exitcode {proc.returncode}, expected -9 (SIGKILL): "
                            f"{err[-300:]}")
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        failures.append("kill child never died (plan did not fire)")
    prev = os.environ.get(salvage.BASE_DIR_ENV)
    os.environ[salvage.BASE_DIR_ENV] = out_dir
    try:
        bundle = salvage.latest_stage_bundle(stage, pid=proc.pid)
        stranger = salvage.latest_stage_bundle(stage, pid=proc.pid + 1)
    finally:
        if prev is None:
            os.environ.pop(salvage.BASE_DIR_ENV, None)
        else:
            os.environ[salvage.BASE_DIR_ENV] = prev
    if stranger is not None:
        failures.append("another pid's lookup returned the killed child's bundle")
    if bundle is None:
        failures.append("no pid-scoped salvage bundle from the killed child")
    else:
        summary = _validated_bundle(inspect_bundle, bundle, res)
        if summary is not None:
            ch = summary.get("chaos") or {}
            if not ch.get("armed"):
                failures.append("salvage bundle missing the armed chaos plan")
    return _finish(res, failures)


def scenario_forensics_io(seed: int, out_dir: str, inspect_bundle,
                          check_trace, fast: bool, bench: Bench) -> Dict[str, Any]:
    res: Dict[str, Any] = {"name": "forensics_io", "verdicts_lost": 0}
    failures: List[str] = []
    RECORDER.configure(forensics_dir=out_dir)
    CHAOS.install(
        FaultPlan(seed).add("forensics.io", match={"section": "trace.json"},
                            count=1)
    )
    bundle = RECORDER.dump("chaos-io", metric_reason="chaos")
    CHAOS.disarm()
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    errs = manifest.get("errors") or {}
    if "trace.json" not in errs:
        failures.append(
            "injected section IO error not recorded in manifest.errors"
        )
    if "trace.json" in manifest.get("files", []):
        failures.append("failed section still listed as written")
    # partial evidence must still validate (per-section isolation)
    _validated_bundle(inspect_bundle, bundle, res)
    return _finish(res, failures)


SCENARIOS = (
    scenario_device_loss,
    scenario_sharded_loss,
    scenario_device_wedge,
    scenario_compile_fault,
    scenario_cache_corrupt,
    scenario_aot_corrupt,
    scenario_bench_kill,
    scenario_forensics_io,
)

#: the scenarios ``--device cuda`` runs on the card's graphs
CARD_SCENARIOS = ("device_loss", "device_wedge", "compile_fault", "sharded_loss")


def run_campaign(seed: int = 0, out_dir: Optional[str] = None,
                 fast: bool = False, scenarios=SCENARIOS,
                 device: Optional[str] = None) -> Dict[str, Any]:
    """The whole campaign; returns the report dict (``ok`` is the gate).
    ``device``: None, stub programs on the CPU; a CUDA device, the card
    scenarios on its real graphs (and the report carries each kernel's
    launches over the campaign's batches, ``launches``, apart from those
    of the verifiers' warmups, ``warmup_launches``)."""
    import tempfile

    bench = Bench(device)
    check_trace = _inspect_bundle._load_check_trace()
    if out_dir is None:
        out_dir = tempfile.mkdtemp(prefix="lodestar-torch-chaos-")
    os.makedirs(out_dir, exist_ok=True)
    report: Dict[str, Any] = {
        "seed": seed, "out_dir": out_dir, "device": device or "cpu (stub programs)",
        "scenarios": {},
    }
    if bench.card:
        from ..ops import fused_core, ring_gather  # noqa: F401 — the ring hop's counter

        fused_core.reset_launch_counts()
    verdicts_lost = 0
    bundles: List[str] = []
    for fn in scenarios:
        name = fn.__name__.replace("scenario_", "")
        scen_dir = os.path.join(out_dir, name)
        os.makedirs(scen_dir, exist_ok=True)
        t0 = time.perf_counter()
        try:
            out = fn(seed, scen_dir, _inspect_bundle, check_trace, fast, bench)
        except Exception as e:  # noqa: BLE001 — one broken scenario must not
            out = {                    # hide the others' results
                "name": name, "ok": False,
                "failures": [f"scenario raised {type(e).__name__}: {e}"],
            }
        finally:
            CHAOS.disarm()
        out["wall_s"] = round(time.perf_counter() - t0, 3)
        out["on_card"] = bench.card and name in CARD_SCENARIOS
        report["scenarios"][out.get("name", name)] = out
        verdicts_lost += int(out.get("verdicts_lost") or 0)
        bundles.extend(out.get("bundles") or [])
    loss = report["scenarios"].get("device_loss", {})
    report["verdicts_lost"] = verdicts_lost
    report["bundles_validated"] = len(bundles)
    report["time_to_quarantine_s"] = loss.get("time_to_quarantine_s")
    report["time_to_recover_s"] = loss.get("time_to_recover_s")
    report["throughput_recovery_ratio"] = loss.get("throughput_recovery_ratio")
    if bench.card:
        from ..ops import fused_core

        report["launches"] = {n: k.launches - bench.warmup_launches.get(n, 0)
                              for n, k in fused_core.COUNTED.items()}
        report["warmup_launches"] = dict(bench.warmup_launches)
    report["failures"] = {
        name: s["failures"]
        for name, s in report["scenarios"].items() if s.get("failures")
    }
    report["ok"] = verdicts_lost == 0 and all(
        s.get("ok") for s in report["scenarios"].values()
    )
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None,
                    help="bundle/trace scratch directory (default: mkdtemp)")
    ap.add_argument("--fast", action="store_true",
                    help="smaller job counts (the CPU tests' size)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the device scenarios on the card's graphs (the "
                    "default); cpu: a host rehearsal over stub bucket programs")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    report = run_campaign(seed=args.seed, out_dir=args.out_dir, fast=args.fast,
                          device="cuda" if args.device == "cuda" else None)
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    else:
        for name, s in report["scenarios"].items():
            mark = "ok " if s.get("ok") else "FAIL"
            print(f"{mark} {name}")
            for f in s.get("failures") or []:
                print(f"      {f}")
        print(
            f"verdicts_lost={report['verdicts_lost']} "
            f"bundles_validated={report['bundles_validated']} "
            f"time_to_quarantine_s={report['time_to_quarantine_s']} "
            f"time_to_recover_s={report['time_to_recover_s']} "
            f"recovery_ratio={report['throughput_recovery_ratio']}"
        )
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
