"""Firehose: sustained-load harness for the BLS verification path (the
port's copy of the repo's ``tools/firehose.py``, over the port's
``BlsBatchPool`` and, by default, the card's verifier).

Replays a configurable, mainnet-shaped duty mix (unaggregated
attestations, aggregates, sync-committee messages, block proposals —
each on its QoS lane) against a real ``BlsBatchPool`` at a target
sets/sec for a sustained window, and reports what the node would feel:

- p50/p99 queue wait (from the ``bls.queue_wait`` spans the pool already
  emits) overall and per lane, and p50/p99 end-to-end verify latency,
  overall and per duty;
- full drop accounting: every offered set ends as verified, typed-dropped
  (``bls_pool_dropped_total{reason,lane}`` analog, read back from
  ``pool.dropped_sets``), shed at intake by backpressure, or errored —
  and the harness asserts nothing is left stranded;
- backpressure behavior: while ``pool.overloaded`` the harness sheds its
  storm-lane submissions exactly as the gossip router does
  (``network/gossip.sheddable_topic``), so an overload run shows intake
  slowing instead of the queue growing without bound: the report holds
  the pending sets' peak (read at every tick) beside the bound that
  backpressure sets (``pending_sets_bound``).

This is the harness that measures the node under SUSTAINED load and
proves the overload machinery (lanes / deadline shedding / eviction /
backpressure) survives offered load > capacity.

Usage:

    # the card: a split fused TorchBlsVerifier on cuda:0 at buckets 4,
    # 16 and 128, its graphs warmed before the window opens
    python -m lodestar_tpu_torch.tools.firehose --rate 150 --seconds 10
    python -m lodestar_tpu_torch.tools.firehose --rate 1000 --seconds 5 --deadline-ms 400
    # the host: the port's C verifier, or a stub with no verification
    python -m lodestar_tpu_torch.tools.firehose --verifier native --rate 300 --seconds 5
    python -m lodestar_tpu_torch.tools.firehose --verifier stub --rate 2000 --seconds 10

``chip_smoke.py`` phase 20 drives ``run_firehose`` in-process on the
card; ``tests/test_torch_firehose.py`` runs seconds-scale stub runs.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import tracing
from ..chain.bls_pool import BlsBatchPool
from ..crypto.bls.verifier import SignatureSetPriority, VerificationDroppedError
from ..observatory.latency import nearest_rank

#: duty name -> (lane, sets per job).  The job mix below approximates the
#: gossip traffic of a large validator set: storms of single attestations,
#: a steady aggregate flow (3 sets per aggregate-and-proof job), per-slot
#: sync-committee messages, and the rare block (a block-import job carries
#: a block's worth of sets on the block_proposal lane).
DUTIES: Dict[str, Tuple[SignatureSetPriority, int]] = {
    "unaggregated": (SignatureSetPriority.UNAGGREGATED, 1),
    "aggregate": (SignatureSetPriority.AGGREGATE, 3),
    "sync_committee": (SignatureSetPriority.SYNC_COMMITTEE, 1),
    "block_proposal": (SignatureSetPriority.BLOCK_PROPOSAL, 32),
}

#: default job mix (fractions of JOBS, not sets)
DEFAULT_MIX: Dict[str, float] = {
    "unaggregated": 0.80,
    "aggregate": 0.12,
    "sync_committee": 0.075,
    "block_proposal": 0.005,
}

#: lanes the gossip router sheds at intake under backpressure
#: (mirrors network/gossip.sheddable_topic)
SHEDDABLE_LANES = (
    SignatureSetPriority.UNAGGREGATED,
    SignatureSetPriority.SYNC_COMMITTEE,
)


class _StubSet:
    """Opaque signature-set stand-in for stub runs (the pool only ever
    len()s and forwards sets; the stub verifier ignores their content)."""

    __slots__ = ()


class StubVerifier:
    """Deterministic stage-split verifier with a configurable capacity:
    pack blocks the calling thread for ``pack_ms``, the 'device' finishes
    ``dispatch_ms + per_set_us * n`` after enqueue, ``result()`` blocks
    until then — the TorchBlsVerifier timing shape without a card or a
    kernel build.  The parameters and defaults are the JAX harness's."""

    def __init__(self, pack_ms: float = 1.0, dispatch_ms: float = 4.0,
                 per_set_us: float = 50.0, n_devices: int = 1,
                 verdict: bool = True):
        self.pack_ms = pack_ms
        self.dispatch_ms = dispatch_ms
        self.per_set_us = per_set_us
        self.n_devices = n_devices
        self.verdict = verdict
        self.dispatches = 0
        self.sets_seen = 0

    def verify_signature_sets_async(self, sets, deadline: Optional[float] = None):
        time.sleep(self.pack_ms / 1e3)  # host pack (worker thread)
        self.dispatches += 1
        self.sets_seen += len(sets)
        ready_at = time.monotonic() + (
            self.dispatch_ms + self.per_set_us * len(sets) / 1e3
        ) / 1e3
        verdict = self.verdict

        class _Pending:
            device = "stub:0"

            def result(_self) -> bool:
                rem = ready_at - time.monotonic()
                if rem > 0:
                    time.sleep(rem)  # device sync (worker thread)
                return verdict

        return _Pending()

    def verify_signature_sets(self, sets):
        return self.verify_signature_sets_async(sets).result()

    def close(self) -> None:
        return None


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty input:
    ``observatory.latency.nearest_rank``, so that a p99 read here and one
    read off the latency histograms land in one bucket."""
    return nearest_rank(values, q)


def make_pool(verifier, flush_threshold: int = 128, pipeline_depth: int = 2,
              max_queue_length: int = 8192, high_water: Optional[int] = None) -> BlsBatchPool:
    """The pool a firehose window runs over: the node's ``BlsBatchPool``
    with a 10 ms buffer wait (``high_water`` None: half the queue)."""
    return BlsBatchPool(verifier, max_buffer_wait=0.01, flush_threshold=flush_threshold,
                        pipeline_depth=pipeline_depth, max_queue_length=max_queue_length,
                        high_water=high_water)


def _lat_stats(ms: List[float]) -> Dict[str, Any]:
    return {
        "n": len(ms),
        "p50_ms": round(percentile(ms, 50), 3) if ms else None,
        "p99_ms": round(percentile(ms, 99), 3) if ms else None,
        "max_ms": round(max(ms), 3) if ms else None,
    }


async def run_firehose(
    pool: BlsBatchPool,
    *,
    rate: float,
    duration_s: float,
    mix: Optional[Dict[str, float]] = None,
    deadline_ms: Optional[float] = None,
    sets_builder=None,
    respect_backpressure: bool = True,
    seed: int = 0,
    grace_s: float = 30.0,
) -> Dict[str, Any]:
    """Offer ``rate`` signature sets/sec of the duty ``mix`` to ``pool``
    for ``duration_s``, then drain and account for every job.

    ``deadline_ms`` (optional) stamps storm-lane jobs (unaggregated /
    sync-committee) with submit-time + deadline — the shed policy's
    input; block/aggregate jobs never carry one here.  ``sets_builder``
    maps a duty name to a list of real SignatureSets for real-verifier
    runs (stub runs use opaque placeholders).  ``respect_backpressure``
    makes the harness behave like gossip intake: while ``pool.overloaded``
    storm-lane jobs are shed at intake instead of submitted.

    ``pending_sets_peak`` is the most pending sets read at a tick, and
    ``pending_sets_bound`` what backpressure holds it to: the high-water
    mark, plus the sets of one tick (its jobs all saw the pool below the
    mark), plus the sets the pool's batches in flight hold back from
    draining (``pipeline_depth`` merged batches a card).  The bound
    assumes the lanes that are never shed at intake alone stay below the
    verifier's rate.
    """
    mix = dict(mix or DEFAULT_MIX)
    rng = random.Random(seed)
    duty_names = list(mix)
    weights = [mix[d] for d in duty_names]
    records: List[Tuple[str, str, float, int]] = []  # (duty, outcome, e2e_ms, n_sets)
    intake_shed: Dict[str, int] = {}
    offered_by_duty: Dict[str, int] = {}
    submitted_by_duty: Dict[str, int] = {}
    offered_sets = 0
    submitted_sets = 0
    tasks: List[asyncio.Task] = []
    pending_peak = 0
    tick_sets_max = 0

    dropped_before = dict(pool.dropped_sets)

    async def one_job(duty: str, sets: List[Any], lane: SignatureSetPriority,
                      deadline: Optional[float]) -> None:
        t0 = time.monotonic()
        try:
            ok = await pool.verify_signature_sets(
                sets, priority=lane, deadline=deadline
            )
            outcome = "verified_ok" if ok else "verified_false"
        except VerificationDroppedError as e:
            outcome = f"dropped_{e.reason}"
        except Exception as e:  # noqa: BLE001 — the harness must account, not die
            outcome = f"error_{type(e).__name__}"
        records.append((duty, outcome, (time.monotonic() - t0) * 1e3, len(sets)))

    t_start = time.monotonic()
    budget = 0.0  # fractional sets earned by elapsed time
    last = t_start
    tick_s = max(0.001, min(0.01, 32.0 / max(rate, 1.0)))
    while True:
        now = time.monotonic()
        if now - t_start >= duration_s:
            break
        budget += (now - last) * rate
        last = now
        pending_peak = max(pending_peak, pool.pending_sets())
        tick_sets = 0
        while budget >= 1.0:
            duty = rng.choices(duty_names, weights=weights, k=1)[0]
            lane, sets_per_job = DUTIES[duty]
            budget -= sets_per_job
            if (
                respect_backpressure
                and lane in SHEDDABLE_LANES
                and pool.overloaded
            ):
                # gossip-intake analog: storm topics slow under backpressure
                # (nominal size: the job's sets are never built)
                offered_sets += sets_per_job
                offered_by_duty[duty] = offered_by_duty.get(duty, 0) + sets_per_job
                intake_shed[duty] = intake_shed.get(duty, 0) + sets_per_job
                continue
            sets = (
                sets_builder(duty) if sets_builder is not None
                else [_StubSet() for _ in range(sets_per_job)]
            )
            # offered counts what the builder ACTUALLY produced so the
            # accounting identity holds for non-nominal builders too
            offered_sets += len(sets)
            offered_by_duty[duty] = offered_by_duty.get(duty, 0) + len(sets)
            deadline = None
            if deadline_ms is not None and lane in SHEDDABLE_LANES:
                deadline = time.monotonic() + deadline_ms / 1e3
            submitted_sets += len(sets)
            submitted_by_duty[duty] = submitted_by_duty.get(duty, 0) + len(sets)
            tick_sets += len(sets)
            tasks.append(asyncio.create_task(one_job(duty, sets, lane, deadline)))
        tick_sets_max = max(tick_sets_max, tick_sets)
        await asyncio.sleep(tick_s)

    # drain: every submitted job must resolve one way or another
    stranded = 0
    if tasks:
        done, pending = await asyncio.wait(tasks, timeout=grace_s)
        stranded = len(pending)
        for t in pending:
            t.cancel()
    wall_s = time.monotonic() - t_start

    # queue-wait distribution from the pool's own spans, by lane
    wait_by_lane: Dict[str, List[float]] = {}
    for s in tracing.TRACER.spans():
        if s.name == "bls.queue_wait":
            lane_name = (s.args or {}).get("lane")
            wait_by_lane.setdefault(lane_name, []).append(s.dur_ns / 1e6)
    queue_wait_ms = [ms for lat in wait_by_lane.values() for ms in lat]
    max_batches, max_batch_sets = pool._flush_window()

    by_duty: Dict[str, List[float]] = {}
    outcomes: Dict[str, int] = {}
    verified_sets = 0
    errored_sets = 0
    for duty, outcome, e2e_ms, n_sets in records:
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
        # account the ACTUAL job size (a sets_builder may return a
        # non-nominal count), matching what submitted_sets summed
        if outcome.startswith("verified"):
            by_duty.setdefault(duty, []).append(e2e_ms)
            verified_sets += n_sets
        elif outcome.startswith("error_"):
            errored_sets += n_sets
    e2e_all = [ms for lat in by_duty.values() for ms in lat]

    dropped: Dict[str, int] = {}
    for key, n in pool.dropped_sets.items():
        delta = n - dropped_before.get(key, 0)
        if delta:
            dropped["/".join(key)] = delta
    dropped_sets_total = sum(dropped.values())
    intake_shed_total = sum(intake_shed.values())

    return {
        "offered_rate_sets_per_s": round(rate, 1),
        "duration_s": round(duration_s, 2),
        "wall_s": round(wall_s, 2),
        "offered_sets": offered_sets,
        "submitted_sets": submitted_sets,
        "offered_by_duty": dict(sorted(offered_by_duty.items())),
        "submitted_by_duty": dict(sorted(submitted_by_duty.items())),
        "verified_sets": verified_sets,
        "achieved_sets_per_s": round(verified_sets / wall_s, 1) if wall_s else None,
        # whole-node headline: what the NODE sustained across every
        # executor, under the JAX harness's key
        "bls_sig_sets_per_s": round(verified_sets / wall_s, 1) if wall_s else None,
        "queue_wait": _lat_stats(queue_wait_ms),
        "queue_wait_by_lane": {k: _lat_stats(v) for k, v in sorted(wait_by_lane.items())},
        "e2e": _lat_stats(e2e_all),
        "e2e_by_duty": {d: _lat_stats(lat) for d, lat in sorted(by_duty.items())},
        "block_lane_p99_ms": _lat_stats(by_duty.get("block_proposal", []))["p99_ms"],
        "outcomes": dict(sorted(outcomes.items())),
        "dropped_sets": dropped,               # reason/lane -> sets, pool-accounted
        "dropped_sets_total": dropped_sets_total,
        "intake_shed_sets": intake_shed,       # backpressure at 'gossip' intake
        "intake_shed_total": intake_shed_total,
        "errored_sets": errored_sets,
        # the accounting identity the acceptance criteria demand: every
        # offered set is verified, typed-dropped, intake-shed, or errored
        "unaccounted_sets": offered_sets - submitted_sets - intake_shed_total
        + (submitted_sets - verified_sets - dropped_sets_total - errored_sets),
        "stranded_futures": stranded,
        "backpressure_now": pool.overloaded,
        "pending_sets_peak": pending_peak,
        "pending_sets_bound": pool.high_water + tick_sets_max + max_batches * max_batch_sets,
        "pending_sets_after": pool.pending_sets(),
        "spans_dropped": tracing.TRACER.dropped,
    }


def _parse_mix(arg: Optional[str]) -> Optional[Dict[str, float]]:
    if not arg:
        return None
    mix: Dict[str, float] = {}
    for part in arg.split(","):
        name, _, frac = part.partition("=")
        if name not in DUTIES:
            raise SystemExit(f"--mix: unknown duty {name!r} (know {sorted(DUTIES)})")
        mix[name] = float(frac)
    return mix


def _build_real_sets(kind: str, n_unique: int = 16):
    """Reusable real signature sets per duty for non-stub verifiers (the
    point cache makes reuse the realistic shape anyway): the port's
    interop keys, reused as the JAX harness reuses them."""
    from ..crypto.bls.api import interop_secret_key
    from ..crypto.bls.verifier import SingleSignatureSet

    pool_sets = []
    for i in range(n_unique):
        sk = interop_secret_key(i % 8)
        msg = bytes([i % 256, kind == "native"]) * 16
        pool_sets.append(
            SingleSignatureSet(
                pubkey=sk.to_public_key(), signing_root=msg,
                signature=sk.sign(msg).to_bytes(),
            )
        )
    counter = {"i": 0}

    def builder(duty: str):
        _, per_job = DUTIES[duty]
        out = []
        for _ in range(per_job):
            out.append(pool_sets[counter["i"] % len(pool_sets)])
            counter["i"] += 1
        return out

    return builder


#: the card verifier's buckets: a storm's small batches, a merged backlog's
#: full one
CARD_BUCKETS = (4, 16, 128)


def card_verifier(device="cuda"):
    """The split fused ``TorchBlsVerifier`` on ``device`` (the card), its
    graphs warmed at ``CARD_BUCKETS`` before any window opens.  Raises
    without a card: nothing falls back to the host."""
    from ..crypto.bls.torch_verifier import TorchBlsVerifier

    v = TorchBlsVerifier(device=device, buckets=CARD_BUCKETS)
    v.warmup()
    return v


def _make_verifier(kind: str):
    if kind == "stub":
        return StubVerifier(), None
    if kind == "native":
        from ..crypto.bls.native_verifier import FastBlsVerifier

        return FastBlsVerifier(), _build_real_sets(kind)
    if kind == "cuda":
        return card_verifier(), _build_real_sets(kind)
    raise SystemExit(f"unknown verifier {kind!r}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered signature sets per second")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="sustained-load window")
    ap.add_argument("--mix", default=None,
                    help="job mix, e.g. unaggregated=0.8,aggregate=0.12,"
                    "sync_committee=0.075,block_proposal=0.005")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="storm-lane job deadline (unaggregated/sync); "
                    "expired jobs are shed, not verified")
    ap.add_argument("--verifier", choices=("cuda", "native", "stub"), default="cuda",
                    help="cuda: the card's split fused verifier (the default); "
                    "native: the port's C verifier on the host; stub: no "
                    "verification, a configurable capacity")
    ap.add_argument("--flush-threshold", type=int, default=128)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--max-queue-length", type=int, default=8192)
    ap.add_argument("--high-water", type=int, default=0,
                    help="backpressure high-water mark in pending sets "
                    "(0 = half the queue length)")
    ap.add_argument("--no-backpressure", action="store_true",
                    help="keep submitting storm lanes while the pool is "
                    "overloaded (measures eviction instead of intake shed)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    verifier, sets_builder = _make_verifier(args.verifier)
    tracing.TRACER.clear()
    tracing.enable(65536)
    pool = make_pool(verifier, flush_threshold=args.flush_threshold,
                     pipeline_depth=args.pipeline_depth,
                     max_queue_length=args.max_queue_length,
                     high_water=args.high_water or None)

    async def run():
        try:
            return await run_firehose(
                pool,
                rate=args.rate,
                duration_s=args.seconds,
                mix=_parse_mix(args.mix),
                deadline_ms=args.deadline_ms,
                sets_builder=sets_builder,
                respect_backpressure=not args.no_backpressure,
                seed=args.seed,
            )
        finally:
            pool.close()

    report = asyncio.run(run())
    verifier.close()
    report["verifier"] = args.verifier
    print(json.dumps(report, indent=1))
    return 1 if (report["stranded_futures"] or report["unaccounted_sets"]) else 0


if __name__ == "__main__":
    raise SystemExit(main())
