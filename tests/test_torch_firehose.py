"""The port's firehose (``lodestar_tpu_torch/tools/firehose.py``) on the
CPU over ``StubVerifier`` (no device, no pack): a sustained stub run and an
overload run keep the accounting identity (every offered set verified,
typed-dropped, shed at intake or errored; no future stranded), and the
port's ``run_firehose`` offers and submits, duty by duty, what the repo's
``tools/firehose.py`` does over the JAX pool on the same stub parameters
and seed, both driven by one stepped clock (each tool module reads a fake
``time.monotonic`` that its ticks advance, so the job sequence does not
depend on the host's speed).  The firehose defaults to the card."""

import asyncio
import time

import pytest

from lodestar_tpu import tracing as jtracing
from lodestar_tpu.chain.bls_pool import BlsBatchPool as JBlsBatchPool
from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
from lodestar_tpu_torch.tools import firehose

from tools import firehose as jfirehose


@pytest.fixture(autouse=True)
def _clean():
    for t in (tracing, jtracing):
        t.TRACER.disable()
        t.TRACER.clear()
    yield
    for t in (tracing, jtracing):
        t.TRACER.disable()
        t.TRACER.clear()


def test_percentile_is_nearest_rank_as_the_jax_harness():
    for fn in (firehose.percentile, jfirehose.percentile):
        assert fn([], 99) is None
        assert fn([5.0], 50) == 5.0
        vals = list(range(1, 101))
        assert (fn(vals, 50), fn(vals, 99), fn(vals, 100)) == (50, 99, 100)
        assert fn([1, 100], 50) == 1  # nearest rank, not round-half-even
    assert firehose.DUTIES.keys() == jfirehose.DUTIES.keys()
    assert {d: (int(lane), n) for d, (lane, n) in firehose.DUTIES.items()} == {
        d: (int(lane), n) for d, (lane, n) in jfirehose.DUTIES.items()}
    assert firehose.DEFAULT_MIX == jfirehose.DEFAULT_MIX
    assert [int(x) for x in firehose.SHEDDABLE_LANES] == [int(x) for x in jfirehose.SHEDDABLE_LANES]


def _run(pool, **kw):
    async def main():
        try:
            return await firehose.run_firehose(pool, **kw)
        finally:
            pool.close()

    return asyncio.run(main())


def test_a_stub_run_at_300_sets_per_second_accounts_for_every_set():
    tracing.enable(65536)
    report = _run(BlsBatchPool(firehose.StubVerifier(), max_buffer_wait=0.01,
                               flush_threshold=128),
                  rate=300.0, duration_s=0.5, deadline_ms=2000.0)
    assert report["stranded_futures"] == 0 and report["unaccounted_sets"] == 0
    assert report["dropped_sets_total"] == 0 and report["intake_shed_total"] == 0
    assert report["verified_sets"] == report["submitted_sets"] == report["offered_sets"] > 0
    assert report["offered_by_duty"] == report["submitted_by_duty"]
    assert sum(report["offered_by_duty"].values()) == report["offered_sets"]
    assert report["queue_wait"]["n"] > 0 and report["e2e"]["p99_ms"] is not None
    assert set(report["outcomes"]) == {"verified_ok"}


def test_an_overload_run_stays_bounded_and_accounted():
    """Offered load far beyond the stub's capacity: bounded queue memory,
    zero stranded futures, every drop typed and accounted, and
    backpressure engaged (intake shed > 0)."""
    tracing.enable(65536)
    pool = BlsBatchPool(firehose.StubVerifier(per_set_us=500.0),  # ~2k sets/s ceiling
                        max_buffer_wait=0.01, flush_threshold=128, max_queue_length=512,
                        overload_shed_threshold=0)
    report = _run(pool, rate=8000.0, duration_s=1.0, deadline_ms=300.0)
    assert report["stranded_futures"] == 0 and report["unaccounted_sets"] == 0
    assert report["intake_shed_total"] > 0
    assert report["pending_sets_after"] <= 512
    # backpressure's bound: the high water (256, half the queue), a tick's
    # sets and the two merged batches in flight
    assert 0 < report["pending_sets_peak"] <= report["pending_sets_bound"]
    assert report["pending_sets_bound"] - 256 - 2 * 128 > 0
    lanes = report["queue_wait_by_lane"]
    assert set(lanes) <= {"block_proposal", "aggregate", "unaggregated", "sync_committee"}
    assert sum(v["n"] for v in lanes.values()) == report["queue_wait"]["n"] > 0
    for key in report["dropped_sets"]:
        reason, lane = key.split("/")
        assert reason in ("deadline", "overflow", "shutdown")
        assert lane in ("block_proposal", "aggregate", "unaggregated", "sync_committee")
    shed = report["intake_shed_sets"]
    assert {d: report["offered_by_duty"][d] - report["submitted_by_duty"].get(d, 0)
            for d in shed} == shed


def test_errored_jobs_stay_accounted():
    class Raising(firehose.StubVerifier):
        def verify_signature_sets_async(self, sets, deadline=None):
            raise RuntimeError("boom")

        def verify_signature_sets(self, sets):
            raise RuntimeError("boom")

    tracing.enable(4096)
    report = _run(BlsBatchPool(Raising(), max_buffer_wait=0.01, flush_threshold=16),
                  rate=300.0, duration_s=0.5)
    assert report["errored_sets"] > 0
    assert report["unaccounted_sets"] == 0 and report["stranded_futures"] == 0
    assert all(o.startswith("error_") for o in report["outcomes"])


class _Clock:
    """One tool module's ``time``: ``monotonic`` reads the stepped clock,
    ``sleep`` (the stub verifier's) is the real one."""

    def __init__(self):
        self.now = 1000.0
        self.sleep = time.sleep

    def monotonic(self):
        return self.now


class _Loop:
    """One tool module's ``asyncio``: ``sleep`` (the harness's tick)
    advances the clock, then yields once; the rest is the real module."""

    def __init__(self, clock):
        self.clock = clock

    def __getattr__(self, name):
        return getattr(asyncio, name)

    async def sleep(self, seconds):
        self.clock.now += seconds
        await asyncio.sleep(0)


def _stepped(module, pool_cls, tracing_mod, monkeypatch, **kw):
    clock = _Clock()
    monkeypatch.setattr(module, "time", clock)
    monkeypatch.setattr(module, "asyncio", _Loop(clock))
    tracing_mod.enable(65536)
    pool = pool_cls(module.StubVerifier(pack_ms=0.5, dispatch_ms=2.0, per_set_us=20.0),
                    max_buffer_wait=0.01, flush_threshold=128)
    seen = []
    real = pool.verify_signature_sets

    async def recording(sets, priority=None, deadline=None):
        seen.append((int(priority), len(sets)))
        return await real(sets, priority=priority, deadline=deadline)

    pool.verify_signature_sets = recording

    async def main():
        try:
            return await module.run_firehose(pool, **kw)
        finally:
            pool.close()

    report = asyncio.run(main())
    lanes = {int(lane): duty for duty, (lane, _) in module.DUTIES.items()}
    by_duty = {}
    for lane, n in seen:
        by_duty[lanes[lane]] = by_duty.get(lanes[lane], 0) + n
    return report, by_duty, seen


@pytest.mark.parametrize("seed", [0, 7])
def test_offered_and_submitted_per_duty_equal_the_jax_harness(seed, monkeypatch):
    kw = dict(rate=600.0, duration_s=0.5, seed=seed, deadline_ms=5000.0)
    port, port_duty, port_seen = _stepped(firehose, BlsBatchPool, tracing, monkeypatch, **kw)
    jax, jax_duty, jax_seen = _stepped(jfirehose, JBlsBatchPool, jtracing, monkeypatch, **kw)
    assert port_seen == jax_seen and port_duty == jax_duty
    assert port["submitted_by_duty"] == port_duty
    jax_offered = {d: jax_duty.get(d, 0) + jax["intake_shed_sets"].get(d, 0)
                   for d in set(jax_duty) | set(jax["intake_shed_sets"])}
    assert port["offered_by_duty"] == dict(sorted(jax_offered.items()))
    for key in ("offered_sets", "submitted_sets", "verified_sets", "outcomes",
                "intake_shed_sets", "dropped_sets", "unaccounted_sets", "stranded_futures"):
        assert port[key] == jax[key], key
    assert port["unaccounted_sets"] == 0 and port["offered_sets"] > 100


def test_the_firehose_defaults_to_the_card_and_raises_without_one(monkeypatch):
    import torch

    asked = []

    def make(kind):
        asked.append(kind)
        raise KeyboardInterrupt  # stop before any window opens

    monkeypatch.setattr(firehose, "_make_verifier", make)
    with pytest.raises(KeyboardInterrupt):
        firehose.main(["--seconds", "0.1"])
    assert asked == ["cuda"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        firehose.card_verifier()
