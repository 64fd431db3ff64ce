"""The port's BlsBatchPool (chain/bls_pool.py): merged dispatches,
per-job retry, the pipeline, priority lanes, deadline shedding, overflow
eviction and backpressure, over the port's host verifier (PyBlsVerifier,
the bigint oracle), stage verifiers that stand in for the device, and one
flush through TorchBlsVerifier on the CPU.

The cases of tests/test_bls_pool.py come first, against the port's pool;
its three utility cases (logger, retry helper, metrics exposition) have no
module in the port, and the pool's counters and warnings stand in for
them.  Through TorchBlsVerifier on the CPU: one flush, a merged batch that
rides the sharded tier over 2 logical shards, and the verifier's close().  Timing: the assertions are on order (events between threads) and
counters; the one wall-clock bound is a 2x margin."""

import asyncio
import logging
import threading
import time

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
from lodestar_tpu_torch.crypto.bls.api import interop_secret_key
from lodestar_tpu_torch.crypto.bls.verifier import (
    PyBlsVerifier,
    SignatureSetPriority,
    SingleSignatureSet,
    VerificationDroppedError,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests here run a verifier's programs' plain versions: one intra-op
    thread, as the other program-running files pin it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_SETS = {}


def make_set(i, valid=True):
    """A single-key set of interop key i over a message of i (memoized:
    the signing is pure Python)."""
    key = (i, valid)
    if key not in _SETS:
        sk = interop_secret_key(i)
        msg = bytes([i % 256]) * 32
        signer = sk if valid else interop_secret_key(i + 100)
        _SETS[key] = SingleSignatureSet(pubkey=sk.to_public_key(), signing_root=msg,
                                        signature=signer.sign(msg).to_bytes())
    return _SETS[key]


class CountingVerifier(PyBlsVerifier):
    def __init__(self):
        super().__init__()
        self.calls = []

    def verify_signature_sets(self, sets):
        self.calls.append(len(sets))
        return super().verify_signature_sets(sets)


class StageVerifier:
    """A split verifier without a device: ``verify_signature_sets_async``
    packs (blocks the calling thread) and returns a handle whose
    ``result()`` waits for the 'device' and the host final exponentiation.
    ``verdict_fn`` decides each batch's verdict; every call is recorded."""

    def __init__(self, verdict_fn=None, n_devices=1, stage_s=0.001):
        self.verdict_fn = verdict_fn or (lambda sets: True)
        self.n_devices = n_devices
        self.stage_s = stage_s
        self.dispatched = []  # batch sizes, in dispatch order
        self.events = []  # ("dispatch", k) / ("result", k) in order
        self.lock = threading.Lock()

    def verify_signature_sets_async(self, sets):
        time.sleep(self.stage_s)
        with self.lock:
            k = len(self.dispatched)
            self.dispatched.append(len(sets))
            self.events.append(("dispatch", k))
        verdict = self.verdict_fn(sets)
        outer = self

        class _Pending:
            def result(self):
                time.sleep(outer.stage_s)
                with outer.lock:
                    outer.events.append(("result", k))
                return verdict

        return _Pending()

    def verify_signature_sets(self, sets):
        return self.verify_signature_sets_async(sets).result()


def run(coro):
    return asyncio.run(coro)


# -- the cases of tests/test_bls_pool.py ---------------------------------------


class TestPool:
    def test_concurrent_jobs_merge_into_one_dispatch(self):
        async def main():
            v = CountingVerifier()
            pool = BlsBatchPool(v, max_buffer_wait=0.01)
            jobs = [pool.verify_signature_sets([make_set(i)]) for i in range(4)]
            results = await asyncio.gather(*jobs)
            assert results == [True] * 4
            assert v.calls == [4]  # one merged dispatch
            pool.close()

        run(main())

    def test_bad_job_retried_individually(self):
        async def main():
            v = CountingVerifier()
            pool = BlsBatchPool(v, max_buffer_wait=0.01)
            jobs = [
                pool.verify_signature_sets([make_set(0)]),
                pool.verify_signature_sets([make_set(1, valid=False)]),
                pool.verify_signature_sets([make_set(2)]),
            ]
            results = await asyncio.gather(*jobs)
            assert results == [True, False, True]
            assert pool.batch_retries == 1
            assert v.calls == [3, 1, 1, 1]  # 1 merged + 3 individual retries
            pool.close()

        run(main())

    def test_flush_threshold_triggers_immediately(self):
        async def main():
            v = CountingVerifier()
            pool = BlsBatchPool(v, max_buffer_wait=30.0, flush_threshold=3)
            jobs = [pool.verify_signature_sets([make_set(i)]) for i in range(3)]
            # far below the 30 s buffer wait: the threshold flushed
            results = await asyncio.wait_for(asyncio.gather(*jobs), timeout=15.0)
            assert results == [True] * 3
            pool.close()

        run(main())

    def test_non_batchable_direct(self):
        async def main():
            v = CountingVerifier()
            pool = BlsBatchPool(v, max_buffer_wait=5.0)
            ok = await pool.verify_signature_sets([make_set(5)], batchable=False)
            assert ok and v.calls == [1]
            pool.close()

        run(main())

    def test_empty_job_raises(self):
        async def main():
            pool = BlsBatchPool(CountingVerifier())
            with pytest.raises(ValueError):
                await pool.verify_signature_sets([])
            pool.close()

        run(main())


class TestPipeline:
    def test_pack_overlaps_dispatch_with_three_batches(self):
        """Batch 0's verdict is read only after batch 1 was dispatched:
        its result() waits for that event (a serial pool would time out
        there), so two batches were in flight together."""

        async def main():
            v = StageVerifier()
            dispatched = [threading.Event() for _ in range(3)]
            timed_out = []

            def verdict(sets):
                k = len(v.dispatched) - 1
                dispatched[k].set()
                return k

            v.verdict_fn = verdict
            real = v.verify_signature_sets_async

            def dispatch(sets):
                pending = real(sets)
                k = len(v.dispatched) - 1
                inner = pending.result

                class _Waits:
                    def result(self):
                        if k < 2 and not dispatched[k + 1].wait(10.0):
                            timed_out.append(k)
                        return inner() >= 0

                return _Waits()

            v.verify_signature_sets_async = dispatch
            pool = BlsBatchPool(v, max_buffer_wait=0.005, pipeline_depth=3, flush_threshold=1)
            jobs = [asyncio.create_task(pool.verify_signature_sets([make_set(i)]))
                    for i in range(3)]
            results = await asyncio.gather(*jobs)
            assert results == [True] * 3
            assert v.dispatched == [1, 1, 1] and timed_out == []
            assert v.events.index(("dispatch", 1)) < v.events.index(("result", 0))
            assert pool.inflight_peak >= 2
            assert len(pool.batch_spans) == 3
            (a0, a1), (b0, _b1) = list(pool.batch_spans)[:2]
            assert b0 < a1  # batch 1 was packed before batch 0's verdict
            pool.close()

        run(main())

    def test_coalescing_fewer_dispatches_than_jobs(self):
        async def main():
            v = StageVerifier()
            pool = BlsBatchPool(v, max_buffer_wait=0.02, flush_threshold=64)
            jobs = []
            for wave in range(4):
                jobs += [pool.verify_signature_sets([make_set(8 * wave + i)]) for i in range(8)]
                await asyncio.sleep(0.002)
            results = await asyncio.gather(*jobs)
            assert results == [True] * 32
            assert len(v.dispatched) < 32, v.dispatched  # merged dispatches
            assert sum(v.dispatched) == 32  # every set verified exactly once
            pool.close()

        run(main())

    def test_retry_individually_on_pipelined_path(self):
        async def main():
            truth = PyBlsVerifier()
            v = StageVerifier(verdict_fn=truth.verify_signature_sets)
            pool = BlsBatchPool(v, max_buffer_wait=0.01, pipeline_depth=2)
            jobs = [
                pool.verify_signature_sets([make_set(0)]),
                pool.verify_signature_sets([make_set(1, valid=False)]),
                pool.verify_signature_sets([make_set(2)]),
            ]
            results = await asyncio.gather(*jobs)
            assert results == [True, False, True]
            assert pool.batch_retries == 1
            pool.close()

        run(main())


    def test_merge_cap_grows_by_the_shard_count_while_the_tier_is_active(self):
        """A stub verifier whose sharded tier has 4 shards on one card: the
        merge cap is flush_threshold x mesh_devices while sharded_active
        and flush_threshold again once it is false; the window stays
        pipeline_depth x n_devices."""

        async def main():
            v = StageVerifier()
            v.sharded_active, v.mesh_devices = True, 4
            pool = BlsBatchPool(v, max_buffer_wait=0.005, pipeline_depth=2, flush_threshold=2)
            assert pool._flush_window() == (2, 8)
            jobs = [pool.verify_signature_sets([make_set(i)]) for i in range(8)]
            assert await asyncio.gather(*jobs) == [True] * 8
            assert v.dispatched == [8]
            v.sharded_active = False
            assert pool._flush_window() == (2, 2)
            jobs = [pool.verify_signature_sets([make_set(i)]) for i in range(8)]
            assert await asyncio.gather(*jobs) == [True] * 8
            assert v.dispatched == [8, 2, 2, 2, 2]
            pool.close()

        run(main())


class TestCountersAndFailures:
    """In place of the JAX file's utility cases: the pool's counters and
    its warnings on failed dispatches."""

    def test_counters(self):
        async def main():
            v = StageVerifier(verdict_fn=lambda sets: len(sets) == 1)
            pool = BlsBatchPool(v, max_buffer_wait=0.01)
            results = await asyncio.gather(*[pool.verify_signature_sets([make_set(i)])
                                             for i in range(2)])
            assert results == [True, True]  # the merged batch failed, each job passed
            assert pool.batch_retries == 1
            assert v.dispatched == [2, 1, 1]
            assert await pool.verify_signature_sets([make_set(3)]) is True
            assert pool.batch_retries == 1 and pool.inflight_peak == 1
            assert len(pool.batch_spans) == 2 and pool.dropped_sets == {}
            assert all(t0 <= t1 for t0, t1 in pool.batch_spans)
            pool.close()

        run(main())

    def test_failed_enqueue_is_logged_and_retried_per_job(self, caplog):
        async def main():
            v = StageVerifier()

            def broken(sets):
                raise RuntimeError("launch refused")

            v.verify_signature_sets_async = broken
            v.verify_signature_sets = lambda sets: len(sets) == 1
            pool = BlsBatchPool(v, max_buffer_wait=0.01)
            with caplog.at_level(logging.WARNING, logger="lodestar_tpu_torch.chain.bls_pool"):
                results = await asyncio.gather(*[pool.verify_signature_sets([make_set(i)])
                                                 for i in range(2)])
            assert results == [True, True] and pool.batch_retries == 1
            assert "dispatch enqueue failed: launch refused" in caplog.text
            pool.close()

        run(main())

    def test_a_raising_verdict_is_retried_per_job(self, caplog):
        async def main():
            v = StageVerifier()
            real = v.verify_signature_sets_async

            def failing_sync(sets):
                real(sets)

                class _Lost:
                    def result(self):
                        raise RuntimeError("device lost")

                return _Lost()

            v.verify_signature_sets_async = failing_sync
            v.verify_signature_sets = lambda sets: True
            pool = BlsBatchPool(v, max_buffer_wait=0.01)
            with caplog.at_level(logging.WARNING, logger="lodestar_tpu_torch.chain.bls_pool"):
                results = await asyncio.gather(*[pool.verify_signature_sets([make_set(i)])
                                                 for i in range(3)])
            assert results == [True] * 3 and pool.batch_retries == 1
            assert "merged dispatch raised: device lost" in caplog.text
            pool.close()

        run(main())


# -- scheduling under overload -----------------------------------------------------


class TestOverload:
    def test_expired_jobs_are_shed_before_packing(self):
        async def main():
            v = StageVerifier()
            pool = BlsBatchPool(v, max_buffer_wait=0.01)
            now = time.monotonic()
            live = pool.verify_signature_sets([make_set(0)], deadline=now + 60.0)
            late = pool.verify_signature_sets([make_set(1), make_set(2)], deadline=now - 1.0,
                                              priority=SignatureSetPriority.AGGREGATE)
            results = await asyncio.gather(live, late, return_exceptions=True)
            assert results[0] is True
            assert isinstance(results[1], VerificationDroppedError)
            assert results[1].reason == "deadline"
            assert results[1].lane is SignatureSetPriority.AGGREGATE
            assert v.dispatched == [1]  # the expired job never reached the verifier
            assert pool.dropped_sets == {("deadline", "aggregate"): 2}
            pool.close()

        run(main())

    def test_block_proposals_drain_first(self):
        async def main():
            v = StageVerifier()
            order = []
            v.verdict_fn = lambda sets: order.append([s.signing_root[0] for s in sets]) or True
            pool = BlsBatchPool(v, max_buffer_wait=0.05, flush_threshold=2, pipeline_depth=1)
            jobs = [pool.verify_signature_sets([make_set(i)]) for i in range(4)]
            jobs.append(pool.verify_signature_sets(
                [make_set(9)], priority=SignatureSetPriority.BLOCK_PROPOSAL))
            assert await asyncio.gather(*jobs) == [True] * 5
            assert order[0][0] == 9  # the block proposal rides the first batch
            pool.close()

        run(main())

    def test_overflow_evicts_the_oldest_job_of_the_lowest_lane(self):
        async def main():
            v = StageVerifier()
            pool = BlsBatchPool(v, max_buffer_wait=5.0, max_queue_length=2, flush_threshold=64)
            low = asyncio.ensure_future(pool.verify_signature_sets([make_set(0)]))
            block = asyncio.ensure_future(pool.verify_signature_sets(
                [make_set(1)], priority=SignatureSetPriority.BLOCK_PROPOSAL))
            await asyncio.sleep(0)
            # a third job overflows the queue: the unaggregated job goes
            agg = asyncio.ensure_future(pool.verify_signature_sets(
                [make_set(2)], priority=SignatureSetPriority.AGGREGATE))
            with pytest.raises(VerificationDroppedError) as e:
                await low
            assert e.value.reason == "overflow"
            # a fourth, of the lowest lane, finds nothing below it: it pays
            with pytest.raises(VerificationDroppedError):
                await pool.verify_signature_sets(
                    [make_set(3)], priority=SignatureSetPriority.SYNC_COMMITTEE)
            assert pool.dropped_sets == {("overflow", "unaggregated"): 1,
                                         ("overflow", "sync_committee"): 1}
            pool.close()  # the two buffered jobs are dropped, typed
            for fut in (block, agg):
                with pytest.raises(VerificationDroppedError) as e:
                    await fut
                assert e.value.reason == "shutdown"
            assert v.dispatched == []

        run(main())

    def test_backpressure_turns_on_at_high_water_and_off_at_half(self):
        async def main():
            v = StageVerifier()
            pool = BlsBatchPool(v, max_buffer_wait=5.0, flush_threshold=64, high_water=4)
            assert (pool.high_water, pool.low_water) == (4, 2)
            jobs = [asyncio.ensure_future(pool.verify_signature_sets([make_set(i)]))
                    for i in range(3)]
            await asyncio.sleep(0.01)
            assert pool.pending_sets() == 3 and not pool.overloaded
            jobs.append(asyncio.ensure_future(pool.verify_signature_sets([make_set(3)])))
            await asyncio.sleep(0.01)
            assert pool.pending_sets() == 4 and pool.overloaded
            pool._schedule_flush(0.0)  # flush now instead of after the 5 s wait
            assert await asyncio.gather(*jobs) == [True] * 4
            assert pool.pending_sets() == 0 and not pool.overloaded
            pool.close()

        run(main())

    def test_pipeline_depth_is_per_card(self):
        v = StageVerifier(n_devices=2)
        assert BlsBatchPool(v, pipeline_depth=2, flush_threshold=16)._flush_window() == (4, 16)
        assert BlsBatchPool(StageVerifier(), pipeline_depth=0)._flush_window()[0] == 1

    def test_closed_pool_refuses_jobs(self):
        async def main():
            pool = BlsBatchPool(StageVerifier())
            pool.close()
            with pytest.raises(RuntimeError):
                await pool.verify_signature_sets([make_set(0)])

        run(main())


# -- through the port's verifier ----------------------------------------------


def test_one_flush_through_torch_verifier_on_the_cpu():
    """Three gossip jobs merge into one bucket-4 batch of the split fused
    program (the plain versions: several seconds)."""
    import torch

    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    async def main():
        v = TorchBlsVerifier(device="cpu", rng=np.random.default_rng(9))
        pool = BlsBatchPool(v, max_buffer_wait=0.01, pipeline_depth=2)
        assert pool._use_async
        jobs = [pool.verify_signature_sets([make_set(i)]) for i in range(2)]
        jobs.append(pool.verify_signature_sets([make_set(2), make_set(3)],
                                               deadline=time.monotonic() + 600))
        results = await asyncio.gather(*jobs)
        pool.close()
        return v, pool, results

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        v, pool, results = run(main())
    finally:
        torch.set_num_threads(threads)
    assert results == [True, True, True]
    assert v.host_final_exps == 1 and pool.batch_retries == 0
    assert len(pool.batch_spans) == 1 and v.device_inflight() == {"cpu": 0}


def test_merged_batch_rides_the_sharded_tier_on_the_cpu():
    """Over 2 logical shards with ``sharded_min_batch=4`` the merge cap is
    ``flush_threshold`` x 2: four one-set jobs merge into one batch of 4,
    which the sharded tier verifies (the plain versions: several seconds)."""
    import torch

    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier

    async def main():
        v = TorchBlsVerifier(device="cpu", devices=["cpu"] * 2, sharded=True,
                             sharded_min_batch=4, rng=np.random.default_rng(10))
        pool = BlsBatchPool(v, max_buffer_wait=0.01, flush_threshold=2)
        assert v.sharded_active and pool._flush_window() == (2, 4)
        results = await asyncio.gather(*[pool.verify_signature_sets([make_set(i)])
                                         for i in range(4)])
        pool.close()
        return v, pool, results

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        v, pool, results = run(main())
    finally:
        torch.set_num_threads(threads)
    assert results == [True] * 4
    assert v.sharded_batches == 1 and len(pool.batch_spans) == 1
    assert v.host_final_exps == 1 and pool.batch_retries == 0
    from lodestar_tpu.ops.sharded_verify import mesh_device_name  # the JAX name

    assert v.device_inflight() == {mesh_device_name(2): 0}


def test_torch_verifier_close_releases_what_it_holds_and_refuses_verifies():
    """TorchBlsVerifier has every method of the IBlsVerifier protocol;
    close() drops the sharded tier's program and the point cache, after
    which sharded_active is False and a verify or dispatch raises."""
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.crypto.bls.verifier import IBlsVerifier

    v = TorchBlsVerifier(device="cpu", devices=["cpu"] * 2, sharded=True,
                         sharded_min_batch=4)
    members = [n for n, f in vars(IBlsVerifier).items() if callable(f) and not n.startswith("_")]
    assert sorted(members) == ["close", "verify_signature_sets"]
    assert all(callable(getattr(v, n)) for n in members)
    packed = v.pack([make_set(0)])
    assert v.sharded_active and len(v.point_cache) >= 1
    v.close()
    assert not v.sharded_active and len(v.point_cache) == 0 and v.shard_enqueue_walls == []
    with pytest.raises(RuntimeError, match="closed"):
        v.verify_signature_sets([make_set(0)])
    with pytest.raises(RuntimeError, match="closed"):
        v.dispatch(packed)
    v.close()  # a second close is harmless
    assert not TorchBlsVerifier(device="cpu").sharded_active  # one device: no tier
