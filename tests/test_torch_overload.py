"""The port pool's overload instrumentation held against the JAX pool on
the CPU: the drop journal, the overload bundle, backpressure and the lane
gauges, the spans, the end-to-end latency and the end-of-flush metrics
(after ``tests/test_overload.py``).

Each case runs one job script through the port's ``BlsBatchPool`` and the
JAX package's, each over the same deterministic stub verifier (no device,
no pack), with each package's own journal, tracer, recorder and metrics
registry, and compares what they recorded: journal events (their clocks
and correlation ids taken out), span names and arguments, and the pool's
metric lines (time-valued histograms by their counts).  Nothing is
compiled.
"""

import asyncio
import os
import time

import pytest

from lodestar_tpu import tracing as jtracing
from lodestar_tpu.chain.bls_pool import BlsBatchPool as JBlsBatchPool
from lodestar_tpu.crypto.bls.verifier import SignatureSetPriority as JPriority
from lodestar_tpu.crypto.bls.verifier import VerificationDroppedError as JDropped
from lodestar_tpu.forensics.journal import JOURNAL as JJOURNAL
from lodestar_tpu.forensics.recorder import RECORDER as JRECORDER
from lodestar_tpu.metrics import create_metrics as jax_create_metrics
from lodestar_tpu.observatory import xprof as jxprof
from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
from lodestar_tpu_torch.crypto.bls.verifier import SignatureSetPriority, VerificationDroppedError
from lodestar_tpu_torch.forensics.bundle import latest_bundle
from lodestar_tpu_torch.forensics.journal import JOURNAL
from lodestar_tpu_torch.forensics.recorder import RECORDER
from lodestar_tpu_torch.metrics import create_metrics
from lodestar_tpu_torch.observatory import xprof
from lodestar_tpu_torch.tools import inspect_bundle

from tools import inspect_bundle as jinspect_bundle

SIDES = {
    "port": dict(pool=BlsBatchPool, lane=SignatureSetPriority, dropped=VerificationDroppedError,
                 journal=JOURNAL, tracing=tracing, recorder=RECORDER, metrics=create_metrics,
                 inspect=inspect_bundle),
    "jax": dict(pool=JBlsBatchPool, lane=JPriority, dropped=JDropped, journal=JJOURNAL,
                tracing=jtracing, recorder=JRECORDER, metrics=jax_create_metrics,
                inspect=jinspect_bundle),
}


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    saved = [(r, r._dir, r.metrics, r.pool, r.verifier) for r in (RECORDER, JRECORDER)]
    for side in SIDES.values():
        side["tracing"].TRACER.disable()
        side["tracing"].TRACER.clear()
        side["journal"].clear()
    xprof.CAPTURE = jxprof.CAPTURE = None
    yield
    for side in SIDES.values():
        side["tracing"].TRACER.disable()
        side["tracing"].TRACER.clear()
        side["journal"].clear()
    xprof.CAPTURE = jxprof.CAPTURE = None
    for r, d, m, p, v in saved:
        r._dir, r.metrics, r.pool, r.verifier = d, m, p, v


class StubVerifier:
    """A split verifier without a device: the batch's verdict at once, its
    sets recorded.  ``verdicts`` scripts merged verdicts (then True)."""

    def __init__(self, verdicts=()):
        self.batches = []
        self.verdicts = list(verdicts)
        self.stage_seconds = {"pack": 0.5, "dispatch": 0.25, "final_exp": 0.125}

    def verify_signature_sets_async(self, sets, deadline=None):
        self.batches.append(list(sets))
        verdict = self.verdicts.pop(0) if self.verdicts else True

        class _Pending:
            device = "stub:0"

            def result(_self):
                return verdict

        return _Pending()

    def verify_signature_sets(self, sets):
        return all(s[0] != "bad" for s in sets)


_CLOCKS = ("ts_ns", "wall", "seq", "thread", "cid")
_TIMED = ("queue_wait_seconds", "e2e_verify_seconds", "dispatch_seconds", "overlap_ratio",
          "sets_per_sec")


def journal_events(side, kinds=None):
    return [{k: v for k, v in e.items() if k not in _CLOCKS}
            for e in SIDES[side]["journal"].events()
            if e["kind"].startswith("pool.") and (kinds is None or e["kind"] in kinds)]


def spans(side):
    keep = ("lane", "reason", "sets", "jobs", "ok", "device", "inflight_left")
    return [(s.name, {k: v for k, v in (s.args or {}).items() if k in keep})
            for s in SIDES[side]["tracing"].TRACER.spans()]


def pool_metric_lines(metrics):
    """The pool's metric lines: counters and gauges whole, a time-valued
    histogram by its count only."""
    out = []
    for line in metrics.reg.expose().decode().splitlines():
        if line.startswith("#") or "_created" in line:
            continue
        name = line.split("{")[0].split(" ")[0]
        if not name.startswith(("lodestar_bls_pool", "lodestar_bls_queue_wait",
                                "lodestar_bls_e2e", "lodestar_bls_sets_per_sec",
                                "lodestar_bls_verifier_stage_seconds",
                                "lodestar_tracing_spans_dropped", "lodestar_forensics_journal")):
            continue
        if any(t in name for t in _TIMED):
            if name.endswith("_count") or not name.endswith(("_bucket", "_sum")):
                out.append(line if name.endswith("_count") else name)
            continue
        out.append(line)
    return sorted(out)


def both(script):
    """``script(side, env)`` on the port's pool and the JAX pool; returns
    {side: its value}."""
    return {name: asyncio.run(script(name, env)) for name, env in SIDES.items()}


def test_deadline_shed_emits_span_journal_and_metric():
    async def script(name, env):
        env["tracing"].enable(1024)
        env["journal"].enabled = True
        m = env["metrics"]()
        pool = env["pool"](StubVerifier(), max_buffer_wait=0.01, metrics=m)
        lane = env["lane"]
        live = asyncio.create_task(pool.verify_signature_sets([("live", 0)], priority=lane.UNAGGREGATED))
        with pytest.raises(env["dropped"]) as ei:
            await pool.verify_signature_sets([("stale", 0), ("stale", 1)],
                                             priority=lane.SYNC_COMMITTEE,
                                             deadline=time.monotonic() - 1)
        assert await live is True
        pool.close()
        return (ei.value.reason, pool.dropped_sets, journal_events(name), spans(name),
                pool_metric_lines(m))

    out = both(script)
    assert out["port"] == out["jax"]
    reason, dropped, events, sp, lines = out["port"]
    assert reason == "deadline" and dropped == {("deadline", "sync_committee"): 2}
    assert {"kind": "pool.shed", "level": "WARNING", "reason": "deadline", "sets": 2,
            "by_lane": {"sync_committee": 2}} in events
    assert ("bls.shed", {"lane": "sync_committee", "reason": "deadline", "sets": 2}) in sp
    assert any(line.startswith("lodestar_bls_pool_dropped_total") and 'reason="deadline"' in line
               and line.endswith(" 2.0") for line in lines)


def test_overflow_eviction_journals_each_drop():
    async def script(name, env):
        env["journal"].enabled = True
        lane = env["lane"]
        pool = env["pool"](StubVerifier(), max_buffer_wait=5.0, flush_threshold=10_000,
                           max_queue_length=2)
        t_sync = asyncio.create_task(pool.verify_signature_sets([("sync", 0)],
                                                                priority=lane.SYNC_COMMITTEE))
        t_un = asyncio.create_task(pool.verify_signature_sets([("u", 0)],
                                                              priority=lane.UNAGGREGATED))
        await asyncio.sleep(0.01)
        t_block = asyncio.create_task(pool.verify_signature_sets([("b", 0)],
                                                                 priority=lane.BLOCK_PROPOSAL))
        reasons = []
        for coro in (t_sync, pool.verify_signature_sets([("sync", 1)],
                                                        priority=lane.SYNC_COMMITTEE)):
            with pytest.raises(env["dropped"]) as ei:
                await coro
            reasons.append(ei.value.reason)
        pool._schedule_flush(0.0)
        verdicts = await asyncio.gather(t_un, t_block)
        pool.close()
        return reasons, verdicts, pool.dropped_sets, journal_events(name, ("pool.drop",))

    out = both(script)
    assert out["port"] == out["jax"]
    reasons, verdicts, dropped, drops = out["port"]
    assert reasons == ["overflow", "overflow"] and verdicts == [True, True]
    assert dropped == {("overflow", "sync_committee"): 2} and len(drops) == 2


def test_backpressure_gauge_journal_and_lane_gauges():
    async def script(name, env):
        env["journal"].enabled = True
        m = env["metrics"]()
        lane = env["lane"]
        pool = env["pool"](StubVerifier(), max_buffer_wait=5.0, flush_threshold=10_000,
                           max_queue_length=100, high_water=10, metrics=m)
        jobs = [asyncio.create_task(pool.verify_signature_sets(
            [("u", i)], priority=lane.UNAGGREGATED if i % 3 else lane.AGGREGATE))
            for i in range(10)]
        await asyncio.sleep(0.01)
        on = pool.overloaded
        pending = pool_metric_lines(m)
        pool._schedule_flush(0.0)
        verdicts = await asyncio.gather(*jobs)
        pool.close()
        return (on, pool.overloaded, verdicts, journal_events(name, ("pool.backpressure",)),
                [line for line in pending if "lane_pending" in line or "backpressure" in line
                 or "queue_length" in line],
                pool_metric_lines(m))

    out = both(script)
    assert out["port"] == out["jax"]
    on, off, verdicts, events, pending, lines = out["port"]
    assert on is True and off is False and verdicts == [True] * 10
    assert [e["on"] for e in events] == [True, False]
    assert "lodestar_bls_pool_backpressure 1.0" in pending
    assert "lodestar_bls_pool_backpressure 0.0" in lines
    assert any('lane="aggregate"' in line for line in lines if "lane_pending" in line)


def test_spans_e2e_and_end_of_flush_metrics():
    """A merged batch that fails and is retried per job, then a clean one:
    the queue-wait and batch spans, one e2e observation per delivered
    verdict by lane, the dispatch metrics and the end-of-flush gauges
    (in-flight peak, the verifier's stage seconds)."""
    async def script(name, env):
        env["tracing"].enable(1024)
        env["journal"].enabled = True
        m = env["metrics"]()
        lane = env["lane"]
        v = StubVerifier(verdicts=[False])
        pool = env["pool"](v, max_buffer_wait=0.01, metrics=m)
        first = await asyncio.gather(
            pool.verify_signature_sets([("ok", 0), ("ok", 1)], priority=lane.AGGREGATE),
            pool.verify_signature_sets([("bad", 0)], priority=lane.UNAGGREGATED))
        second = await asyncio.gather(*[
            pool.verify_signature_sets([("ok", i)], priority=lane.BLOCK_PROPOSAL)
            for i in range(3)])
        pool.close()
        return (first, second, [len(b) for b in v.batches], pool.batch_retries,
                pool.batch_sets_success, spans(name),
                journal_events(name, ("pool.flush",)), pool_metric_lines(m))

    out = both(script)
    assert out["port"] == out["jax"]
    first, second, batches, retries, success, sp, flushes, lines = out["port"]
    assert first == [True, False] and second == [True] * 3
    assert batches == [3, 3] and retries == 1 and success == 3
    assert [n for n, _ in sp].count("bls.queue_wait") == 5
    assert [a["ok"] for n, a in sp if n == "pool.batch"] == [False, True]
    assert [(e["jobs"], e["sets"]) for e in flushes] == [(2, 3), (3, 3)]
    for want in ('lodestar_bls_pool_dispatches_total 2.0',
                 'lodestar_bls_e2e_verify_seconds_count{lane="block_proposal"} 3.0',
                 'lodestar_bls_e2e_verify_seconds_count{lane="aggregate"} 1.0',
                 'lodestar_bls_e2e_verify_seconds_count{lane="unaggregated"} 1.0',
                 'lodestar_bls_queue_wait_seconds_count{lane="aggregate"} 1.0',
                 'lodestar_bls_pool_batch_size_sum 6.0',
                 'lodestar_bls_pool_inflight_peak 1.0',
                 'lodestar_bls_verifier_stage_seconds{stage="pack"} 0.5'):
        assert want in lines, want


def _shed(pool, lane, n, stale):
    async def run():
        for i in range(n):
            try:
                await pool.verify_signature_sets([("s", i)], priority=lane.UNAGGREGATED,
                                                 deadline=stale)
            except Exception as e:  # noqa: BLE001 - each side's own typed drop
                assert type(e).__name__ == "VerificationDroppedError"
    return run()


def test_a_shed_rate_spike_writes_one_triageable_overload_bundle(tmp_path):
    async def script(name, env):
        env["journal"].enabled = True
        pool = env["pool"](StubVerifier(), max_buffer_wait=0.01, overload_shed_threshold=4,
                           overload_cooldown_s=60.0)
        env["recorder"].configure(forensics_dir=str(tmp_path / name), pool=pool)
        await _shed(pool, env["lane"], 6, time.monotonic() - 0.001)
        assert pool._overload_task is not None
        await pool._overload_task
        pool.close()
        bundle = latest_bundle(str(tmp_path / name))
        # each package's bundle read by its own inspector
        assert bundle and "overload" in bundle and env["inspect"].validate(bundle) == []
        ov = env["inspect"].summarize(bundle)["overload"]
        return ({k: ov[k] for k in ("shed_window_sets", "dropped_by_lane", "dropped_by_reason",
                                    "queue_depth_jobs", "pending_sets", "backpressure")},
                journal_events(name, ("pool.overload",)),
                len([d for d in os.listdir(tmp_path / name) if "overload" in d]))

    out = both(script)
    assert out["port"] == out["jax"]
    ov, events, bundles = out["port"]
    assert ov["shed_window_sets"] >= 4 and ov["dropped_by_lane"]["unaggregated"] >= 4
    assert ov["dropped_by_reason"]["deadline"] >= 4 and bundles == 1
    assert events and events[0]["level"] == "ERROR"


def test_cooldown_and_a_disabled_threshold(tmp_path):
    async def script(name, env):
        cooled = env["pool"](StubVerifier(), max_buffer_wait=0.01, overload_shed_threshold=2,
                             overload_cooldown_s=3600.0)
        env["recorder"].configure(forensics_dir=str(tmp_path / name), pool=cooled)
        await _shed(cooled, env["lane"], 20, time.monotonic() - 0.001)
        if cooled._overload_task is not None:
            await cooled._overload_task
        cooled.close()
        off = env["pool"](StubVerifier(), max_buffer_wait=0.01, overload_shed_threshold=0)
        await _shed(off, env["lane"], 30, time.monotonic() - 0.001)
        off.close()
        return (len([d for d in os.listdir(tmp_path / name) if "overload" in d]),
                len(off._shed_window), off._overload_task, off.dropped_sets)

    out = both(script)
    assert out["port"] == out["jax"]
    assert out["port"] == (1, 0, None, {("deadline", "unaggregated"): 30})


def test_every_flush_ends_at_the_profile_windows_flush_boundary(tmp_path):
    """``notify_flush`` in the flush's ``finally``: a one-flush window
    armed on the port's capture closes after one pool flush, with the
    batch's spans in the merged trace."""
    from test_xprof import _fake_profiler

    tracing.enable(1024)
    start, stop, _ = _fake_profiler(tmp_path)
    cap = xprof.configure_capture(profile_dir=str(tmp_path), start_fn=start, stop_fn=stop)

    async def main():
        cap.request_window(flushes=1)
        pool = BlsBatchPool(StubVerifier(), max_buffer_wait=0.005)
        assert await pool.verify_signature_sets([("ok", 0)])
        pool.close()

    asyncio.run(main())
    assert cap.wait_idle(5.0) and cap.windows == 1 and cap.snapshot()["last_error"] is None
    names = {e["name"] for e in cap.last_window()["trace"]["traceEvents"]}
    assert {"bls.queue_wait", "pool.batch"} <= names
