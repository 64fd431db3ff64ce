"""The open-loop schedule: each job is offered at its due instant whatever
the pool does, and timed from that instant."""

import asyncio

from portbench import harness, traffic


class _StallingPool:
    """Answers True after ``delay``; the first call also holds the event
    loop for ``stall`` seconds (a host stall)."""

    def __init__(self, delay=0.01, stall=0.3):
        self.delay, self.stall, self.calls = delay, stall, 0

    async def verify_signature_sets(self, sets, priority=None, deadline=None):
        import time

        self.calls += 1
        if self.calls == 1:
            time.sleep(self.stall)  # blocks the loop: later jobs are offered late
        await asyncio.sleep(self.delay)
        return True

    def pending_sets(self):
        return 0


def _jobs(dues):
    return [traffic.Job(i, d, "beacon_attestation", [traffic.SetSpec((i,), b"r" * 32)])
            for i, d in enumerate(dues)]


def test_jobs_are_timed_from_their_due_instant():
    jobs = _jobs([0.0, 0.05, 0.10, 0.5])
    pool = _StallingPool()
    marks = {}
    t0, t_close, outcomes, late, _ = asyncio.run(harness._offer(
        pool, jobs, [[None]] * len(jobs), 0.7, 12, lambda t: marks.setdefault("open", t),
        lambda t: marks.setdefault("close", t)))
    assert t_close - t0 >= 0.7 - 1e-3
    assert all(o.kind == "verdict" and o.verdict for o in outcomes)
    lat = [o.t_done - (t0 + j.due) for o, j in zip(outcomes, jobs)]
    # jobs 1 and 2 were due during the stall: the generator ran late, and
    # their latency counts the wait from their due instant
    assert late[1] > 0.2 and late[2] > 0.15
    assert lat[1] >= late[1] + 0.01 - 1e-3 and lat[2] >= late[2] + 0.01 - 1e-3
    assert late[3] < 0.05 and lat[3] < 0.1
    assert marks["open"] == t0 and marks["close"] == t_close


def test_a_job_that_never_answers_is_missing(monkeypatch):
    monkeypatch.setattr(harness, "GRACE_S", 0.2)

    class _Hang(_StallingPool):
        async def verify_signature_sets(self, sets, priority=None, deadline=None):
            await asyncio.sleep(10)

    jobs = _jobs([0.0])
    _, _, outcomes, _, _ = asyncio.run(harness._offer(
        _Hang(), jobs, [[None]], 0.1, 12, lambda t: None, lambda t: None))
    assert outcomes[0].kind == "missing"
