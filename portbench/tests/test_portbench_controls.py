"""The check against the reference: the sound verifier in the program's
place comes out correct, the control (coefficients narrowed to none) and
each planted fault as not correct.  A tiny deployment, on the CPU."""

import time

import pytest

from portbench import controls, harness
from portbench.pyref import check as pyref_check


def _cell(cfg, rate=30.0, name="default-node.slo"):
    """The tiny deployment under a cell name of BENCHMARK.json, whose
    per-layer metrics a traced run reads."""
    return harness.Cell(name, cfg, {"sets_per_s": rate, "tampered_gossip": {
        "pairs_at": [0.2, 0.45, 0.7], "single_at": 0.9}}, 1)


@pytest.mark.parametrize("kind, correct", [
    ("sound", True), ("control", False), ("unchanged", False), ("half", False),
    ("altered", False), ("small", False)])
def test_check_separates(tiny_config, kind, correct):
    verifier = controls.make(kind)
    res = harness.run_cell(_cell(tiny_config), 2**31 + 17, 24, False, time.monotonic(), 3,
                           verifier=verifier, pyref_sets=12)
    # the middle block, three aggregates, one attestation
    assert res.extra["expected_false"] == 5
    assert res.extra["pyref_sets"] == 12
    assert res.checks["reference_disagreements"]["value"] == 0
    assert res.correct is correct, res.checks
    seen = verifier.by_bucket(res.extra["tampered_signatures"])
    if kind in ("control", "small"):
        # the gossip's cancelling pairs pass a small batch
        assert any(passed for b, (_, passed) in seen.items() if b <= 16), seen
    if kind == "sound":
        assert all(passed == 0 for _, passed in seen.values()), seen
    assert res.line["correct"] is correct
    assert set(res.line["metrics"]) == set(harness.end_to_end("default-node.slo"))
    assert {"job_p50_ms", "setup_s"} <= set(res.line["metrics"])
    assert res.line["attempted"] == res.extra["jobs"] > 0


def test_traced_line_reads_the_span_metrics(tiny_config):
    res = harness.run_cell(_cell(tiny_config), 99, 12, True, time.monotonic(), 3,
                           verifier=controls.make("sound"), pyref_sets=12)
    # no card: the device readers find nothing, the pool's spans are read
    names = set(res.line["metrics"])
    assert {"queue_wait_p95_ms", "sets_per_batch"} <= names
    assert res.extra["failed_batches"], "the tampered jobs fail their batches"
    assert all(b == harness.bucket_of(n) for n, b in res.extra["failed_batches"])
    assert not names & {"replay_ms_per_batch", "device_idle_pct", "fused_verify_roofline"}


def test_a_disagreement_of_the_two_references_fails_the_run(tiny_config, monkeypatch):
    """The pure-Python pairing's verdicts, as the worker pool hands them
    back, negated: every sampled set disagrees with the C reference."""
    real = harness.bank.run_chunked

    def negate_pyref(pool, fn, items, chunks):
        out = real(pool, fn, items, chunks)
        return [not x for x in out] if fn is pyref_check.verify_tasks else out

    monkeypatch.setattr(harness.bank, "run_chunked", negate_pyref)
    res = harness.run_cell(_cell(tiny_config), 2**31 + 17, 12, False, time.monotonic(), 3,
                           verifier=controls.make("sound"), pyref_sets=6)
    assert res.checks["wrong_verdicts"]["value"] == 0
    assert res.checks["reference_disagreements"]["value"] == res.extra["pyref_sets"] > 0
    assert res.correct is False


@pytest.mark.cuda
def test_port_on_the_card_is_correct(tiny_config, card):
    res = harness.run_cell(_cell(tiny_config), 5, 12, False, time.monotonic(), 3)
    assert res.correct is True, res.checks
    assert res.line["device"]["platform"] == "gpu"
