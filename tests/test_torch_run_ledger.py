"""The port's run ledger (``lodestar_tpu_torch/observatory/run_ledger.py``)
and its two tools, ``perf_report`` and ``tier1_budget``, held against the
JAX package's ``observatory/run_ledger`` and the repo's ``tools/`` on the
same seeded series, and chip_smoke's phase 21 driven on the CPU."""

import glob
import json
import os

import numpy as np
import pytest

import chip_smoke
import tests.conftest as cft
from lodestar_tpu.observatory import run_ledger as jax_ledger
from lodestar_tpu_torch.observatory import run_ledger
from lodestar_tpu_torch.tools import perf_report, tier1_budget
from tools import tier1_budget as jax_budget

H100 = "NVIDIA H100 80GB HBM3, 700.00 W"
H100_LOW = "NVIDIA H100 80GB HBM3, 500.00 W"
OTHER = "NVIDIA A100-SXM4-80GB, 400.00 W"


def _seeded_series(seed):
    """(points, direction, threshold, plateau, cards): 1-9 runs, gaps as
    None, flat, jittery or drifting values, two or three card groups."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 10))
    base = float(rng.uniform(0.5, 500.0))
    spread = (0.01, 0.1, 0.3)[int(rng.integers(3))]
    values = []
    for _ in range(n):
        r = rng.random()
        if r < 0.15:
            values.append(None)
        elif r < 0.2:
            values.append(0.0)
        else:
            values.append(round(base * float(rng.uniform(1 - spread, 1 + spread)), 3))
    groups = [None, H100, H100_LOW][:int(rng.integers(2, 4))]
    cards = [groups[int(rng.integers(len(groups)))] for _ in range(n)]
    name = sorted(run_ledger.TRIPWIRES)[seed % len(run_ledger.TRIPWIRES)]
    direction, threshold = run_ledger.TRIPWIRES[name]
    return list(enumerate(values, start=1)), direction, threshold, bool(rng.random() < 0.5), cards


def test_noise_band_equals_the_jax_ledger_on_seeded_series():
    for seed in range(200):
        points = _seeded_series(seed)[0]
        values = [v for _, v in points if v is not None]
        assert run_ledger._noise_band(values) == jax_ledger._noise_band(values), seed


def test_trend_metric_equals_the_jax_ledger_on_seeded_series():
    flags = set()
    for seed in range(200):
        points, direction, threshold, plateau, cards = _seeded_series(seed)
        got = run_ledger.trend_metric(points, direction, threshold, plateau=plateau, cards=cards)
        want = jax_ledger.trend_metric(points, direction, threshold, plateau=plateau,
                                       backends=cards)
        assert got == want, seed
        flags.update(got["flags"])
    # the series reach every verdict
    assert flags == {"regression", "regression_vs_best", "plateau"}


def test_tripwires_and_constants_equal_the_jax_ledger():
    shared = {k: v for k, v in jax_ledger.TRIPWIRES.items() if k in run_ledger.TRIPWIRES}
    assert run_ledger.TRIPWIRES == shared
    assert set(jax_ledger.TRIPWIRES) - set(run_ledger.TRIPWIRES) == {"fp_mul_speedup_mxu"}
    assert list(run_ledger.TRIPWIRES) == [k for k in jax_ledger.TRIPWIRES
                                          if k != "fp_mul_speedup_mxu"]
    assert run_ledger.TIER1_FULL_RUN_MIN_TESTS == jax_ledger.TIER1_FULL_RUN_MIN_TESTS
    assert run_ledger.TIER1_FULL_RUN_MIN_TESTS == cft._tier1_full_run_min_tests()
    assert (run_ledger.PLATEAU_METRICS, run_ledger.PLATEAU_RUNS, run_ledger.PLATEAU_BAND) == (
        jax_ledger.PLATEAU_METRICS, jax_ledger.PLATEAU_RUNS, jax_ledger.PLATEAU_BAND)
    # every metric chip_smoke measures is a tripwire
    assert set(chip_smoke.LEDGER_METRICS) <= set(run_ledger.TRIPWIRES)


# -- records ---------------------------------------------------------------


def _figures(split=None, pool=None, sharded=None, single=None, device_miller=None,
             cold=None, aot=None, warm=None, chain=None, range_sync=None, slo=None):
    """chip_smoke's phase figures, shaped as the phases return them."""
    fig = {}
    if split is not None or device_miller is not None:
        fig["split"] = {"rate": split, "stages": {
            "device_miller": 0.095 if device_miller is None else device_miller}}
    if pool is not None:
        fig["pool"] = {"rate": pool, "batches": 5}
    if sharded is not None:
        fig["sharded_times"] = {"logical2": {"rate": sharded, "idle": 0.1, "single": single}}
    if cold is not None:
        fig["store"] = {"load_s": 0.01, "build_s": 9.9, "cold_s": cold, "aot_s": aot,
                        "warm_s": warm}
    if chain is not None:
        fig["chain"] = {"chain": {"blocks_per_s": chain}}
    if range_sync is not None:
        fig["network"] = {"range_sync": {"blocks_per_s": range_sync}}
    if slo is not None:
        fig["firehose"] = {"slo": {"achieved_sets_per_s": slo}}
    return fig


def _write_runs(root, runs, start=0):
    """One record a (mode, rc, card, figures) run, its metrics read as
    chip_smoke reads them, a second apart from ``start`` seconds on."""
    paths = []
    for i, (mode, rc, card, fig) in enumerate(runs, start=start):
        rec = run_ledger.make_record(mode, rc, card, chip_smoke.ledger_metrics(mode, fig),
                                     chip_smoke.MODE_PHASES[mode], {"1 build": 1.5},
                                     utc=1_800_000_000.0 + i)
        paths.append(run_ledger.write_record(rec, str(root)))
    return paths


def test_a_record_round_trips_through_the_ledger(tmp_path):
    fig = _figures(split=281.4, pool=329.8, sharded=250.0, single=200.0, device_miller=0.0954,
                   cold=31.0, aot=5.0, warm=4.2, chain=3.05, range_sync=12.5, slo=146.9)
    rec = run_ledger.make_record("all", 0, H100 + "\n", chip_smoke.ledger_metrics("all", fig),
                                 "1-21", {"1 build": 30.04, "11 split": 9.0}, commit="abc",
                                 torch_version="2.9.0", cuda_version="12.8",
                                 utc=1_800_000_000.25)
    assert rec["card"] == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    assert rec["phases_run"] == "1-21"
    assert set(rec["metrics"]) == set(chip_smoke.LEDGER_METRICS)
    path = run_ledger.write_record(rec, str(tmp_path / "runs"))
    assert os.path.basename(path).startswith("smoke-") and path.endswith("-all.json")
    [back] = run_ledger.load_series([path])
    assert back["_run"] == 1 and run_ledger.run_card(back) == H100
    assert {k: back[k] for k in rec} == rec
    got = run_ledger.extract_metrics(back)
    assert got == {
        "bls_sig_sets_per_s_per_chip": 281.4, "dispatch_ms": 95.4, "bls_sig_sets_per_s": 329.8,
        "bls_sig_sets_per_s_sharded": 250.0, "scaling_efficiency_sharded": 1.25,
        "cold_start_cold_s": 31.0, "cold_start_aot_s": 5.0, "cold_start_warm_s": 4.2,
        "dev_chain_blocks_per_s": 3.05, "range_sync_blocks_per_s": 12.5,
        "sustained_sets_per_s_at_slo": 146.9,
    }
    # the metrics no phase measures are absent, and the record has no ok line
    assert not set(rec["metrics"]) & {"scaling_efficiency", "mesh_overlap_ratio",
                                      "epoch_transition_ms_250k"}
    assert '"ok"' not in open(path).read()
    with pytest.raises(ValueError):
        run_ledger.make_record("all", 0, H100, {"fp_mul_speedup_mxu": 1.0}, "1-21", {})


def test_a_failed_run_is_a_gap_and_a_crashed_run(tmp_path):
    paths = _write_runs(tmp_path, [
        ("all", 0, H100, _figures(split=220.0, pool=330.0, chain=3.0)),
        # failed in phase 12: phase 11's figure kept, null for the rest
        ("all", 1, H100, _figures(split=221.0)),
    ])
    [_, failed] = run_ledger.load_series(paths)
    got = run_ledger.extract_metrics(failed)
    assert got["bls_sig_sets_per_s_per_chip"] == 221.0
    assert got["bls_sig_sets_per_s"] is None and got["dev_chain_blocks_per_s"] is None
    report = run_ledger.analyze(paths, tier1=str(tmp_path / "none.json"))
    assert report["crashed_runs"] == [{"run": "r02", "rc": 1,
                                       "file": os.path.basename(paths[1])}]
    assert report["metrics"]["bls_sig_sets_per_s"]["gaps"] == ["r02"]
    assert report["metrics"]["dev_chain_blocks_per_s"]["gaps"] == ["r02"]
    assert report["metrics"]["bls_sig_sets_per_s_per_chip"]["gaps"] == []
    assert report["multichip_dryruns"] == [] and report["compile_ledger"] is None
    assert report["tier1"] is None


def _jax_bench(root, runs):
    """The same series as JAX BENCH_r*.json records (backend = card)."""
    for i, (rc, card, per_chip, dispatch, chain, pool) in enumerate(runs, start=1):
        rec = {"n": i, "rc": rc, "parsed": {
            "metric": "bls_sig_sets_per_s_per_chip", "value": per_chip,
            "extras": {"backend": card, "dispatch_ms": dispatch,
                       "dev_chain_blocks_per_s": chain,
                       "multichip": {"bls_sig_sets_per_s": pool}}}}
        with open(os.path.join(root, f"BENCH_r{i:02d}.json"), "w") as f:
            json.dump(rec, f)


def test_deltas_vs_previous_equal_the_jax_ledger_and_ignore_another_card(tmp_path):
    series = [
        (0, H100, 220.0, 95.0, 3.0, 330.0),
        (0, H100, 219.0, 96.0, 3.1, 325.0),
        (0, OTHER, 150.0, 140.0, 2.0, 200.0),  # another card: never the previous one
        (1, H100, None, None, 3.2, None),      # a failed run: no value, no delta
    ]
    jax_root = tmp_path / "jax"
    jax_root.mkdir()
    _jax_bench(str(jax_root), series)
    paths = _write_runs(tmp_path / "port", [
        ("all", rc, card, _figures(split=pc, device_miller=None if d is None else d / 1e3,
                                   chain=ch, pool=pl))
        for rc, card, pc, d, ch, pl in series])
    current = {"bls_sig_sets_per_s_per_chip": 180.0, "dispatch_ms": 96.5,
               "dev_chain_blocks_per_s": 3.3, "bls_sig_sets_per_s": 326.0,
               "cold_start_warm_s": None}
    for card in (H100, OTHER, None):
        got = run_ledger.deltas_vs_previous(paths, current, card)
        want = jax_ledger.deltas_vs_previous(str(jax_root), current, backend=card)
        assert got == want, card
    got = run_ledger.deltas_vs_previous(paths, current, H100)
    assert got["bls_sig_sets_per_s_per_chip"]["prev_run"] == "r02"
    assert got["bls_sig_sets_per_s_per_chip"]["regressed"] is True
    assert got["dispatch_ms"]["regressed"] is False
    assert got["dev_chain_blocks_per_s"]["prev_run"] == "r04"
    assert "cold_start_warm_s" not in got
    # without the card the other card's record is the previous one
    assert run_ledger.deltas_vs_previous(paths, current)["dispatch_ms"]["prev_run"] == "r03"


# -- perf_report -----------------------------------------------------------


def _report_main(root, *extra):
    return perf_report.main(["--repo", str(root), "--runs", str(root / "runs" / "*.json"),
                             *extra])


def test_an_injected_split_regression_exits_one_and_is_named(tmp_path, capsys):
    _write_runs(tmp_path / "runs", [("split", 0, H100, _figures(split=v, pool=330.0))
                                    for v in (220.0, 221.0, 219.0, 222.0, 187.0)])
    out = tmp_path / "trend.md"
    assert _report_main(tmp_path, "--out", str(out)) == 1
    md = out.read_text()
    assert "REGRESSIONS" in md and "bls_sig_sets_per_s_per_chip" in md
    assert "REGRESSION: bls_sig_sets_per_s_per_chip" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "PERF_TREND.md")


def test_a_flat_series_is_a_plateau_and_fails_only_on_warn(tmp_path, capsys):
    paths = _write_runs(tmp_path / "runs", [
        ("split", 1, H100, {}), ("split", 0, H100, _figures(split=222.0)),
        ("split", 0, H100, _figures(split=219.0))])
    assert _report_main(tmp_path) == 0
    report = run_ledger.analyze(paths, tier1=str(tmp_path / "none.json"))
    t = report["metrics"]["bls_sig_sets_per_s_per_chip"]
    assert "plateau" in t["flags"] and not report["regressions"]
    assert report["crashed_runs"][0]["rc"] == 1 and t["gaps"] == ["r01"]
    assert _report_main(tmp_path, "--fail-on-warn") == 1
    capsys.readouterr()
    assert _report_main(tmp_path, "--json") == 0
    assert json.loads(capsys.readouterr().out)["plateaus"] == ["bls_sig_sets_per_s_per_chip"]
    line = perf_report.summary_line(report)
    assert line.startswith("perf_report: 3 run(s); regressions: none; plateaus: "
                           "bls_sig_sets_per_s_per_chip; gaps: ")
    assert "bls_sig_sets_per_s_per_chip (r01)" in line


def test_the_noise_band_suppresses_jitter(tmp_path):
    paths = _write_runs(tmp_path / "runs", [("split", 0, H100, _figures(split=v))
                                            for v in (200.0, 240.0, 205.0, 238.0, 207.0)])
    t = run_ledger.analyze(paths)["metrics"]["bls_sig_sets_per_s_per_chip"]
    assert not any(f.startswith("regression") for f in t["flags"])
    assert _report_main(tmp_path) == 0


def test_no_runs_exits_two(tmp_path, capsys):
    assert _report_main(tmp_path) == 2
    assert "no run records matched" in capsys.readouterr().err


def test_a_switch_of_card_never_regresses(tmp_path):
    paths = _write_runs(tmp_path / "runs", [
        ("all", 0, H100, _figures(split=220.0, chain=3.0)),
        ("all", 0, H100, _figures(split=221.0, chain=3.1)),
        ("all", 0, H100_LOW, _figures(split=150.0, chain=2.0)),  # the limit lowered
        ("all", 0, OTHER, _figures(split=120.0, chain=1.5)),
    ])
    report = run_ledger.analyze(paths)
    assert report["regressions"] == []
    t = report["metrics"]["bls_sig_sets_per_s_per_chip"]
    assert "delta_vs_prev_pct" not in t  # one point on the latest card
    assert _report_main(tmp_path) == 0
    # the first card again: judged against its own earlier points only
    paths += _write_runs(tmp_path / "runs", [("all", 0, H100, _figures(split=180.0, chain=3.0))],
                         start=4)
    report = run_ledger.analyze(paths)
    assert report["regressions"] == ["bls_sig_sets_per_s_per_chip"]
    t = report["metrics"]["bls_sig_sets_per_s_per_chip"]
    assert t["delta_vs_prev_pct"] == -18.6 and t["noise_band_pct"] == 2.0
    assert "regression" not in report["metrics"]["dev_chain_blocks_per_s"]["flags"]


def test_an_ops_only_record_is_no_gap_on_the_split_rate(tmp_path):
    paths = _write_runs(tmp_path / "runs", [
        ("split", 0, H100, _figures(split=220.0, pool=330.0)),
        ("ops", 0, H100, _figures(slo=146.9)),
        ("split", 0, H100, _figures(split=221.0, pool=331.0)),
        ("all", 1, H100, _figures(slo=147.0)),
    ])
    report = run_ledger.analyze(paths)
    per_chip = report["metrics"]["bls_sig_sets_per_s_per_chip"]
    assert per_chip["points"] == {"r01": 220.0, "r03": 221.0} and per_chip["gaps"] == ["r04"]
    slo = report["metrics"]["sustained_sets_per_s_at_slo"]
    assert slo["points"] == {"r02": 146.9, "r04": 147.0} and slo["gaps"] == []
    assert report["metrics"]["scaling_efficiency"] == {"points": {}, "gaps": [], "flags": []}


def test_the_report_reads_the_ports_compile_ledger_and_the_tier1_ledger(tmp_path, capsys):
    from lodestar_tpu_torch.observatory.compile_ledger import CompileLedger

    ledger = CompileLedger(path=str(tmp_path / "compile_ledger.json"))
    ledger.record("lodestar_tpu_torch", None, "sm_90", "build", 31.04)
    ledger.record("lodestar_tpu_torch", None, "sm_90", "aot_load", 0.01)
    ledger.flush()
    cache = tmp_path / ".jax_cache"
    cache.mkdir()
    json.dump({"schema": 2, "runs": [{"wall_s": 701.0, "n_tests": 2163}],
               "partial_runs": [{"wall_s": 3.0, "n_tests": 11}]},
              open(cache / "tier1_timings.json", "w"))
    paths = _write_runs(tmp_path / "runs", [("store", 0, H100, _figures(cold=41.5, aot=9.9,
                                                                      warm=1.2))])
    report = run_ledger.analyze(paths, compile_ledger=str(tmp_path / "compile_ledger.json"),
                                tier1=str(cache / "tier1_timings.json"))
    assert report["compile_ledger"]["keys"] == 1
    assert report["compile_ledger"]["by_kind"]["build"] == {"count": 1, "total_s": 31.0,
                                                             "max_s": 31.0}
    assert report["tier1"] == {"runs": 1, "wall_s": [701.0], "last_n_tests": 2163}
    md = perf_report.render_markdown(report)
    assert "## Compile ledger" in md and "cap 1470 s" in md
    assert report["records"][0]["mode"] == "store" and report["records"][0]["card"] == H100
    # without paths, no sidecars; the command reads both under --repo
    assert run_ledger.analyze(paths)["tier1"] is None
    assert run_ledger.analyze(paths)["compile_ledger"] is None
    ledger_dir = tmp_path / "build" / "lodestar_tpu_torch"
    ledger_dir.mkdir(parents=True)
    os.replace(tmp_path / "compile_ledger.json", ledger_dir / "compile_ledger.json")
    capsys.readouterr()
    assert _report_main(tmp_path, "--json") == 0
    got = json.loads(capsys.readouterr().out)
    assert got["compile_ledger"] == report["compile_ledger"] and got["tier1"] == report["tier1"]


# -- tier1_budget ----------------------------------------------------------

#: the JAX tool's fixtures (tests/test_observatory.py, TestTier1Budget)
TIER1_FIXTURES = {
    "movers_and_margin": {"schema": 1, "runs": [
        {"wall_s": 820.0, "n_tests": 550, "exitstatus": 0, "compile_events": 9,
         "compile_events_s": 300.0,
         "tests": {"tests/test_ops_pairing.py::t": 98.0, "tests/test_small.py::t": 1.0},
         "test_compiles": {"tests/test_ops_pairing.py::t": 3}},
        {"wall_s": 845.0, "n_tests": 551, "exitstatus": 0, "compile_events": 9,
         "compile_events_s": 310.0,
         "tests": {"tests/test_ops_pairing.py::t": 111.0, "tests/test_small.py::t": 1.1},
         "test_compiles": {"tests/test_ops_pairing.py::t": 3}}]},
    "partial_run_never_gates": {"schema": 1, "runs": [
        {"wall_s": 800.0, "n_tests": 550, "exitstatus": 0, "utc": 100.0, "tests": {}},
        {"wall_s": 860.0, "n_tests": 12, "exitstatus": 0, "utc": 200.0, "tests": {}}]},
    "partial_ring_cannot_evict_full_baselines": {"schema": 1, "runs": [
        {"wall_s": 500.0, "n_tests": 550, "exitstatus": 0, "utc": 1.0,
         "tests": {"tests/test_x.py::t": 9.0}}] + [
        {"wall_s": 30.0 + i, "n_tests": 10, "exitstatus": 0, "utc": 2.0 + i, "tests": {}}
        for i in range(8)]},
    "schema2": {"schema": 2,
                "runs": [{"wall_s": 500.0, "n_tests": 550, "exitstatus": 0, "tests": {}}],
                "partial_runs": [{"wall_s": 12.0, "n_tests": 3, "exitstatus": 0, "tests": {}}]},
    "empty": None,
}


def _tier1_repo(tmp_path, name):
    data = TIER1_FIXTURES[name]
    if data is not None:
        (tmp_path / ".jax_cache").mkdir()
        json.dump(data, open(tmp_path / ".jax_cache" / "tier1_timings.json", "w"))
    return str(tmp_path)


@pytest.mark.parametrize("name", sorted(TIER1_FIXTURES))
def test_tier1_analyze_equals_the_jax_tool(tmp_path, name):
    repo = _tier1_repo(tmp_path, name)
    assert tier1_budget.load_ledger(repo) == jax_budget.load_ledger(repo)
    for cap in (870.0, 1470.0):
        assert tier1_budget.analyze(repo, cap_s=cap) == jax_budget.analyze(repo, cap_s=cap)
        assert tier1_budget.render(tier1_budget.analyze(repo, cap_s=cap)).splitlines()[0] == \
            jax_budget.render(jax_budget.analyze(repo, cap_s=cap)).splitlines()[0]


def test_tier1_default_cap_is_the_tier1_commands_limit(tmp_path, capsys):
    assert tier1_budget.DEFAULT_CAP_S == 1470.0
    repo = _tier1_repo(tmp_path, "movers_and_margin")
    report = tier1_budget.analyze(repo)
    assert report["cap_s"] == 1470.0 and report["margin_s"] == 625.0
    assert report["movers"][0]["delta_s"] == 13.0
    assert tier1_budget.main(["--repo", repo, "--fail-margin", "35"]) == 0
    # at the JAX tool's cap the same margins gate as they do there
    for margin, rc in (("35", 1), ("20", 0)):
        args = ["--repo", repo, "--cap", "870", "--fail-margin", margin]
        assert tier1_budget.main(args) == jax_budget.main(args) == rc
    capsys.readouterr()
    assert tier1_budget.main(["--repo", repo, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["cap_s"] == 1470.0


def test_tier1_enforce_runs_the_ports_test_cost_audit(tmp_path, monkeypatch, capsys):
    from lodestar_tpu_torch.analysis import test_cost
    from lodestar_tpu_torch.analysis.report import Violation

    repo = _tier1_repo(tmp_path, "schema2")
    calls = []
    found = []

    def audit(repo):
        calls.append(repo)
        return list(found)

    monkeypatch.setattr(test_cost, "audit_test_cost", audit)
    assert tier1_budget.main(["--repo", repo, "--enforce"]) == 0
    found.append(Violation(test_cost.RULE, "tests/test_x.py", 3, "unpinned"))
    capsys.readouterr()
    assert tier1_budget.main(["--repo", repo, "--enforce", "--json"]) == 1
    assert calls == [repo, repo]
    captured = capsys.readouterr()
    assert json.loads(captured.out)["test_cost_violations"][0]["path"] == "tests/test_x.py"
    assert "[torch-test-threads] unpinned" in captured.err
    # a thin margin gates too: 60 s by default under --enforce
    found.clear()
    assert tier1_budget.main(["--repo", repo, "--enforce", "--cap", "550"]) == 1


# -- chip_smoke's phase 21 -------------------------------------------------


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    """chip_smoke with its checkout at ``tmp_path``, a card line and the
    card's name, and no card otherwise."""
    import chip_smoke
    import torch

    monkeypatch.setattr(chip_smoke, "REPO", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "PHASE_SECONDS", {})
    monkeypatch.setattr(chip_smoke, "card_line", lambda: H100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    return chip_smoke


def _records(root):
    return run_ledger.load_series(glob.glob(os.path.join(root, "chiprun_out", "runs", "*.json")))


def test_every_mode_ends_in_phase_21_and_prints_deltas(smoke, tmp_path, monkeypatch, capsys):
    rates = iter((220.0, 221.0))

    def phases(mode, card, figures, t_start):
        with smoke.Phase("20a firehose"):
            figures["firehose"] = {"slo": {"achieved_sets_per_s": next(rates)}}

    monkeypatch.setattr(smoke, "run_phases", phases)
    assert smoke.main(["--ops-only"]) == 0
    first = capsys.readouterr().out.splitlines()
    assert first[-1] == json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    assert first[-2] == H100 and first[-3] == json.dumps({"phases": "1, 20, 21"})
    assert any(line.startswith("perf_report: 1 run(s)") for line in first)
    assert "tier-1 budget: none (no .jax_cache/tier1_timings.json in this checkout)" in first
    assert smoke.main(["--ops-only"]) == 0
    second = capsys.readouterr().out.splitlines()
    [deltas] = [line for line in second if line.startswith("run ledger: deltas")]
    got = json.loads(deltas[deltas.index("{"):])
    assert got["sustained_sets_per_s_at_slo"] == {
        "now": 221.0, "prev": 220.0, "prev_run": "r01", "delta_pct": 0.5,
        "noise_band_pct": 0.0, "regressed": False}
    recs = _records(tmp_path)
    assert [(r["mode"], r["rc"], r["metrics"]["sustained_sets_per_s_at_slo"]) for r in recs] \
        == [("ops", 0, 220.0), ("ops", 0, 221.0)]
    assert "20a firehose" in recs[0]["phases_s"] and recs[0]["card"]["power_limit"] == "700.00 W"


def test_a_failed_phase_writes_its_record_and_still_fails(smoke, tmp_path, monkeypatch, capsys):
    def phases(mode, card, figures, t_start):
        figures["split"] = {"rate": 219.0, "stages": {"device_miller": 0.09}}
        raise AssertionError("pool: a valid job did not verify")

    monkeypatch.setattr(smoke, "run_phases", phases)
    with pytest.raises(AssertionError, match="pool: a valid job"):
        smoke.main([])
    out = capsys.readouterr().out
    assert '"ok": true' not in out and "run ledger: wrote" in out
    [rec] = _records(tmp_path)
    assert (rec["mode"], rec["rc"]) == ("all", 1)
    got = run_ledger.extract_metrics(rec)
    assert got["bls_sig_sets_per_s_per_chip"] == 219.0 and got["bls_sig_sets_per_s"] is None


def test_phase_21_reads_the_checkouts_tier1_ledger(smoke, tmp_path, monkeypatch, capsys):
    _tier1_repo(tmp_path, "movers_and_margin")
    monkeypatch.setattr(smoke, "run_phases", lambda *a: None)
    assert smoke.main(["--analysis-only"]) == 0
    out = capsys.readouterr().out
    assert "tier-1 budget (cap 1470s)" in out and "margin 625.0s" in out
    [rec] = _records(tmp_path)
    assert rec["mode"] == "analysis" and run_ledger.extract_metrics(rec) == {}



@pytest.mark.parametrize("mode,phases", [
    ("all", {"10", "11", "12", "14", "17", "18a", "20a"}), ("sharded", {"10"}),
    ("split", {"11", "12"}), ("fused", {"11", "12"}), ("store", {"14"}), ("chain", {"17"}),
    ("network", {"18a"}), ("ops", {"20a"}), ("observatory", set()), ("analysis", set()),
    ("validator", set())])
def test_each_mode_records_the_metrics_of_the_phases_it_runs(mode, phases):
    """A metric is in a mode's record exactly when the mode runs its phase;
    a phase that returned no figures leaves it None (a gap)."""
    want = {name for name, (phase, _, _) in chip_smoke.LEDGER_METRICS.items() if phase in phases}
    got = chip_smoke.ledger_metrics(mode, {})
    assert set(got) == want and all(v is None for v in got.values())
    for phase in phases:
        assert chip_smoke.runs_phase(chip_smoke.MODE_PHASES[mode], phase)
    assert chip_smoke.runs_phase("1, 2b, 11-13, 21", "2b")
    assert not chip_smoke.runs_phase("1, 2b, 11-13, 21", "2")
    assert not chip_smoke.runs_phase("1, 2b, 11-13, 21", "14a")


def test_a_passing_run_that_leaves_a_metric_empty_fails_phase_21(smoke, tmp_path, monkeypatch,
                                                                 capsys):
    monkeypatch.setattr(smoke, "run_phases", lambda *a: None)  # phase 17 returned nothing
    with pytest.raises(AssertionError, match="dev_chain_blocks_per_s"):
        smoke.main(["--chain-only"])
    assert '"ok": true' not in capsys.readouterr().out
    [rec] = _records(tmp_path)
    assert (rec["mode"], rec["rc"], rec["phases_run"]) == ("chain", 1, "1, 17, 21")
    assert rec["metrics"] == {"dev_chain_blocks_per_s": None}


def test_a_phases_directory_starts_fresh_on_every_run(smoke, tmp_path):
    """A second run in one checkout finds no state of the first: the chaos
    campaign's stores and the validator's protection database start empty."""
    out = tmp_path / "chiprun_out" / "chip_smoke_validator"
    out.mkdir(parents=True)
    (out / "slashing_protection.json").write_text("{}")
    assert smoke.fresh_dir(str(out)) == str(out)
    assert os.listdir(out) == []
    assert os.listdir(smoke.fresh_dir(str(tmp_path / "new"))) == []
