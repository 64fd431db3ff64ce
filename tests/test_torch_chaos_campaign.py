"""The port's chaos campaign (``lodestar_tpu_torch/tools/chaos_campaign.py``)
on the CPU over stub bucket programs: every one of its eight fault classes
holds (each fault diagnosable by a bundle the port's ``inspect_bundle``
validates, no verdict lost, the executor re-admitted), as the repo's
``tools/chaos_campaign.py`` holds for the JAX package."""

import json

import pytest

from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.chaos import CHAOS
from lodestar_tpu_torch.forensics import INFLIGHT, RECORDER
from lodestar_tpu_torch.tools import chaos_campaign, inspect_bundle

from tools import chaos_campaign as jchaos_campaign

NAMES = ("device_loss", "sharded_loss", "device_wedge", "compile_fault", "cache_corrupt",
         "aot_corrupt", "bench_kill", "forensics_io")


@pytest.fixture(autouse=True)
def _clean():
    saved = (RECORDER._dir, RECORDER.verifier, RECORDER.pool)
    CHAOS.disarm()
    INFLIGHT.clear()
    yield
    CHAOS.disarm()
    RECORDER.stop_watchdog()
    tracing.TRACER.disable()
    tracing.TRACER.clear()
    INFLIGHT.clear()
    RECORDER._dir, RECORDER.verifier, RECORDER.pool = saved


def test_the_fast_campaign_holds_every_fault_class_on_stub_programs(tmp_path, capsys):
    report = chaos_campaign.run_campaign(seed=0, out_dir=str(tmp_path), fast=True)
    assert tuple(report["scenarios"]) == NAMES
    assert report["failures"] == {}, json.dumps(report["failures"], indent=1)
    assert report["ok"] is True and report["verdicts_lost"] == 0
    for name, s in report["scenarios"].items():
        assert s["ok"] is True and s.get("verdicts_lost", 0) == 0, name
        assert s["on_card"] is False
        for bundle in s.get("bundles") or []:
            assert inspect_bundle.validate(bundle) == [], bundle
    # every fault class but the ledger's and the store's leaves its bundle
    assert report["bundles_validated"] >= 7
    assert report["time_to_quarantine_s"] is not None
    assert report["time_to_recover_s"] >= report["time_to_quarantine_s"]
    assert report["throughput_recovery_ratio"] >= 0.9
    assert "launches" not in report  # stub programs launch nothing
    compile_fault = report["scenarios"]["compile_fault"]
    assert compile_fault["warmup_raised"] == compile_fault["direct_raised"] == \
        "InjectedCompileError"
    assert compile_fault["faulted_jobs"] == 1
    assert compile_fault["landed_during_quarantine"] == ["cpu#1"]
    aot = report["scenarios"]["aot_corrupt"]
    assert aot["midwrite_exitcode"] == -9 and aot["orphan_temp_files"] == 1
    sharded = report["scenarios"]["sharded_loss"]
    assert sharded["mesh_batches"] > 0 and sharded["requeued_batches"] >= 1
    # the JAX campaign's scenarios, with the ladder's the port's compile fault
    jax_names = [fn.__name__.replace("scenario_", "") for fn in jchaos_campaign.SCENARIOS]
    assert sorted(NAMES) == sorted(n if n != "compile_ladder" else "compile_fault"
                                   for n in jax_names)


def test_the_card_scenarios_need_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = chaos_campaign.run_campaign(
        out_dir=str(tmp_path), fast=True, device="cuda",
        scenarios=(chaos_campaign.scenario_device_loss,))
    assert report["ok"] is False
    assert "no CUDA device" in report["failures"]["device_loss"][0]


def test_the_campaign_command_runs_on_the_card_by_default(monkeypatch, capsys):
    asked = []

    def campaign(**kw):
        asked.append(kw["device"])
        return {"ok": True, "scenarios": {}, "verdicts_lost": 0}

    monkeypatch.setattr(chaos_campaign, "run_campaign", campaign)
    assert chaos_campaign.main(["--json"]) == 0
    assert chaos_campaign.main(["--device", "cpu", "--json"]) == 0
    assert asked == ["cuda", None]


def test_the_card_campaigns_launches_leave_the_warmups_out(tmp_path, monkeypatch):
    """Each card verifier's warmup launches kernels; the report's
    ``launches`` counts the campaign's batches only."""
    from lodestar_tpu_torch.ops import fused_core

    def warmed(device, n_devices=2, **kw):
        kw.pop("sharded", None), kw.pop("bucket", None)
        fused_core.COUNTED["mul"].add(5)  # a warmup's launches
        return chaos_campaign.stub_verifier(n_devices=n_devices, **kw)

    monkeypatch.setattr(chaos_campaign, "card_verifier", warmed)
    report = chaos_campaign.run_campaign(
        out_dir=str(tmp_path), fast=True, device="cuda",
        scenarios=(chaos_campaign.scenario_device_loss,))
    assert report["ok"] is True, report["failures"]
    assert report["warmup_launches"]["mul"] == 5
    assert report["launches"]["mul"] == 0  # the stub programs launch nothing
