"""The port's bundle inspector (``lodestar_tpu_torch/tools/inspect_bundle.py``)
held against the repo's ``tools/inspect_bundle.py`` on the port's own
bundles: for each bundle, whole or damaged, both give equal ``validate``
results, equal ``summarize`` keys (and values, but the last build event,
which the port reads from the compile ledger's journal events) and equal
exit codes."""

import json
import os

import pytest

from lodestar_tpu_torch.chaos import CHAOS, FaultPlan
from lodestar_tpu_torch.forensics import JOURNAL, RECORDER
from lodestar_tpu_torch.observatory.compile_ledger import CompileLedger
from lodestar_tpu_torch.tools import inspect_bundle

from tools import inspect_bundle as jinspect_bundle


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    saved = (RECORDER._dir, RECORDER.verifier, RECORDER.pool)
    CHAOS.disarm()
    RECORDER.configure(forensics_dir=str(tmp_path / "bundles"))
    yield
    CHAOS.disarm()
    RECORDER._dir, RECORDER.verifier, RECORDER.pool = saved


def _plain(tmp_path):
    return RECORDER.dump("plain")


def _chaos(tmp_path):
    CHAOS.install(FaultPlan(5).add("forensics.io", match={"section": "config.json"}, count=1))
    return RECORDER.dump("chaos-io")


def _ledger_and_store_events(tmp_path):
    ledger = CompileLedger().configure(path=str(tmp_path / "ledger.json"))
    ledger.record("kernels", None, "sm_90", "build", 1.25)
    ledger.record("fused_split", 4, "cuda:0", "capture", 0.5)
    JOURNAL.record("aot.corrupt", level="WARNING", store=str(tmp_path), what="checksum",
                   entry="kernels", capability="sm_90", error="sha256 mismatch")
    JOURNAL.record("aot.skew", level="WARNING", store=str(tmp_path), entry="kernels",
                   capability="sm_90", reason="torch_version")
    return RECORDER.dump("store")


def _missing_file(tmp_path):
    path = RECORDER.dump("damaged")
    os.remove(os.path.join(path, "inflight.json"))
    return path


def _bad_journal(tmp_path):
    path = RECORDER.dump("journal")
    with open(os.path.join(path, "journal.jsonl"), "a") as f:
        f.write("{not json\n")
        f.write(json.dumps({"seq": 0, "kind": "late"}) + "\n")
    return path


def _bad_manifest(tmp_path):
    path = RECORDER.dump("manifest")
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"schema": 1, "reason"')
    return path


CASES = {"plain": _plain, "chaos": _chaos, "ledger_and_store": _ledger_and_store_events,
         "missing_file": _missing_file, "bad_journal": _bad_journal,
         "bad_manifest": _bad_manifest}


@pytest.mark.parametrize("case", CASES)
def test_validate_summarize_and_exit_code_equal_the_jax_tools(case, tmp_path, capsys):
    path = CASES[case](tmp_path)
    CHAOS.disarm()
    errors = inspect_bundle.validate(path)
    assert errors == jinspect_bundle.validate(path)
    assert (errors == []) == (case in ("plain", "chaos", "ledger_and_store"))
    rc = inspect_bundle.main([path, "--json"])
    out = capsys.readouterr().out
    assert rc == jinspect_bundle.main([path, "--json"]) == (1 if errors else 0)
    if errors:
        return
    port = json.loads(out)
    jax = json.loads(capsys.readouterr().out)
    assert set(port) == set(jax)
    assert {k: v for k, v in port.items() if k != "last_compile"} == {
        k: v for k, v in jax.items() if k != "last_compile"}
    if case == "chaos":
        assert port["chaos"]["armed"] is True and port["chaos"]["seed"] == 5
        assert port["dump_errors"] == {"config.json": "InjectedIOError: injected fault at "
                                                      "forensics.io (seed 5)"}
    if case == "ledger_and_store":
        assert port["last_compile"]["compile_kind"] == "capture"
        assert port["last_compile"]["entry"] == "fused_split"
        assert port["aot"]["corrupt"] == 1 and port["aot"]["skew"] == 1
        assert port["aot"]["last_corrupt"]["what"] == "checksum"
    inspect_bundle._print_text(inspect_bundle.summarize(path))
    text = capsys.readouterr().out
    assert f"reason   {port['reason']}" in text


def test_a_path_that_is_no_directory_exits_1(tmp_path):
    assert inspect_bundle.main([str(tmp_path / "absent")]) == 1
