"""The port's stage salvage (``lodestar_tpu_torch/forensics/salvage.py``)
held against the JAX package's module: the same environment names,
directories and pruning, and a child process SIGKILLed after its first
heartbeat leaves a bundle that its parent finds by the child's pid (and
another pid does not), valid for the port's ``inspect_bundle``."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from lodestar_tpu.forensics import salvage as jsalvage
from lodestar_tpu_torch.forensics import JOURNAL, salvage
from lodestar_tpu_torch.tools import inspect_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {"port": salvage, "jax": jsalvage}


def test_names_and_directories_equal_the_jax_modules(tmp_path, monkeypatch):
    for name in ("BASE_DIR_ENV", "INTERVAL_ENV", "DEFAULT_INTERVAL_S", "KEEP_BUNDLES"):
        assert getattr(salvage, name) == getattr(jsalvage, name)
    monkeypatch.setenv(salvage.BASE_DIR_ENV, str(tmp_path))
    for stage in ("fused split", "chaos/kill:stage", "plain_stage-1"):
        assert salvage.stage_dir(stage) == jsalvage.stage_dir(stage)
    monkeypatch.delenv(salvage.BASE_DIR_ENV)
    assert salvage.base_dir() == jsalvage.base_dir()
    monkeypatch.setenv(salvage.INTERVAL_ENV, "0.01")
    assert salvage.Heartbeat("s").interval_s == jsalvage.Heartbeat("s").interval_s == 0.05


@pytest.mark.parametrize("side", MODULES)
def test_heartbeat_prunes_and_scopes_by_pid(side, tmp_path, monkeypatch):
    """The JAX package's heartbeat unit case, run on each module."""
    mod = MODULES[side]
    monkeypatch.setenv(mod.BASE_DIR_ENV, str(tmp_path))
    assert mod.latest_stage_bundle("never_ran") is None
    hb = mod.Heartbeat("unit_stage", interval_s=60.0)
    path = hb.beat()
    assert path and mod.latest_stage_bundle("unit_stage") == path
    for _ in range(mod.KEEP_BUNDLES + 2):
        time.sleep(0.01)  # distinct mtimes
        path = hb.beat()
    kept = [n for n in os.listdir(mod.stage_dir("unit_stage")) if n.startswith("bundle-")]
    assert len(kept) <= mod.KEEP_BUNDLES
    assert mod.latest_stage_bundle("unit_stage") == path
    assert mod.latest_stage_bundle("unit_stage", pid=os.getpid()) == path
    assert mod.latest_stage_bundle("unit_stage", pid=999999999) is None


def test_start_heartbeat_journals_the_stage_and_beats(tmp_path, monkeypatch):
    monkeypatch.setenv(salvage.BASE_DIR_ENV, str(tmp_path))
    seq0 = JOURNAL.seq
    hb = salvage.start_heartbeat("started_stage", interval_s=30.0)
    try:
        deadline = time.monotonic() + 10
        while salvage.latest_stage_bundle("started_stage") is None:
            assert time.monotonic() < deadline, "no first heartbeat"
            time.sleep(0.02)
    finally:
        hb.stop()
    starts = [e for e in JOURNAL.events() if e["seq"] >= seq0 and e["kind"] == "bench.stage_start"]
    assert [(e["stage"], e["pid"]) for e in starts] == [("started_stage", os.getpid())]
    assert inspect_bundle.validate(salvage.latest_stage_bundle("started_stage")) == []


CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from lodestar_tpu_torch.forensics import salvage
salvage.start_heartbeat(sys.argv[2], interval_s=60.0)
time.sleep(600)  # the parent kills it
"""


def test_a_child_killed_after_one_beat_leaves_its_bundle_for_its_pid(tmp_path):
    stage = "killed_stage"
    env = dict(os.environ, **{salvage.BASE_DIR_ENV: str(tmp_path)})
    proc = subprocess.Popen([sys.executable, "-c", CHILD, REPO, stage], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    old = os.environ.get(salvage.BASE_DIR_ENV)
    os.environ[salvage.BASE_DIR_ENV] = str(tmp_path)
    try:
        deadline = time.monotonic() + 60
        while salvage.latest_stage_bundle(stage, pid=proc.pid) is None:
            assert proc.poll() is None, proc.communicate()[1][-800:]
            assert time.monotonic() < deadline, "the child never beat"
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=30)
        assert proc.returncode == -signal.SIGKILL
        bundle = salvage.latest_stage_bundle(stage, pid=proc.pid)
        assert bundle is not None
        assert salvage.latest_stage_bundle(stage, pid=proc.pid + 1) is None
    finally:
        if old is None:
            os.environ.pop(salvage.BASE_DIR_ENV, None)
        else:
            os.environ[salvage.BASE_DIR_ENV] = old
    assert inspect_bundle.validate(bundle) == []
    summary = inspect_bundle.summarize(bundle)
    assert summary["reason"] == "heartbeat" and summary["pid"] == proc.pid
    with open(os.path.join(bundle, "manifest.json")) as f:
        assert json.load(f)["stage"] == stage
    with open(os.path.join(bundle, "journal.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f if line.strip()]
    assert "bench.stage_start" in kinds
