"""BENCHMARK.json against the limits it has to keep, and every file it
names found where the harness looks for it."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    full = 2 + 14 * 24
    assert full * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert cells >= 1 and sum(w["chips"] == 4 for w in bench["workloads"]) <= 1


def test_names_and_files(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
        assert _one_line(c["source"]) and _one_line(c["why"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert all(k in cfg for k in c["reduced"])
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _one_line(w["why"])
        assert NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and _one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024
