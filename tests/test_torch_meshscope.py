"""The port's mesh observatory report (``lodestar_tpu_torch/tools/meshscope.py``)
over the port's ``observatory/attribution.py``: on the JAX package's merged
trace fixture it prints what the repo's ``tools/meshscope.py`` prints; on a
merged trace of the port's (the sharded batch's combine is the port's ring
hop kernel) it books the hop as the collective combine; unreadable and
unattributable inputs exit 1."""

import json

import pytest

from lodestar_tpu_torch.tools import meshscope

from test_torch_xprof import _ring_hop_doc
from test_xprof import _synthetic_merged_doc
from tools import meshscope as jmeshscope


def _write(tmp_path, name, doc):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@pytest.mark.parametrize("flags", [[], ["--json"], ["--fail-on-residual"],
                                   ["--json", "--tolerance", "0.2"]])
def test_the_report_equals_the_jax_tools_on_its_fixture(flags, tmp_path, capsys):
    path = _write(tmp_path, "merged.json", _synthetic_merged_doc())
    assert meshscope.main([path, *flags]) == 0
    port = capsys.readouterr().out
    assert jmeshscope.main([path, *flags]) == 0
    assert port == capsys.readouterr().out
    if "--json" in flags:
        doc = json.loads(port)
        assert doc["attribution"]["batches"] and doc["scaling_loss"]["within_tolerance"] is True
    else:
        assert "mesh scaling loss" in port or "n/a" in port


def test_the_ports_merged_trace_books_the_ring_hop_as_the_combine(tmp_path, capsys):
    path = _write(tmp_path, "port_merged.json", _ring_hop_doc())
    assert meshscope.main([path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    stages = {b["cid"]: b for b in doc["attribution"]["batches"]}[1]["stages"]
    assert stages["collective_combine"] == pytest.approx(0.015)
    assert stages["device_compute"] == pytest.approx(0.030)
    assert meshscope.main([path]) == 0
    text = capsys.readouterr().out
    assert "bubble" in text and "merged batch(es)" in text


def test_unattributable_or_unreadable_input_exits_1(tmp_path, capsys):
    assert meshscope.main([_write(tmp_path, "empty.json", {"traceEvents": []})]) == 1
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    assert meshscope.main([str(garbage)]) == 1
    assert meshscope.main([_write(tmp_path, "odd.json", {"traceEvents": 3})]) == 1
    assert "no traceEvents list" in capsys.readouterr().err
