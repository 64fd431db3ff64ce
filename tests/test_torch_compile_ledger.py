"""The port's compile ledger (``observatory/compile_ledger.py``) against the
JAX package's ``CompileLedger``: the same records, attribution windows,
flushes and merges give the same keys and the same files.

The one difference by design is the runtime tag: the JAX key's last
component is ``jax<version>`` and its records carry ``"jax"``; the port's
are ``torch<version>`` and ``"torch"``.  Both versions are pinned to one
string here and the tag is compared through that mapping.
"""

from __future__ import annotations

import json

import pytest

from lodestar_tpu.observatory import compile_ledger as jcl
from lodestar_tpu_torch.forensics import JOURNAL
from lodestar_tpu_torch.observatory import compile_ledger as pcl

VERSION = "9.9.9"

#: (entry, bucket, device, kind, seconds): builds, loads and captures of
#: the per-card and mesh programs and of the library, and hits
RECORDS = [
    ("kernels", None, "sm_90", "build", 31.5),
    ("fused_split", 128, "cuda:0", "capture", 1.25),
    ("sharded_split", 256, "mesh2", "capture", 2.0),
    ("sharded_split", 256, "mesh2", "hit", 0.0),
    ("kernels", None, "sm_90", "aot_load", 0.021),
    ("fused_split", 128, "cuda:0", "capture", 1.5),
    ("xla_full", 4, "cuda:0#1", "capture", 25.75),
]


@pytest.fixture(autouse=True)
def _pinned_versions(monkeypatch):
    monkeypatch.setattr(jcl, "_jax_version", lambda: VERSION)
    monkeypatch.setattr(pcl, "_torch_version", lambda: VERSION)


def as_port(obj):
    """A JAX ledger key, record or file in the port's runtime tag."""
    text = json.dumps(obj).replace(f"|jax{VERSION}", f"|torch{VERSION}")
    return json.loads(text.replace('"jax": ', '"torch": '))


def without_walls(records):
    return {k: {**r, "kinds": {kind: {f: v for f, v in s.items() if f != "last_wall"}
                               for kind, s in r["kinds"].items()}}
            for k, r in records.items()}


def on_disk(path):
    with open(path) as f:
        doc = json.load(f)
    return {**doc, "records": without_walls(doc["records"])}


def test_keys_equal_the_jax_ledgers():
    for entry, bucket, device, _, _ in RECORDS:
        assert pcl.CompileLedger.key(entry, bucket, device) == as_port(
            jcl.CompileLedger.key(entry, bucket, device))
    assert pcl.CompileLedger.key("kernels", None, None) == f"kernels|b?|?|torch{VERSION}"


def test_the_same_records_give_the_same_files_and_merges(tmp_path):
    """Two processes' worth of records, each flushed into one file (read,
    merge, atomic replace), in both packages."""
    paths = {}
    for name, mod in (("jax", jcl), ("port", pcl)):
        path = str(tmp_path / name / "compile_ledger.json")
        first = mod.CompileLedger().configure(path=path)
        for rec in RECORDS[:4]:
            first.record(*rec)
        second = mod.CompileLedger().configure(path=path)  # the next process
        for rec in RECORDS[4:]:
            second.record(*rec)
        second.record(*RECORDS[3])  # a hit is kept, then flushed by hand
        assert second.flush() == path
        paths[name] = path
    assert on_disk(paths["port"]) == as_port(on_disk(paths["jax"]))
    port = pcl.CompileLedger().configure(path=paths["port"])
    rec = port.to_dict()[port.key("fused_split", 128, "cuda:0")]["kinds"]["capture"]
    assert (rec["count"], rec["total_s"], rec["last_s"], rec["max_s"]) == (2, 2.75, 1.5, 1.5)
    # a hit does not flush: the first process's, never flushed, is not on disk
    assert port.summary()["by_entry"]["sharded_split"]["hit"]["count"] == 1


def test_attribution_windows_classify_as_the_jax_ledgers(tmp_path):
    """A window with a store load is ``aot_load``, one with nothing is
    ``hit``, a nested window leaves its costs to the outer one; outside a
    window a note is recorded under its own key."""
    views = {}
    for name, mod in (("jax", jcl), ("port", pcl)):
        ledger = mod.CompileLedger()
        # the JAX ledger's store-load marker, the port's note of that kind
        if mod is jcl:
            note = ledger.note_aot_load
        else:
            def note(seconds, entry=None, bucket=None, device=None, _ledger=ledger):
                _ledger.note("aot_load", seconds, entry, bucket, device)
        with ledger.attribute("sharded_split", bucket=256, device="mesh2"):
            note(0.5)
        with ledger.attribute("fused_split", bucket=4, device="cuda:0"):
            pass
        with ledger.attribute("xla_split", bucket=16, device="cuda:0"):
            with ledger.attribute("ignored", bucket=1, device="x"):
                note(0.25)
        note(0.125, entry="kernels", device="sm_90")
        views[name] = without_walls(ledger.to_dict())
    assert views["port"] == as_port(views["jax"])
    kinds = {k.split("|")[0]: list(r["kinds"]) for k, r in views["port"].items()}
    assert kinds == {"sharded_split": ["aot_load"], "fused_split": ["hit"],
                     "xla_split": ["aot_load"], "kernels": ["aot_load"]}


def test_a_capture_noted_in_a_window_is_its_kind_with_its_parts():
    ledger = pcl.CompileLedger()
    seq0 = JOURNAL.seq
    with ledger.attribute("sharded_full", bucket=256, device="mesh4"):
        ledger.note("capture", 3.5, eager_s=2.0, capture_s=1.0, instantiate_s=0.5)
    rec = ledger.to_dict()[ledger.key("sharded_full", 256, "mesh4")]
    assert rec["kinds"]["capture"]["total_s"] == 3.5
    ev = [e for e in JOURNAL.events() if e["seq"] >= seq0 and e["kind"] == "compile.ledger"]
    assert [(e["compile_kind"], e["device"], e["eager_s"], e["instantiate_s"]) for e in ev] == [
        ("capture", "mesh4", 2.0, 0.5)]


def test_a_corrupt_ledger_file_is_survivable_and_journaled(tmp_path):
    path = tmp_path / "compile_ledger.json"
    path.write_text("{not json")
    seq0 = JOURNAL.seq
    ledger = pcl.CompileLedger().configure(path=str(path))
    assert ledger.to_dict() == {}
    assert "cache.corrupt" in [e["kind"] for e in JOURNAL.events() if e["seq"] >= seq0]
    ledger.record("kernels", None, "sm_90", "build", 30.0)
    assert json.loads(path.read_text())["schema"] == pcl.SCHEMA_VERSION


def test_the_ledger_observes_bls_compile_seconds():
    seen = []

    class Histogram:
        def labels(self, **labels):
            return type("Child", (), {"observe": lambda _, s: seen.append((labels, s))})()

    metrics = type("Metrics", (), {"bls_compile_seconds": Histogram()})()
    ledger = pcl.CompileLedger(metrics=metrics)
    ledger.record("fused_split", 128, "cuda:0", "capture", 1.25)
    assert seen == [({"entry": "fused_split", "kind": "capture"}, 1.25)]
    from lodestar_tpu_torch.metrics import create_metrics

    assert hasattr(create_metrics(), "bls_compile_seconds")
