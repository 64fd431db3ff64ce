"""The port's prewarm farm (``lodestar_tpu_torch/tools/prewarm.py``) on the
CPU, over the g++-built stand-in library of ``tests/test_torch_aot_store.py``
(every launcher symbol, built in well under a second; ``_build.build``
replaced by that build, the loader's memo, build directory and compile
ledger the test's own): a farm run fills an empty store with the library
and reports its graphs as captured per process, never stored; a held farm
lock exits 3; ``--verify`` exits 1 on a corrupted entry and 0 on a clean
store; ``--sweep-orphans`` deletes a killed writer's temp file."""

import functools
import json
import os
import shutil

import pytest

from lodestar_tpu_torch.aot.store import KernelLibraryStore, acquire_lockfile, release_lockfile
from lodestar_tpu_torch.chaos import corrupt_file
from lodestar_tpu_torch.crypto.bls import torch_verifier as tv
from lodestar_tpu_torch.observatory.compile_ledger import CompileLedger
from lodestar_tpu_torch.ops.kernels import _build
from lodestar_tpu_torch.tools import prewarm

from test_torch_aot_store import CAP, stub_library

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A farm run makes the verifier's CPU programs: one intra-op thread,
    as every file that makes a device program pins it."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def farm(tmp_path, monkeypatch):
    """``_build`` with its own memo, build directory and ledger, ``build``
    the stand-in's g++ build (counted), and the verifier loading the
    library through the store on the CPU as it does on a card."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "COMPILE_LEDGER",
                        CompileLedger(path=str(tmp_path / "build" / "compile_ledger.json")))
    monkeypatch.setattr(_build, "nvcc_version", lambda: "release 12.8, V12.8.93")
    builds = []

    def build(extra=()):
        out = _build.library_path(extra)
        if not os.path.exists(out):
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            stub_library(out, marker=5)
            builds.append(extra)
        return out

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(tv.TorchBlsVerifier, "_kernels", lambda self, card, load_only=None:
                        _build.load(store=self.aot_store, capability=CAP,
                                    load_only=self.load_only if load_only is None else load_only))
    # the command's farm on the CPU's programs (the command runs on the card)
    monkeypatch.setattr(prewarm, "prewarm", functools.partial(prewarm.prewarm, device="cpu"))
    return builds


def _json(capsys):
    return json.loads(capsys.readouterr().out)


def test_a_farm_run_fills_the_store_and_stores_no_graph(tmp_path, farm, capsys, monkeypatch):
    store = str(tmp_path / "store")
    argv = ["--store", store, "--buckets", "4,16", "--json"]
    assert prewarm.main(argv) == 0
    report = _json(capsys)
    assert farm == [()] and report["library"]["kind"] == "build"
    assert len(report["entries"]) == 1 and report["stats"]["saves"] == 1
    assert report["graphs"]["captured_here"] == ["cpu b16", "cpu b4"]
    assert report["graphs"]["stored"] == prewarm.GRAPHS_NOTE
    assert report["devices"] == ["cpu"] and not os.path.exists(
        os.path.join(store, prewarm.FARM_LOCK_NAME))
    # a restart (a new process: an empty memo) loads from the store, load_only
    monkeypatch.setattr(_build, "_libs", {})
    shutil.rmtree(_build.BUILD_DIR)
    v = tv.TorchBlsVerifier(device="cpu", buckets=(4,), load_only=True,
                            aot_store=KernelLibraryStore(path=store))
    v.warmup()
    assert _build.build_kind == "aot_load" and farm == [()]
    assert prewarm.main(["--store", store, "--verify", "--json"]) == 0
    assert _json(capsys)["ok"] == report["entries"]


def test_mesh_runs_warmup_sharded_over_repeated_executors(tmp_path, farm, capsys):
    store = str(tmp_path / "store")
    assert prewarm.main(["--store", store, "--buckets", "4,16",
                         "--devices", "2", "--mesh", "--json"]) == 0
    report = _json(capsys)
    assert report["mesh"] is True and report["devices"] == ["mesh2"]
    assert report["graphs"]["captured_here"] == ["b16", "b4"]
    with pytest.raises(SystemExit, match="needs two executors"):
        prewarm.main(["--store", store, "--mesh"])
    with pytest.raises(SystemExit, match="divide evenly"):
        prewarm.main(["--store", store, "--buckets", "5", "--devices", "2",
                      "--mesh"])


def test_a_held_farm_lock_exits_3(tmp_path, farm, capsys):
    store = tmp_path / "store"
    store.mkdir()
    lock = str(store / prewarm.FARM_LOCK_NAME)
    assert acquire_lockfile(lock, 0.0)  # held by this live process
    try:
        assert prewarm.main(["--store", str(store),
                             "--lock-wait-s", "0.1"]) == 3
        assert "another prewarmer holds" in capsys.readouterr().err
        assert farm == [] and not (store / "manifest.json").exists()
    finally:
        release_lockfile(lock)


def test_verify_exits_1_on_a_corrupted_entry_and_sweeps_orphans(tmp_path, capsys):
    store_dir = tmp_path / "store"
    store = KernelLibraryStore(path=str(store_dir))
    key = store.save("kernels", (), "0123456789abcdef", stub_library(str(tmp_path / "a.so")), CAP)
    assert prewarm.main(["--store", str(store_dir), "--verify"]) == 0
    assert f"ok       {key}" in capsys.readouterr().out
    orphan = store_dir / "entries" / "deadbeef.so.4242.tmp"
    orphan.write_bytes(b"half-written")
    corrupt_file(str(store_dir / store.keys()[key]["file"]), seed=3)
    assert prewarm.main(["--store", str(store_dir), "--verify", "--json"]) == 1
    report = _json(capsys)
    assert report["corrupt"] == [key] and report["orphans"] == [orphan.name]
    assert prewarm.main(["--store", str(store_dir), "--verify", "--sweep-orphans"]) == 1
    assert "orphans removed: 1" in capsys.readouterr().out and not orphan.exists()
