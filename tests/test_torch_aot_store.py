"""The port's durable store of built kernel libraries (``aot/store.py``) and
the kernel loader's ladder over it (``ops/kernels/_build.load``), the
cases of ``tests/test_aot_store.py`` for the JAX executable store.

Every store lives under ``tmp_path``.  The library is a tiny stand-in that
g++ builds in well under a second: it exports every launcher symbol the
loader declares, each returning a marker, so the store's payload is a real
shared object that ``ctypes`` opens.  No nvcc runs here: ``_build.build``
is replaced by that g++ build, and the loader's memo, build directory and
compile ledger are the test's own.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

import pytest

from lodestar_tpu_torch.aot import store as st
from lodestar_tpu_torch.aot.store import (
    AotStoreMiss,
    KernelLibraryStore,
    acquire_lockfile,
    entry_key,
    release_lockfile,
)
from lodestar_tpu_torch.chaos import corrupt_file
from lodestar_tpu_torch.forensics import JOURNAL
from lodestar_tpu_torch.observatory.compile_ledger import CompileLedger
from lodestar_tpu_torch.ops.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = "sm_90"
DIGEST = "0123456789abcdef"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


def stub_library(path: str, marker: int = 7) -> str:
    """A shared object with every launcher the loader declares, each
    returning ``marker``."""
    names = [f"launch_{n}" for n in _build.LAUNCHERS] + ["launch_empty", "ring_enable_peer"]
    src = path + ".cpp"
    with open(src, "w") as f:
        for name in names:
            f.write(f'extern "C" int {name}(...) {{ return {marker}; }}\n')
    subprocess.run(["g++", "-shared", "-fPIC", "-O0", "-o", path, src], check=True)
    return path


@pytest.fixture
def lib(tmp_path):
    return stub_library(str(tmp_path / "stub.so"))


def journal_since(seq0):
    return [e for e in JOURNAL.events() if e["seq"] >= seq0]


def kinds_since(seq0):
    return [e["kind"] for e in journal_since(seq0)]


def save(store, lib, extra=()):
    return store.save("kernels", extra, DIGEST, lib, CAP, nvcc="release 12.8")


def load(store, extra=(), opener=None):
    return store.load("kernels", extra, DIGEST, CAP, opener=opener)


# -- round trip ---------------------------------------------------------------


class TestRoundTrip:
    def test_save_load_returns_a_library_that_runs(self, tmp_path, lib):
        store = KernelLibraryStore(path=str(tmp_path / "store"))
        key = save(store, lib)
        assert key == entry_key(CAP, "kernels", (), DIGEST)
        rec = store.keys()[key]
        assert rec["nvcc"] == "release 12.8" and rec["source_hash"] == DIGEST
        fresh = KernelLibraryStore(path=str(tmp_path / "store"))
        loaded = load(fresh, opener=ctypes.CDLL)
        assert loaded is not None and loaded.launch_empty(None) == 7
        assert fresh.hits == 1 and fresh.corrupt == 0

    def test_round_trip_survives_a_new_process(self, tmp_path, lib):
        save(KernelLibraryStore(path=str(tmp_path / "store")), lib)
        code = (
            "import ctypes, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from lodestar_tpu_torch.aot.store import KernelLibraryStore\n"
            f"store = KernelLibraryStore(path={str(tmp_path / 'store')!r})\n"
            f"lib = store.load('kernels', (), {DIGEST!r}, {CAP!r}, opener=ctypes.CDLL)\n"
            "assert lib is not None, 'the store missed in the new process'\n"
            "print(lib.launch_mul(None, None, 0, None, None))\n"
        )
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-800:]
        assert out.stdout.strip().splitlines()[-1] == "7"

    def test_absent_key_is_a_plain_miss(self, tmp_path, lib):
        store = KernelLibraryStore(path=str(tmp_path))
        save(store, lib)
        seq0 = JOURNAL.seq
        assert load(store, extra=("-DLF_INLINE_ALL",)) is None
        assert store.load("kernels", (), "ffffffffffffffff", CAP) is None
        assert store.load("kernels", (), DIGEST, "sm_80") is None
        assert store.misses == 3 and store.corrupt == 0 and store.skew == 0
        assert "aot.corrupt" not in kinds_since(seq0)

    def test_disabled_store_is_inert(self, lib):
        store = KernelLibraryStore(path=None)
        assert load(store) is None and save(store, lib) is None
        assert store.stats()["entries"] == 0

    def test_the_process_store_follows_its_environment_variable(self, tmp_path, monkeypatch):
        monkeypatch.setattr(st, "AOT_STORE", KernelLibraryStore())
        monkeypatch.delenv(st.STORE_ENV, raising=False)
        assert st.active_store() is None
        monkeypatch.setenv(st.STORE_ENV, str(tmp_path))
        assert st.active_store() is st.AOT_STORE and st.AOT_STORE.path == str(tmp_path)
        mine = KernelLibraryStore(path=str(tmp_path / "mine"))
        assert st.active_store(mine) is mine
        assert st.active_store(KernelLibraryStore()) is None


# -- crash consistency and integrity -------------------------------------------


class TestCrashConsistency:
    def test_orphan_temp_from_killed_writer_is_ignored(self, tmp_path, lib):
        store = KernelLibraryStore(path=str(tmp_path))
        save(store, lib)
        orphan = tmp_path / "entries" / "deadbeef.so.12345.tmp"
        orphan.write_bytes(b"half-written garbage")
        fresh = KernelLibraryStore(path=str(tmp_path))
        assert load(fresh) is not None and fresh.corrupt == 0
        sweep = fresh.verify()
        assert sweep["orphans"] == [orphan.name] and len(sweep["ok"]) == 1
        assert fresh.sweep_orphans() == 1
        assert not orphan.exists()

    def test_checksum_rejection_quarantines(self, tmp_path, lib):
        store = KernelLibraryStore(path=str(tmp_path))
        key = save(store, lib)
        rel = store.keys()[key]["file"]
        corrupt_file(str(tmp_path / rel), seed=7)
        assert KernelLibraryStore(path=str(tmp_path)).verify()["corrupt"] == [key]
        seq0 = JOURNAL.seq
        fresh = KernelLibraryStore(path=str(tmp_path))
        assert load(fresh, opener=ctypes.CDLL) is None
        assert fresh.corrupt == 1
        ev = [e for e in journal_since(seq0) if e["kind"] == "aot.corrupt"]
        assert ev and ev[0]["what"] == "checksum"
        # quarantined aside (evidence), dropped from the manifest, and the
        # next load is a cheap plain miss
        assert (tmp_path / (rel + ".quarantined")).exists()
        assert key not in fresh.keys()
        assert load(fresh) is None and fresh.corrupt == 1

    @pytest.mark.parametrize("field,value,reason", [
        ("torch", "0.0.0-skewed", "torch_version"),
        ("cuda", "9.9", "cuda_version"),
        ("source_hash", "feedfacefeedface", "source_hash"),
    ])
    def test_skew_evicts(self, tmp_path, lib, field, value, reason):
        store = KernelLibraryStore(path=str(tmp_path))
        key = save(store, lib)
        mpath = tmp_path / "manifest.json"
        doc = json.loads(mpath.read_text())
        doc["entries"][key][field] = value
        mpath.write_text(json.dumps(doc))
        assert KernelLibraryStore(path=str(tmp_path)).verify()["skew"] == [key]
        seq0 = JOURNAL.seq
        fresh = KernelLibraryStore(path=str(tmp_path))
        assert load(fresh) is None and fresh.skew == 1
        ev = [e for e in journal_since(seq0) if e["kind"] == "aot.skew"]
        assert ev and ev[0]["reason"] == reason
        assert key not in fresh.keys()  # evicted, the file deleted
        assert not (tmp_path / doc["entries"][key]["file"]).exists()

    def test_truncated_manifest_survivable(self, tmp_path, lib):
        store = KernelLibraryStore(path=str(tmp_path))
        save(store, lib)
        mpath = tmp_path / "manifest.json"
        blob = mpath.read_bytes()
        mpath.write_bytes(blob[: len(blob) // 2])
        seq0 = JOURNAL.seq
        fresh = KernelLibraryStore(path=str(tmp_path))
        assert fresh.keys() == {} and load(fresh) is None
        ev = [e for e in journal_since(seq0) if e["kind"] == "aot.corrupt"]
        assert ev and ev[0]["what"] == "manifest"

    def test_a_payload_the_loader_refuses_quarantines(self, tmp_path, lib):
        """Bytes that match the manifest but are no shared object (written
        so at save time) still fall through cleanly."""
        store = KernelLibraryStore(path=str(tmp_path))
        key = save(store, lib)
        rec = store.keys()[key]
        bad = b"not an ELF object"
        (tmp_path / rec["file"]).write_bytes(bad)
        mpath = tmp_path / "manifest.json"
        doc = json.loads(mpath.read_text())
        doc["entries"][key]["sha256"] = hashlib.sha256(bad).hexdigest()
        mpath.write_text(json.dumps(doc))
        fresh = KernelLibraryStore(path=str(tmp_path))
        assert load(fresh, opener=ctypes.CDLL) is None
        assert fresh.corrupt == 1 and (tmp_path / (rec["file"] + ".quarantined")).exists()


# -- the writers' lockfile -----------------------------------------------------


class TestLockfile:
    def test_contended_save_bypasses_bounded(self, tmp_path, lib):
        store = KernelLibraryStore(path=str(tmp_path), lock_wait_s=0.2)
        lock = tmp_path / "store.lock"
        lock.write_text(json.dumps({"pid": os.getpid(), "wall": 0}))
        seq0 = JOURNAL.seq
        t0 = time.monotonic()
        assert save(store, lib) is None
        assert time.monotonic() - t0 < 3.0
        assert store.lock_bypasses == 1 and "aot.lock_busy" in kinds_since(seq0)
        lock.unlink()
        assert save(store, lib) is not None

    def test_stale_lock_from_dead_pid_is_broken(self, tmp_path):
        p = multiprocessing.get_context("spawn").Process(target=int)
        p.start()
        p.join(30)
        lock = tmp_path / "store.lock"
        lock.write_text(json.dumps({"pid": p.pid, "wall": 0}))
        t0 = time.monotonic()
        assert acquire_lockfile(str(lock), timeout_s=5.0)
        assert time.monotonic() - t0 < 2.0
        release_lockfile(str(lock))

    def test_unreadable_lock_is_not_broken(self, tmp_path):
        lock = tmp_path / "store.lock"
        lock.write_text("")
        t0 = time.monotonic()
        assert not acquire_lockfile(str(lock), timeout_s=0.2)
        assert 0.15 < time.monotonic() - t0 < 3.0
        assert lock.exists()

    def test_save_on_unwritable_store_never_raises(self, tmp_path, lib):
        blocker = tmp_path / "not-a-dir"
        blocker.write_text("")
        store = KernelLibraryStore(path=str(blocker / "store"), lock_wait_s=0.1)
        assert save(store, lib) is None and load(store) is None

    def test_loads_take_no_lock(self, tmp_path, lib):
        store = KernelLibraryStore(path=str(tmp_path))
        save(store, lib)
        (tmp_path / "store.lock").write_text(json.dumps({"pid": os.getpid(), "wall": 0}))
        t0 = time.monotonic()
        assert load(store) is not None
        assert time.monotonic() - t0 < 1.0


class TestKeySchema:
    def test_entry_key_components(self):
        key = entry_key("sm_90", "kernels", ("-DLF_INLINE_ALL", "-G"), "abc123",
                        torch_ver="2.11.0+cu128", cuda_ver="12.8")
        assert key == "sm_90|kernels|-DLF_INLINE_ALL -G|torch2.11.0+cu128|cuda12.8|abc123"
        assert entry_key("sm_90", "kernels", (), "abc123", "1", "2").split("|")[2] == "-"

    def test_capability_tag_without_a_card(self):
        import torch

        if not torch.cuda.is_available():
            assert st.capability_tag() == "nocuda"


# -- the loader's ladder ---------------------------------------------------------


@pytest.fixture
def loader(tmp_path, monkeypatch):
    """``_build`` with its own memo, build directory and ledger, and
    ``build`` replaced by the stand-in's g++ build (counted)."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    ledger = CompileLedger(path=str(tmp_path / "build" / "compile_ledger.json"))
    monkeypatch.setattr(_build, "COMPILE_LEDGER", ledger)
    monkeypatch.setattr(_build, "nvcc_version", lambda: "release 12.8, V12.8.93")
    builds = []

    def build(extra=()):
        out = _build.library_path(extra)
        if not os.path.exists(out):
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            stub_library(out, marker=11)
            builds.append(extra)
        return out

    monkeypatch.setattr(_build, "build", build)
    return builds, ledger


def ledger_kinds(ledger):
    rec = ledger.to_dict()[ledger.key(_build.ENTRY, None, CAP)]
    return {kind: s["count"] for kind, s in rec["kinds"].items()}


def test_load_walks_memo_store_build_dir_then_build(tmp_path, loader, monkeypatch):
    builds, ledger = loader
    store = KernelLibraryStore(path=str(tmp_path / "store"))
    # nothing anywhere: nvcc builds it, and it is saved to the store
    lib = _build.load(store=store, capability=CAP)
    assert lib.launch_empty(None) == 11 and builds == [()] and _build.build_kind == "build"
    assert len(store.keys()) == 1 and store.saves == 1
    assert next(iter(store.keys().values()))["nvcc"] == "release 12.8, V12.8.93"
    # the memo: the same object, nothing recorded
    assert _build.load(store=store, capability=CAP) is lib
    # a new process (an empty memo): the store serves it
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.load(store=store, capability=CAP).launch_empty(None) == 11
    assert _build.build_kind == "aot_load" and builds == [()]
    # the store off: the library built earlier into build/
    monkeypatch.setattr(_build, "_libs", {})
    _build.load(store=KernelLibraryStore(), capability=CAP)
    assert _build.build_kind == "build_cache" and builds == [()]
    assert ledger_kinds(ledger) == {"build": 1, "aot_load": 1, "build_cache": 1}
    on_disk = json.loads(open(ledger.path).read())["records"]
    assert set(on_disk) == {ledger.key("kernels", None, CAP)}


def test_load_only_miss_raises_and_starts_no_process(tmp_path, loader, monkeypatch):
    builds, _ = loader

    def refuse(*a, **k):
        raise AssertionError("a process was started under load_only")

    monkeypatch.setattr(_build.subprocess, "Popen", refuse)
    monkeypatch.setattr(_build.subprocess, "run", refuse)
    monkeypatch.setattr(_build, "nvcc_version", refuse)
    seq0 = JOURNAL.seq
    empty = KernelLibraryStore(path=str(tmp_path / "empty"))
    with pytest.raises(AotStoreMiss, match="load-only"):
        _build.load(store=empty, load_only=True, capability=CAP)
    with pytest.raises(AotStoreMiss):  # a store that is off serves nothing either
        _build.load(store=KernelLibraryStore(), load_only=True, capability=CAP)
    assert builds == [] and _build._libs == {}
    assert [e["load_only"] for e in journal_since(seq0) if e["kind"] == "aot.miss"] == [True] * 2


def test_load_only_is_served_by_a_populated_store(tmp_path, loader, monkeypatch):
    builds, ledger = loader
    store = KernelLibraryStore(path=str(tmp_path / "store"))
    _build.load(store=store, capability=CAP)
    monkeypatch.setattr(_build, "_libs", {})
    shutil.rmtree(_build.BUILD_DIR)
    lib = _build.load(store=store, load_only=True, capability=CAP)
    assert lib.launch_ring_hop(None, None, 0, None) == 11 and _build.build_kind == "aot_load"
    assert builds == [()]


def test_a_corrupt_stored_library_is_quarantined_and_rebuilt(tmp_path, loader, monkeypatch):
    builds, _ = loader
    store = KernelLibraryStore(path=str(tmp_path / "store"))
    _build.load(store=store, capability=CAP)
    rec = next(iter(store.keys().values()))
    corrupt_file(str(tmp_path / "store" / rec["file"]), seed=3)
    monkeypatch.setattr(_build, "_libs", {})
    os.remove(_build.library_path())
    seq0 = JOURNAL.seq
    lib = _build.load(store=store, capability=CAP)
    assert lib.launch_empty(None) == 11 and builds == [(), ()] and _build.build_kind == "build"
    assert "aot.corrupt" in kinds_since(seq0)
    assert (tmp_path / "store" / (rec["file"] + ".quarantined")).exists()
    assert store.verify()["ok"] and store.saves == 2  # the rebuilt library, saved again
