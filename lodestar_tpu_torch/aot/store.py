"""Durable store of built kernel libraries: crash-safe build persistence.

The port's copy of ``lodestar_tpu/aot/store.py``.  The JAX store keeps
compiled XLA executables; this one keeps what the port compiles, the
kernel library (the ``.so`` that ``ops/kernels/_build.py`` links from
nvcc's objects), so that a restart, or a host without nvcc, loads it in
milliseconds instead of paying the build.  A CUDA graph cannot be
serialized: the verifier still captures its graphs at warmup, from the
stored library.

The ladder ``_build.load`` walks::

    in-process memo  ->  this store  ->  build/ (a library built earlier
        in this checkout)  ->  nvcc build (then saved here)

and with ``load_only`` it stops after the store: a miss raises
``AotStoreMiss`` and no nvcc process starts (the rolling-restart
contract).

Key schema (one entry per library identity), all of it readable without
nvcc::

    (capability, entry, extra flags, torch version, CUDA version, source hash)

- **capability** -- the card's ``sm_XY`` (an sm_90a library is refused by
  any other architecture);
- **entry** -- ``kernels`` (every launcher in one library);
- **extra flags** -- a variant's nvcc flags (``-DLF_INLINE_ALL``), ``-``
  for the default library;
- **torch / CUDA version** -- ``torch.__version__`` and
  ``torch.version.cuda`` of the process that built it;
- **source hash** -- ``_build._digest``: the kernel sources and the nvcc
  flags, so an edited source misses.

``nvcc --version`` rides the entry's record as provenance, not the key:
a ``load_only`` host may have no nvcc to ask.

Crash-consistency discipline, as the JAX store's:

- every payload is written ``<file>.tmp`` then ``os.replace``d;
- the manifest (the only index a loader trusts) is re-read, merged and
  atomically replaced **last**, so a listed entry has its payload on disk;
- every entry carries the sha256 of its payload; a mismatch on load
  journals ``aot.corrupt``, quarantines the file (renamed aside, never
  deleted: it is evidence) and falls through to the next tier, as does a
  payload the loader cannot open;
- a record whose versions or source hash disagree with this process's
  journals ``aot.skew`` and is evicted;
- writers serialize through ``store.lock`` (O_CREAT|O_EXCL, pid and wall
  inside); a contended lock is a bounded wait then a bypass (the save is
  skipped, journaled ``aot.lock_busy``), and a loader takes no lock.

Nothing here raises out of ``load`` or ``save``: a broken store costs a
rebuild, never a node.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..chaos import CHAOS
from ..forensics.journal import JOURNAL

#: the environment variable naming the store directory (the port's own:
#: the JAX store's ``LODESTAR_TPU_AOT_STORE`` holds XLA executables)
STORE_ENV = "LODESTAR_TPU_TORCH_AOT_STORE"

MANIFEST_NAME = "manifest.json"
ENTRIES_DIR = "entries"
LOCK_NAME = "store.lock"
SCHEMA_VERSION = 1

#: bounded writer-lock wait before a save bypasses (seconds)
DEFAULT_LOCK_WAIT_S = 5.0

#: orphaned break-mutexes older than this are reclaimed
BREAK_MUTEX_STALE_S = 10.0


class AotStoreMiss(RuntimeError):
    """A ``load_only`` caller asked for a library the store does not hold
    (typed, so that a refusal to build is told from a failed build)."""


def torch_version() -> str:
    import torch

    return torch.__version__


def cuda_version() -> str:
    import torch

    return str(torch.version.cuda)


def capability_tag(device=None) -> str:
    """``sm_XY`` of ``device`` (default: the current card), ``nocuda``
    where no card is visible; initializes nothing on a CPU-only host."""
    import torch

    if not torch.cuda.is_available():
        return "nocuda"
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}"


def entry_key(capability: str, entry: str, extra, digest: str,
              torch_ver: Optional[str] = None, cuda_ver: Optional[str] = None) -> str:
    """The canonical store key string (also the manifest dict key)."""
    flags = " ".join(extra) if extra else "-"
    return "|".join((capability, entry, flags, f"torch{torch_ver or torch_version()}",
                     f"cuda{cuda_ver or cuda_version()}", digest))


def _key_digest(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()[:24]


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _read_lock_holder(lock_path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(lock_path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # mid-write or vanished: not evidence of anything


def _holder_is_dead(holder: Optional[Dict[str, Any]]) -> bool:
    """True only on positive evidence that the recorded pid is gone; an
    unreadable lock, a foreign pid or garbage count as alive."""
    if holder is None:
        return False
    try:
        pid = int(holder.get("pid", -1))
    except (TypeError, ValueError):
        return False
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return False
    except ProcessLookupError:
        return True
    except OSError:  # PermissionError et al: alive, just not ours
        return False


def _try_break_lock(lock_path: str, observed: Dict[str, Any],
                    store: Optional[str]) -> bool:
    """Break a stale lock through a short-lived O_EXCL break-mutex, re-read
    under it: only a lock still naming the same dead holder is removed."""
    bm = lock_path + ".break"
    try:
        if time.time() - os.path.getmtime(bm) > BREAK_MUTEX_STALE_S:
            os.unlink(bm)  # a breaker crashed mid-break; reclaim
    except OSError:
        pass
    try:
        os.close(os.open(bm, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except OSError:
        return False  # another breaker is active
    try:
        current = _read_lock_holder(lock_path)
        if current != observed or not _holder_is_dead(current):
            return False
        os.unlink(lock_path)
        JOURNAL.record("aot.lock_broken", level="WARNING", store=store,
                       lock=os.path.basename(lock_path))
        return True
    except OSError:
        return False
    finally:
        release_lockfile(bm)


def acquire_lockfile(lock_path: str, timeout_s: float,
                     store: Optional[str] = None) -> bool:
    """Single-writer lockfile: O_CREAT|O_EXCL with {pid, wall} inside.
    Bounded wait; False on timeout or on an unwritable store.  A lock
    whose pid is provably dead is broken; an unreadable one is not."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                json.dump({"pid": os.getpid(), "wall": round(time.time(), 3)}, f)
            return True
        except FileExistsError:
            holder = _read_lock_holder(lock_path)
            if _holder_is_dead(holder) and _try_break_lock(lock_path, holder, store):
                continue
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)
        except OSError:
            return False


def release_lockfile(lock_path: str) -> None:
    try:
        os.unlink(lock_path)
    except OSError:
        pass


class KernelLibraryStore:
    """One directory of built libraries and the manifest indexing them.
    Thread-safe; writers in several processes serialize on the lockfile,
    readers take no lock (the manifest is only ever atomically replaced)."""

    def __init__(self, path: Optional[str] = None,
                 lock_wait_s: float = DEFAULT_LOCK_WAIT_S):
        self._path = path
        self.lock_wait_s = lock_wait_s
        self._lock = threading.Lock()
        self._manifest: Optional[Dict[str, Any]] = None
        self._manifest_mtime: Optional[float] = None
        #: keys quarantined or evicted by this process (loads skip them
        #: even when the manifest rewrite could not take the lock)
        self._dead_keys: set = set()
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.skew = 0
        self.saves = 0
        self.save_errors = 0
        self.lock_bypasses = 0

    # -- configuration -------------------------------------------------------

    @property
    def path(self) -> Optional[str]:
        return self._path

    @property
    def enabled(self) -> bool:
        return bool(self._path)

    def configure(self, path: Optional[str] = None) -> "KernelLibraryStore":
        """Point the store at its directory (``path`` wins over the
        ``LODESTAR_TPU_TORCH_AOT_STORE`` environment variable).
        Idempotent."""
        if path is None:
            path = os.environ.get(STORE_ENV) or None
        with self._lock:
            if path != self._path:
                self._path = path
                self._manifest = None
                self._manifest_mtime = None
                self._dead_keys = set()
        return self

    def _manifest_path(self) -> str:
        return os.path.join(self._path, MANIFEST_NAME)

    def _entries_dir(self) -> str:
        return os.path.join(self._path, ENTRIES_DIR)

    # -- manifest ------------------------------------------------------------

    def _read_manifest(self) -> Dict[str, Any]:
        """The on-disk manifest; a corrupt one is journaled and read as
        empty."""
        mpath = self._manifest_path()
        try:
            with open(mpath) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and doc.get("schema") == SCHEMA_VERSION:
                entries = doc.get("entries")
                if isinstance(entries, dict):
                    return entries
            raise ValueError(f"unsupported manifest shape/schema in {mpath}")
        except OSError:
            return {}  # no manifest yet: the normal first-run state
        except ValueError as e:
            self.corrupt += 1
            JOURNAL.record("aot.corrupt", level="WARNING", store=self._path,
                           what="manifest", error=str(e)[:200])
            return {}

    def _entries(self) -> Dict[str, Any]:
        """Cached manifest view, refreshed when its mtime changes."""
        mpath = self._manifest_path()
        try:
            mtime = os.path.getmtime(mpath)
        except OSError:
            mtime = None
        with self._lock:
            if self._manifest is not None and mtime == self._manifest_mtime:
                return self._manifest
        entries = self._read_manifest() if mtime is not None else {}
        with self._lock:
            self._manifest = entries
            self._manifest_mtime = mtime
            return self._manifest

    def _write_manifest_locked(self, entries: Dict[str, Any]) -> None:
        """Atomic manifest replace; the caller holds the writer lockfile."""
        os.makedirs(self._path, exist_ok=True)
        tmp = f"{self._manifest_path()}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": SCHEMA_VERSION, "entries": entries}, f, indent=0)
        os.replace(tmp, self._manifest_path())
        with self._lock:
            self._manifest = entries
            try:
                self._manifest_mtime = os.path.getmtime(self._manifest_path())
            except OSError:
                self._manifest_mtime = None

    # -- writer lockfile -----------------------------------------------------

    def acquire_writer(self, timeout_s: Optional[float] = None) -> bool:
        if timeout_s is None:
            timeout_s = self.lock_wait_s
        try:
            os.makedirs(self._path, exist_ok=True)
        except OSError:
            return False
        return acquire_lockfile(os.path.join(self._path, LOCK_NAME), timeout_s,
                                store=self._path)

    def release_writer(self) -> None:
        release_lockfile(os.path.join(self._path, LOCK_NAME))

    # -- save ----------------------------------------------------------------

    def save(self, entry: str, extra, digest: str, library: str,
             capability: Optional[str] = None,
             nvcc: Optional[str] = None) -> Optional[str]:
        """Copy the built ``library`` into the store under its key; returns
        the key, or None (every failure is journaled, nothing raises)."""
        if not self.enabled:
            return None
        capability = capability or capability_tag()
        key = entry_key(capability, entry, extra, digest)
        fname = f"{_key_digest(key)}.so"
        if not self.acquire_writer():
            self.lock_bypasses += 1
            JOURNAL.record("aot.lock_busy", level="WARNING", store=self._path,
                           entry=entry, capability=capability)
            return None
        try:
            os.makedirs(self._entries_dir(), exist_ok=True)
            fpath = os.path.join(self._entries_dir(), fname)
            tmp = f"{fpath}.{os.getpid()}.tmp"
            shutil.copyfile(library, tmp)
            # chaos seam: a writer killed mid-write leaves the temp file,
            # never the rename or the manifest row
            if CHAOS.armed:
                CHAOS.maybe_kill("aot.midwrite", entry=entry, capability=capability)
            digest_file = _sha256_file(tmp)
            size = os.path.getsize(tmp)
            os.replace(tmp, fpath)
            entries = dict(self._read_manifest())
            entries[key] = {
                "file": f"{ENTRIES_DIR}/{fname}",
                "sha256": digest_file,
                "size": size,
                "capability": capability,
                "entry": entry,
                "extra": list(extra),
                "torch": torch_version(),
                "cuda": cuda_version(),
                "source_hash": digest,
                "nvcc": nvcc,
                "created_unix": round(time.time(), 3),
            }
            # the manifest written last: its row is the commit point
            self._write_manifest_locked(entries)
            self.saves += 1
            with self._lock:
                self._dead_keys.discard(key)
            JOURNAL.record("aot.save", store=self._path, entry=entry,
                           capability=capability, bytes=size)
            return key
        except OSError as e:
            self.save_errors += 1
            JOURNAL.record("aot.save_failed", level="WARNING", store=self._path,
                           entry=entry, capability=capability, error=str(e)[:200])
            return None
        finally:
            self.release_writer()

    # -- load ----------------------------------------------------------------

    def _quarantine(self, key: str, rec: Dict[str, Any], what: str, error: str) -> None:
        """A corrupt entry: journal, move the payload aside (evidence),
        drop the manifest row best-effort."""
        self.corrupt += 1
        with self._lock:
            self._dead_keys.add(key)
        JOURNAL.record("aot.corrupt", level="WARNING", store=self._path, what=what,
                       entry=rec.get("entry"), capability=rec.get("capability"),
                       error=error[:200])
        fpath = os.path.join(self._path, rec.get("file", ""))
        try:
            if os.path.exists(fpath):
                os.replace(fpath, fpath + ".quarantined")
        except OSError:
            pass
        self._drop_rows([key])

    def _evict(self, key: str, rec: Dict[str, Any], reason: str) -> None:
        """Version or source skew: journal ``aot.skew``, delete the
        payload, drop the manifest row best-effort."""
        self.skew += 1
        with self._lock:
            self._dead_keys.add(key)
        JOURNAL.record("aot.skew", level="WARNING", store=self._path,
                       entry=rec.get("entry"), capability=rec.get("capability"),
                       reason=reason, entry_torch=rec.get("torch"),
                       current_torch=torch_version())
        try:
            fpath = os.path.join(self._path, rec.get("file", ""))
            if os.path.exists(fpath):
                os.unlink(fpath)
        except OSError:
            pass
        self._drop_rows([key])

    def _drop_rows(self, keys) -> None:
        """Manifest cleanup under a non-blocking writer lock."""
        if not self.acquire_writer(timeout_s=0.0):
            return
        try:
            entries = dict(self._read_manifest())
            changed = False
            for key in keys:
                if key in entries:
                    del entries[key]
                    changed = True
            if changed:
                self._write_manifest_locked(entries)
        except OSError:
            pass
        finally:
            self.release_writer()

    @staticmethod
    def _skew(rec: Dict[str, Any], digest: str) -> Optional[str]:
        if rec.get("torch") != torch_version():
            return "torch_version"
        if rec.get("cuda") != cuda_version():
            return "cuda_version"
        if rec.get("source_hash") != digest:
            return "source_hash"
        return None

    def load(self, entry: str, extra, digest: str, capability: Optional[str] = None,
             opener: Optional[Callable[[str], Any]] = None):
        """The stored library: ``opener(path)`` (``ctypes.CDLL`` for the
        kernel loader; the verified path itself when None), or None.
        Every miss class is distinct and journaled: absent (plain miss), a
        checksum mismatch or a payload the opener refuses (``aot.corrupt``
        and quarantine), version or source skew (``aot.skew`` and
        eviction).  Never raises; takes no lock."""
        if not self.enabled:
            return None
        capability = capability or capability_tag()
        key = entry_key(capability, entry, extra, digest)
        with self._lock:
            if key in self._dead_keys:
                self.misses += 1
                return None
        rec = self._entries().get(key)
        if rec is None:
            self.misses += 1
            return None
        reason = self._skew(rec, digest)
        if reason is not None:
            self._evict(key, rec, reason)
            return None
        fpath = os.path.join(self._path, rec.get("file", ""))
        try:
            digest_file = _sha256_file(fpath)
        except OSError as e:
            self._quarantine(key, rec, what="payload_missing", error=str(e))
            return None
        if digest_file != rec.get("sha256"):
            self._quarantine(key, rec, what="checksum", error="sha256 mismatch")
            return None
        t0 = time.perf_counter()
        try:
            out = fpath if opener is None else opener(fpath)
        except Exception as e:  # noqa: BLE001 - a payload the loader refuses
            self._quarantine(key, rec, what="open", error=str(e))
            return None
        self.hits += 1
        JOURNAL.record("aot.load", store=self._path, entry=entry, capability=capability,
                       seconds=round(time.perf_counter() - t0, 3))
        return out

    # -- introspection -------------------------------------------------------

    def keys(self) -> Dict[str, Dict[str, Any]]:
        """A manifest snapshot."""
        return dict(self._entries())

    def verify(self) -> Dict[str, Any]:
        """Integrity sweep: the checksum and versions of every manifest
        entry (nothing is opened).  Returns {"ok", "corrupt", "skew",
        "orphans"} lists of keys or file names."""
        out: Dict[str, Any] = {"ok": [], "corrupt": [], "skew": [], "orphans": []}
        entries = self._entries()
        listed = set()
        for key, rec in entries.items():
            listed.add(os.path.basename(rec.get("file", "")))
            if self._skew(rec, key.rsplit("|", 1)[-1]) is not None:
                out["skew"].append(key)
                continue
            fpath = os.path.join(self._path, rec.get("file", ""))
            try:
                digest = _sha256_file(fpath)
            except OSError:
                out["corrupt"].append(key)
                continue
            (out["ok"] if digest == rec.get("sha256") else out["corrupt"]).append(key)
        try:
            for name in os.listdir(self._entries_dir()):
                if name not in listed and not name.endswith(".quarantined"):
                    out["orphans"].append(name)
        except OSError:
            pass
        return out

    def sweep_orphans(self) -> int:
        """Delete unlisted temp and entry files (crashed writers leave
        them; they are never loaded).  0 when the lock is contended."""
        if not self.enabled or not self.acquire_writer():
            return 0
        try:
            removed = 0
            listed = {os.path.basename(rec.get("file", ""))
                      for rec in self._read_manifest().values()}
            try:
                names = os.listdir(self._entries_dir())
            except OSError:
                return 0
            for name in names:
                if name in listed or name.endswith(".quarantined"):
                    continue
                try:
                    os.unlink(os.path.join(self._entries_dir(), name))
                    removed += 1
                except OSError:
                    pass
            return removed
        finally:
            self.release_writer()

    def stats(self) -> Dict[str, Any]:
        return {
            "path": self._path,
            "entries": len(self._entries()) if self.enabled else 0,
            "hits": self.hits,
            "misses": self.misses,
            "corrupt": self.corrupt,
            "skew": self.skew,
            "saves": self.saves,
            "save_errors": self.save_errors,
            "lock_bypasses": self.lock_bypasses,
        }


#: the process-wide store (``AOT_STORE.configure(path)`` or the
#: environment variable turn it on); tests construct their own
AOT_STORE = KernelLibraryStore()


def active_store(store: Optional[KernelLibraryStore] = None) -> Optional[KernelLibraryStore]:
    """The store a caller should use, or None when the tier is off:
    ``store`` when given, else the process-wide one, which picks up the
    environment variable at first use."""
    if store is None:
        store = AOT_STORE
        if not store.enabled and os.environ.get(STORE_ENV):
            store.configure()
    return store if store.enabled else None
