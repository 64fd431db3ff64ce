"""Build and load the port's CUDA kernels (nvcc into a shared library with
a plain C interface, loaded with ctypes).

``fused_kernels.cu`` (the fused path's ten kernels), ``tower_kernels.cu``
(the XLA-graph path's four tower products), ``ring_kernels.cu`` (the
sharded tier's ring hop) and ``library_kernels.cu`` (the library's Fq2
product) are compiled once per kernel (``-DLF_KERNEL_<name>``), all sixteen
nvcc processes started together, and the objects are linked into one
library.  It is built at first use into ``build/lodestar_tpu_torch/``
under the repository root, named by a hash of the sources and the flags,
so an edited source rebuilds and an unchanged one loads at once.  Nothing
is built or loaded when the module is imported.

``extra`` nvcc flags (``"-DLF_INLINE_ALL"``, ``"-G"``) build a variant of
the library beside the default one; the port's kernels run the default,
and the variants exist for the card tests.

``load`` walks the materialization ladder: the in-process memo, then the
durable store of built libraries (``aot/store.py``, when one is given or
configured), then a library built earlier into ``build/``, then an nvcc
build, which is then saved to the store.  Each step that costs anything
is recorded in the compile ledger (``observatory/compile_ledger.py``:
``aot_load``, ``build_cache``, ``build``; entry ``kernels``, device the
card's compute capability).  With ``load_only`` the ladder stops after
the store: a miss journals ``aot.miss`` and raises ``AotStoreMiss``, and
no nvcc process starts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Tuple

from ...aot.store import AotStoreMiss, KernelLibraryStore, active_store, capability_tag
from ...forensics.journal import JOURNAL
from ...observatory.compile_ledger import COMPILE_LEDGER

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_REPO, "build", "lodestar_tpu_torch")
SOURCES = ("field.cuh", "field_coop.cuh", "launchers.cuh", "fused_kernels.cu", "tower_coop.cuh",
           "tower_kernels.cu", "ring_hop.cuh", "ring_kernels.cu", "library_kernels.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
_FUSED = ("mul", "fq2mul", "fq2sqr", "pow16mul", "fq2pow16mul",
          "fold", "canon", "lad1", "lad2", "lad3")
_TOWER = ("tower_fq2_mul", "tower_fq2_sqr", "tower_fq6_mul", "tower_fq12_mul")
_LIBRARY = ("library_fq2_mul",)
#: every launcher, by the source file that holds its kernel
LAUNCHERS = {**{name: "fused_kernels.cu" for name in _FUSED},
             **{name: "tower_kernels.cu" for name in _TOWER},
             "ring_hop": "ring_kernels.cu",
             **{name: "library_kernels.cu" for name in _LIBRARY}}

#: the library's entry label in the store and the compile ledger
ENTRY = "kernels"

_lock = threading.Lock()
_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}
#: wall seconds the last library load took (a build, a load from build/
#: or from the store), and which of the three it was
build_seconds = None
build_kind = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_version() -> Optional[str]:
    """The last line of ``nvcc --version`` (the store's provenance), or
    None where nvcc cannot be found or run."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[-1] if out.returncode == 0 and lines else None


def _digest(extra: Tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(extra: Tuple[str, ...] = ()) -> str:
    return os.path.join(BUILD_DIR, f"kernels_{_digest(extra)}.so")


def build(extra: Tuple[str, ...] = ()) -> str:
    """Compile the kernels unless a library of these sources exists; return
    its path.  Raises with the compiler's output when nvcc fails."""
    out = library_path(extra)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out}.{os.getpid()}"
    objs, procs = [], []
    for name, src in LAUNCHERS.items():
        obj = f"{tag}.{name}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, f"-DLF_KERNEL_{name}", "-c", "-o", obj,
               os.path.join(_HERE, src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    cmd = [nvcc, "-shared", "-o", f"{tag}.so", *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(f"{tag}.so", out)
    for obj in objs:
        os.remove(obj)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Every launcher's argument types: the row kernels' (ins, outs, n,
    constant table, stream), the ring hop's (src, dst, n, stream), the
    empty kernel's (stream)."""
    ptr_array = ctypes.POINTER(ctypes.c_void_p)
    for name in _FUSED + _TOWER + _LIBRARY:
        fn = getattr(lib, f"launch_{name}")
        fn.argtypes = [ptr_array, ptr_array, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.launch_ring_hop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_void_p]
    lib.launch_ring_hop.restype = ctypes.c_int
    lib.ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ring_enable_peer.restype = ctypes.c_int
    lib.launch_empty.argtypes = [ctypes.c_void_p]
    lib.launch_empty.restype = ctypes.c_int
    return lib


def load(extra: Tuple[str, ...] = (), store: Optional[KernelLibraryStore] = None,
         load_only: bool = False, capability: Optional[str] = None) -> ctypes.CDLL:
    """The loaded kernel library, with every launcher's argument types
    declared: from this process's memo, else the store (``store``, or the
    process-wide one when configured), else ``build/``, else built by
    nvcc and saved to the store.  ``load_only``: the store or nothing,
    ``AotStoreMiss`` on a miss.  ``capability``: the store key's
    ``sm_XY`` (default: the current card's)."""
    global build_seconds, build_kind
    with _lock:
        lib = _libs.get(extra)
        if lib is not None:
            return lib
        if COMPILE_LEDGER.path is None:
            COMPILE_LEDGER.configure(cache_dir=BUILD_DIR)
        t0 = time.perf_counter()
        digest = _digest(extra)
        cap = capability or capability_tag()
        tier = active_store(store)
        if tier is not None:
            lib = tier.load(ENTRY, extra, digest, cap, opener=lambda p: _declare(ctypes.CDLL(p)))
        if lib is not None:
            kind = "aot_load"
        elif load_only:
            JOURNAL.record("aot.miss", level="WARNING", entry=ENTRY, device=cap,
                           store=tier.path if tier is not None else None, load_only=True)
            raise AotStoreMiss(f"load-only: no stored kernel library {ENTRY} for {cap} "
                               f"(sources {digest}) in "
                               f"{tier.path if tier is not None else 'a store that is off'}")
        else:
            path = library_path(extra)
            kind = "build_cache" if os.path.exists(path) else "build"
            lib = _declare(ctypes.CDLL(build(extra)))
            if tier is not None:
                tier.save(ENTRY, extra, digest, path, cap, nvcc=nvcc_version())
        build_seconds = time.perf_counter() - t0
        build_kind = kind
        COMPILE_LEDGER.record(ENTRY, None, cap, kind, build_seconds)
        _libs[extra] = lib
    return lib
