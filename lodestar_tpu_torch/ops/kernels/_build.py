"""Build and load the fused CUDA kernels (nvcc into a shared library with a
plain C interface, loaded with ctypes).

``fused_kernels.cu`` is compiled once per kernel (``-DLF_KERNEL_<name>``),
all ten nvcc processes started together, and the objects are linked into
one library.  It is built at first use into ``build/lodestar_tpu_torch/``
under the repository root, named by a hash of the sources and the flags,
so an edited source rebuilds and an unchanged one loads at once.  Nothing
is built or loaded when the module is imported.

``extra`` nvcc flags (``"-DLF_INLINE_ALL"``, ``"-G"``) build a variant of
the library beside the default one; the port's kernels run the default,
and the variants exist for the card tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_REPO, "build", "lodestar_tpu_torch")
SOURCES = ("field.cuh", "fused_kernels.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
LAUNCHERS = (
    "mul", "fq2mul", "fq2sqr", "pow16mul", "fq2pow16mul",
    "fold", "canon", "lad1", "lad2", "lad3",
)

_lock = threading.Lock()
_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}
#: wall seconds the last build (or load of a cached build) took
build_seconds = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused CUDA kernels cannot be built")


def _digest(extra: Tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(extra: Tuple[str, ...] = ()) -> str:
    return os.path.join(BUILD_DIR, f"fused_kernels_{_digest(extra)}.so")


def build(extra: Tuple[str, ...] = ()) -> str:
    """Compile the kernels unless a library of these sources exists; return
    its path.  Raises with the compiler's output when nvcc fails."""
    out = library_path(extra)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    src = os.path.join(_HERE, "fused_kernels.cu")
    tag = f"{out}.{os.getpid()}"
    objs, procs = [], []
    for name in LAUNCHERS:
        obj = f"{tag}.{name}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, f"-DLF_KERNEL_{name}", "-c", "-o", obj, src]
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


def load(extra: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every
    launcher's argument types declared."""
    global build_seconds
    with _lock:
        lib = _libs.get(extra)
        if lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(build(extra))
            ptr_array = ctypes.POINTER(ctypes.c_void_p)
            for name in LAUNCHERS:
                fn = getattr(lib, f"launch_{name}")
                fn.argtypes = [ptr_array, ptr_array, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            build_seconds = time.perf_counter() - t0
            _libs[extra] = lib
    return lib
