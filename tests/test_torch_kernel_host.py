"""The CUDA kernels' row arithmetic, built for the CPU.

field.cuh holds every kernel's per-row body as __host__ __device__
functions; ops/kernels/host_shim.cpp wraps them in a plain C interface.
Here g++ builds that shim (into build/, keyed by the sources' hash) and the
ten row bodies are held bitwise against the plain PyTorch versions.  This
checks the arithmetic the kernels run, not the kernels: the launches are
checked on the card by chip_smoke.py and the cuda-marked tests.

The same bodies, built with every step inlined (the layout that ptxas -O2
and -O3 miscompile on the card, tests/kernel_build_variants.py) and
without, run here under AddressSanitizer and UndefinedBehaviorSanitizer:
the source reads no memory out of bounds and overflows no int."""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from lodestar_tpu_torch.ops import fused_core as fc
from lodestar_tpu_torch.ops import fused_ladder  # noqa: F401 - registers lad1..3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KDIR = os.path.join(REPO, "lodestar_tpu_torch", "ops", "kernels")
ROWS = 8


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel rows cannot be made")
    return gxx


def _host_build(flags) -> str:
    """host_shim.cpp built with g++ and flags into build/, keyed by the
    sources and the flags."""
    gxx = _gxx()
    h = hashlib.sha256(" ".join(flags).encode())
    for name in ("field.cuh", "host_shim.cpp"):
        with open(os.path.join(KDIR, name), "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(REPO, "build", "lodestar_tpu_torch_host")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"host_shim_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(
            [gxx, "-std=c++17", *flags, "-shared", "-fPIC", "-o", tmp,
             os.path.join(KDIR, "host_shim.cpp")],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, lib)
    return lib


def run_rows(lib, name: str, rows: int, seed: int) -> None:
    """Kernel ``name``'s row body from the host library against its plain
    version on ``rows`` seeded rows."""
    k = fc.KERNELS[name]
    ins = chip_smoke.kernel_inputs(k, rows, np.random.default_rng(seed), "cpu")
    outs = [torch.empty((rows,) + k.tail) for _ in range(k.n_out)]
    ins_arr = (ctypes.c_void_p * 17)(*(t.data_ptr() for t in ins))  # null-terminated
    outs_arr = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in outs))
    fn = getattr(lib, f"host_{name}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    assert fn(ins_arr, outs_arr, rows, fc._CONST_TABLE.ctypes.data) == 0
    for got, want in zip(outs, k.plain(*ins)):
        assert torch.equal(got, want), name
        assert float(got.max()) <= 256


@pytest.fixture(scope="module")
def host_lib():
    return ctypes.CDLL(_host_build(["-O2"]))


@pytest.mark.parametrize("name", sorted(fc.KERNELS))
def test_host_built_row_body_equals_plain_version_bitwise(name, host_lib):
    run_rows(host_lib, name, ROWS, 7)


def test_heavy_steps_are_real_calls_in_the_kernels_build():
    """ptxas -O2/-O3 miscompile the kernels when every step is inlined, so
    the steps that make a kernel big stay out-of-line calls by default."""
    src = open(os.path.join(KDIR, "field.cuh"), encoding="utf-8").read()
    assert re.search(r"#else\n#define LF_CALL static __host__ __device__ __noinline__\n", src)
    for step in ("fold", "mul", "fq2_mul", "fq2_sqr", "cond_sub", "canon"):
        assert re.search(rf"^LF_CALL void {step}\(", src, re.M), step


@pytest.mark.parametrize("layout", ["calls", "inlined"])
def test_host_build_is_clean_under_address_and_undefined_behaviour_sanitizers(layout):
    gxx = _gxx()
    runtimes = [subprocess.run([gxx, f"-print-file-name={so}"], capture_output=True,
                               text=True).stdout.strip() for so in ("libasan.so", "libubsan.so")]
    if not all(os.path.isabs(r) for r in runtimes):
        pytest.skip("g++ has no sanitizer runtimes")
    flags = ["-O3", "-fsanitize=address,undefined", "-fno-sanitize-recover=all"]
    lib = _host_build(flags + (["-DLF_INLINE_ALL"] if layout == "inlined" else []))
    code = (
        "import ctypes, sys\n"
        "sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import test_torch_kernel_host as t\n"
        "lib = ctypes.CDLL(sys.argv[3])\n"
        "for name in sorted(t.fc.KERNELS):\n"
        "    t.run_rows(lib, name, 64, 11)\n"
        "print('clean')\n"
    )
    env = dict(os.environ, LD_PRELOAD=" ".join(runtimes),
               ASAN_OPTIONS="detect_leaks=0:halt_on_error=1")
    proc = subprocess.run([sys.executable, "-c", code, REPO, os.path.dirname(__file__), lib],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-4000:]
