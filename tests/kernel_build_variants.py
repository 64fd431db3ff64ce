"""Builds of the port's kernel sources that the port does not run, held
against the plain versions on the card.

    python3 tests/kernel_build_variants.py [--kernels a,b,...] [variant ...]

The port builds field_coop.cuh and tower_coop.cuh with their heavy steps
(the fold and the digit product) as real calls.  With every step inlined
(``-DLF_INLINE_ALL``, the layout of the first, one-thread kernels) some of
those kernels gave wrong digits on the card, although g++ built the same
source bitwise right; the ``inlined*`` variants build the cooperative
kernels that way, each changing one more thing (ptxas optimisation level,
device debug), so the table shows which stage of the compiler a fault
follows.  The cooperative kernels lad1, lad2, lad3, fq2pow16mul, fq2mul,
pow16mul, mul, fq2sqr, fold, canon and library_fq2_mul (field_coop.cuh)
and the four tower kernels (tower_coop.cuh): the ``ptxas-O1`` variant
holds them at another ptxas level, the ``*-warps``
variants at other block sizes (``LF_COOP_WARPS``: the ladder kernels'
warps a block, 8 by default; ``LF_POW_WARPS``: fq2pow16mul's, 4;
``LF_FQ2MUL_WARPS``: fq2mul's warps a row, 3; ``LF_MUL_WARPS`` and
``LF_FQ2SQR_WARPS``: mul's and fq2sqr's, set together with their rows a
block in the ``mul-fq2sqr-*`` variants), the ``rows-*`` variants at other
rows a block (``LF_FQ2MUL_ROWS``, ``LF_POW16_ROWS``, ``LF_MUL_ROWS`` and
``LF_FQ2SQR_ROWS``, set together: the kernels are timed apart),
``k-global*`` with the constant table read from global memory instead of
staged into each block's shared memory (``LF_COOP_K_GLOBAL``), the
``canon-*`` variants at other rows a block (``LF_CANON_ROWS``), with its
table slices staged (``LF_CANON_K_STAGED=1``) and with its ripples'
carries by warp ballots (``LF_CANON_BALLOT``), the ``tower-fq12-*``
variants at other warps a block of tower_fq12_mul
(``LF_TOWER_FQ12_WARPS``, 16 by default) and with its registers sized
for two blocks a SM (``LF_TOWER_FQ12_BLOCKS_PER_SM``, 1 by default), the
``tower-fq2-*`` variants at other warps a row and rows a block of
tower_fq2_mul (``LF_TOWER_FQ2_WARPS``, ``LF_TOWER_FQ2_ROWS``: 3 and 2), the
``tower-fq2sqr-*`` variants the same of tower_fq2_sqr
(``LF_TOWER_FQ2SQR_WARPS``, ``LF_TOWER_FQ2SQR_ROWS``: 3 and 2), the
``tower-fq6-*`` variants at other warps a block of tower_fq6_mul
(``LF_TOWER_FQ6_WARPS``, 12 by default), the ``fold-*`` variants at other
rows a block of fold (``LF_FOLD_ROWS``, 2 by default) with the RED rows
it reads from global memory (the default) or staged a block
(``LF_FOLD_K_STAGED=1``, ``fold-k-staged-*``), the ``lib-fq2mul-*``
variants at other warps a row and rows a block of library_fq2_mul
(``LF_LIB_FQ2MUL_WARPS``, ``LF_LIB_FQ2MUL_ROWS``: 2 and 2), and
``ring-scalar``, the ring hop without its float4 path
(``LF_RING_VEC=0``).

For each variant and kernel it prints one JSON line: the rows that differ
from the plain version over 1, 37, 256, 512, 513 and 2,560 rows and three
seeds, and the first differing row's digits (for the ring hop: the
chunks, of the ring's two shapes, that differ from a copy, whether it
equals copy_ at every length and pointer offset, and its device time at
both shapes beside copy_); then each kernel's ptxas report (registers,
stack, spills); the dynamic shared memory, rows and threads of a
cooperative kernel's block; and each cooperative kernel's device time at
the rows chip_smoke times it at (20 launches in a CUDA graph, replayed
between CUDA events).  A variant builds only the kernels it checks, one
nvcc process each, all started together, and the variants build side by
side (as many at once as the host's cores over the kernels a variant
builds); ``--kernels`` names them (the ring hop's check runs when it is
named), and by default every kernel is built.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from lodestar_tpu_torch.ops import fused_core as fc  # noqa: E402
from lodestar_tpu_torch.ops import fused_ladder  # noqa: E402,F401 - registers lad1..3
from lodestar_tpu_torch.ops import library_fuse  # noqa: E402,F401 - registers library_fq2_mul
from lodestar_tpu_torch.ops import tower_kernels  # noqa: E402,F401 - registers the tower kernels
from lodestar_tpu_torch.ops.kernels import _build  # noqa: E402

INLINE = "-DLF_INLINE_ALL"


def _rows(r: int):
    return tuple(f"-DLF_{k}_ROWS={r}" for k in ("FQ2MUL", "POW16", "MUL", "FQ2SQR"))


def _mul_fq2sqr(warps: int, rows: int):
    return tuple(f"-DLF_{k}_{what}={v}" for k in ("MUL", "FQ2SQR")
                 for what, v in (("WARPS", warps), ("ROWS", rows)))


VARIANTS = {
    "calls": (),
    "inlined": (INLINE,),
    "inlined-ptxas-O0": (INLINE, "-Xptxas", "-O0"),
    "inlined-ptxas-O1": (INLINE, "-Xptxas", "-O1"),
    "inlined-ptxas-O2": (INLINE, "-Xptxas", "-O2"),
    "inlined-G": (INLINE, "-G"),
    "ptxas-O1": ("-Xptxas", "-O1"),
    "coop-4-warps": ("-DLF_COOP_WARPS=4",),  # the ladder's; fq2pow16mul has 4 already
    "coop-12-warps": ("-DLF_COOP_WARPS=12",),
    "pow-2-warps": ("-DLF_POW_WARPS=2",),
    "pow-3-warps": ("-DLF_POW_WARPS=3",),
    "pow-8-warps": ("-DLF_POW_WARPS=8",),
    # the rows a block of fq2mul, pow16mul, mul and fq2sqr, set together
    **{f"rows-{r}": _rows(r) for r in (1, 2, 4, 8)},
    # fq2mul's three products one after the other, on one warp a row
    "fq2mul-1-warp-rows-1": ("-DLF_FQ2MUL_WARPS=1", "-DLF_FQ2MUL_ROWS=1"),
    "fq2mul-1-warp-rows-4": ("-DLF_FQ2MUL_WARPS=1", "-DLF_FQ2MUL_ROWS=4"),
    "fq2mul-1-warp-rows-8": ("-DLF_FQ2MUL_WARPS=1", "-DLF_FQ2MUL_ROWS=8"),
    # mul's and fq2sqr's warps a row and rows a block, set together
    **{f"mul-fq2sqr-{w}-warp{'s' * (w > 1)}-rows-{r}": _mul_fq2sqr(w, r) for w in (1, 2) for r in (1, 2, 4, 8)},
    # canon's rows a block (one warp a row), its table slices read from
    # global memory (the default) or staged a block, its ripples' carries
    # by warp ballots instead of the host-checked OR of the pairs' flags
    **{f"canon-rows-{r}": (f"-DLF_CANON_ROWS={r}",) for r in (1, 2, 4, 8, 16)},
    **{f"canon-k-staged-rows-{r}": (f"-DLF_CANON_ROWS={r}", "-DLF_CANON_K_STAGED=1")
       for r in (1, 2, 4, 8, 16)},
    "canon-ballot": ("-DLF_CANON_BALLOT",),
    # the ring hop with every float a scalar item
    "ring-scalar": ("-DLF_RING_VEC=0",),
    # tower_fq12_mul's warps (one row a block, registers for one block a
    # SM; 16 warps by default), its registers sized for two blocks a SM,
    # tower_fq2_mul's and tower_fq2_sqr's warps a row and rows a block, and
    # tower_fq6_mul's warps (one row a block; 12 by default)
    **{f"tower-fq12-{w}-warps": (f"-DLF_TOWER_FQ12_WARPS={w}",) for w in (8, 12, 24)},
    **{f"tower-fq12-{w}-warps-2-blocks": (f"-DLF_TOWER_FQ12_WARPS={w}",
                                          "-DLF_TOWER_FQ12_BLOCKS_PER_SM=2") for w in (12, 16)},
    **{f"tower-fq2-{w}-warp{'s' * (w > 1)}-rows-{r}": (f"-DLF_TOWER_FQ2_WARPS={w}",
                                                       f"-DLF_TOWER_FQ2_ROWS={r}")
       for w in (1, 2, 3) for r in (1, 2, 4, 8) if (w, r) != (3, 2)},
    **{f"tower-fq2sqr-{w}-warp{'s' * (w > 1)}-rows-{r}": (f"-DLF_TOWER_FQ2SQR_WARPS={w}",
                                                          f"-DLF_TOWER_FQ2SQR_ROWS={r}")
       for w in (1, 2, 3) for r in (1, 2, 3, 4) if (w, r) != (3, 2)},
    **{f"tower-fq6-{w}-warps": (f"-DLF_TOWER_FQ6_WARPS={w}",) for w in (6, 8, 9, 16, 18, 24)},
    # fold's rows a block, its three RED rows read from global memory (the
    # default) or staged a block; library_fq2_mul's warps a row and rows a
    # block
    **{f"fold-rows-{r}": (f"-DLF_FOLD_ROWS={r}",) for r in (1, 4, 8)},
    **{f"fold-k-staged-rows-{r}": (f"-DLF_FOLD_ROWS={r}", "-DLF_FOLD_K_STAGED=1")
       for r in (1, 2, 4, 8)},
    **{f"lib-fq2mul-{w}-warp{'s' * (w > 1)}-rows-{r}": (f"-DLF_LIB_FQ2MUL_WARPS={w}",
                                                        f"-DLF_LIB_FQ2MUL_ROWS={r}")
       for w in (1, 2, 3, 4) for r in (1, 2, 4) if (w, r) != (2, 2)},
    "k-global": ("-DLF_COOP_K_GLOBAL",),
    "k-global-rows-1": ("-DLF_COOP_K_GLOBAL", *_rows(1)),
    **{f"k-global-mul-fq2sqr-{w}-warp{'s' * (w > 1)}-rows-{r}": ("-DLF_COOP_K_GLOBAL", *_mul_fq2sqr(w, r))
       for w in (1, 2) for r in (1, 4)},
}
ROWS = (1, 37, 256, 512, 513, 2560)
SEEDS = range(3)


def launch(lib, k, ins, sync: bool = True):
    """Run kernel k of library lib on CUDA rows, as Kernel.launch does
    (``sync``: then wait for the card)."""
    n = ins[0].shape[0]
    outs = [torch.empty((n,) + k.tail, dtype=torch.float32, device=ins[0].device)
            for _ in range(k.n_out)]
    ins_arr = (ctypes.c_void_p * k.n_in)(*(t.data_ptr() for t in ins))
    outs_arr = (ctypes.c_void_p * k.n_out)(*(t.data_ptr() for t in outs))
    table = fc.const_tensor(fc._CONST_TABLE, ins[0].device, torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, f"launch_{k.name}")(ins_arr, outs_arr, n, table.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"launch_{k.name} failed: cudaError {rc}")
    if sync:
        torch.cuda.synchronize()
    return outs


def check(lib, k, dev) -> dict:
    """Rows that differ from the plain version, over every row count and
    seed, and the first difference seen."""
    differ, checked, first = 0, 0, None
    for rows in ROWS:
        for seed in SEEDS:
            ins = chip_smoke.kernel_inputs(k, max(rows, 4), np.random.default_rng(seed), dev)
            ins = [t[:rows].contiguous() for t in ins]
            bad = torch.zeros(rows, dtype=torch.bool, device=dev)
            for j, (g, w) in enumerate(zip(launch(lib, k, ins), k.plain(*ins))):
                rows_bad = (g != w).reshape(rows, -1).any(1)
                if first is None and bool(rows_bad.any()):
                    r = int(rows_bad.nonzero()[0])
                    first = {"rows": rows, "seed": seed, "output": j, "row": r,
                             "digits": (g[r] != w[r]).nonzero().tolist()}
                bad |= rows_bad
            differ += int(bad.sum())
            checked += rows
    return {"rows_checked": checked, "rows_differ": differ, "first": first}


def check_ring(lib, dev) -> dict:
    """Chunks that the variant's ring hop copies wrong, over the ring's
    shapes and three seeds (the plain version of a hop is a copy), whether
    it equals copy_ at every length and pointer offset of
    chip_smoke.check_hop_offsets, and its device time at each ring shape
    (the bits at an odd slot of their stack) beside copy_ of the same
    slots."""
    differ, checked = 0, 0
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for shape, slot in zip(chip_smoke.RING_SHAPES, (0, 1)):
        for seed in SEEDS:
            src = torch.from_numpy(
                np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)
            dst = torch.full_like(src, float("nan"))
            rc = lib.launch_ring_hop(src.data_ptr(), dst.data_ptr(), src.numel(), stream)
            if rc != 0:
                raise RuntimeError(f"launch_ring_hop failed: cudaError {rc}")
            torch.cuda.synchronize()
            differ += int(not torch.equal(src, dst))
            checked += 1
        stack = torch.zeros((2, 2) + shape, device=dev)
        a, b = stack[0][slot], stack[1][slot]
        ms[str(shape)] = {
            "hop": chip_smoke.graph_ms(lambda: lib.launch_ring_hop(
                a.data_ptr(), b.data_ptr(), a.numel(), torch.cuda.current_stream().cuda_stream)),
            "copy_": chip_smoke.graph_ms(lambda: b.copy_(a))}
    try:
        chip_smoke.check_hop_offsets(dev, np.random.default_rng(0), "variant", lib)
        offsets_ok = True
    except AssertionError:
        offsets_ok = False
    return {"chunks_checked": checked, "chunks_differ": differ, "offsets_ok": offsets_ok,
            "ms": ms}


def build(extra, names):
    """The kernels ``names`` built with a variant's flags, one nvcc process
    each (all started together, ptxas's report on), and linked into one
    library under build/; returns the library, its launchers' argument
    types declared as ``_build.load`` declares them, and, per kernel,
    ptxas's register, stack, spill and shared-memory lines."""
    out = os.path.join(_build.BUILD_DIR, f"variant_{_build._digest((*extra, *names))}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(os.path.dirname(_build.__file__), _build.LAUNCHERS[name])
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, f"-DLF_KERNEL_{name}",
               "-Xptxas", "-v", "-c", "-o", f"{out}.{name}.o", src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    reports = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v of {name} failed:\n{log}")
        reports[name] = [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "stack frame" in ln or "spill" in ln or "smem" in ln]
    subprocess.run([_build._nvcc(), "-shared", "-o", f"{out}.so", *(f"{out}.{n}.o" for n in names)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(f"{out}.so")
    ptr_array = ctypes.POINTER(ctypes.c_void_p)
    for name in names:
        fn = getattr(lib, f"launch_{name}")
        if name == "ring_hop":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        else:
            fn.argtypes = [ptr_array, ptr_array, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, reports


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_build_variants: no CUDA device", file=sys.stderr)
        return 2
    kernels = list(fc.KERNELS) + ["ring_hop"]
    if argv[:1] == ["--kernels"]:
        kernels, argv = argv[1].split(","), argv[2:]
    unknown = [v for v in argv if v not in VARIANTS] + [
        k for k in kernels if k not in fc.KERNELS and k != "ring_hop"]
    if unknown:
        print(f"kernel_build_variants: unknown variants or kernels {unknown}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    variants = argv or list(VARIANTS)
    # the variants build side by side, each its kernels' nvcc processes at
    # once, while the card checks the ones built
    workers = max(1, (os.cpu_count() or 1) // len(kernels))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        builds = {v: pool.submit(build, VARIANTS[v], kernels) for v in variants}
        for variant in variants:
            check_variant(variant, kernels, *builds[variant].result(), dev)
    return 0


def check_variant(variant: str, kernels, lib, reports, dev) -> None:
    """Print a built variant's lines: each kernel's check, ptxas's reports,
    each cooperative kernel's layout and device times."""
    for name in kernels:
        result = check_ring(lib, dev) if name == "ring_hop" else check(lib, fc.KERNELS[name], dev)
        print(json.dumps({"variant": variant, "kernel": name, **result}), flush=True)
    for name, report in reports.items():
        print(json.dumps({"variant": variant, f"ptxas_{name}": report}), flush=True)
    for name in chip_smoke.COOP:
        if name not in kernels:
            continue
        k = fc.KERNELS[name]
        ms = {}
        for rows in chip_smoke.SHAPES[name]:
            ins = chip_smoke.kernel_inputs(k, rows, np.random.default_rng(rows), dev)
            ms[rows] = chip_smoke.graph_ms(lambda: launch(lib, k, ins, sync=False))
        print(json.dumps({"variant": variant,
                          f"smem_bytes_{name}": getattr(lib, f"smem_bytes_{name}")(),
                          f"rows_per_block_{name}": getattr(lib, f"rows_per_block_{name}")(),
                          f"threads_per_block_{name}": getattr(lib, f"threads_per_block_{name}")(),
                          f"ms_{name}": ms}), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
