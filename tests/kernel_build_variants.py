"""Builds of the port's kernel sources that the port does not run, held
against the plain versions on the card.

    python3 tests/kernel_build_variants.py [variant ...]

The port builds field.cuh, tower.cuh and limbs.cuh with their heavy steps
(fold, the digit product, the Fq2 product and square, the
canonicalisation, the tower's Fq2 / Fq6 / Fq12 products, the library
kernel's strict sum, product and subtraction) as real calls.  With
every step inlined (``-DLF_INLINE_ALL``, the layout of the kernels' first
build) some kernels give wrong digits on the card, although g++ builds the
same source bitwise right.  Each variant here changes one thing about that
build (block size, ptxas optimisation level, device debug), so the table
shows which stage of the compiler the fault follows.  The cooperative
kernels lad1, lad2, lad3 and fq2pow16mul (field_coop.cuh) keep the
product and the fold as calls too; the ``ptxas-O1`` variant holds them at
another ptxas level, and the ``*-warps`` variants at other block sizes
(``LF_COOP_WARPS``: the ladder kernels' warps a block, 8 by default;
``LF_POW_WARPS``: fq2pow16mul's, 4).

For each variant and kernel it prints one JSON line: the rows that differ
from the plain version over 1, 37, 256, 512, 513 and 2,560 rows and three
seeds, and the first differing row's digits (for the ring hop: the
chunks, of the ring's two shapes, that differ from a copy); then, for the
fq2sqr, lad1, lad2, lad3, fq2pow16mul, tower_fq12_mul, library_fq2_mul
and ring_hop kernels, ptxas's register, stack and spill report; the
dynamic shared memory of a cooperative kernel's block; and each
cooperative kernel's device time at the rows chip_smoke times it at (20
launches in a CUDA graph, replayed between CUDA events).  Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

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
VARIANTS = {
    "calls": (),
    "inlined": (INLINE,),
    "inlined-128-threads": (INLINE, "-DLF_THREADS=128"),
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
}
ROWS = (1, 37, 256, 512, 513, 2560)
PTXAS = ("fq2sqr", "lad1", "lad2", "lad3", "fq2pow16mul", "tower_fq12_mul", "library_fq2_mul",
         "ring_hop")
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
    shapes and three seeds (the plain version of a hop is a copy)."""
    differ, checked = 0, 0
    stream = torch.cuda.current_stream().cuda_stream
    for shape in chip_smoke.RING_SHAPES:
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
    return {"chunks_checked": checked, "chunks_differ": differ}


def ptxas_report(extra, name: str) -> list:
    """ptxas's resource lines for kernel ``name`` of a variant."""
    src = os.path.join(os.path.dirname(_build.__file__), _build.LAUNCHERS[name])
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, f"-DLF_KERNEL_{name}",
           "-Xptxas", "-v", "-c", "-o", os.devnull, src]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
            if "registers" in ln or "stack frame" in ln or "spill" in ln or "smem" in ln]


def main(names) -> int:
    if not torch.cuda.is_available():
        print("kernel_build_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    for variant in names:
        lib = _build.load(VARIANTS[variant])
        for name, k in fc.KERNELS.items():
            print(json.dumps({"variant": variant, "kernel": name, **check(lib, k, dev)}),
                  flush=True)
        print(json.dumps({"variant": variant, "kernel": "ring_hop", **check_ring(lib, dev)}),
              flush=True)
        for name in PTXAS:
            print(json.dumps({"variant": variant, f"ptxas_{name}": ptxas_report(VARIANTS[variant], name)}),
                  flush=True)
        for name in chip_smoke.COOP:
            k = fc.KERNELS[name]
            ms = {}
            for rows in chip_smoke.SHAPES[name]:
                ins = chip_smoke.kernel_inputs(k, rows, np.random.default_rng(rows), dev)
                ms[rows] = chip_smoke.graph_ms(lambda: launch(lib, k, ins, sync=False))
            print(json.dumps({"variant": variant,
                              f"smem_bytes_{name}": getattr(lib, f"smem_bytes_{name}")(),
                              f"ms_{name}": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
