"""Builds of the port's kernel sources that the port does not run, held
against the plain versions on the card.

    python3 tests/kernel_build_variants.py [variant ...]

The port builds field.cuh with its heavy steps (fold, the digit product,
the Fq2 product and square, the canonicalisation) as real calls.  With
every step inlined (``-DLF_INLINE_ALL``, the layout of the kernels' first
build) some kernels give wrong digits on the card, although g++ builds the
same source bitwise right.  Each variant here changes one thing about that
build (block size, ptxas optimisation level, device debug), so the table
shows which stage of the compiler the fault follows.

For each variant and kernel it prints one JSON line: the rows that differ
from the plain version over 1, 37, 512 and 2,560 rows and three seeds,
and the first differing row's digits; then, for the fq2sqr kernel,
ptxas's register, stack and spill report.  Needs a CUDA card and nvcc.
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
}
ROWS = (1, 37, 512, 2560)
SEEDS = range(3)


def launch(lib, k, ins):
    """Run kernel k of library lib on CUDA rows, as Kernel.launch does."""
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


def ptxas_report(extra) -> list:
    """ptxas's resource lines for the fq2sqr kernel of a variant."""
    src = os.path.join(os.path.dirname(_build.__file__), "fused_kernels.cu")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-DLF_KERNEL_fq2sqr",
           "-Xptxas", "-v", "-c", "-o", os.devnull, src]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
            if "registers" in ln or "stack frame" in ln or "spill" in ln]


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
        print(json.dumps({"variant": variant, "ptxas_fq2sqr": ptxas_report(VARIANTS[variant])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
