"""The frozen yardstick of the kernels' layer: the work one batch of a
bucket needs, priced at the H100's published peaks.

The arithmetic is a frozen copy of ``chip_smoke.py``'s operation count
(``MACS_PER_ROW``: int32 multiply-adds a row of each kernel; carries and
adds are not counted, so the bound is a lower bound) and of its kernel
shapes (inputs, outputs, the float32 digits a row).  ``data/work_table.json``
holds the launch census of the split fused program at each bucket (each
kernel's launches by row count, as the port's bucket programs recorded
them at capture on NVIDIA H100 80GB HBM3), and the totals below computed
from it.  A bucket's multiply-adds are exactly a fixed part per batch plus
a part per lane (``linear_work``), so a batch is priced by the sets it
holds, not by its bucket's padding lanes: the fixed part plus its sets
times the part per lane.  Its bytes are its inputs and outputs once:
``pack()``'s arrays of its sets in, the Fq12 product and the verdict out.
A batch's least time is the larger of its multiply-adds (two operations
each) over the int32 rate and its bytes over HBM bandwidth.  Whatever a
later version of the port launches, the same sets are held to the same
work.
"""

from __future__ import annotations

import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
TABLE = os.path.join(HERE, "data", "work_table.json")

#: H100 SXM, NVIDIA's data sheet, at the 700 W limit: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
#: int32 multiply-add on the CUDA cores: 64 lanes per SM per clock (half
#: the fp32 lanes) x 132 SMs x 1.98 GHz, 2 operations each = half of the
#: 67 TFLOP/s fp32 rate
INT32_OPS_PER_S = 33.5e12

NL = 50  # float32 digits of one Fq value


def _fold(w: int, bits: int) -> int:
    extra = max(1, -(-(bits - 8) // 8))
    return (w + extra - 49) * 50


_MUL = 2500 + _fold(99, 22)
_LOADF = _fold(50, 22)
_SMALL = _fold(50, 13)
_F2MUL = 3 * _MUL + 2 * _SMALL
_F2SQR = 2 * _MUL + 2 * _SMALL
_TF2MUL = 3 * _MUL + 5 * _SMALL
_TF2 = 2 * _SMALL
_TF6MUL = 6 * _TF2MUL + 6 * _TF2 + 11 * _TF2
_TF12MUL = 3 * _TF6MUL + 6 * _TF2 + 10 * _TF2
MACS_PER_ROW = {
    "mul": 2 * _LOADF + _MUL,
    "fq2mul": 4 * _LOADF + _F2MUL,
    "fq2sqr": 2 * _LOADF + _F2SQR,
    "pow16mul": 2 * _LOADF + 5 * _MUL,
    "fq2pow16mul": 4 * _LOADF + 4 * _F2SQR + _F2MUL,
    "fold": _LOADF,
    "canon": _LOADF + 4 * 6 + 3 * 48,
    "lad1": 12 * _LOADF + 6 * _F2SQR + 2 * _F2MUL,
    "lad2": 8 * _LOADF + 4 * _F2MUL + 2 * (3 * _F2SQR + 18 * _SMALL),
    "lad3": 4 * _LOADF + 9 * _F2MUL + 3 * _F2SQR + 32 * _SMALL,
    "tower_fq2_mul": _TF2MUL,
    "tower_fq2_sqr": 2 * _MUL + 3 * _SMALL,
    "tower_fq6_mul": _TF6MUL,
    "tower_fq12_mul": _TF12MUL,
    "library_fq2_mul": 3 * _MUL + 2 * _fold(50, 24) + 2 * _fold(51, 24),
}
#: (inputs, outputs, float32 values a row) of each kernel
SHAPES = {
    "mul": (2, 1, NL), "fq2mul": (2, 1, 2 * NL), "fq2sqr": (1, 2, 2 * NL),
    "pow16mul": (2, 1, NL), "fq2pow16mul": (2, 1, 2 * NL), "fold": (1, 1, NL),
    "canon": (1, 1, NL), "lad1": (6, 8, 2 * NL), "lad2": (10, 12, 2 * NL),
    "lad3": (16, 9, 2 * NL), "tower_fq2_mul": (2, 1, 2 * NL),
    "tower_fq2_sqr": (1, 1, 2 * NL), "tower_fq6_mul": (2, 1, 6 * NL),
    "tower_fq12_mul": (2, 1, 12 * NL), "library_fq2_mul": (2, 1, 2 * NL),
}


#: float32 values one set brings to the card (``pack()``: a public key's x
#: and y, a signature's x and y in Fq2, ``hash_to_field``'s two Fq2, 64
#: coefficient bits), and a batch takes back (the Fq12 product)
IN_FLOATS_PER_SET = 2 * NL + 4 * NL + 4 * NL + 64
OUT_FLOATS_PER_BATCH = 12 * NL


def census_work(census: Dict[str, Dict[str, int]]) -> Dict[str, int]:
    """{"macs", "bytes"} of one batch from its census {kernel: {rows:
    launches}} (rows as strings, as JSON keeps them)."""
    macs = nbytes = 0
    for kernel, by_rows in census.items():
        n_in, n_out, width = SHAPES[kernel]
        for rows, launches in by_rows.items():
            r = int(rows) * launches
            macs += MACS_PER_ROW[kernel] * r
            nbytes += 4 * r * width * (n_in + n_out)
    return {"macs": macs, "bytes": nbytes}


def bound_seconds(work: Dict[str, int]) -> float:
    """The least time the card could take for ``work``: the larger of the
    operations over the int32 rate and the bytes over HBM bandwidth."""
    return max(2 * work["macs"] / INT32_OPS_PER_S, work["bytes"] / HBM_BYTES_PER_S)


def load_table(path: str = TABLE) -> Dict[int, Dict[str, int]]:
    """{bucket: {"macs", "bytes"}} of the frozen table."""
    with open(path) as f:
        doc = json.load(f)
    return {int(b): census_work(c) for b, c in doc["census"].items()}


def linear_work(table: Dict[int, Dict[str, int]]) -> Dict[str, int]:
    """{"batch", "set"}: the multiply-adds of a batch of any bucket, ``batch
    + set * bucket``, fitted through the smallest and largest buckets and
    checked exact at every other."""
    lo, hi = min(table), max(table)
    per_set, rem = divmod(table[hi]["macs"] - table[lo]["macs"], hi - lo)
    fixed = table[lo]["macs"] - per_set * lo
    if rem or any(table[b]["macs"] != fixed + per_set * b for b in table):
        raise ValueError("the census's work is not linear in the bucket")
    return {"batch": fixed, "set": per_set}


def batch_work(n_sets: int, linear: Dict[str, int]) -> Dict[str, int]:
    """{"macs", "bytes"} that verifying a batch of ``n_sets`` needs: the
    fixed part and the sets' part of the multiply-adds, and its inputs
    (float32 values and a mask byte a set) and outputs (the product and a
    verdict byte) once."""
    return {"macs": linear["batch"] + linear["set"] * n_sets,
            "bytes": n_sets * (4 * IN_FLOATS_PER_SET + 1) + 4 * OUT_FLOATS_PER_BATCH + 1}
