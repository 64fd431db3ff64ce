"""The CUDA kernel audit: shared-memory races, launch resources and the
ring's plan.

The port's counterpart of ``lodestar_tpu/analysis/pallas_audit.py``.  Its
rules:

- ``cuda-smem-race`` (from ``pallas-ref-race``).  On the card,
  ``compute-sanitizer`` (found under the card's CUDA toolkit,
  ``$CUDA_HOME/bin`` or ``extras/compute-sanitizer``; its version logged)
  runs ``racecheck``, ``synccheck`` and ``memcheck`` over a child process
  (``python -m lodestar_tpu_torch.analysis.kernel_audit --launch-all``)
  that launches each of the sixteen kernels once at a row count that
  leaves the last block partial and holds every output against its plain
  version.  A toolkit without the sanitizer, or a sanitizer that refuses
  the device ("Device not supported": then it attaches to no process,
  not even a two-kernel test program), leaves this half out, and the
  report says which; any
  hazard, error or failed launch is a violation.  On the host (no card),
  the rule's half is the g++ walks (``audit_host_walks``): every
  cooperative body built from ``host_shim.cpp`` with its blocks, rows,
  warps and lanes walked forwards and backwards (``-DLC_HOST_REVERSED``),
  each held bitwise against its plain version on seeded rows and rows at
  the digit bounds; a step that reads what another lane or warp writes in
  the same step or stage differs in one of the two orders.  A violation
  names the kernel's schedule (its ``*Stages`` struct).  The test suite
  runs the walks as ``tests/test_torch_kernel_host.py``'s cases, one
  (kernel, rows, order) a case.
- ``cuda-launch-resources`` (from ``pallas-block-misaligned``).  The
  library's ``attrs_<name>`` returns ``cudaFuncGetAttributes`` of each
  kernel (registers, local bytes, static shared bytes, the most threads a
  block), held against its launch configuration in ``launchers.cuh``
  (``threads_per_block_<name>``, ``smem_bytes_<name>``): no local (spill)
  bytes, the block's threads at most the kernel's most, dynamic plus
  static shared memory within the card's opt-in limit.  The ring hop's
  three instances are held against ``ring_hop.cuh``'s block of
  ``lr::THREADS``.  The three ladder kernels break the "no spill" rule:
  at the 64 registers a thread their launch bounds size them for
  (``field_coop.cuh``: four blocks of 256 threads a SM, which ran faster
  than the uncapped build) they spill, 88, 144 and 296 bytes a thread on
  the H100 (``LOCAL_BYTES``).  That is an open fault, not a clean result:
  ``known_spills`` reports each as a known violation (the report's
  ``known``, printed apart from the clean count), and a new spill
  anywhere, or a larger one, is a violation.
- ``ring-plan`` (from ``pallas-ring-neighbor``).  ``ring_gather``'s hop
  schedule at n = 2, 4 and 8 shards, simulated: every hop comes from the
  sender's left neighbour's chunk it holds, fills a slot its right
  neighbour does not hold yet (each slot once), and every shard ends with
  all n slots; its neighbour map (shard s sends to s + 1 mod n) is the
  JAX ring's (``pallas_ring._right_neighbor``, held in the tests).

Not carried over: ``pallas-dma-unbalanced``.  The port has no remote DMA
and no semaphores: the ring hop is a kernel its issuer launches, ordered by
CUDA events, and the host walks above cover the copy's plan.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .report import Violation

RULE_RACE = "cuda-smem-race"
RULE_RESOURCES = "cuda-launch-resources"
RULE_RING = "ring-plan"

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(_HERE))
KDIR = os.path.join(REPO, "lodestar_tpu_torch", "ops", "kernels")
KDIR_REL = os.path.relpath(KDIR, REPO)
HOST_SOURCES = ("field.cuh", "field_coop.cuh", "tower_coop.cuh", "ring_hop.cuh", "host_shim.cpp")
HOST_DIR = os.path.join(REPO, "build", "lodestar_tpu_torch_host")

#: the cooperative row kernels and the schedule each runs (its header and
#: the struct or function whose stages it walks)
COOP = {
    "lad1": ("field_coop.cuh", "struct Lad1Stages"),
    "lad2": ("field_coop.cuh", "struct Lad2Stages"),
    "lad3": ("field_coop.cuh", "struct Lad3Stages"),
    "fq2pow16mul": ("field_coop.cuh", "struct Fq2Pow16MulStages"),
    "fq2mul": ("field_coop.cuh", "struct Fq2MulStages"),
    "pow16mul": ("field_coop.cuh", "struct Pow16MulStages"),
    "mul": ("field_coop.cuh", "struct MulStages"),
    "fq2sqr": ("field_coop.cuh", "struct Fq2SqrStages"),
    "fold": ("field_coop.cuh", "struct FoldStages"),
    "canon": ("field_coop.cuh", "LC_HD void canon_row("),
    "library_fq2_mul": ("field_coop.cuh", "struct LibFq2MulStages"),
    "tower_fq2_mul": ("tower_coop.cuh", "struct TowerFq2MulStages"),
    "tower_fq2_sqr": ("tower_coop.cuh", "struct TowerFq2SqrStages"),
    "tower_fq6_mul": ("tower_coop.cuh", "struct TowerFq6MulStages"),
    "tower_fq12_mul": ("tower_coop.cuh", "struct TowerFq12MulStages"),
}
#: rows that leave a partial last block for every rows-a-block count
PARTIAL_ROWS = 37
#: the host walks: each cooperative body at these row counts, in both
#: orders (the g++ flags of each)
WALK_ROWS = (8, PARTIAL_ROWS)
WALK_ORDERS = {"forward": [], "reversed": ["-DLC_HOST_REVERSED"]}
RING_SHARDS = (2, 4, 8)
SANITIZER_TOOLS = ("racecheck", "synccheck", "memcheck")
LOOSE_TOP = (1 << 22) - 1


# ---------------------------------------------------------------------------
# the host build of the block bodies (g++)
# ---------------------------------------------------------------------------


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ is not installed: the host build of the kernel bodies "
                           "cannot be made")
    return gxx


def host_build(flags: Sequence[str], mutation: Optional[Tuple[str, str, str]] = None) -> str:
    """``host_shim.cpp`` built with g++ and ``flags`` into ``build/``, keyed
    by the sources, the flags and ``mutation``: (header, text,
    replacement), applied to a copy of the sources in a temporary
    directory (``text`` must occur once in ``header``), for a mutant or a
    fixture's build."""
    gxx = _gxx()
    h = hashlib.sha256(" ".join(flags).encode() + repr(mutation).encode())
    for name in HOST_SOURCES:
        with open(os.path.join(KDIR, name), "rb") as f:
            h.update(f.read())
    os.makedirs(HOST_DIR, exist_ok=True)
    lib = os.path.join(HOST_DIR, f"host_shim_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    src_dir = KDIR
    if mutation is not None:
        src_dir = tempfile.mkdtemp(prefix="mutant_")
        for name in HOST_SOURCES:
            with open(os.path.join(KDIR, name), encoding="utf-8") as f:
                text = f.read()
            if name == mutation[0]:
                if text.count(mutation[1]) != 1:
                    shutil.rmtree(src_dir, ignore_errors=True)
                    raise ValueError(f"the mutation's text is not in {name} once")
                text = text.replace(mutation[1], mutation[2])
            with open(os.path.join(src_dir, name), "w", encoding="utf-8") as f:
                f.write(text)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([gxx, "-std=c++17", *flags, "-shared", "-fPIC", "-o", tmp,
                               os.path.join(src_dir, "host_shim.cpp")],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on host_shim.cpp {' '.join(flags)}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        if src_dir != KDIR:
            shutil.rmtree(src_dir, ignore_errors=True)
    return lib


def _definition_span(text: str, anchor: str) -> Tuple[int, int]:
    """[start, end) of the definition that starts at ``anchor``: to the
    brace that closes its first ``{`` (and a ``;`` after it)."""
    start = text.index(anchor)
    i = text.index("{", start)
    depth = 0
    while True:
        c = text[i]
        depth += c == "{"
        depth -= c == "}"
        i += 1
        if depth == 0:
            break
    if text[i:i + 1] == ";":
        i += 1
    return start, i


def definition_mutation(header: str, anchor: str, replacement: str) -> Tuple[str, str, str]:
    """``host_build``'s mutation that replaces the definition of ``header``
    starting at ``anchor`` (to its closing ``};`` or ``}``) by
    ``replacement``."""
    with open(os.path.join(KDIR, header), encoding="utf-8") as f:
        text = f.read()
    start, end = _definition_span(text, anchor)
    return header, text[start:end], replacement.strip()


def run_host(lib, name: str, ins) -> list:
    """Kernel ``name``'s block body from the host library on the CPU rows
    ``ins`` (outputs with one guard row, which must stay unwritten)."""
    import torch

    from ..ops import fused_core as fc

    k = fc.KERNELS[name]
    rows = ins[0].shape[0]
    outs = [torch.full((rows + 1,) + k.tail, -7.0) for _ in range(k.n_out)]
    ins_arr = (ctypes.c_void_p * 17)(*(t.data_ptr() for t in ins))  # null-terminated
    outs_arr = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in outs))
    fn = getattr(lib, f"host_{name}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(ins_arr, outs_arr, rows, fc._CONST_TABLE.ctypes.data) != 0:
        raise RuntimeError(f"host_{name} failed")
    if any(not bool((o[rows] == -7.0).all()) for o in outs):
        raise RuntimeError(f"host_{name} wrote past its last row")
    return [o[:rows] for o in outs]


def kernel_inputs(kernel, rows: int, rng: np.random.Generator, dev="cpu"):
    """Seeded inputs: loose digits up to 2^22 - 1 where the kernel folds on
    entry, semi-strict digits (<= 256) where it takes kernel outputs.  Row
    0 is random; rows 1-4, as many as there are, are zero, p, 2p and every
    digit at the bound (chip_smoke's and the host tests' inputs too)."""
    import torch

    from ..crypto.bls.fields import P
    from ..ops import limbs as fl

    out = []
    for i in range(kernel.n_in):
        top = LOOSE_TOP if i < kernel.loose_in else 256
        a = rng.integers(0, top + 1, size=(rows,) + kernel.tail).astype(np.float32)
        flat = a.reshape(rows, -1, 50)
        for r, edge in enumerate((0, fl.int_to_limbs(P), fl.int_to_limbs(2 * P), top)[: rows - 1]):
            flat[r + 1] = edge
        out.append(torch.from_numpy(a).to(dev))
    return out


def edge_inputs(kernel, rows: int, rng: np.random.Generator, dev="cpu"):
    """Seeded inputs at the digit bounds: every digit of row 0 at its
    input's bound (2^22 - 1 loose, 256 semi-strict), and in the other rows
    each digit at the bound or random, with even odds."""
    import torch

    out = []
    for i in range(kernel.n_in):
        top = LOOSE_TOP if i < kernel.loose_in else 256
        shape = (rows,) + kernel.tail
        a = rng.integers(0, top + 1, size=shape)
        a = np.where(rng.random(shape) < 0.5, top, a).astype(np.float32)
        a[0] = top
        out.append(torch.from_numpy(a).to(dev))
    return out


def schedule_site(name: str, text: Optional[str] = None) -> Tuple[str, int]:
    """(header path, line) of kernel ``name``'s schedule."""
    header, anchor = COOP[name]
    if text is None:
        with open(os.path.join(KDIR, header), encoding="utf-8") as f:
            text = f.read()
    return os.path.join(KDIR_REL, header), text[:text.index(anchor)].count("\n") + 1


def rows_off(lib, name: str, rows: int, seed: int, edge: bool = False) -> List[str]:
    """Kernel ``name``'s body from the host library against its plain
    version on ``rows`` rows from ``seed`` (``edge``: at the digit bounds):
    what is off (rows that differ, digits above 256)."""
    from ..ops import fused_core as fc

    k = fc.KERNELS[name]
    make = edge_inputs if edge else kernel_inputs
    ins = make(k, rows, np.random.default_rng(seed))
    got, want = run_host(lib, name, ins), k.plain(*ins)
    off = []
    diff = sum(int((g != w).reshape(rows, -1).any(1).sum()) for g, w in zip(got, want))
    if diff:
        off.append(f"{make.__name__}: {diff} of {rows} rows differ")
    if any(float(g.max()) > 256 for g in got):
        off.append(f"{make.__name__}: digits above 256")
    return off


def audit_host_walks(kernels: Sequence[str] = tuple(COOP), rows: Sequence[int] = WALK_ROWS,
                     orders: Sequence[str] = tuple(WALK_ORDERS),
                     mutation: Optional[Tuple[str, str, str]] = None,
                     mutation_path: Optional[str] = None) -> List[Violation]:
    """The host half of ``cuda-smem-race``: each cooperative body, walked
    in each of ``orders``, against its plain version on seeded rows (seed
    ``rows``) and digit-bound rows (seed ``rows + 1``) at each count of
    ``rows``.  ``tests/test_torch_kernel_host.py`` runs it one (kernel,
    rows, order) a case.  ``mutation`` (``host_build``'s, e.g. from
    ``definition_mutation``) builds the bodies from a changed copy (a
    fixture's schedule); a violation of the kernel whose schedule the
    replacement defines is reported at that line of ``mutation_path``."""
    from ..ops import fused_ladder, library_fuse, tower_kernels  # noqa: F401 - the kernels

    libs = {order: ctypes.CDLL(host_build(["-O2"] + WALK_ORDERS[order], mutation))
            for order in orders}
    out: List[Violation] = []
    for name in kernels:
        bad = [f"{order} walk at {n} rows, {what}" for order, lib in libs.items()
               for n in rows for edge in (False, True)
               for what in rows_off(lib, name, n, n + edge, edge)]
        if not bad:
            continue
        anchor = COOP[name][1]
        if mutation is not None and mutation_path is not None and anchor in mutation[2]:
            path, line = mutation_path, mutation[2][:mutation[2].index(anchor)].count("\n") + 1
        else:
            path, line = schedule_site(name)
        out.append(Violation(
            RULE_RACE, path, line,
            f"{name}: the cooperative body differs from its plain version ({'; '.join(bad)}): "
            f"a step reads what another lane, warp or row writes in the same step or stage"))
    return out


# ---------------------------------------------------------------------------
# the card: compute-sanitizer over a child that launches every kernel
# ---------------------------------------------------------------------------


def find_sanitizer() -> Optional[str]:
    """compute-sanitizer of the card's CUDA toolkit, or None."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "compute-sanitizer"),
                 os.path.join(home, "extras", "compute-sanitizer", "compute-sanitizer"),
                 shutil.which("compute-sanitizer")):
        if cand and os.path.exists(cand):
            return cand
    return None


def sanitizer_version(path: str) -> str:
    out = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("Version")]
    return lines[0] if lines else out.stdout.strip().splitlines()[-1]


def launch_all(rows: int = PARTIAL_ROWS) -> Dict[str, dict]:
    """Every one of the sixteen kernels launched once on the card at
    ``rows`` rows (the ring hop on a chunk of ``rows`` floats), synchronized
    and held bitwise against its plain version: {name: {rows, max_abs_err}}.
    Raises on a failed launch or a difference."""
    import torch

    from ..ops import fused_core as fc
    from ..ops import fused_ladder, library_fuse, tower_kernels  # noqa: F401 - the kernels
    from ..ops import ring_gather

    dev = torch.device("cuda", 0)
    out = {}
    rng = np.random.default_rng(rows)
    for name, k in sorted(fc.KERNELS.items()):
        ins = kernel_inputs(k, rows, rng, dev)
        got = k(*ins)
        torch.cuda.synchronize(dev)
        want = k.plain(*(x.cpu() for x in ins))
        err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        if err != 0:
            raise RuntimeError(f"{name}: {rows} rows differ from the plain version by {err}")
        out[name] = {"rows": rows, "max_abs_err": err}
    src = torch.from_numpy(rng.standard_normal(rows).astype(np.float32)).to(dev)
    dst = torch.full((rows,), -7.0, device=dev)
    ring_gather.launch_hop(src, dst, torch.cuda.current_stream(dev))
    torch.cuda.synchronize(dev)
    err = float((dst - src).abs().max())
    if err != 0:
        raise RuntimeError(f"ring_hop: {rows} floats differ from copy_ by {err}")
    out["ring_hop"] = {"rows": rows, "max_abs_err": err}
    return out


_SUMMARY = re.compile(r"(ERROR|RACECHECK|SYNCCHECK) SUMMARY: (\d+) (?:error|hazard)", re.I)


def run_sanitizer(path: str, tool: str, rows: int = PARTIAL_ROWS,
                  timeout: float = 600) -> dict:
    """``tool`` over the child that launches every kernel: {tool, status
    ("clean", "found", "unsupported", "failed"), errors, rc, tail}."""
    cmd = [path, "--tool", tool, "--error-exitcode", "99"]
    if tool == "racecheck":
        cmd += ["--racecheck-report", "all"]
    cmd += [sys.executable, "-m", "lodestar_tpu_torch.analysis.kernel_audit", "--launch-all",
            str(rows)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    text = proc.stdout + proc.stderr
    errors = sum(int(m.group(2)) for m in _SUMMARY.finditer(text))
    if "Device not supported" in text:
        status = "unsupported"
    elif proc.returncode == 0 and errors == 0 and "launched" in proc.stdout:
        status = "clean"
    elif errors:
        status = "found"
    else:
        status = "failed"
    return {"tool": tool, "status": status, "errors": errors, "rc": proc.returncode,
            "tail": text[-2000:]}


def audit_sanitizers(tools: Sequence[str] = SANITIZER_TOOLS,
                     rows: int = PARTIAL_ROWS) -> Tuple[List[Violation], dict]:
    """The card half of ``cuda-smem-race``: violations, and a report of the
    sanitizer (path, version, each tool's status; ``carried`` False when
    the toolkit has none, ``supported`` False when it refuses the
    device; then the child runs without it, and must pass)."""
    path = find_sanitizer()
    report = {"path": path, "carried": path is not None, "supported": None, "tools": {}}
    out: List[Violation] = []
    report["version"] = sanitizer_version(path) if path else None
    for tool in tools if path else ():
        res = run_sanitizer(path, tool, rows)
        report["tools"][tool] = {k: v for k, v in res.items() if k != "tail"}
        if res["status"] == "unsupported":
            report["supported"] = False
            report["message"] = next((ln.strip("= ") for ln in res["tail"].splitlines()
                                      if "Device not supported" in ln), "Device not supported")
            break
        report["supported"] = True
        if res["status"] != "clean":
            out.append(Violation(RULE_RACE, f"compute-sanitizer:{tool}", 0,
                                 f"{tool} over the sixteen kernels at {rows} rows: "
                                 f"{res['status']} ({res['errors']} errors, rc {res['rc']}): "
                                 f"{res['tail'][-600:]}"))
    if not report["supported"]:
        # the half is left out; the child it would have watched still runs
        proc = subprocess.run([sys.executable, "-m", "lodestar_tpu_torch.analysis.kernel_audit",
                               "--launch-all", str(rows)], capture_output=True, text=True,
                              timeout=600, cwd=REPO)
        report["child"] = (proc.stdout.strip().splitlines() or [""])[-1]
        if proc.returncode != 0:
            out.append(Violation(RULE_RACE, "launch-all", 0,
                                 f"the child that launches every kernel failed (rc "
                                 f"{proc.returncode}): {proc.stderr[-600:]}"))
    return out, report


# ---------------------------------------------------------------------------
# cuda-launch-resources
# ---------------------------------------------------------------------------

ATTRS = ("registers", "local_bytes", "static_shared_bytes", "max_threads", "max_dynamic_shared")
#: the known violations of "no spill": the ladder kernels' measured local
#: bytes a thread at their 64-register cap (chip_smoke phase 16, NVIDIA
#: H100 80GB HBM3, CUDA 12.8); reported by ``known_spills``, and a spill
#: above these, or in any other kernel, is a violation
LOCAL_BYTES = {"lad1": 88, "lad2": 144, "lad3": 296}


def _attrs(fn, *args) -> Dict[str, int]:
    buf = (ctypes.c_int * 5)()
    rc = fn(*args, buf)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {rc}")
    return dict(zip(ATTRS, list(buf)))


def launch_resources(lib=None) -> List[dict]:
    """Each kernel's function attributes beside its launch configuration
    (the ring hop's three instances as ``ring_hop[variant]``)."""
    import torch

    from ..ops.kernels import _build

    lib = lib if lib is not None else _build.load()
    optin = int(torch.cuda.get_device_properties(0).shared_memory_per_block_optin)
    rows = []
    ptr = ctypes.POINTER(ctypes.c_int)
    for name, src in _build.LAUNCHERS.items():
        if name == "ring_hop":
            continue
        fn = getattr(lib, f"attrs_{name}")
        fn.argtypes, fn.restype = [ptr], ctypes.c_int
        a = _attrs(fn)
        for q in ("smem_bytes", "threads_per_block", "rows_per_block"):
            getattr(lib, f"{q}_{name}").restype = ctypes.c_int
        rows.append({"name": name, "source": src, **a,
                     "threads": lib[f"threads_per_block_{name}"](),
                     "dynamic_shared_bytes": lib[f"smem_bytes_{name}"](),
                     "rows_per_block": lib[f"rows_per_block_{name}"](), "optin": optin})
    lib.attrs_ring_hop.argtypes, lib.attrs_ring_hop.restype = [ctypes.c_int, ptr], ctypes.c_int
    lib.ring_hop_threads.restype = ctypes.c_int
    for variant in range(3):
        a = _attrs(lib.attrs_ring_hop, variant)
        rows.append({"name": f"ring_hop[{variant}]", "source": _build.LAUNCHERS["ring_hop"], **a,
                     "threads": lib.ring_hop_threads(), "dynamic_shared_bytes": 0,
                     "rows_per_block": 0, "optin": optin})
    return rows


def _resource_site(r: dict) -> str:
    return os.path.join(KDIR_REL, "launchers.cuh" if not r["name"].startswith("ring_hop")
                        else r["source"])


def known_spills(rows: Sequence[dict]) -> List[Violation]:
    """The known violations of "no spill": each kernel that spills no more
    than its ``LOCAL_BYTES`` count (more is ``check_resources``')."""
    return [Violation(RULE_RESOURCES, _resource_site(r), 0,
                      f"{r['name']}: {r['local_bytes']} local (spill) bytes a thread "
                      f"({r['registers']} registers a thread): a known violation of "
                      f"'no spill', held at its measured {LOCAL_BYTES[r['name']]}")
            for r in rows if 0 < r["local_bytes"] <= LOCAL_BYTES.get(r["name"], 0)]


def check_resources(rows: Sequence[dict]) -> List[Violation]:
    out = []
    for r in rows:
        where = _resource_site(r)
        problems = []
        budget = LOCAL_BYTES.get(r["name"], 0)
        if r["local_bytes"] > budget:
            problems.append(f"{r['local_bytes']} local (spill) bytes a thread, above its "
                            f"{budget}")
        if r["threads"] > r["max_threads"]:
            problems.append(f"a block of {r['threads']} threads above its most, "
                            f"{r['max_threads']}")
        shared = r["dynamic_shared_bytes"] + r["static_shared_bytes"]
        if shared > r["optin"]:
            problems.append(f"{shared} shared bytes a block above the card's opt-in limit "
                            f"{r['optin']}")
        if problems:
            out.append(Violation(RULE_RESOURCES, where, 0,
                                 f"{r['name']}: {'; '.join(problems)} ({r['registers']} "
                                 f"registers a thread)"))
    return out


# ---------------------------------------------------------------------------
# ring-plan
# ---------------------------------------------------------------------------


def ring_neighbors(n: int) -> Dict[int, int]:
    """The receiver of each shard's hops in ``ring_gather``'s schedule."""
    from ..ops import ring_gather

    out: Dict[int, set] = {}
    for _k, s, _slot in ring_gather.hop_order(n):
        out.setdefault(s, set()).add((s + 1) % n)
    return {s: min(r) if len(r) == 1 else -1 for s, r in out.items()}


def check_ring_plan(n: int, hops=None) -> List[Violation]:
    """``hop_order(n)`` (or ``hops``: (k, sender, slot) triples) simulated:
    each shard starts with its own slot; a hop sends a slot its sender
    holds to the right neighbour, which must not hold it yet; every shard
    ends with all n."""
    from ..ops import ring_gather

    hops = ring_gather.hop_order(n) if hops is None else hops
    where = os.path.join("lodestar_tpu_torch", "ops", "ring_gather.py")
    held = [{s} for s in range(n)]
    problems = []
    for k, s, slot in hops:
        right = (s + 1) % n
        if right == s:
            problems.append(f"hop {k}: shard {s} sends to itself")
        if slot not in held[s]:
            problems.append(f"hop {k}: shard {s} sends slot {slot}, which it does not hold")
        if slot in held[right]:
            problems.append(f"hop {k}: shard {right} receives slot {slot} a second time")
        held[right].add(slot)
    for s in range(n):
        if held[s] != set(range(n)):
            problems.append(f"shard {s} ends without slots {sorted(set(range(n)) - held[s])}")
    if len(hops) != n * (n - 1):
        problems.append(f"{len(hops)} hops, not n (n - 1) = {n * (n - 1)}")
    return [Violation(RULE_RING, where, 0, f"n={n}: {p}") for p in problems]


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def audit_kernels(device: str = "cpu", report: Optional[dict] = None,
                  host_walks: bool = True) -> List[Violation]:
    """The kernel audit: ``ring-plan`` and (``host_walks``) the host walks
    always; with ``device="cuda"`` the launch resources and the sanitizer
    tools on the card.  ``report`` (when given) receives the resources,
    the sanitizer's report and the known violations (``known``)."""
    out: List[Violation] = []
    for n in RING_SHARDS:
        out += check_ring_plan(n)
    if host_walks:
        out += audit_host_walks()
    if device == "cuda":
        rows = launch_resources()
        out += check_resources(rows)
        found, san = audit_sanitizers()
        out += found
        if report is not None:
            report["resources"] = rows
            report["sanitizer"] = san
            report.setdefault("known", []).extend(known_spills(rows))
    return out


def _child(argv: Sequence[str]) -> int:
    """The sanitizer's child: ``--launch-all ROWS``."""
    if len(argv) != 2 or argv[0] != "--launch-all":
        print("usage: python -m lodestar_tpu_torch.analysis.kernel_audit --launch-all ROWS",
              file=sys.stderr)
        return 2
    res = launch_all(int(argv[1]))
    print(f"launched {len(res)} kernels at {argv[1]} rows, each equal to its plain version")
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]))
