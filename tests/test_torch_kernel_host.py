"""The CUDA kernels' row arithmetic, built for the CPU.

field_coop.cuh holds the cooperative block bodies of lad1, lad2, lad3,
fq2pow16mul, fq2mul, pow16mul, mul, fq2sqr, fold, canon and the library
kernel library_fq2_mul as __host__ __device__ functions, tower_coop.cuh
those of the four tower kernels (one warp per step; one row a block, or
several for fq2mul, pow16mul, mul, fq2sqr, fold, canon, tower_fq2_mul,
tower_fq2_sqr and library_fq2_mul), whose blocks, rows, warps and lanes
the host build walks in turn, and ring_hop.cuh the ring hop's plan and
per-thread body; ops/kernels/host_shim.cpp wraps them in a plain C
interface.  Here g++ builds that shim (into build/, keyed by the sources'
hash) and the fifteen row bodies are held bitwise against the plain
PyTorch versions, also with their lanes and warps walked in the reverse
order (-DLC_HOST_REVERSED) and on inputs at the digit bounds, canon also
at the edges of its branches (and two broken copies of its ripple must
fail those checks, as must the tower Karatsuba built with the fused
path's finish or product, the tower Fq2 square built with the fused
path's product, and the library kernel built with the fused path's
subtraction or product); the hop, its grid's threads walked both ways,
against copy_ at every tested length and pointer offset.  This checks the
arithmetic the kernels run, not the kernels: the launches are checked on
the card by chip_smoke.py and the cuda-marked tests.

The same bodies, built with every heavy step inlined (the layout of the
first, one-thread kernels that ptxas -O2 and -O3 miscompiled on the card,
tests/kernel_build_variants.py) and without, run here under
AddressSanitizer and UndefinedBehaviorSanitizer: the source reads no
memory out of bounds and overflows no int."""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
from lodestar_tpu_torch.ops import fused_core as fc
from lodestar_tpu_torch.ops import fused_ladder  # noqa: F401 - registers lad1..3
from lodestar_tpu_torch.ops import library_fuse  # noqa: F401 - registers library_fq2_mul
from lodestar_tpu_torch.ops import tower_kernels  # noqa: F401 - registers the tower kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KDIR = os.path.join(REPO, "lodestar_tpu_torch", "ops", "kernels")
ROWS = 8


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel rows cannot be made")
    return gxx


HOST_SOURCES = ("field.cuh", "field_coop.cuh", "tower_coop.cuh", "ring_hop.cuh", "host_shim.cpp")


def _host_build(flags, mutation=None) -> str:
    """host_shim.cpp built with g++ and flags into build/, keyed by the
    sources, the flags and ``mutation``: (file, text, replacement), applied
    to a copy of the sources in a temporary directory, for a mutant build."""
    gxx = _gxx()
    h = hashlib.sha256(" ".join(flags).encode() + repr(mutation).encode())
    for name in HOST_SOURCES:
        with open(os.path.join(KDIR, name), "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(REPO, "build", "lodestar_tpu_torch_host")
    os.makedirs(out_dir, exist_ok=True)
    key = h.hexdigest()[:16]
    lib = os.path.join(out_dir, f"host_shim_{key}.so")
    if not os.path.exists(lib):
        src_dir = KDIR
        if mutation is not None:
            src_dir = tempfile.mkdtemp(prefix="mutant_")
            for name in HOST_SOURCES:
                with open(os.path.join(KDIR, name), encoding="utf-8") as f:
                    text = f.read()
                if name == mutation[0]:
                    assert text.count(mutation[1]) == 1, f"the mutation's text is not in {name} once"
                    text = text.replace(mutation[1], mutation[2])
                with open(os.path.join(src_dir, name), "w", encoding="utf-8") as f:
                    f.write(text)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(
            [gxx, "-std=c++17", *flags, "-shared", "-fPIC", "-o", tmp,
             os.path.join(src_dir, "host_shim.cpp")],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, lib)
        if src_dir != KDIR:
            shutil.rmtree(src_dir)
    return lib


COOP = chip_smoke.COOP  # the cooperative bodies of field_coop.cuh and tower_coop.cuh
PARTIAL_ROWS = 37  # rows that leave a partial last block for every rows-a-block count


def run_host(lib, name: str, ins) -> list:
    """Kernel ``name``'s row body from the host library on the CPU rows
    ``ins``; each output has one guard row past the last, which must stay
    unwritten.  Returns the outputs' rows."""
    k = fc.KERNELS[name]
    rows = ins[0].shape[0]
    outs = [torch.full((rows + 1,) + k.tail, -7.0) for _ in range(k.n_out)]
    ins_arr = (ctypes.c_void_p * 17)(*(t.data_ptr() for t in ins))  # null-terminated
    outs_arr = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in outs))
    fn = getattr(lib, f"host_{name}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    assert fn(ins_arr, outs_arr, rows, fc._CONST_TABLE.ctypes.data) == 0
    for got in outs:
        assert bool((got[rows] == -7.0).all()), f"{name} wrote past its last row"
    return [got[:rows] for got in outs]


def run_rows(lib, name: str, rows: int, seed: int, edge: bool = False) -> None:
    """Kernel ``name``'s row body from the host library against its plain
    version on ``rows`` seeded rows (``edge``: rows at the digit bounds)."""
    k = fc.KERNELS[name]
    rng = np.random.default_rng(seed)
    ins = (chip_smoke.edge_inputs if edge else chip_smoke.kernel_inputs)(k, rows, rng, "cpu")
    for got, want in zip(run_host(lib, name, ins), k.plain(*ins)):
        assert torch.equal(got, want), name
        assert float(got.max()) <= 256


@pytest.fixture(scope="module")
def host_lib():
    return ctypes.CDLL(_host_build(["-O2"]))


@pytest.fixture(scope="module")
def host_lib_reversed():
    return ctypes.CDLL(_host_build(["-O2", "-DLC_HOST_REVERSED"]))


@pytest.mark.parametrize("name", sorted(fc.KERNELS))
def test_host_built_row_body_equals_plain_version_bitwise(name, host_lib):
    run_rows(host_lib, name, ROWS, 7)


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("rows", [ROWS, PARTIAL_ROWS])
@pytest.mark.parametrize("name", COOP)
def test_cooperative_ladder_bodies_equal_plain_versions_bitwise(name, rows, order, host_lib,
                                                               host_lib_reversed):
    """The cooperative bodies one step a warp, blocks, rows, lanes and
    warps walked forwards and backwards: a lane reading what another lane
    writes in the same step, or a warp what another warp (of its row or of
    another row) writes in the same stage, would differ."""
    lib = host_lib if order == "forward" else host_lib_reversed
    run_rows(lib, name, rows, rows)
    run_rows(lib, name, rows, rows + 1, edge=True)


@pytest.mark.parametrize("name", COOP)
def test_cooperative_bodies_mask_the_last_blocks_missing_rows(name, host_lib, host_lib_reversed):
    """A kernel of several rows a block runs ceil(n / R) blocks, the last
    one's missing rows on zeros and unstored: at one row (R - 1 rows
    missing) and at PARTIAL_ROWS, which leaves a partial last block for the
    build's R, in both walk orders, the rows equal the plain version and
    nothing past them is written."""
    per_block = getattr(host_lib, f"host_rows_per_block_{name}")()
    assert per_block == 1 or PARTIAL_ROWS % per_block != 0, per_block
    for lib in (host_lib, host_lib_reversed):
        assert getattr(lib, f"host_rows_per_block_{name}")() == per_block
        for rows in (1, PARTIAL_ROWS):
            run_rows(lib, name, rows, 3 * rows)
            run_rows(lib, name, rows, 3 * rows + 1, edge=True)


def test_cooperative_steps_are_calls_and_keep_no_local_arrays():
    """field_coop.cuh keeps its two heavy steps, the digit product and the
    fold, out of line (inlined into every stage they made a body of 128
    registers with spills), inlines the rest, and holds every digit in
    shared memory: its only arrays, and tower_coop.cuh's, are the rows'
    layouts, each a template over its warp count, and the Fq6 product's
    work arrays that two of those layouts hold.  The kernels of
    fused_kernels.cu, tower_kernels.cu and library_kernels.cu run their
    block bodies, field.cuh holds no row body, and no kernel is launched
    one thread a row."""
    src = open(os.path.join(KDIR, "field_coop.cuh"), encoding="utf-8").read()
    assert re.search(r"^#define LC_STEP static __host__ __device__ __noinline__$", src, re.M)
    for step in ("fold", "mul"):
        assert re.search(rf"^LC_STEP void {step}\(", src, re.M), step
    block = r"^template <template <int> class Row, int NW, int R>\nstruct Block : Warps<NW, R> \{\n.*?^\};"
    assert len(re.findall(block, src, re.M | re.S)) == 1
    # the row layouts (inputs first), each a template over its warp count
    layout = r"^template <int NW>\nstruct (\w+) \{\n  int in\[.*?^\};"
    # the layouts and the work arrays they share (a struct of arrays)
    shared = r"^(?:template <int NW>\n)?struct (\w+) \{\n  int \w+\[.*?^\};"
    tower = open(os.path.join(KDIR, "tower_coop.cuh"), encoding="utf-8").read()
    assert '#include "field_coop.cuh"' in tower and "LC_STEP" not in tower
    fused_layouts = ["Lad1", "Lad2", "Lad3", "Fq2Pow16Mul", "Fq2Mul", "Pow16Mul", "Mul", "Fq2Sqr",
                     "Fold", "Canon", "LibFq2Mul"]
    tower_layouts = ["TowerFq2Mul", "TowerFq2Sqr", "TowerFq6Mul", "TowerFq12Mul"]
    for text, want, want_shared in (
            (src, fused_layouts, fused_layouts),
            (tower, tower_layouts, ["TowerFq2Mul", "TowerFq2Sqr", "TowerFq6", "TowerFq6Mul",
                                    "TowerFq12Mul"])):
        assert re.findall(layout, text, re.M | re.S) == want
        assert re.findall(shared, text, re.M | re.S) == want_shared
        rest = re.sub(shared, "", re.sub(block, "", text, flags=re.M | re.S), flags=re.M | re.S)
        code = re.sub(r"//[^\n]*", "", rest)
        assert not re.search(r"\bint\s+\w+\s*\[", code), "an array outside the shared layouts"
    from lodestar_tpu_torch.ops.kernels import _build

    for name in ("field_coop.cuh", "tower_coop.cuh", "launchers.cuh"):
        assert name in _build.SOURCES, name  # an edit rebuilds the kernels
    launchers = open(os.path.join(KDIR, "launchers.cuh"), encoding="utf-8").read()
    assert "lfc::block_##NAME(" in launchers and "extern __shared__" in launchers
    assert "LF_LAUNCHER" not in launchers and launchers.count("<<<") == 1
    row_bodies = open(os.path.join(KDIR, "field.cuh"), encoding="utf-8").read()
    assert "row_" not in row_bodies and "__global__" not in row_bodies
    header = {"fused_kernels.cu": "field_coop.cuh", "tower_kernels.cu": "tower_coop.cuh",
              "library_kernels.cu": "field_coop.cuh"}
    assert sorted(COOP) == sorted(fc.KERNELS)
    for name in COOP:
        kernels = open(os.path.join(KDIR, _build.LAUNCHERS[name]), encoding="utf-8").read()
        assert '#include "launchers.cuh"' in kernels
        body = kernels[kernels.index(f"#ifdef LF_KERNEL_{name}"):]
        body = body[:body.index("#endif")]
        assert f'#include "{header[_build.LAUNCHERS[name]]}"' in body
        assert f"LF_COOP_KERNEL({name}, " in body
        assert f"lf::row_{name}" not in body and f"row_{name}(" not in row_bodies


def test_heavy_steps_are_real_calls_in_the_kernels_build():
    """ptxas -O2/-O3 miscompiled the kernels when every step was inlined,
    so the steps that make a kernel big stay out-of-line calls by default;
    only -DLF_INLINE_ALL (a variant build) inlines them."""
    src = open(os.path.join(KDIR, "field_coop.cuh"), encoding="utf-8").read()
    assert re.search(r"#ifdef LF_INLINE_ALL[^\n]*\n#define LC_STEP LC_HD\n#else\n"
                     r"#define LC_STEP static __host__ __device__ __noinline__\n#endif\n", src)
    for step in ("fold", "mul"):
        assert re.search(rf"^LC_STEP void {step}\(", src, re.M), step


@pytest.mark.parametrize("layout", ["calls", "inlined", "reversed"])
def test_host_build_is_clean_under_address_and_undefined_behaviour_sanitizers(layout):
    gxx = _gxx()
    runtimes = [subprocess.run([gxx, f"-print-file-name={so}"], capture_output=True,
                               text=True).stdout.strip() for so in ("libasan.so", "libubsan.so")]
    if not all(os.path.isabs(r) for r in runtimes):
        pytest.skip("g++ has no sanitizer runtimes")
    flags = ["-O3", "-fsanitize=address,undefined", "-fno-sanitize-recover=all"]
    extra = {"calls": [], "inlined": ["-DLF_INLINE_ALL"], "reversed": ["-DLC_HOST_REVERSED"]}
    lib = _host_build(flags + extra[layout])
    code = (
        "import ctypes, sys\n"
        "sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import test_torch_kernel_host as t\n"
        "lib = ctypes.CDLL(sys.argv[3])\n"
        "for name in sorted(t.fc.KERNELS):\n"
        "    t.run_rows(lib, name, 64, 11)\n"
        "for name in t.COOP:\n"
        "    t.run_rows(lib, name, 37, 12, edge=True)\n"
        "print('clean')\n"
    )
    env = dict(os.environ, LD_PRELOAD=" ".join(runtimes),
               ASAN_OPTIONS="detect_leaks=0:halt_on_error=1")
    proc = subprocess.run([sys.executable, "-c", code, REPO, os.path.dirname(__file__), lib],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-4000:]


# -- canon at the edges of its branches ----------------------------------------

CANON_EDGES = chip_smoke.CANON_EDGES


def _value(row) -> int:
    return sum(int(d) << (8 * i) for i, d in enumerate(row))


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("case", CANON_EDGES)
def test_canon_body_at_its_branch_edges_equals_plain_version_and_the_oracle(case, order, host_lib,
                                                                            host_lib_reversed):
    """canon's cooperative body, both walk orders, on inputs at the edges
    of its branches: bitwise the plain version's digits, and those are the
    oracle's canonical residue."""
    from lodestar_tpu_torch.crypto.bls.fields import P
    from lodestar_tpu_torch.ops import limbs as fl

    lib = host_lib if order == "forward" else host_lib_reversed
    x = chip_smoke.canon_edge_rows(case, CANON_EDGES.index(case))
    (got,) = run_host(lib, "canon", [x])
    (want,) = fc.K_CANON.plain(x)
    assert torch.equal(got, want), case
    oracle = np.stack([fl.int_to_limbs(_value(r) % P) for r in x.to(torch.int64).tolist()])
    np.testing.assert_array_equal(want.numpy(), oracle.astype(np.float32))


# a ripple that skips its carry passes, and one that drops the prefix (each
# pair's carry in only from the generate of the pair below)
RIPPLE_MUTANTS = {
    "skips-the-carry-passes": ("field_coop.cuh",
                               "PASSES = lf::carry_passes(BITS);\n  static_assert(W <= RB - RA",
                               "PASSES = 0;\n  static_assert(W <= RB - RA"),
    "drops-the-prefix": ("field_coop.cuh", "const unsigned c = (gp + g) ^ gp ^ g;",
                         "const unsigned c = g << 1;"),
}


@pytest.mark.parametrize("mutant", sorted(RIPPLE_MUTANTS))
def test_host_test_catches_a_broken_ripple(mutant):
    """The checks above fail a canon whose exact ripple is broken: built
    from a copy of the sources with the mutation, its body differs from the
    plain version on the seeded, digit-bound or branch-edge rows."""
    lib = ctypes.CDLL(_host_build(["-O2"], RIPPLE_MUTANTS[mutant]))
    k = fc.K_CANON
    rng = np.random.default_rng(5)
    inputs = [chip_smoke.kernel_inputs(k, PARTIAL_ROWS, rng, "cpu")[0],
              chip_smoke.edge_inputs(k, PARTIAL_ROWS, rng, "cpu")[0],
              *(chip_smoke.canon_edge_rows(case, 0) for case in CANON_EDGES)]
    differ = sum(int((run_host(lib, "canon", [x])[0] != k.plain(x)[0]).any(dim=1).sum())
                 for x in inputs)
    assert differ > 0, f"the mutant {mutant} passed the host checks"


# the tower Karatsuba with the fused path's digit algorithm in place of
# pallas_tower's: out1 = t2 - (t0 + t1) folded once (fq2mul_finish's
# sub_sum), and t2 the product of the unfolded sums (fq2mul_products); the
# tower Fq2 square with out0 the product of the unfolded sum a0 + a1 and d
# (fq2sqr_finish's)
TOWER_MUTANTS = {
    "sub-sum-finish": ("tower_coop.cuh", "t_fold<13>(c, sub(t + 2 * NL, s + 2 * NL), out + NL);",
                       "t_fold<13>(c, sub_sum(t + 2 * NL, t, t + NL), out + NL);"),
    "unfolded-sums": ("tower_coop.cuh", "t_mul(c, s, nullptr, s + NL, nullptr, t + 2 * NL);",
                      "t_mul(c, a, a + NL, b, b + NL, t + 2 * NL);"),
    "unfolded-square-sum": ("tower_coop.cuh", "t_mul(c, r.sd, nullptr, r.sd + NL, nullptr, r.out);",
                            "t_mul(c, a, a + NL, r.sd + NL, nullptr, r.out);"),
}
# The sub_sum finish gives out1 the same value mod p; its digits differ
# only where the value lands across a multiple of 2^392 - RED[0], rare in
# the Fq2 product, and in the Fq12 product the folds after each Karatsuba
# absorb even that: so it is held on 8,192 rows, on the Fq2 product.  The
# unfolded sums differ from the folded ones as integers in almost every
# row (the fold moves digit 49 of a0 + a1 through the RED rows), so their
# products are caught on PARTIAL_ROWS, the Fq2 square's too.
TOWER_MUTANT_CASES = [("sub-sum-finish", "tower_fq2_mul", 8192),
                      ("unfolded-sums", "tower_fq2_mul", PARTIAL_ROWS),
                      ("unfolded-sums", "tower_fq6_mul", PARTIAL_ROWS),
                      ("unfolded-sums", "tower_fq12_mul", PARTIAL_ROWS),
                      ("unfolded-square-sum", "tower_fq2_sqr", PARTIAL_ROWS)]

# the library kernel with the fused path's steps in place of the limbs
# library's: out0 through m_sub (the 50-digit bias-2^12 pad, 51 columns
# and 2 passes at bound 13) in place of limbs.fp_sub (the width-51 pad, 53
# columns and 3 passes at bound 24), and t2 the product of the unfolded
# sums a0 + a1 and b0 + b1 (fq2mul_products') in place of the strict ones
LIBRARY_MUTANTS = {
    "fused-sub": ("field_coop.cuh",
                  "t_fold<24, NL + 1>(c, limbs_sub(r.t, r.t + NL, nullptr), r.out);",
                  "t_fold<13>(c, sub(r.t, r.t + NL), r.out);"),
    "unfolded-sums": ("field_coop.cuh",
                      "t_mul(c, r.s, nullptr, r.s + NL, nullptr, r.t + 2 * NL);",
                      "t_mul(c, a, a + NL, b, b + NL, r.t + 2 * NL);"),
}
# The fused subtraction gives out0 the same value mod p in other digits on
# seeded rows, and the unfolded sums differ as integers from the strict
# ones in almost every row: both are caught on PARTIAL_ROWS.
LIBRARY_MUTANT_CASES = [("fused-sub", PARTIAL_ROWS), ("unfolded-sums", PARTIAL_ROWS)]


def _mutant_rows_differ(mutation, name: str, rows: int) -> int:
    """Rows of kernel ``name``, built from a copy of the sources with the
    mutation, that differ from the plain version on ``rows`` seeded and
    ``rows`` digit-bound rows."""
    lib = ctypes.CDLL(_host_build(["-O2"], mutation))
    k = fc.KERNELS[name]
    rng = np.random.default_rng(9)
    differ = 0
    for make in (chip_smoke.kernel_inputs, chip_smoke.edge_inputs):
        ins = make(k, rows, rng, "cpu")
        differ += sum(int((g != w).reshape(rows, -1).any(1).sum())
                      for g, w in zip(run_host(lib, name, ins), k.plain(*ins)))
    return differ


@pytest.mark.parametrize("mutant, name, rows", TOWER_MUTANT_CASES)
def test_host_test_catches_the_fused_paths_karatsuba_in_the_tower_kernels(mutant, name, rows):
    """The tower kernels' digits are pallas_tower's: a Karatsuba built
    from a copy of the sources with the fused path's finish or product
    (the same value mod p in other digits) differs from the plain version
    on seeded and digit-bound rows."""
    differ = _mutant_rows_differ(TOWER_MUTANTS[mutant], name, rows)
    assert differ > 0, f"the mutant {mutant} of {name} passed the host checks"


@pytest.mark.parametrize("mutant, rows", LIBRARY_MUTANT_CASES)
def test_host_test_catches_the_fused_paths_steps_in_the_library_kernel(mutant, rows):
    """The library kernel's digits are the JAX limbs library's: built from
    a copy of the sources with the fused path's subtraction or Karatsuba
    product (the same value mod p in other digits), it differs from the
    plain version on seeded and digit-bound rows."""
    differ = _mutant_rows_differ(LIBRARY_MUTANTS[mutant], "library_fq2_mul", rows)
    assert differ > 0, f"the mutant {mutant} of library_fq2_mul passed the host checks"


# -- the ring hop ------------------------------------------------------------------

RING_LENGTHS = chip_smoke.HOP_LENGTHS
RING_OFFSETS = chip_smoke.HOP_OFFSETS  # bytes past a 16-byte boundary


def _aligned(buf: torch.Tensor, offset: int, n: int):
    """n floats of buf starting ``offset`` bytes past a 16-byte boundary,
    and their address (an empty view has none of its own)."""
    start = (-buf.data_ptr() % 16 + offset) // 4
    ptr = buf.data_ptr() + 4 * start
    assert ptr % 16 == offset
    return buf[start:start + n], ptr


def _host_hop(lib, src: int, dst: int, n: int) -> int:
    fn = lib.host_ring_hop
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return fn(src, dst, n)


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("dst_offset", RING_OFFSETS)
@pytest.mark.parametrize("src_offset", RING_OFFSETS)
def test_host_built_ring_hop_equals_copy_at_every_length_and_offset(src_offset, dst_offset, order,
                                                                    host_lib, host_lib_reversed):
    """ring_hop_k's plan and per-thread body, its grid's threads walked
    forwards and backwards, against ``copy_``: chunks of 0-40 floats, and
    of 600, 1,027 and 4,099 (more than one block or one item a thread), at
    pointers 0, 4, 8 and 12 bytes past a 16-byte boundary; float4 items
    exactly when both pointers are 16-byte aligned, nothing written
    outside the chunk."""
    lib = host_lib if order == "forward" else host_lib_reversed
    rng = np.random.default_rng(16 * src_offset + dst_offset)
    for n in RING_LENGTHS:
        src_buf = torch.from_numpy(rng.standard_normal(n + 8).astype(np.float32))
        dst_buf, want_buf = torch.full((n + 8,), -7.0), torch.full((n + 8,), -7.0)
        src, src_ptr = _aligned(src_buf, src_offset, n)
        nvec = _host_hop(lib, src_ptr, _aligned(dst_buf, dst_offset, n)[1], n)
        _aligned(want_buf, dst_offset, n)[0].copy_(src)
        assert torch.equal(dst_buf, want_buf), (n, src_offset, dst_offset)
        assert nvec == (n // 4 if src_offset == dst_offset == 0 else 0), (n, nvec)


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("shape", chip_smoke.RING_SHAPES)
@pytest.mark.parametrize("n", chip_smoke.RING_SHARDS)
def test_host_built_ring_hop_fills_every_slot_of_the_rings_stacks(n, shape, order, host_lib,
                                                                  host_lib_reversed):
    """Every slot of an (n, *shape) stack, as the gather fills it (the
    verdict bits' odd slots 8-byte aligned only), equals ``copy_``."""
    lib = host_lib if order == "forward" else host_lib_reversed
    rng = np.random.default_rng(n)
    chunks = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(n)]
    out = torch.full((n,) + shape, -7.0)
    for slot, chunk in enumerate(chunks):
        nvec = _host_hop(lib, chunk.data_ptr(), out[slot].data_ptr(), chunk.numel())
        aligned = chunk.data_ptr() % 16 == 0 and out[slot].data_ptr() % 16 == 0
        assert nvec == (chunk.numel() // 4 if aligned else 0)
    assert torch.equal(out, torch.stack(chunks))
