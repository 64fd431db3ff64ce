#!/usr/bin/env python3
"""Chip smoke test of lodestar_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. card: name and power limit (nvidia-smi), torch and CUDA versions, and
   the nvcc build of the fused kernels from this checkout's sources;
2. kernels: each of the ten CUDA kernels against its plain PyTorch version
   on the card, on seeded inputs at the main path's shapes (field kernels
   at 512 and 2,560 rows, ladder kernels at 512 rows), three inputs a
   shape — bitwise, tolerance zero, since both are exact integer
   arithmetic.  Times are device times: 20 calls captured in one CUDA
   graph, the replays timed by CUDA events, so the host's cost of issuing
   a launch is outside the window (it is printed beside them as
   ``issue_ms``, 20 eager calls between events);
3. slice: 128 real signature sets (interop keys, the port's own oracle)
   through ``TorchBlsVerifier.verify_signature_sets`` at bucket 128 with
   every launch counter set to 0 just before: the valid batch verifies,
   every kernel launched; then a corrupted signature, a signature outside
   G2 and 100 live sets in bucket 128 give False, False, True; the
   batch-128 example inputs verify through ``verify_signature_sets_fused``;
   the card's Miller product at bucket 4 equals the CPU plain run's
   canonically, digit for digit;
4. times: three batches of 128 fresh signatures (new messages, so no
   signature is in the verifier's point cache; the public keys are, as on
   a node), each timed as pack then device dispatch to the verdict on the
   host clock; the best batch gives sets/s;
5. profile: one more fresh batch's dispatch under ``torch.profiler``: the
   device time of the port's kernels and of PyTorch's glue kernels, and
   the device's idle share over that dispatch.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# int32 multiply-add on the CUDA cores: 64 lanes per SM per clock (half the
# fp32 lanes) x 132 SMs x 1.98 GHz, 2 operations each = half of the
# 67 TFLOP/s fp32 rate
INT32_OPS_PER_S = 33.5e12

SEED = 20261016
# seeded inputs each kernel is held against its plain version on, per shape
# (a miscompiled build can be wrong on a few rows in thousands)
CHECKS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- operation counts (int32 multiply-adds a row; carries and adds are not
#    counted, so the bound below is a lower bound) ---------------------------


def _fold(w: int, bits: int) -> int:
    extra = max(1, -(-(bits - 8) // 8))
    return (w + extra - 49) * 50


_MUL = 2500 + _fold(99, 22)  # same fold width for bits 16/17/18
_LOADF = _fold(50, 22)
_SMALL = _fold(50, 13)  # add / sub / doubling folds (one extra column)
_F2MUL = 3 * _MUL + 2 * _SMALL
_F2SQR = 2 * _MUL + 2 * _SMALL
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
}


def bound(kernel, rows: int):
    """(bound_ms, bound_by): the larger of the bytes over HBM and the
    multiply-adds over the int32 rate, for ``rows`` rows."""
    width = int(np.prod(kernel.tail))
    nbytes = 4 * rows * width * (kernel.n_in + kernel.n_out)
    ops = 2 * MACS_PER_ROW[kernel.name] * rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of fn: reps calls captured in one CUDA graph,
    replayed and timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def issue_ms(fn, reps: int = 20) -> float:
    """Time of one eager call of fn by CUDA events over reps calls: for a
    short kernel, the rate at which the host issues launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 2: every kernel against its plain version -------------------------


def kernel_inputs(kernel, rows: int, rng: np.random.Generator, dev):
    """Seeded inputs: loose digits up to 2^22 - 1 where the kernel folds on
    entry, semi-strict digits (<= 256) where it takes kernel outputs, plus
    zero, p and 2p rows and one all-(2^22 - 1) row."""
    from lodestar_tpu_torch.crypto.bls.fields import P
    from lodestar_tpu_torch.ops import limbs as fl

    loose_in = {"lad1": 6, "lad2": 4, "lad3": 2}.get(kernel.name, kernel.n_in)
    shape = (rows,) + kernel.tail
    out = []
    for i in range(kernel.n_in):
        top = (1 << 22) if i < loose_in else 257
        a = rng.integers(0, top, size=shape).astype(np.float32)
        if i < loose_in:
            flat = a.reshape(rows, -1, 50)
            flat[0] = 0
            flat[1] = fl.int_to_limbs(P)
            flat[2] = fl.int_to_limbs(2 * P)
            flat[3] = (1 << 22) - 1
        out.append(torch.from_numpy(a).to(dev))
    return out


def check_kernels(dev, card: str):
    from lodestar_tpu_torch.ops import fused_ladder  # noqa: F401 - registers lad1..3
    from lodestar_tpu_torch.ops.fused_core import KERNELS

    rng = np.random.default_rng(SEED)
    results = {}
    for name, k in KERNELS.items():
        shapes = (512,) if name.startswith("lad") else (512, 2560)
        for rows in shapes:
            err = 0.0
            for _ in range(CHECKS):
                ins = kernel_inputs(k, rows, rng, dev)
                got = k.launch(*ins)
                torch.cuda.synchronize()
                want = k.plain(*ins)
                err = max([err] + [float((g - w).abs().max()) for g, w in zip(got, want)])
                semi = max(float(g.max()) for g in got)
                if err != 0.0 or semi > 256:
                    raise AssertionError(f"kernel {name} at {rows} rows: max |kernel - plain| "
                                         f"= {err}, max digit {semi}")
            ms = graph_ms(lambda: k.launch(*ins))
            plain_ms = graph_ms(lambda: k.plain(*ins), reps=3)
            issue = issue_ms(lambda: k.launch(*ins))
            b_ms, b_by = bound(k, rows)
            log(f"kernel {name} rows={rows}: bitwise equal to plain; device {ms:.4f} ms "
                f"(plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by}; "
                f"eager issue {issue:.4f} ms) [{card}]")
            results[name] = dict(rows=rows, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by, issue_ms=issue)
    return results


# -- phase 3: the slice --------------------------------------------------------


def make_keys(n: int):
    """The first n interop secret keys and their public keys, read back from
    their compressed bytes as a node's validator registry holds them (so
    the verifier's point cache can key them)."""
    from lodestar_tpu_torch.crypto.bls import PublicKey, interop_secret_key

    sks = [interop_secret_key(i) for i in range(n)]
    return [(sk, PublicKey.from_bytes(sk.to_public_key().to_bytes())) for sk in sks]


def make_sets(keys, tag: bytes):
    """One valid single-key signature set per key, over messages that
    ``tag`` makes new."""
    from lodestar_tpu_torch.crypto.bls import SingleSignatureSet

    sets = []
    for i, (sk, pk) in enumerate(keys):
        msg = b"chip smoke %s %d" % (tag, i)
        sets.append(SingleSignatureSet(
            pubkey=pk, signing_root=msg, signature=sk.sign(msg).to_bytes()))
    return sets


def non_subgroup_signature() -> bytes:
    """A point on E2 outside G2: the SSWU + isogeny image of one field draw,
    before cofactor clearing."""
    from lodestar_tpu_torch.crypto.bls.curve import g2_subgroup_check, g2_to_bytes
    from lodestar_tpu_torch.crypto.bls.hash_to_curve import hash_to_field_fq2, map_to_curve_g2

    pt = map_to_curve_g2(hash_to_field_fq2(b"outside the subgroup", 2)[0])
    if g2_subgroup_check(pt):
        raise AssertionError("expected a point outside G2")
    return g2_to_bytes(pt)


def run_slice(dev, card: str):
    import dataclasses

    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops import fused_core, fused_verify

    t0 = time.perf_counter()
    keys = make_keys(128)
    sets = make_sets(keys, b"slice")
    log(f"slice: built 128 signature sets on the host in {time.perf_counter() - t0:.1f} s")
    verifier = TorchBlsVerifier(device=dev, rng=np.random.default_rng(SEED))

    # the main path, counted: every launch counter is 0 just before
    fused_core.reset_launch_counts()
    t0 = time.perf_counter()
    ok = verifier.verify_signature_sets(sets)
    first_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in fused_core.KERNELS.items()}
    log(f"slice: valid batch of 128 -> {ok} (first run {first_s:.3f} s); "
        f"launches per batch {json.dumps(launches)}")
    if ok is not True:
        raise AssertionError("a valid batch of 128 sets did not verify")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")

    bad = list(sets)
    bad[5] = dataclasses.replace(bad[5], signature=sets[6].signature)
    got = verifier.verify_signature_sets(bad)
    log(f"slice: one corrupted signature -> {got}")
    if got is not False:
        raise AssertionError("a corrupted batch verified")

    bad = list(sets)
    bad[9] = dataclasses.replace(bad[9], signature=non_subgroup_signature())
    got = verifier.verify_signature_sets(bad)
    log(f"slice: one signature outside G2 -> {got}")
    if got is not False:
        raise AssertionError("a batch with a non-subgroup signature verified")

    got = verifier.verify_signature_sets(sets[:100])
    log(f"slice: 100 live sets in bucket 128 -> {got}")
    if got is not True:
        raise AssertionError("a padded batch of 100 valid sets did not verify")

    args = fused_verify.from_packed(fused_verify.example_inputs(128), dev)
    got = bool(fused_verify.verify_signature_sets_fused(*args))
    log(f"slice: example_inputs(128) through verify_signature_sets_fused -> {got}")
    if got is not True:
        raise AssertionError("the batch-128 example inputs did not verify")

    # the card against the CPU plain versions on a small input
    small = fused_verify.example_inputs(4)
    f_gpu, ok_gpu = fused_verify.miller_product_fused(*fused_verify.from_packed(small, dev))
    f_cpu, ok_cpu = fused_verify.miller_product_fused(*fused_verify.from_packed(small, "cpu"))
    same = torch.equal(fused_core.f_canon(f_gpu).cpu(), fused_core.f_canon(f_cpu))
    log(f"slice: bucket-4 Miller product, card vs CPU plain: canonical f equal {same}, "
        f"ok {bool(ok_gpu)} / {bool(ok_cpu)}")
    if not (same and bool(ok_gpu) and bool(ok_cpu)):
        raise AssertionError("the card's Miller product differs from the CPU plain run")

    # phase 4: three batches of fresh signatures; the public keys stay in
    # the point cache, as on a node
    fresh = [make_sets(keys, b"timed %d" % r) for r in range(4)]
    cache = verifier.point_cache
    packs, dispatches = [], []
    for r, batch in enumerate(fresh[:3]):
        torch.cuda.synchronize()
        hits, misses = cache.hits, cache.misses
        t0 = time.perf_counter()
        packed = verifier.pack(batch)
        t1 = time.perf_counter()
        log(f"times: batch {r} pack: point cache {cache.hits - hits} hits, "
            f"{cache.misses - misses} misses")
        ok = bool(verifier.dispatch(packed))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not ok:
            raise AssertionError(f"timed batch {r} did not verify")
        packs.append(t1 - t0)
        dispatches.append(t2 - t1)
    walls = [p + d for p, d in zip(packs, dispatches)]
    best = min(range(3), key=walls.__getitem__)
    log(f"times: batch of 128 fresh signatures, best of 3: {walls[best]} s = "
        f"{128 / walls[best]} sets/s (pack {packs[best]} s + device dispatch "
        f"{dispatches[best]} s); all packs {packs}, dispatches {dispatches} [{card}]")

    profile_dispatch(verifier.pack(fresh[3]), verifier, dispatches[best], card)
    return launches


def profile_dispatch(packed, verifier, dispatch_s: float, card: str) -> None:
    """Phase 5: one dispatch under torch.profiler.  The port's kernels and
    PyTorch's glue kernels run on one stream and do not overlap, so the
    device is idle for the wall time their summed device time leaves: over
    the profiled wall, which the profiler stretches, and over ``dispatch_s``,
    the best unprofiled dispatch of phase 4."""
    from torch.profiler import ProfilerActivity, profile

    from lodestar_tpu_torch.ops.fused_core import KERNELS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ok = bool(verifier.dispatch(packed))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        raise AssertionError("the profiled batch did not verify")
    ours = {f"{name}_k" for name in KERNELS}
    per_kernel, glue_ms, glue_launches = {}, 0.0, 0
    for ev in prof.key_averages():
        dev_us = ev.device_time_total
        if dev_us <= 0 or ev.key.startswith(("cuda", "aten::")):
            continue
        if ev.key.split("(")[0] in ours:
            per_kernel[ev.key.split("(")[0]] = {"device_ms": dev_us / 1e3, "launches": ev.count}
        else:
            glue_ms += dev_us / 1e3
            glue_launches += ev.count
    if set(per_kernel) != ours:
        raise AssertionError(f"the profiler saw no device time for {sorted(ours - set(per_kernel))}")
    ours_ms = sum(v["device_ms"] for v in per_kernel.values())
    busy_ms = ours_ms + glue_ms
    log("profile: " + json.dumps({
        "card": card, "wall_ms": wall_ms, "port_kernels_device_ms": ours_ms,
        "glue_kernels_device_ms": glue_ms, "glue_kernel_launches": glue_launches,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "unprofiled_dispatch_ms": dispatch_s * 1e3,
        "device_idle_share_unprofiled": 1.0 - busy_ms / (dispatch_s * 1e3),
        "per_kernel": per_kernel}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure", file=sys.stderr)
        return 2
    from lodestar_tpu_torch.ops.fused_core import KERNELS
    from lodestar_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load()
    log(f"build: nvcc sm_90a library {_build.library_path()} in {time.perf_counter() - t0:.1f} s")

    results = check_kernels(dev, card)
    launches = run_slice(dev, card)

    line = []
    for name, k in KERNELS.items():
        r = results[name]
        line.append({
            "name": name,
            "route": "cuda",
            "source": "lodestar_tpu_torch/ops/kernels/fused_kernels.cu",
            "replaces": k.replaces,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "rows": r["rows"],
            "issue_ms": r["issue_ms"],
        })
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
