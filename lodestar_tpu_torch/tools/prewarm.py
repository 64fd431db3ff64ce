"""Prewarm farm: populate the durable kernel-library store out-of-band.

The port's copy of the repo's ``tools/prewarm.py``.  A fleet doing
rolling restarts never builds: THIS tool pays the kernel build once per
card architecture, ahead of time, and the nodes restart with
``load_only=True`` against the populated store (no nvcc needed).

What one run does:

- takes the farm-level single-writer lockfile (``prewarm.lock`` in the
  store) so concurrent prewarmers on a shared store don't stampede the
  same build — a held lock means another farm is already working: this
  one exits 3 (rerun later, or point at its own store);
- builds a ``TorchBlsVerifier`` over the requested cards with the store
  as its ``aot_store`` and runs its ``warmup()`` over ``--buckets``,
  which walks memo -> store -> ``build/`` -> nvcc for the kernel library
  and saves a library it had to build (or found in ``build/``) to the
  store, then captures each bucket's CUDA graph;
- reports what the store holds: the kernel libraries, one entry per
  (capability, flags, torch, CUDA, sources).  CUDA graphs are not stored:
  a graph cannot be serialized, and each process captures its own from
  the stored library (the report says so under ``graphs``).

``--mesh`` runs ``warmup_sharded`` instead: the sharded tier's programs
over the cards (``--devices N`` >= 2; a card may repeat), from the same
stored library.

``--verify`` instead runs the integrity sweep: every manifest entry's
checksum and torch / CUDA / source versions, plus orphan temp files from
crashed writers (exit 1 on any corrupt entry, after listing them).
``--sweep-orphans`` (with ``--verify``) deletes those orphans.

Usage:
    python -m lodestar_tpu_torch.tools.prewarm --store .torch_aot_store --buckets 4,16
    python -m lodestar_tpu_torch.tools.prewarm --store .torch_aot_store --buckets 256 \\
        --devices 2 --mesh
    python -m lodestar_tpu_torch.tools.prewarm --store .torch_aot_store --verify
    python -m lodestar_tpu_torch.tools.prewarm --store .torch_aot_store --verify --sweep-orphans
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

#: farm-level lock (distinct from the store's per-save writer lock: the
#: farm holds THIS for its whole run, saves still serialize individually)
FARM_LOCK_NAME = "prewarm.lock"

#: what the report says in place of per-bucket entries
GRAPHS_NOTE = ("not stored: a CUDA graph cannot be serialized; each process "
               "captures its own from the stored library")


def _devices(n_devices: int, device: str) -> Optional[List[str]]:
    """``--devices``: 1 = the single ``device``; N = N executors, over the
    visible cards in turn (one card repeats as logical executors); 0 =
    every visible card."""
    import torch

    if n_devices == 1:
        return None
    count = torch.cuda.device_count() if device.startswith("cuda") else 1
    if n_devices == 0:
        n_devices = max(1, count)
    if not device.startswith("cuda"):
        return [device] * n_devices
    return [f"cuda:{i % max(1, count)}" for i in range(n_devices)]


def prewarm(store_path: str, buckets, n_devices: int = 1, device: str = "cuda",
            lock_wait_s: float = 2.0, mesh: bool = False) -> Dict[str, Any]:
    """Populate ``store_path`` for this host's cards.  Returns the report
    dict; ``{"locked": True}`` when another prewarmer holds the farm lock
    (the caller exits 3 — never a stampede).  The verifier is the node's
    default program (split fused): the stored library serves every
    program, so the farm has no program options."""
    from ..aot.store import KernelLibraryStore, acquire_lockfile, release_lockfile
    from ..chaos import install_from_env

    # chaos activation seam: a fault campaign arms a plan in THIS process
    # through the environment (a no-op when unset)
    install_from_env()

    os.makedirs(store_path, exist_ok=True)
    farm_lock = os.path.join(store_path, FARM_LOCK_NAME)
    if not acquire_lockfile(farm_lock, lock_wait_s, store=store_path):
        return {"locked": True, "store": store_path, "lock": farm_lock}
    t0 = time.perf_counter()
    try:
        from ..crypto.bls.torch_verifier import TorchBlsVerifier
        from ..ops.kernels import _build

        store = KernelLibraryStore(path=store_path)
        devices = _devices(n_devices, device)
        if mesh:
            if devices is None or len(devices) < 2:
                raise SystemExit("--mesh needs two executors or more: pass --devices N "
                                 "(>= 2) or 0 (every card)")
            v = TorchBlsVerifier(device=device, devices=devices, buckets=tuple(buckets),
                                 aot_store=store, sharded=True,
                                 sharded_min_batch=min(buckets))
            eligible = [b for b in buckets if v._sharded_size_ok(b)]
            if not eligible:
                # a silent zero-program "success" would let the operator
                # believe the mesh programs were made when none were
                raise SystemExit(f"--mesh: none of buckets {sorted(buckets)} divide evenly "
                                 f"across {len(devices)} executors — nothing to prewarm")
            wall = v.warmup_sharded()
            programs = sorted(f"b{k[1]}" for k in v.mesh_programs)
            executors = [v._mesh_ex.name]
        else:
            v = TorchBlsVerifier(device=device, devices=devices, buckets=tuple(buckets),
                                 aot_store=store)
            wall = v.warmup()
            programs = sorted(f"{k[0]} b{k[1]}" for k in v.programs)
            executors = [ex.name for ex in v._executors]
        v.close()
        return {
            "store": store_path,
            "buckets": list(buckets),
            "devices": executors,
            "mesh": mesh or None,
            "library": {"kind": _build.build_kind, "seconds": _build.build_seconds},
            "warmup_s": round(wall, 2),
            "wall_s": round(time.perf_counter() - t0, 2),
            "stats": store.stats(),
            "entries": sorted(store.keys()),
            "graphs": {"captured_here": programs, "stored": GRAPHS_NOTE},
        }
    finally:
        release_lockfile(farm_lock)


def verify(store_path: str, sweep_orphans: bool = False) -> Dict[str, Any]:
    """Integrity sweep of every manifest entry (no card touched)."""
    from ..aot.store import KernelLibraryStore

    store = KernelLibraryStore(path=store_path)
    report = store.verify()
    report["store"] = store_path
    report["entries"] = len(store.keys())
    if sweep_orphans:
        report["orphans_removed"] = store.sweep_orphans()
    return report


def main(argv: Optional[List[str]] = None) -> int:
    from ..aot.store import STORE_ENV
    from .inspect_bundle import REPO

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", default=None,
                    help=f"store directory (default: ${STORE_ENV} or the "
                    "repo-local .torch_aot_store)")
    ap.add_argument("--buckets", default="4,16,64,128,256",
                    help="comma-separated padding buckets whose graphs to capture")
    ap.add_argument("--devices", type=int, default=1,
                    help="executors: 1 = the current card (default), N = N "
                    "executors over the visible cards, 0 = every visible card")
    ap.add_argument("--mesh", action="store_true",
                    help="make the sharded tier's programs instead of the "
                    "per-card ones; requires --devices >= 2 or 0")
    ap.add_argument("--lock-wait-s", type=float, default=2.0,
                    help="bounded wait for the farm lock before exiting 3")
    ap.add_argument("--verify", action="store_true",
                    help="integrity sweep instead of building")
    ap.add_argument("--sweep-orphans", action="store_true",
                    help="with --verify: delete crashed writers' temp files")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    store_path = (
        args.store
        or os.environ.get(STORE_ENV)
        or os.path.join(REPO, ".torch_aot_store")
    )
    if args.verify:
        report = verify(store_path, sweep_orphans=args.sweep_orphans)
        if args.json:
            print(json.dumps(report, indent=1))
        else:
            print(f"store    {report['store']}  ({report['entries']} entries)")
            for cls in ("ok", "skew", "corrupt", "orphans"):
                for key in report[cls]:
                    print(f"  {cls:8s} {key}")
            if args.sweep_orphans:
                print(f"  orphans removed: {report['orphans_removed']}")
        return 1 if report["corrupt"] else 0

    buckets = tuple(int(b) for b in str(args.buckets).split(",") if b)
    report = prewarm(
        store_path, buckets, n_devices=args.devices,
        lock_wait_s=args.lock_wait_s, mesh=args.mesh,
    )
    if report.get("locked"):
        print(
            f"another prewarmer holds {report['lock']} — not stampeding "
            f"(rerun when it finishes)",
            file=sys.stderr,
        )
        return 3
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        s = report["stats"]
        print(
            f"prewarmed {report['store']} buckets={report['buckets']} "
            f"devices={report['devices']}"
        )
        print(
            f"  library {report['library']['kind']} {report['library']['seconds']:.3f}s, "
            f"warmup {report['warmup_s']}s — saves={s['saves']} hits={s['hits']} "
            f"save_errors={s['save_errors']} lock_bypasses={s['lock_bypasses']}"
        )
        for key in report["entries"]:
            print(f"  library entry {key}")
        print(f"  graphs captured here {report['graphs']['captured_here']}: "
              f"{report['graphs']['stored']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
