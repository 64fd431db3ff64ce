"""Mesh observatory report: per-batch latency attribution + scaling-loss
breakdown from a trace dump (the port's copy of the repo's
``tools/meshscope.py``, over the port's ``observatory/attribution.py``).

Feed it any Chrome trace the port produces — a ``--trace-dump`` file, a
``/eth/v1/lodestar/traces?format=chrome`` download, or (best) the merged
host+device dump from ``POST /eth/v1/lodestar/profile?format=chrome`` /
``--torch-profile``'s ``merged_trace.json`` — and it prints, per merged
batch, the six-way split queue / pack / device-compute /
collective-combine / final-exp / pipeline-bubble, the compute/pack
overlap ratio, and (when mesh batches are present) the live
scaling-loss breakdown.  With device events in the dump the
device-compute vs collective split is measured; span-only dumps fall
back to the host-side dispatch wall.  The ring hop's kernels
(``ring_hop_k``) count as the collective combine.

Usage:
    python -m lodestar_tpu_torch.tools.meshscope MERGED_TRACE.json [--json]
        [--tolerance FRAC] [--fail-on-residual]

Exit codes: 0 ok, 1 unreadable/attributable input, 2 (with
--fail-on-residual) a mesh breakdown whose components do not sum to the
gap within the tolerance.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..observatory import attribution


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:8.3f}"


def render(report: dict, breakdown: Optional[dict]) -> str:
    lines: List[str] = []
    batches = report["batches"]
    lines.append(
        f"{len(batches)} merged batch(es); "
        f"overlap_ratio={report['overlap_ratio']}"
    )
    lines.append("")
    header = (
        f"{'cid':>6} {'dev':>8} {'mesh':>4} | {'queue':>8} {'pack':>8} "
        f"{'device':>8} {'combine':>8} {'finexp':>8} {'bubble':>8} "
        f"| {'e2e ms':>8} {'expl':>5}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for b in batches:
        s = b["stages"]
        lines.append(
            f"{str(b['cid']):>6} {str(b['device'] or '-'):>8} "
            f"{str(b['mesh_devices'] or '-'):>4} | "
            f"{_fmt_ms(s['queue'])} {_fmt_ms(s['pack'])} "
            f"{_fmt_ms(s['device_compute'])} "
            f"{_fmt_ms(s['collective_combine'])} "
            f"{_fmt_ms(s['final_exp'])} {_fmt_ms(s['pipeline_bubble'])} | "
            f"{_fmt_ms(b['e2e_s'])} {b['explained_ratio']:>5}"
        )
    lines.append("")
    if breakdown is None:
        lines.append("no mesh (sharded) batches: scaling-loss breakdown n/a")
    else:
        c = breakdown["components"]
        lines.append(
            f"mesh scaling loss (live estimate): "
            f"efficiency={breakdown['efficiency']} "
            f"loss={breakdown['loss']}"
        )
        lines.append(
            f"  communication={c['communication']} "
            f"shard_imbalance={c['shard_imbalance']} "
            f"serial_host={c['serial_host']}"
        )
        lines.append(
            f"  explained={breakdown['explained']} "
            f"residual={breakdown['residual']} "
            f"within_tolerance={breakdown['within_tolerance']}"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome trace JSON (merged or span-only)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="scaling-loss reconciliation tolerance (fraction "
                    "of the gap, default 0.05)")
    ap.add_argument("--fail-on-residual", action="store_true",
                    help="exit 2 when the breakdown components do not sum "
                    "to the gap within --tolerance")
    args = ap.parse_args(argv)
    try:
        with open(args.trace) as f:
            trace = json.load(f)
    except (OSError, ValueError) as e:
        print(f"{args.trace}: unreadable trace: {e}", file=sys.stderr)
        return 1
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) else trace
    if not isinstance(events, list):
        print(f"{args.trace}: no traceEvents list", file=sys.stderr)
        return 1
    report = attribution.attribute_spans(events)
    if not report["batches"]:
        print(f"{args.trace}: no attributable merged batches "
              f"(needs cid-correlated bls.* spans)", file=sys.stderr)
        return 1
    breakdown = attribution.mesh_scaling_loss(
        report["batches"], tolerance=args.tolerance
    )
    if args.json:
        print(json.dumps({"attribution": report, "scaling_loss": breakdown},
                         indent=1))
    else:
        print(render(report, breakdown))
    if (args.fail_on_residual and breakdown is not None
            and not breakdown["within_tolerance"]):
        print("scaling-loss components do not reconcile with the gap",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
