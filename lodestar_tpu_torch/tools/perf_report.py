"""Perf trend report and regression tripwires over ``chip_smoke.py``'s run
records (the port's counterpart of the repo's ``tools/perf_report.py``).

Reads every record matched by ``--runs`` (default
``chiprun_out/runs/*.json``, where ``chip_smoke.py`` writes one a run),
plus the port's compile ledger and the tier-1 timing ledger when present,
computes per-metric trends with noise bands within each card's sub-series
(``lodestar_tpu_torch/observatory/run_ledger.py``), prints the report and
exits nonzero on a tripwire regression.  It never writes ``PERF_TREND.md``
and never reads ``BENCH_r*.json``: those are the JAX package's.

Usage:
    python -m lodestar_tpu_torch.tools.perf_report                 # report + gate
    python -m lodestar_tpu_torch.tools.perf_report --out trend.md  # also write markdown
    python -m lodestar_tpu_torch.tools.perf_report --json          # machine-readable
    python -m lodestar_tpu_torch.tools.perf_report --fail-on-warn  # plateaus fail too

Exit codes: 0 clean (warnings allowed unless --fail-on-warn), 1 at least
one tripwire regression, 2 no runs found.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional

from ..observatory import run_ledger
from ..observatory.compile_ledger import LEDGER_FILENAME
from .tier1_budget import DEFAULT_CAP_S, TIER1_LEDGER

_REPO_DEFAULT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_RUNS = os.path.join(run_ledger.RUNS_DIR, "*.json")
#: the ledger the kernel build keeps beside the library (``_build.BUILD_DIR``)
COMPILE_LEDGER_FILE = os.path.join("build", "lodestar_tpu_torch", LEDGER_FILENAME)


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.4g}" if abs(v) < 1000 else f"{v:.0f}"
    return str(v)


def render_markdown(report: dict) -> str:
    runs = report["runs"]
    lines: List[str] = [
        "# Run trend — chip_smoke's run records",
        "",
        "Generated by `python -m lodestar_tpu_torch.tools.perf_report` over",
        "`chip_smoke.py`'s records.  Tripwire thresholds live in",
        "`lodestar_tpu_torch/observatory/run_ledger.py`; verdicts compare",
        "records of one card only.",
        "",
    ]
    reg, plat = report["regressions"], report["plateaus"]
    lines.append("## Verdict")
    lines.append("")
    if reg:
        lines.append(f"**REGRESSIONS ({len(reg)})**: " + ", ".join(f"`{m}`" for m in reg))
    else:
        lines.append("No tripwire regressions.")
    if plat:
        lines.append("")
        lines.append(
            "**PLATEAU WARNING**: " + ", ".join(f"`{m}`" for m in plat)
            + f" — ≥{run_ledger.PLATEAU_RUNS} trailing runs within "
            f"±{run_ledger.PLATEAU_BAND:.0%}; the north-star metric is "
            "not moving."
        )
    crashed = report["crashed_runs"]
    if crashed:
        lines.append("")
        lines.append(
            "**FAILED RUNS**: "
            + ", ".join(f"{c['run']} (rc={c['rc']})" for c in crashed)
            + " — these runs contribute gaps, not data."
        )
    lines += ["", "## Runs", "", "| run | mode | rc | card | commit | file |",
              "|---|---|---|---|---|---|"]
    for r in report["records"]:
        commit = (r["commit"] or "—")[:12]
        lines.append(f"| {r['run']} | {r['mode']} | {r['rc']} | {r['card'] or '—'} "
                     f"| {commit} | {r['file']} |")
    lines += ["", "## Metric trends", ""]
    header = "| metric | " + " | ".join(runs) + " | Δ vs prev | noise band | flags |"
    sep = "|---" * (len(runs) + 4) + "|"
    lines += [header, sep]
    for name, t in report["metrics"].items():
        cells = []
        for r in runs:
            v = t["points"].get(r)
            cells.append(_fmt(v) if v is not None else "·")
        delta = t.get("delta_vs_prev_pct")
        band = t.get("noise_band_pct")
        flags = ", ".join(t["flags"]) if t["flags"] else ""
        if t.get("gaps"):
            flags = (flags + "; " if flags else "") + "gaps: " + ",".join(t["gaps"])
        lines.append(
            f"| `{name}` | " + " | ".join(cells)
            + f" | {_fmt(delta) + '%' if delta is not None else '—'}"
            + f" | {_fmt(band) + '%' if band is not None else '—'}"
            + f" | {flags} |"
        )
    cl = report.get("compile_ledger")
    if cl:
        lines += ["", "## Compile ledger", ""]
        lines.append("| kind | events | total s | max s |")
        lines.append("|---|---|---|---|")
        for kind, s in sorted(cl["by_kind"].items()):
            lines.append(
                f"| {kind} | {s['count']} | {s['total_s']} | {s['max_s']} |"
            )
        lines.append("")
        lines.append(f"({cl['keys']} (entry, bucket, device, torch) keys ledgered.)")
    t1 = report.get("tier1")
    if t1 and t1.get("runs"):
        lines += ["", "## Tier-1 wall time", ""]
        walls = ", ".join(_fmt(w) + "s" for w in t1["wall_s"] if w is not None)
        lines.append(
            f"{t1['runs']} recorded run(s): {walls} (cap {DEFAULT_CAP_S:.0f} s; see "
            "`python -m lodestar_tpu_torch.tools.tier1_budget`)."
        )
    lines.append("")
    return "\n".join(lines)


def summary_line(report: dict) -> str:
    """One line: the runs, the regressions, the plateaus and the gaps."""
    gaps = [f"{name} ({','.join(t['gaps'])})" for name, t in report["metrics"].items()
            if t["gaps"]]
    return (f"perf_report: {len(report['runs'])} run(s); regressions: "
            f"{', '.join(report['regressions']) or 'none'}; plateaus: "
            f"{', '.join(report['plateaus']) or 'none'}; gaps: {'; '.join(gaps) or 'none'}")


def run_paths(pattern: str, repo: str) -> List[str]:
    """The files ``pattern`` matches, relative to ``repo`` unless absolute."""
    return sorted(glob.glob(pattern if os.path.isabs(pattern) else os.path.join(repo, pattern)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=_REPO_DEFAULT)
    ap.add_argument("--runs", default=DEFAULT_RUNS, metavar="GLOB",
                    help="the run records (relative to --repo unless absolute)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the markdown report here")
    ap.add_argument("--json", action="store_true",
                    help="print the raw report JSON instead of markdown")
    ap.add_argument("--fail-on-warn", action="store_true",
                    help="plateaus exit nonzero too, not just regressions")
    args = ap.parse_args(argv)

    report = run_ledger.analyze(
        run_paths(args.runs, args.repo),
        compile_ledger=os.path.join(args.repo, COMPILE_LEDGER_FILE),
        tier1=os.path.join(args.repo, TIER1_LEDGER),
    )
    if not report["runs"]:
        print("no run records matched", file=sys.stderr)
        return 2
    md = render_markdown(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(f"wrote {args.out}", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(md)
    if report["regressions"]:
        print(
            f"REGRESSION: {', '.join(report['regressions'])}", file=sys.stderr
        )
        return 1
    if args.fail_on_warn and report["plateaus"]:
        print(f"PLATEAU: {', '.join(report['plateaus'])}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
