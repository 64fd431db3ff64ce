"""Tier-1 wall-time budget report: who is eating the cap (the port's
counterpart of the repo's ``tools/tier1_budget.py``).

Reads the run ledger that the repo's ``tests/conftest.py`` appends to
``.jax_cache/tier1_timings.json`` (per-test setup+call+teardown wall plus
per-test compile-guard event counts, last 8 runs kept) and prints:

- the suite wall-time trend against the cap and the margin left;
- the top-10 movers against the previous full run (the node ids both
  ran: a test that got 13 s slower shows here before the suite hits the
  cap);
- the top-10 slowest tests of the latest run and which tests triggered
  expensive compile or cache-load events.

The cap is the tier-1 command's time limit, 1,470 s (``timeout ... 1470``).

Usage:
    python -m lodestar_tpu_torch.tools.tier1_budget                 # report
    python -m lodestar_tpu_torch.tools.tier1_budget --json
    python -m lodestar_tpu_torch.tools.tier1_budget --fail-margin 35
        # exit 1 when the latest full run left < 35 s of cap
    python -m lodestar_tpu_torch.tools.tier1_budget --enforce
        # fail-margin 60 PLUS the port's test-cost audit: exit 1 on any
        # violation or a thin margin

Partial runs (``pytest -k`` subsets, below
``run_ledger.TIER1_FULL_RUN_MIN_TESTS`` tests) live in their own ring
(``partial_runs``): they are reported but never gate, and the movers
always compare a full run with a full run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from ..observatory.run_ledger import TIER1_FULL_RUN_MIN_TESTS

_REPO_DEFAULT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_CAP_S = 1470.0

#: the ledger tests/conftest.py writes, under the checkout
TIER1_LEDGER = os.path.join(".jax_cache", "tier1_timings.json")


def load_ledger(repo: str) -> Dict[str, List[Dict[str, Any]]]:
    """Both rings, as ``{"full": [...], "partial": [...]}``.

    Schema 2 stores them separately; a schema-1 file (one mixed ``runs``
    list) is split on read by the absolute threshold the conftest writer
    uses when it migrates one."""
    path = os.path.join(repo, TIER1_LEDGER)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {"full": [], "partial": []}
    runs = data.get("runs", [])
    partial = data.get("partial_runs", [])
    if data.get("schema", 1) < 2:
        full = [r for r in runs if r.get("n_tests", 0) >= TIER1_FULL_RUN_MIN_TESTS]
        partial = [r for r in runs if r.get("n_tests", 0) < TIER1_FULL_RUN_MIN_TESTS]
        runs = full
    return {"full": runs, "partial": partial}


def movers(prev: Dict[str, float], last: Dict[str, float],
           top: int = 10) -> List[Dict[str, Any]]:
    """Largest absolute per-test deltas over the shared node ids."""
    shared = set(prev) & set(last)
    deltas = [
        {
            "test": nodeid,
            "prev_s": prev[nodeid],
            "last_s": last[nodeid],
            "delta_s": round(last[nodeid] - prev[nodeid], 3),
        }
        for nodeid in shared
    ]
    deltas.sort(key=lambda d: -abs(d["delta_s"]))
    return deltas[:top]


def _run_summary(r: Dict[str, Any]) -> Dict[str, Any]:
    return {"wall_s": r.get("wall_s"), "n_tests": r.get("n_tests"),
            "exitstatus": r.get("exitstatus"),
            "compile_events": r.get("compile_events"),
            "compile_events_s": r.get("compile_events_s"),
            "aot": r.get("aot")}


def analyze(repo: str, cap_s: float = DEFAULT_CAP_S) -> Dict[str, Any]:
    rings = load_ledger(repo)
    runs, partial = rings["full"], rings["partial"]
    out: Dict[str, Any] = {
        "cap_s": cap_s,
        "runs": [_run_summary(r) for r in runs],
        "partial_runs": [_run_summary(r) for r in partial],
    }
    if not runs:
        return out
    last = runs[-1]
    out["last_wall_s"] = last.get("wall_s")
    out["margin_s"] = (
        round(cap_s - last["wall_s"], 1) if last.get("wall_s") is not None else None
    )
    # "full" is absolute, never relative to the previous entry, and the
    # gating entry always comes off the full ring
    out["is_full_run"] = last.get("n_tests", 0) >= TIER1_FULL_RUN_MIN_TESTS
    prev_full = runs[-2] if len(runs) >= 2 else None
    if prev_full is not None:
        out["movers"] = movers(prev_full.get("tests", {}), last.get("tests", {}))
        if last.get("wall_s") and prev_full.get("wall_s"):
            out["wall_delta_s"] = round(last["wall_s"] - prev_full["wall_s"], 1)
    out["aot"] = last.get("aot")
    if partial:
        p = partial[-1]
        if p.get("utc") and last.get("utc") and p["utc"] > last["utc"]:
            # the newest run was a -k subset: the margin still reflects
            # the older full run
            out["newer_partial"] = True
    slowest = sorted(
        last.get("tests", {}).items(), key=lambda kv: -kv[1]
    )[:10]
    out["slowest"] = [{"test": t, "seconds": s} for t, s in slowest]
    out["compiling_tests"] = dict(
        sorted(last.get("test_compiles", {}).items(), key=lambda kv: -kv[1])[:10]
    )
    return out


def render(report: Dict[str, Any]) -> str:
    lines = [f"tier-1 budget (cap {report['cap_s']:.0f}s)"]
    if not report["runs"]:
        lines.append("  no recorded runs — run the suite once to seed the ledger")
        return "\n".join(lines)
    walls = " -> ".join(
        f"{r['wall_s']}s({r['n_tests']}t,rc{r['exitstatus']})"
        for r in report["runs"]
    )
    lines.append(f"  full runs: {walls}")
    if report.get("partial_runs"):
        pwalls = " -> ".join(
            f"{r['wall_s']}s({r['n_tests']}t,rc{r['exitstatus']})"
            for r in report["partial_runs"]
        )
        lines.append(f"  partial (-k) runs [never gate]: {pwalls}")
    if report.get("margin_s") is not None:
        ok = report["margin_s"] >= 60
        margin = f"margin {report['margin_s']}s"
        if sys.stdout.isatty():
            margin = f"\x1b[32m{margin}\x1b[0m" if ok else f"\x1b[31m{margin}\x1b[0m"
        elif not ok:
            margin += "  ⚠"
        lines.append(
            f"  latest full wall {report['last_wall_s']}s — {margin}"
            + ("  [a newer -k subset ran since]" if report.get("newer_partial")
               else "")
        )
    if report.get("wall_delta_s") is not None:
        lines.append(f"  wall delta vs previous full run: {report['wall_delta_s']:+}s")
    if report.get("aot"):
        a = report["aot"]
        lines.append(
            f"  AOT executable store (latest run): hits={a.get('hits')} "
            f"misses={a.get('misses')} saves={a.get('saves')} "
            f"corrupt={a.get('corrupt')} skew={a.get('skew')}"
        )
    if report.get("movers"):
        lines.append("  top movers vs previous run:")
        for m in report["movers"]:
            lines.append(
                f"    {m['delta_s']:+8.2f}s  {m['test']}  "
                f"({m['prev_s']} -> {m['last_s']})"
            )
    if report.get("slowest"):
        lines.append("  slowest tests (latest run):")
        for s in report["slowest"]:
            lines.append(f"    {s['seconds']:8.2f}s  {s['test']}")
    if report.get("compiling_tests"):
        lines.append("  compile-guard events by test (latest run):")
        for t, n in report["compiling_tests"].items():
            lines.append(f"    {n:3d}  {t}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=_REPO_DEFAULT)
    ap.add_argument("--cap", type=float, default=DEFAULT_CAP_S)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--fail-margin", type=float, default=None, metavar="S",
                    help="exit 1 when the latest FULL run left less than "
                    "this many seconds of cap margin")
    ap.add_argument("--enforce", action="store_true",
                    help="CI gate: --fail-margin 60 combined with the port's "
                    "test-cost audit — exit nonzero on any violation OR a "
                    "thin margin")
    args = ap.parse_args(argv)
    if args.enforce and args.fail_margin is None:
        args.fail_margin = 60.0
    report = analyze(args.repo, cap_s=args.cap)
    rc = 0
    if args.enforce:
        from ..analysis.report import format_report, to_dicts
        from ..analysis.test_cost import audit_test_cost

        violations = audit_test_cost(repo=args.repo)
        report["test_cost_violations"] = to_dicts(violations)
        if violations:
            print(format_report(violations), file=sys.stderr)
            rc = 1
    print(json.dumps(report, indent=1) if args.json else render(report))
    if (
        args.fail_margin is not None
        and report.get("margin_s") is not None
        and report.get("is_full_run")
        and report["margin_s"] < args.fail_margin
    ):
        print(
            f"tier-1 margin {report['margin_s']}s < {args.fail_margin}s",
            file=sys.stderr,
        )
        rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
