"""``python -m lodestar_tpu_torch.analysis [--json] [--skip-<layer> ...]
[--device cuda]``: every analysis layer of the port; exit 1 on a
violation, 0 when the tree is clean.  The known violations (open faults
the rules hold at their measured size, such as the ladder kernels' spill)
are printed apart and do not change the exit code.  Run from the
repository root."""

import argparse
import json
import sys

from . import LAYERS, run_all
from .report import format_report, to_dicts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lodestar_tpu_torch.analysis",
                                 description=__doc__)
    ap.add_argument("--json", action="store_true", help="print the violations as JSON")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                    help="cuda: also the halves that run on the card")
    ap.add_argument("--repo", default=None, help="the repository root (default: this one)")
    for name in LAYERS:
        ap.add_argument(f"--skip-{name}", action="store_true", help=f"skip the {name} layer")
    args = ap.parse_args(argv)
    skip = [name for name in LAYERS if getattr(args, f"skip_{name.replace('-', '_')}")]
    report: dict = {}
    log = None if args.json else (lambda line: print(line, flush=True))
    violations = run_all(args.repo, args.device, skip, report=report, log=log)
    known = report.get("known", [])
    if args.json:
        print(json.dumps({"violations": to_dicts(violations), "known": to_dicts(known),
                          "seconds": report["seconds"]}))
    else:
        for v in known:
            print(f"known violation (open): {v}")
        print(format_report(violations))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
