"""The plain reference put in the program's place, the control, and the
faults that the check must catch.

``ReferenceVerifier`` verifies a merged batch the way the port does, by a
random linear combination (``bank.verify_sum``, the frozen C library),
with fresh odd 64-bit coefficients, as the configuration states.  The
control narrows the coefficients to none (``coeff_bits=0``: every
coefficient 1, the unweighted sum): the guarantee a faster batch check
would be tempted to drop.  The faults are planted in the same verifier:

- ``unchanged``: a step that returns its state unchanged (every batch
  after the first gets the first batch's verdict);
- ``half``: half of the batch left out (only its first half verified);
- ``altered``: the answer altered where it is produced (every verdict
  negated);
- ``small``: a small batch, of 16 sets or fewer (buckets 4 and 16),
  accepted unseen.

The exchange between cards does not exist in a one-card cell.  Each must
come out as not correct; the sound verifier as correct.

    python3 portbench/controls.py --workload default-node.slo --seeds 1,2,3

runs the sound verifier, the control and each fault through the harness
at the cell's own rate and window (the card is not used) and prints each
reading of ``wrong_verdicts`` and ``unanswered_jobs``, and, by the port's
bucket of each batch that held a tampered set, how many such batches the
verifier saw and how many it passed.  The pure-Python check of the
reference is left to the sound runs (``pyref_sets`` 0 here).
"""

from __future__ import annotations

import argparse
import json
import os
import secrets
import sys
import threading
import time
from typing import Optional

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import bank  # noqa: E402

KINDS = ("sound", "control", "unchanged", "half", "altered", "small")
#: the largest batch the ``small`` fault accepts unseen
SMALL_SETS = 16


def _triple(s):
    pks = s.pubkeys if hasattr(s, "pubkeys") else [s.pubkey]
    return ([pk.to_bytes() for pk in pks], s.signing_root, s.signature)


class ReferenceVerifier:
    """A verifier of the port's signature sets in the frozen C library."""

    def __init__(self, coeff_bits: int = 64, fault: Optional[str] = None):
        self.coeff_bits = coeff_bits
        self.fault = fault
        self._first: Optional[bool] = None
        self._lock = threading.Lock()
        #: (sets, signatures, verdict) of every batch it was given
        self.seen: list = []

    def _verify(self, sets) -> bool:
        triples = [_triple(s) for s in sets]
        if self.coeff_bits:
            coeffs = [secrets.randbits(self.coeff_bits) | 1 for _ in triples]
        else:
            coeffs = [1] * len(triples)
        return bank.verify_sum(triples, coeffs)

    def verify_signature_sets(self, sets) -> bool:
        sets = list(sets)
        ok = self._verdict(sets)
        with self._lock:
            self.seen.append((len(sets), [s.signature for s in sets], ok))
        return ok

    def _verdict(self, sets) -> bool:
        if self.fault == "unchanged":
            with self._lock:
                if self._first is None:
                    self._first = self._verify(sets)
                return self._first
        if self.fault == "small" and len(sets) <= SMALL_SETS:
            return True
        if self.fault == "half" and len(sets) > 1:
            sets = sets[: len(sets) // 2]
        ok = self._verify(sets)
        return (not ok) if self.fault == "altered" else ok

    def by_bucket(self, tampered) -> dict:
        """{bucket: [batches that held a tampered signature, of which
        passed]}, over every batch it was given, merged or retried."""
        from portbench.harness import bucket_of

        bad = set(tampered)
        out: dict = {}
        for n, sigs, ok in self.seen:
            if bad.intersection(sigs):
                row = out.setdefault(bucket_of(n), [0, 0])
                row[0] += 1
                row[1] += bool(ok)
        return dict(sorted(out.items()))

    def close(self) -> None:
        pass


def make(kind: str) -> ReferenceVerifier:
    if kind == "sound":
        return ReferenceVerifier()
    if kind == "control":
        return ReferenceVerifier(coeff_bits=0)
    return ReferenceVerifier(fault=kind)


def main(argv=None) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=None,
                    help="window seconds (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--workers", type=int, default=None,
                    help="processes that sign and check (default: the harness's)")
    args = ap.parse_args(argv)
    args.workers = args.workers or harness.WORKERS
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = harness.traffic.load_json(os.path.join(root, "BENCHMARK.json"))
    seconds = args.seconds or bench["run_seconds"]
    cell = harness.load_cell(root, args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        for kind in args.kinds.split(","):
            verifier = make(kind)
            res = harness.run_cell(cell, seed, seconds, False, time.monotonic(),
                                   args.workers, verifier=verifier, pyref_sets=0)
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                              "correct": res.correct,
                              **{k: v["value"] for k, v in res.checks.items()},
                              "jobs": res.extra["jobs"],
                              "expected_false": res.extra["expected_false"],
                              "tampered_by_bucket": verifier.by_bucket(
                                  res.extra["tampered_signatures"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
