"""Run ledger: ``chip_smoke.py``'s run records as a regression-gated
trend (the port's copy of the JAX package's ``observatory/run_ledger``).

Every ``chip_smoke.py`` run writes one record (:func:`make_record`,
:func:`write_record`) under ``chiprun_out/runs/``.  This module reads
the series, computes per-metric trends with noise bands, and classifies:

- **regression** -- the latest value moved against the metric's good
  direction by more than its tripwire threshold AND beyond the noise
  band of the earlier points of the same card (``python -m
  lodestar_tpu_torch.tools.perf_report`` exits 1);
- **plateau** -- >= ``PLATEAU_RUNS`` trailing values within a tight
  relative band on a metric that is supposed to move (a warning);
- **gap** -- a record that holds the metric with no value (its run runs
  the metric's phase, which failed or was killed): trend math skips it,
  the report names it.  A record without the metric (an ``--ops-only``
  run and the split rate: chip_smoke records only the metrics of the
  phases a mode runs) is no gap: it has no point.

The series is partitioned by card: ``nvidia-smi``'s ``name, power.limit``
(:func:`run_card`), so that a run on another card, or at another power
limit, is a sub-series of its own and a switch of card never regresses.

:data:`TRIPWIRES` keeps the JAX table's names, directions and thresholds.
``fp_mul_speedup_mxu`` (the TPU's MXU limb product against its VPU
ladder) has no counterpart on the card and is left out, as the TPU
workarounds are.  ``scaling_efficiency``, ``mesh_overlap_ratio``, the
``scaling_loss_*`` terms and ``epoch_transition_ms_250k`` stay in the
table with no phase that measures them: no record holds them yet.

Reads and writes JSON only; imports nothing beyond the standard library.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: metric -> (direction, relative tripwire).  direction +1 = higher is
#: better, -1 = lower is better; the tripwire is the relative change
#: against the good direction that fails the gate.
TRIPWIRES: Dict[str, Tuple[int, float]] = {
    "bls_sig_sets_per_s_per_chip": (+1, 0.10),
    "bls_sig_sets_per_s": (+1, 0.10),
    "scaling_efficiency": (+1, 0.10),
    "bls_sig_sets_per_s_sharded": (+1, 0.10),
    "scaling_efficiency_sharded": (+1, 0.10),
    "mesh_overlap_ratio": (+1, 0.15),
    "scaling_loss_communication": (-1, 0.25),
    "scaling_loss_shard_imbalance": (-1, 0.25),
    "scaling_loss_serial_host": (-1, 0.25),
    "cold_start_warm_s": (-1, 0.25),
    "cold_start_aot_s": (-1, 0.25),
    "cold_start_cold_s": (-1, 0.25),
    "dev_chain_blocks_per_s": (+1, 0.15),
    "range_sync_blocks_per_s": (+1, 0.15),
    "epoch_transition_ms_250k": (-1, 0.25),
    "sustained_sets_per_s_at_slo": (+1, 0.10),
    "dispatch_ms": (-1, 0.15),
}

#: a tier-1 ledger entry counts as a FULL suite run at or above this many
#: tests (the repo's tests/conftest.py splits its rings on the JAX
#: package's constant, which this one equals)
TIER1_FULL_RUN_MIN_TESTS = 400

#: metrics where a multi-run flat line is itself a finding
PLATEAU_METRICS = ("bls_sig_sets_per_s_per_chip", "bls_sig_sets_per_s")
PLATEAU_RUNS = 2
PLATEAU_BAND = 0.05  # +/-5% relative

SCHEMA = 1

#: where chip_smoke.py keeps its records, under the checkout
RUNS_DIR = os.path.join("chiprun_out", "runs")


def parse_card(line: str) -> Dict[str, Optional[str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    line -> {"name", "power_limit"}."""
    name, sep, limit = line.strip().rpartition(", ")
    return {"name": name, "power_limit": limit} if sep else {"name": limit, "power_limit": None}


def make_record(mode: str, rc: int, card: str, metrics: Dict[str, Optional[float]],
                phases_run: str, phases_s: Dict[str, float], commit: Optional[str] = None,
                torch_version: Optional[str] = None, cuda_version: Optional[str] = None,
                utc: Optional[float] = None) -> Dict[str, Any]:
    """One chip_smoke run's record: its mode, the phases it runs and its
    exit code, the card's nvidia-smi line, the versions, each phase's wall
    seconds and ``metrics``: the TRIPWIRES metrics of the phases the run
    runs, each a number or None where the run produced none (a gap).  A
    metric of a phase the run does not run is left out."""
    unknown = sorted(set(metrics) - set(TRIPWIRES))
    if unknown:
        raise ValueError(f"not tripwire metrics: {unknown}")
    return {
        "schema": SCHEMA,
        "utc": round(time.time() if utc is None else utc, 3),
        "commit": commit,
        "mode": mode,
        "phases_run": phases_run,
        "rc": int(rc),
        "card": parse_card(card),
        "torch": torch_version,
        "cuda": cuda_version,
        "phases_s": {k: round(float(v), 3) for k, v in phases_s.items()},
        "metrics": {name: (None if v is None else float(v)) for name, v in metrics.items()},
    }


def write_record(record: Dict[str, Any], runs_dir: str) -> str:
    """Writes ``record`` to ``runs_dir`` (made if missing) under a name
    of its time and mode; returns the path."""
    os.makedirs(runs_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(record["utc"]))
    millis = int(round(record["utc"] * 1000)) % 1000
    path = os.path.join(runs_dir, f"smoke-{stamp}.{millis:03d}Z-{record['mode']}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_series(paths: Iterable[str]) -> List[dict]:
    """The records at ``paths`` in ``utc`` order, each given ``_run`` (its
    1-based place in the series) and ``_path``; files that are not
    records are skipped."""
    out = []
    for path in paths:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(data, dict) or "utc" not in data or "metrics" not in data:
            continue
        data["_path"] = os.path.basename(path)
        out.append(data)
    out.sort(key=lambda d: (d["utc"], d["_path"]))
    for i, d in enumerate(out, start=1):
        d["_run"] = i
    return out


def run_card(run: dict) -> Optional[str]:
    """The card a record measured on, as nvidia-smi's ``name, power.limit``
    line (None for a record without one).  Rates on two cards, or on one
    card at two power limits, are not comparable, so trend verdicts and
    deltas only ever compare records of the same card."""
    card = run.get("card") or {}
    if not card.get("name"):
        return None
    return ", ".join(str(v) for v in (card["name"], card.get("power_limit")) if v)


def extract_metrics(run: dict) -> Dict[str, Optional[float]]:
    """The tripwire metrics a record's run measures (None = the run
    produced no value: a gap, not a zero); a metric of a phase the run
    does not run is absent."""
    return {name: v for name, v in (run.get("metrics") or {}).items() if name in TRIPWIRES}


def _noise_band(values: List[float]) -> float:
    """Relative noise band of a series: stddev of consecutive relative
    steps (robust to drift; 2 points -> their single step; 1 point -> a
    5% floor so a single-sample history never declares regressions on
    measurement jitter alone)."""
    steps = [
        abs(b - a) / abs(a)
        for a, b in zip(values, values[1:])
        if a
    ]
    if not steps:
        return 0.05
    mean = sum(steps) / len(steps)
    var = sum((s - mean) ** 2 for s in steps) / len(steps)
    return max(0.02, mean + math.sqrt(var))


def trend_metric(
    points: List[Tuple[int, Optional[float]]],
    direction: int,
    threshold: float,
    plateau: bool = False,
    cards: Optional[List[Optional[str]]] = None,
) -> Dict[str, Any]:
    """Trend verdict for one metric over (run, value|None) points.

    ``cards`` (aligned with ``points``, see :func:`run_card`) partitions
    the series: regressions, noise bands and plateaus are only ever
    computed within one card's sub-series and the flags unioned.  ``None``
    cards form their own group.
    """
    gaps = [r for r, v in points if v is None]
    series = [(r, float(v)) for r, v in points if v is not None]
    ck = cards if cards is not None else [None] * len(points)
    series_ck = [c for (r, v), c in zip(points, ck) if v is not None]
    out: Dict[str, Any] = {
        "points": {f"r{r:02d}": v for r, v in series},
        "gaps": [f"r{r:02d}" for r in gaps],
        "flags": [],
    }
    if not series:
        return out
    runs, values = zip(*series)
    out["last"] = values[-1]
    out["best"] = max(values) if direction > 0 else min(values)

    def _judge(vals):
        """(flags, delta_pct, band_pct) over one card's sub-series."""
        flags = []
        delta_pct = band_pct = None
        if len(vals) >= 2:
            last, prev = vals[-1], vals[-2]
            delta = (last - prev) / abs(prev) if prev else 0.0
            delta_pct = round(delta * 100, 1)
            band = _noise_band(list(vals[:-1]))
            band_pct = round(band * 100, 1)
            # "moved against the good direction": direction*delta < 0
            if direction * delta < 0 and abs(delta) >= max(threshold, band):
                flags.append("regression")
            # ratchet check against the best: a slow multi-run bleed
            # passes every pairwise check but still loses the threshold
            best = max(vals) if direction > 0 else min(vals)
            slump = (last - best) / abs(best) if best else 0.0
            if direction * slump < 0 and abs(slump) >= max(threshold, band) \
                    and "regression" not in flags:
                flags.append("regression_vs_best")
        if plateau and len(vals) >= PLATEAU_RUNS:
            tail = vals[-PLATEAU_RUNS:]
            mid = sorted(tail)[len(tail) // 2]
            if mid and all(abs(v - mid) / abs(mid) <= PLATEAU_BAND for v in tail):
                flags.append("plateau")
        return flags, delta_pct, band_pct

    # group the measured values by card, keeping run order
    groups: Dict[Optional[str], List[float]] = {}
    for v, c in zip(values, series_ck):
        groups.setdefault(c, []).append(v)
    last_card = series_ck[-1]
    for c, vals in groups.items():
        flags, delta_pct, band_pct = _judge(vals)
        for f in flags:
            if f not in out["flags"]:
                out["flags"].append(f)
        # the headline delta / noise columns describe the latest
        # measurement's card
        if c == last_card:
            if delta_pct is not None:
                out["delta_vs_prev_pct"] = delta_pct
            if band_pct is not None:
                out["noise_band_pct"] = band_pct
    return out


def analyze(paths: Iterable[str], compile_ledger: Optional[str] = None,
            tier1: Optional[str] = None) -> Dict[str, Any]:
    """The whole report: per-metric trends, the crashed runs, the
    compile-ledger sidecar (the port's ``COMPILE_LEDGER`` file at
    ``compile_ledger``) and the tier-1 sidecar (the repo's
    ``.jax_cache/tier1_timings.json`` at ``tier1``); each sidecar is None
    without a path or a readable file."""
    runs = load_series(paths)
    per_run = [(r["_run"], extract_metrics(r)) for r in runs]
    cards = [run_card(r) for r in runs]
    crashed = [
        {"run": f"r{r['_run']:02d}", "rc": r.get("rc"), "file": r.get("_path")}
        for r in runs if r.get("rc") not in (0, None)
    ]
    metrics: Dict[str, Any] = {}
    for name, (direction, threshold) in TRIPWIRES.items():
        measured = [(run, vals, card) for (run, vals), card in zip(per_run, cards)
                    if name in vals]
        metrics[name] = trend_metric(
            [(run, vals[name]) for run, vals, _ in measured], direction, threshold,
            plateau=name in PLATEAU_METRICS, cards=[card for _, _, card in measured],
        )
    regressions = sorted(
        name for name, t in metrics.items()
        if any(f.startswith("regression") for f in t["flags"])
    )
    warnings = sorted(
        name for name, t in metrics.items() if "plateau" in t["flags"]
    )
    return {
        "runs": [f"r{r['_run']:02d}" for r in runs],
        "records": [{"run": f"r{r['_run']:02d}", "file": r["_path"], "utc": r.get("utc"),
                     "mode": r.get("mode"), "rc": r.get("rc"), "card": run_card(r),
                     "commit": r.get("commit")} for r in runs],
        "metrics": metrics,
        "crashed_runs": crashed,
        "multichip_dryruns": [],
        "regressions": regressions,
        "plateaus": warnings,
        "compile_ledger": _sidecar_compile_ledger(compile_ledger),
        "tier1": _sidecar_tier1(tier1),
    }


def _sidecar_compile_ledger(path: Optional[str]) -> Optional[dict]:
    if not path:
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    by_kind: Dict[str, Dict[str, float]] = {}
    for rec in (data.get("records") or {}).values():
        for kind, s in rec.get("kinds", {}).items():
            d = by_kind.setdefault(kind, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            d["count"] += s.get("count", 0)
            d["total_s"] = round(d["total_s"] + s.get("total_s", 0.0), 1)
            d["max_s"] = round(max(d["max_s"], s.get("max_s", 0.0)), 1)
    return {"keys": len(data.get("records") or {}), "by_kind": by_kind}


def _sidecar_tier1(path: Optional[str]) -> Optional[dict]:
    if not path:
        return None
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    # subset invocations also append to the ledger; only full-suite-scale
    # runs say anything about the cap
    runs = [
        r for r in (data.get("runs") or [])
        if r.get("n_tests", 0) >= TIER1_FULL_RUN_MIN_TESTS
    ]
    if not runs:
        return None
    return {
        "runs": len(runs),
        "wall_s": [r.get("wall_s") for r in runs],
        "last_n_tests": runs[-1].get("n_tests"),
    }


def deltas_vs_previous(paths: Iterable[str], current: Dict[str, Optional[float]],
                       card: Optional[str] = None) -> Dict[str, Any]:
    """Each current metric against the newest earlier record that produced
    it, with the tripwire verdict (the JAX bench's ``extras.perf_deltas``).

    ``card`` (nvidia-smi's ``name, power.limit`` line of this run)
    restricts the comparison to records of the same card; ``None`` keeps
    the whole series.
    """
    runs = load_series(paths)
    if card is not None:
        runs = [r for r in runs if run_card(r) == card.strip()]
    out: Dict[str, Any] = {}
    for name, now in current.items():
        if now is None or name not in TRIPWIRES:
            continue
        direction, threshold = TRIPWIRES[name]
        prior = [
            float(v) for r in runs
            for v in [extract_metrics(r).get(name)] if v is not None
        ]
        entry: Dict[str, Any] = {"now": round(float(now), 3)}
        if prior and prior[-1]:
            prev = prior[-1]
            prev_run = next(
                f"r{r['_run']:02d}" for r in reversed(runs)
                if extract_metrics(r).get(name) is not None
            )
            delta = (float(now) - prev) / abs(prev)
            # the verdict arithmetic of trend_metric: a step inside the
            # series' own noise band never regresses
            band = _noise_band(prior) if len(prior) >= 2 else 0.0
            entry.update({
                "prev": round(prev, 3), "prev_run": prev_run,
                "delta_pct": round(delta * 100, 1),
                "noise_band_pct": round(band * 100, 1),
                "regressed": bool(
                    direction * delta < 0
                    and abs(delta) >= max(threshold, band)
                ),
            })
        out[name] = entry
    return out
