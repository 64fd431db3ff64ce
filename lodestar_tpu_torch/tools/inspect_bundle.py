"""Validate and summarize a diagnostic bundle (lodestar_tpu_torch/forensics).

The port's copy of the repo's ``tools/inspect_bundle.py``: it reads the
port's bundle schema, manifest name and journal keys, so that the port
checks its own bundles without the JAX package.

Usage:
    python -m lodestar_tpu_torch.tools.inspect_bundle BUNDLE_DIR [--json]

Validation (exit 1 with one error per line on failure):

- ``manifest.json`` present, parses, ``schema`` is a supported version,
  and the required keys (reason/created_unix/pid/files/journal/trace/
  inflight) are present;
- every file the manifest lists actually exists in the bundle — the
  manifest is written LAST, so a listed-but-missing file means a
  corrupted bundle, not an interrupted dump;
- the manifest notes its drop counts (``journal.dropped`` /
  ``trace.dropped``) so a reader knows how much history is missing;
- ``journal.jsonl`` is one JSON object per line, each carrying the
  REQUIRED_EVENT_KEYS of the journal schema, in ``seq`` order;
- ``trace.json`` passes the Chrome trace-event schema of the repo's
  ``tools/check_trace.py`` (standard library only, loaded by path;
  including its own drop-count note);
- ``inflight.json`` parses and its ``inflight`` table is a list.

Summary (the triage view — what a responder needs FIRST after a death):

- reason, wall time, pid, and any per-section dump errors;
- the last build, store load or graph capture the compile ledger
  journaled (``compile.ledger``: was a build in flight?);
- stalled batches: cid, device, bucket, age at flag time;
- per-device in-flight counts at dump time;
- the last ERROR/WARNING journal events (the stderr that got lost);
- chaos triage: the armed fault plan's seed, the last
  injected fault (seam + context), requeued-batch count, per-executor
  health states, and the quarantine/re-admission timeline;
- kernel-library store triage: the store path, the last
  ``aot.corrupt``/``aot.skew`` events, and the per-entry load outcome
  timeline (loads/misses/saves) — the first questions after a restart
  that came up slow or degraded.

``--json`` prints the summary as one JSON object instead of text
(harnesses and tests consume this form).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional

from ..forensics.bundle import BUNDLE_SCHEMA, MANIFEST_NAME
from ..forensics.journal import REQUIRED_EVENT_KEYS

#: the repository root (the port's package sits in it)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_check_trace():
    """The repo's ``tools/check_trace.py`` (standard library only), loaded
    by path."""
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(REPO, "tools", "check_trace.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MANIFEST_REQUIRED = (
    "schema", "reason", "created_unix", "pid", "files",
    "journal", "trace", "inflight",
)


def validate(bundle_dir: str) -> List[str]:
    """Schema errors for one bundle directory (empty list = valid)."""
    errors: List[str] = []
    manifest_path = os.path.join(bundle_dir, MANIFEST_NAME)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{MANIFEST_NAME}: unreadable ({e}) — bundle incomplete or corrupt"]
    for key in MANIFEST_REQUIRED:
        if key not in manifest:
            errors.append(f"{MANIFEST_NAME}: missing required key {key!r}")
    schema = manifest.get("schema")
    if schema != BUNDLE_SCHEMA:
        errors.append(
            f"{MANIFEST_NAME}: schema {schema!r} != supported {BUNDLE_SCHEMA}"
        )
    # drop-count notes: a dump that cannot say how much history it is
    # missing is not a flight recorder, it is a guess
    for section in ("journal", "trace"):
        meta = manifest.get(section)
        if isinstance(meta, dict) and not isinstance(meta.get("dropped"), int):
            errors.append(f"{MANIFEST_NAME}: {section}.dropped count missing")
    for fname in manifest.get("files", []):
        if not os.path.exists(os.path.join(bundle_dir, fname)):
            errors.append(f"{fname}: listed in manifest but absent")

    jpath = os.path.join(bundle_dir, "journal.jsonl")
    if os.path.exists(jpath):
        prev_seq = None
        for lineno, line in enumerate(open(jpath), 1):
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                errors.append(f"journal.jsonl:{lineno}: not valid JSON")
                continue
            for key in REQUIRED_EVENT_KEYS:
                if key not in ev:
                    errors.append(f"journal.jsonl:{lineno}: missing {key!r}")
            seq = ev.get("seq")
            if isinstance(seq, int) and prev_seq is not None and seq <= prev_seq:
                errors.append(
                    f"journal.jsonl:{lineno}: seq {seq} not increasing "
                    f"(prev {prev_seq})"
                )
            if isinstance(seq, int):
                prev_seq = seq

    tpath = os.path.join(bundle_dir, "trace.json")
    if os.path.exists(tpath):
        check_trace = _load_check_trace()
        try:
            with open(tpath) as f:
                trace = json.load(f)
        except ValueError as e:
            errors.append(f"trace.json: not valid JSON ({e})")
        else:
            errors.extend(f"trace.json: {e}" for e in check_trace.validate(trace))
            if isinstance(trace, dict) and not isinstance(
                (trace.get("otherData") or {}).get("dropped_spans"), int
            ):
                errors.append("trace.json: otherData.dropped_spans note missing")

    ipath = os.path.join(bundle_dir, "inflight.json")
    if os.path.exists(ipath):
        try:
            with open(ipath) as f:
                inflight = json.load(f)
        except ValueError as e:
            errors.append(f"inflight.json: not valid JSON ({e})")
        else:
            if not isinstance(inflight.get("inflight"), list):
                errors.append("inflight.json: 'inflight' table missing or not a list")
    return errors


def _journal_events(bundle_dir: str) -> List[Dict[str, Any]]:
    path = os.path.join(bundle_dir, "journal.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    for line in open(path):
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def summarize(bundle_dir: str) -> Dict[str, Any]:
    """The triage summary: what was this process doing when it died."""
    with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    events = _journal_events(bundle_dir)
    compiles = [e for e in events if e.get("kind") == "compile.ledger"]
    errors_log = [e for e in events if e.get("level") in ("ERROR", "CRITICAL")]
    warnings_log = [e for e in events if e.get("level") == "WARNING"]
    inflight = manifest.get("inflight") or []
    per_device: Dict[str, int] = {}
    for e in inflight:
        dev = str(e.get("device"))
        per_device[dev] = per_device.get(dev, 0) + 1
    inflight_file: Optional[Dict[str, Any]] = None
    ipath = os.path.join(bundle_dir, "inflight.json")
    if os.path.exists(ipath):
        try:
            with open(ipath) as f:
                inflight_file = json.load(f)
        except ValueError:
            pass
    # chaos triage: what was INDUCED (manifest.chaos from
    # the armed fault plan), what the self-healing pool did about it
    # (bls.requeue / bls.health journal events), and where every executor's
    # health state machine stands (inflight.json verifier.health)
    chaos_manifest = manifest.get("chaos") or {}
    injected = chaos_manifest.get("injected") or []
    requeues = [e for e in events if e.get("kind") == "bls.requeue"]
    health_events = [e for e in events if e.get("kind") == "bls.health"]
    health_timeline = [
        {k: e.get(k) for k in ("wall", "device", "state", "failures",
                               "backoff_s", "readmitted")}
        for e in health_events
    ]
    verifier_stats = (inflight_file or {}).get("verifier") or {}
    # store triage: what the durable kernel-library store did — per-entry
    # load outcomes plus the last corruption/skew events
    aot_events = [
        e for e in events if str(e.get("kind", "")).startswith("aot.")
    ]
    aot_summary: Optional[Dict[str, Any]] = None
    if aot_events:
        corrupts = [e for e in aot_events if e.get("kind") == "aot.corrupt"]
        skews = [e for e in aot_events if e.get("kind") == "aot.skew"]
        store_paths = [e.get("store") for e in aot_events if e.get("store")]
        aot_summary = {
            "store": store_paths[-1] if store_paths else None,
            "loads": sum(1 for e in aot_events if e.get("kind") == "aot.load"),
            "misses": sum(1 for e in aot_events if e.get("kind") == "aot.miss"),
            "saves": sum(1 for e in aot_events if e.get("kind") == "aot.save"),
            "corrupt": len(corrupts),
            "skew": len(skews),
            "last_corrupt": corrupts[-1] if corrupts else None,
            "last_skew": skews[-1] if skews else None,
            "outcomes": [
                {k: e.get(k) for k in ("wall", "kind", "entry", "bucket",
                                       "device", "seconds", "what", "reason")}
                for e in aot_events[-10:]
            ],
        }
    chaos_summary: Optional[Dict[str, Any]] = None
    if injected or requeues or health_events or chaos_manifest:
        chaos_summary = {
            "armed": chaos_manifest.get("armed"),
            "seed": chaos_manifest.get("seed"),
            "last_fault": injected[-1] if injected else None,
            "injected_total": len(injected),
            "requeued_batches": len(requeues),
            "executor_health": verifier_stats.get("health"),
            "health_timeline": health_timeline,
        }
    return {
        "bundle": bundle_dir,
        "reason": manifest.get("reason"),
        "created_unix": manifest.get("created_unix"),
        "pid": manifest.get("pid"),
        "schema": manifest.get("schema"),
        "chaos": chaos_summary,
        "aot": aot_summary,
        "dump_errors": manifest.get("errors"),
        "journal_events": manifest.get("journal", {}).get("events"),
        "journal_dropped": manifest.get("journal", {}).get("dropped"),
        "trace_spans": manifest.get("trace", {}).get("spans"),
        "trace_dropped": manifest.get("trace", {}).get("dropped"),
        "last_compile": compiles[-1] if compiles else None,
        # overload bundles (shed-rate trigger, chain/bls_pool): per-lane
        # shed counts and queue depth at trigger — the first thing a
        # responder needs for a "node under storm" death
        "overload": manifest.get("overload"),
        "stalled": [
            {
                k: e.get(k)
                for k in ("cid", "device", "bucket", "sets", "age_s", "deadline_s")
            }
            for e in manifest.get("stalled") or []
        ],
        "inflight_per_device": per_device,
        "inflight_total": len(inflight),
        "verifier": (inflight_file or {}).get("verifier"),
        "pool": (inflight_file or {}).get("pool"),
        "last_errors": errors_log[-5:],
        "last_warnings": warnings_log[-5:],
    }


def _print_text(s: Dict[str, Any]) -> None:
    print(f"bundle   {s['bundle']}")
    print(f"reason   {s['reason']}  (pid {s['pid']}, schema {s['schema']})")
    print(f"journal  {s['journal_events']} events ({s['journal_dropped']} dropped)")
    print(f"trace    {s['trace_spans']} spans ({s['trace_dropped']} dropped)")
    if s["dump_errors"]:
        print(f"dump errors: {s['dump_errors']}")
    lc = s["last_compile"]
    if lc:
        print(f"last compile  {lc.get('compile_kind')} {lc.get('entry')} "
              f"b{lc.get('bucket')} {lc.get('device')}  {lc.get('seconds')}s "
              f"(wall {lc.get('wall')})")
    else:
        print("last compile  none recorded")
    ov = s.get("overload")
    if ov:
        print(f"OVERLOAD: {ov.get('shed_window_sets')} sets shed in the last "
              f"{ov.get('window_s')}s; queue {ov.get('queue_depth_jobs')} jobs "
              f"/ {ov.get('pending_sets')} sets; "
              f"backpressure={'on' if ov.get('backpressure') else 'off'}")
        if ov.get("dropped_by_lane"):
            for lane, n in sorted(ov["dropped_by_lane"].items()):
                print(f"  shed lane {lane:15s} {n} sets")
        if ov.get("dropped_by_reason"):
            for reason, n in sorted(ov["dropped_by_reason"].items()):
                print(f"  shed reason {reason:13s} {n} sets")
    aot = s.get("aot")
    if aot:
        print(f"store  {aot.get('store')}  loads={aot.get('loads')} "
              f"misses={aot.get('misses')} saves={aot.get('saves')} "
              f"corrupt={aot.get('corrupt')} skew={aot.get('skew')}")
        lc = aot.get("last_corrupt")
        if lc:
            print(f"  last corrupt  {lc.get('what')} entry={lc.get('entry')} "
                  f"b{lc.get('bucket')} {lc.get('device')} (wall {lc.get('wall')})")
        ls = aot.get("last_skew")
        if ls:
            print(f"  last skew     {ls.get('reason')} entry={ls.get('entry')} "
                  f"b{ls.get('bucket')} {ls.get('device')} (wall {ls.get('wall')})")
        for e in aot.get("outcomes") or []:
            print(f"  {e.get('wall')}  {e.get('kind'):12s} "
                  f"{e.get('entry')} b{e.get('bucket')} {e.get('device')}")
    ch = s.get("chaos")
    if ch:
        lf = ch.get("last_fault") or {}
        print(f"CHAOS: plan {'armed' if ch.get('armed') else 'disarmed'} "
              f"(seed {ch.get('seed')}), {ch.get('injected_total')} fault(s) "
              f"injected, {ch.get('requeued_batches')} batch(es) requeued")
        if lf:
            print(f"  last fault  seam={lf.get('seam')} seed={lf.get('seed')} "
                  f"ctx={lf.get('ctx')}")
        for dev, h in sorted((ch.get("executor_health") or {}).items()):
            extra_h = ""
            if h.get("readmission_in_s") is not None:
                extra_h = f" readmission in {h['readmission_in_s']}s"
            print(f"  health {dev:12s} {h.get('state'):11s} "
                  f"failures={h.get('failures')} "
                  f"quarantines={h.get('quarantines')}{extra_h}")
        for e in ch.get("health_timeline") or []:
            tag = " (re-admitted)" if e.get("readmitted") else ""
            print(f"  {e.get('wall')}  {e.get('device')} -> {e.get('state')}"
                  f"{tag} failures={e.get('failures')}")
    if s["stalled"]:
        print("STALLED batches:")
        for e in s["stalled"]:
            dl = e.get("deadline_s")
            worth = "" if dl is None else (
                f" deadline_headroom={dl}s" + (" (EXPIRED)" if dl < 0 else "")
            )
            print(f"  cid={e['cid']} device={e['device']} bucket={e['bucket']} "
                  f"sets={e['sets']} age={e['age_s']}s{worth}")
    print(f"in flight at dump: {s['inflight_total']} "
          f"(per device: {s['inflight_per_device'] or '{}'})")
    for e in s["last_errors"]:
        print(f"  ERROR  {e.get('kind')}: {e.get('msg') or e.get('exc') or e.get('error') or e}")
    for e in s["last_warnings"]:
        print(f"  WARN   {e.get('kind')}: {e.get('msg') or e.get('exc') or e.get('error') or e}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle_dir")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable summary on stdout")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.bundle_dir):
        print(f"{args.bundle_dir}: not a directory", file=sys.stderr)
        return 1
    errors = validate(args.bundle_dir)
    for err in errors:
        print(f"{args.bundle_dir}: {err}", file=sys.stderr)
    if errors:
        return 1
    summary = summarize(args.bundle_dir)
    if args.json:
        print(json.dumps(summary, default=str))
    else:
        _print_text(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
