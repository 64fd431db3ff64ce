"""Attribution: per-merged-batch latency decomposition and the
scaling-loss breakdown (the port's copy of the JAX package's
``observatory/attribution.py``).

The span stack records *when* each pipeline stage ran; the profile
capture (``xprof.py``) records what the cards did underneath.  This
module turns both into answers:

- :func:`attribute_spans` — decompose every merged batch's end-to-end
  latency into the six-way split ``queue / pack / device_compute /
  collective_combine / final_exp / pipeline_bubble``.  Host spans alone
  give queue/pack/final_exp and the dispatch wall; merged device events
  (clock-remapped by xprof) refine the dispatch wall into device compute
  and the sharded tier's combine; whatever the stages cannot explain is
  the pipeline bubble, never silently dropped.
- ``overlap_ratio`` — the fraction of device-busy (dispatch-window) time
  during which the host was packing *another* batch: 1.0 means the
  pipeline fully hides host pack behind device compute, 0 means the
  stages strictly alternate.
- :func:`scaling_loss_breakdown` — split a measured ``1 - efficiency``
  mesh gap into communication / shard_imbalance / serial_host
  components that sum (within a tolerance, default 5 %) to the gap.  With
  per-shard walls the imbalance term is measured independently and the
  residual is reported; without them the imbalance term absorbs the
  unexplained remainder so the components always reconcile exactly.
- :func:`mesh_scaling_loss` — the live estimator used when no one-card
  baseline exists: efficiency is proxied by the device-compute fraction
  of mesh-batch wall time, split with the same arithmetic, so the
  ``bls_scaling_loss{component}`` gauges have a value between runs.

One difference from the JAX module: ``COLLECTIVE_RE`` also matches the
port's ring hop kernel, ``ring_hop_k`` (``ops/kernels/ring_kernels.cu``),
which moves the sharded tier's partials between shards; without it the
tier's combine would be booked as device compute.

Pure stdlib; inputs are SpanTracer ``Span`` objects, their ``to_dict``
forms, or Chrome trace events (a merged xprof dump) — all normalized.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: the six-way decomposition every merged batch resolves into
STAGES = (
    "queue",
    "pack",
    "device_compute",
    "collective_combine",
    "final_exp",
    "pipeline_bubble",
)

#: scaling-loss gauge label values (``bls_scaling_loss{component}``)
LOSS_COMPONENTS = ("communication", "shard_imbalance", "serial_host")

#: device event names that are communication between shards rather than
#: compute: the JAX module's collective names (XLA collective thunks, jax
#: collective primitives) and the port's ring hop kernel, ``ring_hop_k``
COLLECTIVE_RE = re.compile(
    r"all[-_]?gather|all[-_]?reduce|reduce[-_]?scatter|all[-_]?to[-_]?all"
    r"|collective|ppermut|psum\b|cross[-_]?replica|\bring_hop_k\b",
    re.I,
)

_SPAN_TO_STAGE = {
    "bls.queue_wait": "queue",
    "bls.pack": "pack",
    "bls.dispatch": "device_compute",  # refined by device events when present
    "bls.final_exp": "final_exp",
}

#: merged-trace device processes start here (xprof.DEVICE_PID_BASE twin;
#: duplicated to keep this module importable without xprof)
_DEVICE_PID_BASE = 1000


def _normalize(ev: Any) -> Optional[Dict[str, Any]]:
    """One event shape for Span objects, Span.to_dict() dicts, and Chrome
    trace events (``None`` for metadata/instant events we don't use)."""
    if isinstance(ev, dict):
        if "ts_us" in ev:  # Span.to_dict()
            args = dict(ev.get("args") or {})
            return {
                "name": ev.get("name"),
                "ts_us": float(ev.get("ts_us", 0.0)),
                "dur_us": float(ev.get("dur_us", 0.0)),
                "cid": ev.get("cid", args.get("cid")),
                "args": args,
                "pid": 0,
            }
        ph = ev.get("ph")
        if ph not in (None, "X"):
            return None
        args = dict(ev.get("args") or {})
        return {
            "name": ev.get("name"),
            "ts_us": float(ev.get("ts", 0.0)),
            "dur_us": float(ev.get("dur", 0.0)),
            "cid": args.get("cid", ev.get("id")),
            "args": args,
            "pid": int(ev.get("pid", 0) or 0),
        }
    # SpanTracer Span object
    if getattr(ev, "instant", False):
        return None
    return {
        "name": ev.name,
        "ts_us": ev.ts_ns / 1e3,
        "dur_us": ev.dur_ns / 1e3,
        "cid": ev.cid,
        "args": dict(ev.args or {}),
        "pid": 0,
    }


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total covered microseconds of an interval set (overlaps merged)."""
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _clip(a: float, b: float, lo: float, hi: float) -> Optional[Tuple[float, float]]:
    a, b = max(a, lo), min(b, hi)
    return (a, b) if b > a else None


def attribute_spans(
    events: Iterable[Any],
    device_events: Optional[Iterable[Any]] = None,
) -> Dict[str, Any]:
    """Decompose every merged batch found in ``events``.

    ``events`` may be a raw span list, ``/traces`` dicts, or a merged
    Chrome trace's ``traceEvents`` (device events at pid >=
    ``_DEVICE_PID_BASE`` are then split out automatically); explicit
    ``device_events`` (already host-clock-remapped) override the split.
    Returns ``{"batches": [per-cid dicts], "overlap_ratio": float|None}``.
    """
    host: List[Dict[str, Any]] = []
    devs: List[Dict[str, Any]] = []
    for ev in events:
        n = _normalize(ev)
        if n is None:
            continue
        (devs if n["pid"] >= _DEVICE_PID_BASE else host).append(n)
    if device_events is not None:
        devs = [n for ev in device_events if (n := _normalize(ev)) is not None]

    by_cid: Dict[Any, List[Dict[str, Any]]] = {}
    for n in host:
        if n["cid"] is None:
            continue
        if n["name"] in _SPAN_TO_STAGE or n["name"] == "pool.batch":
            by_cid.setdefault(n["cid"], []).append(n)

    dev_comm: List[Tuple[float, float]] = []
    dev_compute: List[Tuple[float, float]] = []
    for n in devs:
        iv = (n["ts_us"], n["ts_us"] + n["dur_us"])
        (dev_comm if COLLECTIVE_RE.search(n["name"] or "") else dev_compute).append(iv)

    batches: List[Dict[str, Any]] = []
    pack_by_cid: Dict[Any, List[Tuple[float, float]]] = {}
    for cid, spans in by_cid.items():
        pack_by_cid[cid] = [
            (s["ts_us"], s["ts_us"] + s["dur_us"])
            for s in spans
            if s["name"] == "bls.pack"
        ]
    for cid, spans in sorted(by_cid.items(), key=lambda kv: str(kv[0])):
        dispatch = [s for s in spans if s["name"] == "bls.dispatch"]
        if not dispatch:
            continue
        stages = {s: 0.0 for s in STAGES}
        for s in spans:
            stage = _SPAN_TO_STAGE.get(s["name"])
            if stage and stage != "device_compute":
                stages[stage] = max(stages[stage], s["dur_us"] / 1e6)
        d0 = min(s["ts_us"] for s in dispatch)
        d1 = max(s["ts_us"] + s["dur_us"] for s in dispatch)
        in_window_comm = [
            c for iv in dev_comm if (c := _clip(iv[0], iv[1], d0, d1))
        ]
        in_window_compute = [
            c for iv in dev_compute if (c := _clip(iv[0], iv[1], d0, d1))
        ]
        combine_s = _union_us(in_window_comm) / 1e6
        compute_s = _union_us(in_window_compute) / 1e6
        if combine_s + compute_s <= 0.0:
            # no device evidence: the host-side dispatch wall IS the
            # device estimate (it includes the readback wait)
            compute_s = (d1 - d0) / 1e6
        stages["device_compute"] = compute_s
        stages["collective_combine"] = combine_s
        t0 = min(s["ts_us"] for s in spans)
        t1 = max(s["ts_us"] + s["dur_us"] for s in spans)
        e2e_s = (t1 - t0) / 1e6
        explained = sum(
            stages[k] for k in STAGES if k != "pipeline_bubble"
        )
        stages["pipeline_bubble"] = max(0.0, e2e_s - explained)
        args = dispatch[0]["args"]
        other_packs = [
            iv
            for other, packs in pack_by_cid.items()
            if other != cid
            for p in packs
            if (iv := _clip(p[0], p[1], d0, d1))
        ]
        window_us = d1 - d0
        batches.append(
            {
                "cid": cid,
                "device": args.get("device"),
                "sharded": bool(args.get("sharded")),
                "mesh_devices": args.get("mesh_devices"),
                "e2e_s": e2e_s,
                "stages": {k: round(v, 9) for k, v in stages.items()},
                "explained_ratio": round(
                    min(1.0, explained / e2e_s) if e2e_s > 0 else 1.0, 4
                ),
                "overlap_ratio": round(
                    _union_us(other_packs) / window_us, 4
                )
                if window_us > 0
                else None,
                "window_us": (round(d0, 3), round(d1, 3)),
            }
        )
    windows = sum(b["window_us"][1] - b["window_us"][0] for b in batches)
    overlapped = sum(
        (b["overlap_ratio"] or 0.0) * (b["window_us"][1] - b["window_us"][0])
        for b in batches
    )
    return {
        "batches": batches,
        "overlap_ratio": round(overlapped / windows, 4) if windows > 0 else None,
    }


def scaling_loss_breakdown(
    *,
    efficiency: float,
    wall_s: float,
    comm_s: float = 0.0,
    serial_host_s: float = 0.0,
    shard_walls: Optional[Sequence[float]] = None,
    tolerance: float = 0.05,
) -> Dict[str, Any]:
    """Split ``loss = 1 − efficiency`` into communication /
    shard_imbalance / serial_host fractions of ``wall_s``.

    With ``shard_walls`` (per-shard busy walls of the mesh program) the
    imbalance term is measured — ``(max − mean) / max`` of the shard
    walls — and the residual loss the three terms fail to cover is
    reported (``within_tolerance`` gates it at ``tolerance`` of the
    loss).  Without shard walls the imbalance term absorbs the
    remainder, so the components reconcile exactly by construction.
    Over-explained components (estimators double-counting) are scaled
    down proportionally to the loss and the factor recorded.
    """
    loss = max(0.0, 1.0 - float(efficiency))
    wall = max(float(wall_s), 1e-12)
    comm = max(0.0, float(comm_s)) / wall
    serial = max(0.0, float(serial_host_s)) / wall
    measured_imbalance = (
        shard_walls is not None and len(list(shard_walls)) > 1
    )
    if measured_imbalance:
        walls = [max(0.0, float(w)) for w in shard_walls]
        mx = max(walls)
        imb = (mx - sum(walls) / len(walls)) / mx if mx > 0 else 0.0
    else:
        imb = max(0.0, loss - comm - serial)
    explained = comm + imb + serial
    scale = None
    if explained > loss and explained > 0:
        scale = loss / explained
        comm, imb, serial = comm * scale, imb * scale, serial * scale
        explained = loss
    residual = loss - explained
    out: Dict[str, Any] = {
        "efficiency": round(float(efficiency), 6),
        "loss": round(loss, 6),
        "wall_s": round(float(wall_s), 6),
        "components": {
            "communication": round(comm, 6),
            "shard_imbalance": round(imb, 6),
            "serial_host": round(serial, 6),
        },
        "imbalance_measured": measured_imbalance,
        "explained": round(explained, 6),
        "residual": round(residual, 6),
        "tolerance": tolerance,
        "within_tolerance": abs(residual) <= max(tolerance * loss, 1e-9),
    }
    if scale is not None:
        out["scale_factor"] = round(scale, 4)
    return out


def mesh_scaling_loss(
    batches: Sequence[Dict[str, Any]], tolerance: float = 0.05
) -> Optional[Dict[str, Any]]:
    """Live scaling-loss estimate over the ``sharded`` batches of an
    :func:`attribute_spans` result (no single-chip baseline needed):
    efficiency is proxied as device-compute seconds / end-to-end
    seconds — under the idealized model where a perfectly scaled mesh
    batch is 100 % parallel device compute — and split with the same
    arithmetic the bench uses on the measured efficiency."""
    mesh = [b for b in batches if b.get("sharded")]
    if not mesh:
        return None
    e2e = sum(b["e2e_s"] for b in mesh)
    if e2e <= 0:
        return None
    compute = sum(b["stages"]["device_compute"] for b in mesh)
    comm = sum(b["stages"]["collective_combine"] for b in mesh)
    serial = sum(
        b["stages"]["queue"] + b["stages"]["pack"] + b["stages"]["final_exp"]
        for b in mesh
    )
    return scaling_loss_breakdown(
        efficiency=min(1.0, compute / e2e),
        wall_s=e2e,
        comm_s=comm,
        serial_host_s=serial,
        tolerance=tolerance,
    )


def publish(metrics, report: Optional[Dict[str, Any]],
            breakdown: Optional[Dict[str, Any]] = None) -> None:
    """Set/observe the mesh-observatory metric families from an
    attribution report (+ optional scaling-loss breakdown)."""
    if metrics is None:
        return
    if report:
        ov = report.get("overlap_ratio")
        if ov is not None:
            metrics.bls_mesh_overlap_ratio.set(ov)
        for b in report.get("batches", ()):
            metrics.bls_pipeline_bubble_seconds.observe(
                b["stages"]["pipeline_bubble"]
            )
            if b.get("sharded"):
                metrics.bls_sharded_combine_seconds.observe(
                    b["stages"]["collective_combine"]
                )
    if breakdown:
        for comp in LOSS_COMPONENTS:
            metrics.bls_scaling_loss.labels(component=comp).set(
                breakdown["components"].get(comp, 0.0)
            )
