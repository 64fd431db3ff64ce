"""Chrome trace-event exporter for SpanTracer dumps (the port's copy of the
JAX package's ``tracing/export.py``).

Produces the JSON Object Format of the Trace Event spec (the format
``chrome://tracing`` and Perfetto's legacy importer load): a top-level
``traceEvents`` list of complete events (``ph: "X"``, microsecond ``ts``
and ``dur``), instant events (``ph: "i"``), and metadata events naming
the process and each recording thread.  Correlation ids ride in
``args.cid`` and in the event ``id`` so Perfetto's flow/selection tools
can group one merged batch's queue-wait/pack/dispatch/final-exp spans.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from .tracer import SpanTracer

PROCESS_NAME = "lodestar-tpu-torch"


def to_chrome_trace(tracer: SpanTracer) -> Dict[str, Any]:
    """Render the tracer's current ring buffer as a Chrome trace object."""
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {"name": PROCESS_NAME},
        }
    ]
    for tid, tname in sorted(tracer.thread_names().items()):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": tid,
                "args": {"name": tname},
            }
        )
    for s in tracer.spans():
        ev: Dict[str, Any] = {
            "name": s.name,
            "cat": s.cat,
            "pid": 0,
            "tid": s.tid,
            "ts": s.ts_ns / 1e3,
        }
        args = dict(s.args) if s.args else {}
        if s.cid is not None:
            args["cid"] = s.cid
            ev["id"] = s.cid
        if args:
            ev["args"] = args
        if s.instant:
            ev["ph"] = "i"
            ev["s"] = "g"  # global-scope instant (full-height line)
        else:
            ev["ph"] = "X"
            ev["dur"] = s.dur_ns / 1e3
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": PROCESS_NAME,
            "dropped_spans": tracer.dropped,
        },
    }


def write_chrome_trace(tracer: SpanTracer, path: str) -> str:
    """Dump the tracer to ``path`` as Chrome trace JSON; returns the path."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f)
    return path
