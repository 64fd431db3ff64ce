"""Per-layer metric readers, one module per metric, found by the metric's
name in ``BENCHMARK.json``: ``<name>.py`` here defines ``read(ctx)``,
which returns the metric's value or None when the run gave it nothing to
read (the harness then leaves the metric out of the line).

``Context`` is what a reader may read: the port's spans (those that ended
before ``span_cutoff_ns``, the profiler sub-window's start: the
sub-window's own cost stays out of them), the verifier's
``stage_seconds`` and host final exponentiations over the same stretch of
the window, and the device sub-window's summary (``devtrace``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


@dataclasses.dataclass
class Context:
    spans: list
    span_cutoff_ns: Optional[int] = None
    stage_delta: Dict[str, float] = dataclasses.field(default_factory=dict)
    final_exps_delta: Optional[int] = None
    device: Optional[dict] = None

    def spans_named(self, name: str) -> List:
        cut = self.span_cutoff_ns
        return [s for s in self.spans if s.name == name
                and (cut is None or s.ts_ns + s.dur_ns <= cut)]

    def device_batches(self) -> List[dict]:
        return list(self.device["batches"]) if self.device else []


def _reader(name: str):
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(ctx: Context, cell: str, root: str = ROOT) -> Dict[str, dict]:
    """Every per-layer metric of ``cell`` that its reader found, with the
    unit ``BENCHMARK.json`` gives it."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = _reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
