"""The traced run's device evidence: one ``torch.profiler`` sub-window on
the card, read from its Kineto events.

A batch on the card is one ``BucketProgram.run``: seven host-to-device
copies, one CUDA-graph replay, the copies of its outputs back.  The
replay's device events carry the correlation id of its
``cudaGraphLaunch``; the batch's bucket is the one the verifier's
``bls.dispatch`` span that encloses the launch names (the profiler's
clock is the host's wall clock, mapped onto the spans' monotonic clock by
the offset read when the profiler starts), and its sets those of the
``bls.pack`` span that the same thread closed last before that dispatch
(``dispatch_spans``).  A batch counts when its launch and all of its
device events lie inside the sub-window.

The port's kernels are the ``__global__`` functions of
``lodestar_tpu_torch/ops/kernels/*.cu`` (their names are read from the
sources at run time); every other device event inside a replay is glue.
"""

from __future__ import annotations

import bisect
import glob
import os
import re
import time
from typing import Dict, List, Sequence

from . import work
from .stats import union_seconds

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KERNEL_SOURCES = os.path.join(ROOT, "lodestar_tpu_torch", "ops", "kernels")


def port_kernel_names(src_dir: str = KERNEL_SOURCES) -> set:
    """The identifiers of the port's CUDA kernels, from its sources."""
    names = set()
    for path in glob.glob(os.path.join(src_dir, "*.cu")) + glob.glob(
            os.path.join(src_dir, "*.cuh")):
        with open(path) as f:
            text = f.read()
        names.update(n + "_k" for n in re.findall(r"^LF_COOP_KERNEL\((\w+)", text, re.M))
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                text))
    names.discard("__launch_bounds__")
    return names


def _base_name(name: str) -> str:
    m = re.match(r"\s*(?:void\s+)?([A-Za-z_][\w:]*)", name)
    return m.group(1).split("::")[-1] if m else name


def dispatch_spans(spans: Sequence) -> List[tuple]:
    """(start ns, end ns, bucket, sets) of every ``bls.dispatch`` span, by
    start; ``sets`` is the count of the last ``bls.pack`` span its thread
    ended at or before the dispatch began (None where there is none)."""
    packs: Dict[int, list] = {}
    for sp in spans:
        if sp.name == "bls.pack" and sp.args:
            packs.setdefault(sp.tid, []).append((sp.ts_ns + sp.dur_ns, sp.args.get("sets")))
    ends = {}
    for tid, v in packs.items():
        v.sort(key=lambda p: p[0])
        ends[tid] = [e for e, _ in v]
    out = []
    for sp in spans:
        if sp.name != "bls.dispatch" or not sp.args:
            continue
        k = bisect.bisect_right(ends.get(sp.tid, []), sp.ts_ns) - 1
        out.append((sp.ts_ns, sp.ts_ns + sp.dur_ns, sp.args.get("bucket"),
                    packs[sp.tid][k][1] if k >= 0 else None))
    return sorted(out, key=lambda d: d[0])


def warm_profiler(dev) -> None:
    """One short profile in set-up, so that the window's start does not
    pay the profiler's first initialisation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(16, device=dev).sum().item()


class Profile:
    """A ``torch.profiler`` window on ``dev``: ``start`` and ``stop`` on one
    thread; the sub-window read runs from ``start`` to ``close_window``."""

    def __init__(self, dev):
        self.dev = dev
        self.prof = None
        self.t_start_ns = self.t_stop_ns = 0
        self.offset_ns = 0  # profiler clock minus time.monotonic_ns

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.offset_ns = time.time_ns() - time.monotonic_ns()
        self.t_start_ns = time.time_ns()

    def close_window(self) -> None:
        """The sub-window ends here; the profiler may record on."""
        self.t_stop_ns = time.time_ns()

    def stop(self) -> None:
        if not self.t_stop_ns:
            self.close_window()
        self.prof.stop()

    def _events(self):
        return self.prof.profiler.kineto_results.events()

    def summary(self, spans: Sequence) -> Dict:
        """busy_s, window_s, the batches inside the sub-window (bucket,
        device seconds, glue seconds, bound seconds), the breakdown."""
        lo, hi = self.t_start_ns, self.t_stop_ns
        kernels = port_kernel_names()
        dev_events = []
        launches = {}
        for ev in self._events():
            dt = str(ev.device_type())
            name = ev.name()
            if dt.endswith("CUDA"):
                s = ev.start_ns()
                e = s + ev.duration_ns()
                dev_events.append((s, e, name, ev.correlation_id()))
            elif name.startswith("cudaGraphLaunch"):
                launches[ev.correlation_id()] = ev.start_ns()
        dev_events.sort()
        inside = [(max(s, lo), min(e, hi), n) for s, e, n, _ in dev_events if e > lo and s < hi]
        busy = union_seconds([(s / 1e9, e / 1e9) for s, e, _ in inside])
        window = (hi - lo) / 1e9
        by_corr: Dict[int, list] = {}
        for ev in dev_events:
            if ev[3] in launches:
                by_corr.setdefault(ev[3], []).append(ev)
        dispatches = dispatch_spans(spans)
        starts = [d[0] for d in dispatches]
        linear = work.linear_work(work.load_table())
        batches = []
        for corr, evs in sorted(by_corr.items(), key=lambda kv: kv[1][0][0]):
            last = max(e for _, e, _, _ in evs)
            if launches[corr] < lo or last > hi:
                continue
            mono = launches[corr] - self.offset_ns
            k = bisect.bisect_right(starts, mono) - 1
            if k < 0 or mono > dispatches[k][1]:
                continue  # no span encloses the launch: its bucket is unknown
            _, _, bucket, n_sets = dispatches[k]
            glue = [(s / 1e9, e / 1e9) for s, e, n, _ in evs if _base_name(n) not in kernels]
            batches.append({
                "bucket": bucket,
                "sets": n_sets,
                "busy_s": union_seconds([(s / 1e9, e / 1e9) for s, e, _, _ in evs]),
                "glue_s": union_seconds(glue),
                "events": len(evs),
                "bound_s": (work.bound_seconds(work.batch_work(n_sets, linear))
                            if n_sets else None),
            })
        totals: Dict[str, float] = {}
        for s, e, n in inside:
            totals[n] = totals.get(n, 0.0) + (e - s) / 1e9
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        return {
            "busy_s": busy,
            "window_s": window,
            "batches": batches,
            "graph_launches": len(launches),
            "device_events": len(inside),
            "breakdown": {"device_ops": [[n[:160], v] for n, v in ops],
                          "idle_gaps": self._gaps(inside, spans)},
        }

    def _gaps(self, inside: List[tuple], spans: Sequence) -> List[list]:
        """The ten longest idle stretches of the card inside the
        sub-window, each named by what the host was doing at its middle."""
        lo, hi = self.t_start_ns, self.t_stop_ns
        gaps = []
        end = lo
        for s, e, _ in sorted(inside):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        order = ("bls.pack", "bls.final_exp", "bls.dispatch", "pool.batch", "bls.queue_wait")
        out = []
        for a, b in gaps[:10]:
            mid = (a + b) // 2 - self.offset_ns
            doing = "no job waiting"
            for name in order:
                if any(sp.name == name and sp.ts_ns <= mid <= sp.ts_ns + sp.dur_ns
                       for sp in spans):
                    doing = name
                    break
            out.append([f"idle during {doing}", (b - a) / 1e9])
        return out
