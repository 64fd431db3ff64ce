"""The port's profile windows, their merge with the span timeline and the
per-batch attribution (``observatory/xprof.py`` and ``attribution.py``),
held against the JAX package's modules on the CPU.

The cases of ``tests/test_xprof.py`` run through both packages with the
same synthetic trace-viewer fixtures and fake profiler hooks (nothing is
compiled) and give equal parses, clock maps, merged documents, reports
and scaling-loss breakdowns; where a window's timestamps differ between
the two runs, the documents are compared with the clock taken out.  The
port's deliberate differences each have a case: the collective pattern
also matches the ring hop kernel ``ring_hop_k``; the parse keeps only
device events of torch's categories (and the profiler's window span, the
clock anchor); and one real ``torch.profiler`` window on the CPU, whose
exported file the port's parser reads.
"""

import asyncio
import os
import time

import pytest
import torch

from lodestar_tpu.metrics import create_metrics as jax_create_metrics
from lodestar_tpu.observatory import attribution as jattr
from lodestar_tpu.observatory import xprof as jxprof
from lodestar_tpu.tracing import TRACER as JTRACER
from lodestar_tpu.tracing import SpanTracer as JSpanTracer
from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
from lodestar_tpu_torch.metrics import create_metrics
from lodestar_tpu_torch.observatory import attribution as pattr
from lodestar_tpu_torch.observatory import xprof as pxprof
from lodestar_tpu_torch.tracing import TRACER, SpanTracer

from test_xprof import (
    _device_fixture_events,
    _fake_profiler,
    _synthetic_merged_doc,
    _write_profile_fixture,
    check_trace,
)

SIDES = {"jax": (jxprof, jattr, JSpanTracer), "port": (pxprof, pattr, SpanTracer)}


@pytest.fixture(autouse=True)
def _clean_state():
    for tr in (TRACER, JTRACER):
        tr.disable()
        tr.clear()
    jxprof.CAPTURE = pxprof.CAPTURE = None
    yield
    for tr in (TRACER, JTRACER):
        tr.disable()
        tr.clear()
    jxprof.CAPTURE = pxprof.CAPTURE = None


def both(fn):
    """fn(xprof, attribution, SpanTracer) through both packages."""
    return {side: fn(*mods) for side, mods in SIDES.items()}


def _producer(obj):
    """The tracer's producer name, which is the package's own, as the
    JAX package's: the one place two merged documents of one window may
    differ."""
    if isinstance(obj, dict):
        return {k: _producer(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_producer(v) for v in obj]
    return "lodestar-tpu" if obj == "lodestar-tpu-torch" else obj


def equal(fn):
    out = both(fn)
    assert _producer(out["port"]) == out["jax"]
    return out["port"]


def without_clock(doc):
    """A merged document with its timestamps taken out: what two windows
    of the same work share."""
    return [(e.get("name"), e.get("ph"), e.get("pid"), e.get("cat"), e.get("dur"))
            for e in doc["traceEvents"] if e.get("ph") != "X" or e.get("pid", 0) != 0
            ] + [sorted(doc["otherData"]["device_clock"])]


# -- ingestion ---------------------------------------------------------------


def test_parse_profile_dir_gz_and_plain(tmp_path):
    d = str(tmp_path)
    _write_profile_fixture(d, _device_fixture_events(), run="a")
    _write_profile_fixture(d, [{"name": "x", "ph": "X", "pid": 1, "tid": 0, "ts": 1.0,
                                "dur": 1.0}], run="b", gz=False)
    parsed = equal(lambda x, a, t: x.parse_profile_dir(d))
    assert len(parsed["files"]) == 2 and parsed["skipped"] == []
    assert len(parsed["events"]) == 4


def test_corrupt_file_skipped_not_fatal(tmp_path):
    d = str(tmp_path)
    _write_profile_fixture(d, _device_fixture_events(), run="good")
    bad = os.path.join(d, "plugins", "profile", "bad", "h.trace.json.gz")
    os.makedirs(os.path.dirname(bad))
    with open(bad, "wb") as f:
        f.write(b"not gzip at all")
    parsed = equal(lambda x, a, t: x.parse_profile_dir(d))
    assert parsed["skipped"] == [bad] and len(parsed["events"]) == 3


def test_recursive_fallback_layout(tmp_path):
    nested = tmp_path / "some" / "drifted" / "layout"
    nested.mkdir(parents=True)
    path = str(nested / "x.trace.json")
    with open(path, "w") as f:
        f.write('[{"name": "e", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0, "dur": 1.0}]')
    assert equal(lambda x, a, t: x.find_trace_files(str(tmp_path))) == [path]
    assert len(equal(lambda x, a, t: x.load_trace_events(path))) == 1


def _torch_like_events(base=1_000.0):
    """A torch.profiler export's shapes: metadata, host events of torch's
    categories, flow and instant events, the profiler's window span and
    the card's kernels, copies and sets."""
    return [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0, "args": {"name": "python3"}},
        {"name": "process_name", "ph": "M", "pid": 4242, "tid": 0, "args": {"name": "python3"}},
        {"name": "PyTorch Profiler (0)", "ph": "X", "cat": "Trace", "pid": "Spans",
         "tid": "PyTorch Profiler", "ts": base, "dur": 9_000.0},
        {"name": "Iteration Start: PyTorch Profiler", "ph": "i", "s": "g", "pid": "Traces",
         "tid": "Trace PyTorch Profiler", "ts": base},
        {"name": "cudaGraphLaunch", "ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 7,
         "ts": base + 500.0, "dur": 30.0},
        {"name": "aten::copy_", "ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 7,
         "ts": base + 400.0, "dur": 50.0},
        {"name": "ac2g", "ph": "s", "cat": "ac2g", "id": 3, "pid": 4242, "tid": 7,
         "ts": base + 500.0},
        {"name": "Memcpy HtoD (Pinned -> Device)", "ph": "X", "cat": "gpu_memcpy", "pid": 0,
         "tid": 7, "ts": base + 2_000.0, "dur": 5.0},
        {"name": "mul_k(Ptrs, int, int const*)", "ph": "X", "cat": "kernel", "pid": 0,
         "tid": 7, "ts": base + 2_010.0, "dur": 40.0},
        {"name": "Memset (Device)", "ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7,
         "ts": base + 2_060.0, "dur": 1.0},
        {"name": "Record Window End", "ph": "i", "s": "g", "pid": "", "tid": "",
         "ts": base + 9_000.0},
    ]


def test_parse_keeps_only_device_events_of_torch_categories(tmp_path):
    """The port's one parse difference: host runtime, operator, flow,
    overhead and instant events are not device evidence; the kernels,
    copies and sets are, and the profiler's window span stays as the
    clock anchor (its pid is not a number: the merge skips it).  The JAX
    parser keeps every event."""
    d = str(tmp_path)
    _write_profile_fixture(d, _torch_like_events(), gz=False)
    port = pxprof.parse_profile_dir(d)["events"]
    jax = jxprof.parse_profile_dir(d)["events"]
    assert len(jax) == len(_torch_like_events())
    assert [e["name"] for e in port if e.get("ph") != "M"] == [
        "PyTorch Profiler (0)", "Memcpy HtoD (Pinned -> Device)",
        "mul_k(Ptrs, int, int const*)", "Memset (Device)"]
    t0 = time.monotonic_ns()
    clock = pxprof.ClockMap(t0, t0 + 10_000_000, 1_000.0, 10_000.0)
    tr = SpanTracer()
    tr.enable()
    tr.add_span("bls.dispatch", "bls", t0, t0 + 3_000_000, cid=1, device="cuda:0")
    doc = pxprof.merge_host_device(tr, port, clock)
    dev = [e for e in doc["traceEvents"] if e["pid"] >= pxprof.DEVICE_PID_BASE
           and e["ph"] == "X"]
    assert [e["name"] for e in dev] == ["Memcpy HtoD (Pinned -> Device)",
                                        "mul_k(Ptrs, int, int const*)", "Memset (Device)"]
    # the window span anchors the clock: the first kernel lands 2.01 ms
    # after the host start, not at it
    assert dev[1]["ts"] == pytest.approx(t0 / 1e3 + 2_010.0)
    assert check_trace.validate_device_merge(doc) == []


# -- clock map and merge -------------------------------------------------------


def test_clock_map_offset_remap_and_skew():
    def run(x, a, t):
        c = x.ClockMap(1_000_000_000, 1_200_000_000, 5_000_000.0, 5_150_000.0)
        s = x.ClockMap(1_000_000_000, 1_200_000_000, 5_000_000.0, 5_450_000.0)
        return c.offset_us, c.remap(5_000_000.0), c.skew_us, s.skew_us

    offset, remapped, skew, overrun = equal(run)
    assert offset == pytest.approx(-4_000_000.0) and remapped == pytest.approx(1_000_000.0)
    assert skew == 0.0 and overrun == pytest.approx(250_000.0)


def _merged(x, t, t0, span_us=4_500.0, tolerance_us=None, events=True):
    tr = t()
    tr.enable()
    tr.add_span("bls.dispatch", "bls", t0, t0 + 2_000_000, cid=1, device="stub:0")
    clock = x.ClockMap(t0, t0 + 10_000_000, 5_000_000.0, 5_000_000.0 + span_us) if events else None
    kw = {} if tolerance_us is None else {"tolerance_us": tolerance_us}
    return x.merge_host_device(tr, _device_fixture_events() if events else [], clock, **kw)


def test_merge_schema_pids_and_clock_note():
    t0 = time.monotonic_ns()
    doc = equal(lambda x, a, t: _merged(x, t, t0))
    assert check_trace.validate(doc) == [] and check_trace.validate_device_merge(doc) == []
    pids = {e["pid"] for e in doc["traceEvents"]}
    assert 0 in pids and pxprof.DEVICE_PID_BASE in pids
    note = doc["otherData"]["device_clock"]
    assert note["offset_us"] == pytest.approx(t0 / 1e3 - 5_000_000.0)
    assert note["skew_us"] == 0.0 and note["tolerance_us"] == pxprof.DEFAULT_TOLERANCE_US
    dev = [e for e in doc["traceEvents"] if e["pid"] >= pxprof.DEVICE_PID_BASE and e["ph"] == "X"]
    assert min(e["ts"] for e in dev) == pytest.approx(t0 / 1e3)


def test_skew_beyond_tolerance_fails_validation():
    t0 = time.monotonic_ns()
    doc = equal(lambda x, a, t: _merged(x, t, t0, span_us=300_000.0, tolerance_us=1000.0))
    errs = check_trace.validate_device_merge(doc)
    assert errs and "skew" in errs[0]
    assert check_trace.validate_device_merge(doc, tolerance_us=1_000_000.0) == []


def test_merge_without_device_events_fails_require_device():
    t0 = time.monotonic_ns()
    doc = equal(lambda x, a, t: _merged(x, t, t0, events=False))
    assert any("no complete device events" in e for e in check_trace.validate_device_merge(doc))


# -- attribution ------------------------------------------------------------------


def test_six_way_decomposition_with_device_evidence():
    report = equal(lambda x, a, t: a.attribute_spans(_synthetic_merged_doc()["traceEvents"]))
    b1 = {b["cid"]: b for b in report["batches"]}[1]
    s = b1["stages"]
    assert b1["sharded"] is True and b1["mesh_devices"] == 4
    assert (s["queue"], s["pack"], s["device_compute"], s["collective_combine"],
            s["final_exp"], s["pipeline_bubble"]) == pytest.approx(
        (0.010, 0.020, 0.030, 0.015, 0.010, 0.005))
    assert sum(s.values()) == pytest.approx(b1["e2e_s"]) and b1["e2e_s"] == pytest.approx(0.09)


def test_no_device_evidence_falls_back_to_the_dispatch_wall_and_overlap():
    report = equal(lambda x, a, t: a.attribute_spans(_synthetic_merged_doc()["traceEvents"]))
    by_cid = {b["cid"]: b for b in report["batches"]}
    assert by_cid[2]["stages"]["device_compute"] == pytest.approx(0.010)
    assert by_cid[2]["stages"]["collective_combine"] == 0.0
    assert by_cid[1]["overlap_ratio"] == pytest.approx(0.5) and by_cid[2]["overlap_ratio"] == 0.0
    assert report["overlap_ratio"] == pytest.approx(0.5 * 50_000 / 60_000, abs=1e-3)


def test_span_objects_and_dict_inputs_agree():
    def run(x, a, t):
        tr = t()
        tr.enable()
        tr.add_span("bls.pack", "bls", 10_000_000, 30_000_000, cid=5)
        tr.add_span("bls.dispatch", "bls", 30_000_000, 80_000_000, cid=5, device="stub:0")
        spans = a.attribute_spans(tr.spans())
        assert spans["batches"] == a.attribute_spans([s.to_dict() for s in tr.spans()])["batches"]
        return spans

    assert equal(run)["batches"][0]["stages"]["pack"] == pytest.approx(0.020)
    events = [{"name": "bls.pack", "ph": "X", "pid": 0, "tid": 1, "ts": 0.0, "dur": 5.0,
               "args": {"cid": 3}}]
    assert equal(lambda x, a, t: a.attribute_spans(events))["batches"] == []


def _ring_hop_doc():
    """A sharded batch whose dispatch window holds 30 ms of compute and
    15 ms of the port's ring hop kernel."""
    doc = _synthetic_merged_doc()
    for e in doc["traceEvents"]:
        if e["name"] == "all-gather.combine":
            e["name"] = "void (anonymous namespace)::ring_hop_k<int, 4>(float const*, float*, int, int)"
            e["cat"] = "kernel"
    return doc


def test_the_ring_hop_kernel_is_the_combine_in_the_port_only():
    """The port's one attribution difference: the hop kernel's time is the
    sharded tier's combine; the JAX pattern books it as compute."""
    events = _ring_hop_doc()["traceEvents"]
    port = {b["cid"]: b for b in pattr.attribute_spans(events)["batches"]}[1]["stages"]
    jax = {b["cid"]: b for b in jattr.attribute_spans(events)["batches"]}[1]["stages"]
    assert port["collective_combine"] == pytest.approx(0.015)
    assert port["device_compute"] == pytest.approx(0.030)
    assert jax["collective_combine"] == 0.0 and jax["device_compute"] == pytest.approx(0.045)
    assert pattr.COLLECTIVE_RE.search("ring_hop_k") and not jattr.COLLECTIVE_RE.search("ring_hop_k")
    for name in ("mul_k(Ptrs, int, int const*)", "empty_k()", "lad3_k(Ptrs, int, int const*)"):
        assert not pattr.COLLECTIVE_RE.search(name)


def test_the_widened_pattern_rejects_what_the_jax_pattern_rejects_on_its_fixtures():
    names = {e["name"] for e in _device_fixture_events() + _synthetic_merged_doc()["traceEvents"]
             if e.get("ph") == "X"}
    names |= {"fusion.multiply.1", "all-gather.2", "all-reduce", "psum", "ppermute.3",
              "reduce-scatter", "cross-replica-sum", "collective-permute"}
    for name in names:
        assert bool(pattr.COLLECTIVE_RE.search(name)) == bool(jattr.COLLECTIVE_RE.search(name)), name


def test_scaling_loss_breakdowns_are_the_jax_modules():
    def run(x, a, t):
        report = a.attribute_spans(_synthetic_merged_doc()["traceEvents"])
        return (a.scaling_loss_breakdown(efficiency=0.839, wall_s=10.0, comm_s=0.9,
                                         serial_host_s=0.4),
                a.scaling_loss_breakdown(efficiency=0.9, wall_s=4.0, comm_s=0.2,
                                         shard_walls=[1.0, 0.9, 0.8, 0.9]),
                a.scaling_loss_breakdown(efficiency=0.8, wall_s=1.0, comm_s=0.05,
                                         shard_walls=[1.0, 1.0]),
                a.mesh_scaling_loss(report["batches"]),
                a.mesh_scaling_loss([]),
                a.mesh_scaling_loss([{"sharded": False, "e2e_s": 1.0,
                                      "stages": {k: 0.0 for k in a.STAGES}}]))

    gap, scaled, residual, live, none1, none2 = equal(run)
    assert gap["loss"] == pytest.approx(0.161) and gap["within_tolerance"] is True
    assert scaled["scale_factor"] == pytest.approx(2 / 3, rel=1e-3)
    assert residual["residual"] == pytest.approx(0.15) and residual["within_tolerance"] is False
    assert live["efficiency"] == pytest.approx(1 / 3, abs=1e-4)
    assert none1 is None and none2 is None


def _families(text):
    return sorted(line for line in text.splitlines()
                  if "_created" not in line
                  and line.startswith(("lodestar_bls_mesh_overlap_ratio",
                                      "lodestar_bls_pipeline_bubble_seconds",
                                      "lodestar_bls_sharded_combine_seconds",
                                      "lodestar_bls_scaling_loss")))


def test_publish_sets_the_four_families_as_the_jax_module():
    out = {}
    for side, metrics in (("port", create_metrics()), ("jax", jax_create_metrics())):
        _x, a, _t = SIDES[side]
        report = a.attribute_spans(_synthetic_merged_doc()["traceEvents"])
        a.publish(metrics, report, a.mesh_scaling_loss(report["batches"]))
        a.publish(None, report)
        out[side] = _families(metrics.reg.expose().decode())
    assert out["port"] == out["jax"] and len(out["port"]) > 20


# -- the capture controller -----------------------------------------------------


def _lifecycle(x, a, t, tmp):
    tr = t()
    tr.enable()
    start, stop, dirs = _fake_profiler(tmp)
    cap = x.ProfileCapture(str(tmp), tracer=tr, start_fn=start, stop_fn=stop)
    armed = cap.request_window(flushes=2)
    again = cap.request_window(flushes=5)["armed"]
    t0 = time.monotonic_ns()
    tr.add_span("bls.dispatch", "bls", t0, t0 + 2_000_000, cid=9, device="stub:0")
    cap.notify_flush()
    remaining = cap.snapshot()["flushes_remaining"]
    cap.notify_flush()
    assert cap.wait_idle(5.0)
    snap = cap.snapshot()
    doc = cap.last_window()["trace"]
    assert check_trace.validate(doc) == [] and check_trace.validate_device_merge(doc) == []
    path = str(tmp / "merged.json")
    assert cap.write_merged(path) == path and check_trace.main([path, "--require-device"]) == 0
    assert 0.0 <= cap.overhead_ratio() < 1.0
    summary = {k: v for k, v in snap["last_window"].items()
               if k not in ("files", "offset_us", "skew_us")}
    return (armed, again, remaining, cap.windows, snap["state"], snap["last_error"], summary,
            [os.path.relpath(d, tmp) for d in dirs], without_clock(doc))


def test_window_lifecycle_and_merged_output(tmp_path):
    out = both(lambda x, a, t: _lifecycle(x, a, t, tmp_path / x.__name__.split(".")[0]))
    assert _producer(out["port"]) == out["jax"]
    armed, again, remaining, windows, state, err, summary, dirs, _doc = out["port"]
    assert armed == {"armed": True, "state": "capturing", "flushes_remaining": 2}
    assert again is False and remaining == 1 and windows == 1
    assert state == "idle" and err is None and summary["device_events"] == 2
    assert dirs == ["window-0"]


def test_sampled_cadence_errors_run_window_finalize_and_slot(tmp_path):
    def run(x, a, t):
        tmp = tmp_path / x.__name__.split(".")[0]
        tr = t()
        tr.enable()
        t0 = time.monotonic_ns()
        tr.add_span("bls.dispatch", "bls", t0, t0 + 1_000_000, cid=1, device="stub:0")
        start, stop, _ = _fake_profiler(tmp)
        cap = x.ProfileCapture(str(tmp / "c"), tracer=tr, start_fn=start, stop_fn=stop,
                               sample_every=3, sample_flushes=1)
        states = []
        for _ in range(4):
            cap.notify_flush()
            states.append(cap.snapshot()["state"])
        assert cap.wait_idle(5.0)
        cadence = (states[:3], cap.windows)

        def bad_stop():
            raise RuntimeError("profiler exploded")

        bad = x.ProfileCapture(str(tmp / "b"), start_fn=lambda d: None, stop_fn=bad_stop)
        bad.request_window(flushes=1)
        bad.notify_flush()
        assert bad.wait_idle(5.0)
        errors = (bad.snapshot()["state"], bad.windows, "RuntimeError" in bad.snapshot()[
            "last_error"], bad.last_window(), bad.write_merged(str(tmp / "x.json")))

        cap2 = x.ProfileCapture(str(tmp / "r"), tracer=tr, start_fn=start, stop_fn=stop)
        value = cap2.run_window(lambda: 42, label="warmup")
        cap2.request_window(flushes=100)
        last = cap2.finalize()
        windows = (value, cap2.windows, cap2.last_window()["summary"]["label"],
                   last["summary"]["label"])

        assert x.get_capture() is None
        x.notify_flush()  # a no-op until configured
        slot = x.configure_capture(profile_dir=str(tmp / "s"), tracer=tr, start_fn=start,
                                   stop_fn=stop)
        assert x.get_capture() is slot
        slot.request_window(flushes=1)
        x.notify_flush()
        assert slot.wait_idle(5.0)
        x.CAPTURE = None
        return cadence, errors, windows, slot.windows

    cadence, errors, windows, slot = equal(run)
    assert cadence == (["idle", "idle", "capturing"], 1)
    assert errors == ("idle", 1, True, None, None)
    assert windows == (42, 2, "shutdown", "shutdown") and slot == 1


def test_bundle_carries_capture_state(tmp_path):
    from lodestar_tpu_torch.forensics.bundle import write_bundle

    def profile(path):
        with open(os.path.join(path, "profile.json")) as f:
            import json

            return json.load(f)

    assert profile(write_bundle(str(tmp_path / "b"), "test")) == {"configured": False}
    pxprof.configure_capture(profile_dir=str(tmp_path / "p"), start_fn=lambda d: None,
                             stop_fn=lambda: None)
    prof = profile(write_bundle(str(tmp_path / "b"), "test"))
    assert prof["configured"] is True and prof["state"] == "idle"


class _TimedStubVerifier:
    """The verifier's timing shape without a device (tests/test_xprof.py's
    stub on the port's tracer): pack blocks, the 'device' computes in
    wall time, the spans carry the pool's correlation id."""

    PACK_S, DEVICE_S = 0.004, 0.006

    def __init__(self):
        self.stage_seconds = {"pack": 0.0, "dispatch": 0.0, "final_exp": 0.0}

    def verify_signature_sets_async(self, sets):
        cid = tracing.current_batch_id()
        t0 = TRACER.now()
        time.sleep(self.PACK_S)
        TRACER.add_span("bls.pack", "bls", t0, cid=cid, sets=len(sets))
        t0 = TRACER.now()
        ready_at = time.monotonic() + self.DEVICE_S
        TRACER.add_span("bls.dispatch", "bls", t0, cid=cid, bucket=len(sets), device="stub:0",
                        devices_total=1)

        class _Pending:
            def result(_self):
                rem = ready_at - time.monotonic()
                if rem > 0:
                    time.sleep(rem)
                TRACER.add_span("bls.final_exp", "bls", TRACER.now(),
                                cid=tracing.current_batch_id())
                return True

        return _Pending()

    def verify_signature_sets(self, sets):
        return self.verify_signature_sets_async(sets).result()


def test_a_window_over_a_live_pool_flush_is_merged_and_attributed(tmp_path):
    """The pool drives the window (its flush boundary) and the window's
    attribution lands in the metric families; the merged trace passes
    check_trace with device evidence."""
    tracing.enable(1024)
    start, stop, _ = _fake_profiler(tmp_path)
    metrics = create_metrics()
    cap = pxprof.configure_capture(profile_dir=str(tmp_path), start_fn=start, stop_fn=stop,
                                   metrics=metrics)

    async def main():
        t0 = TRACER.now()
        TRACER.add_span("test.window_open", "test", t0, t0 + 1000)
        cap.request_window(flushes=1)
        pool = BlsBatchPool(_TimedStubVerifier(), metrics=metrics, max_buffer_wait=0.004)
        assert await pool.verify_signature_sets([object()])
        pool.close()

    asyncio.run(main())
    assert cap.wait_idle(5.0) and cap.windows == 1
    doc = cap.last_window()["trace"]
    assert check_trace.validate(doc) == [] and check_trace.validate_device_merge(doc) == []
    assert cap.last_window()["summary"]["batches"] >= 1
    assert "lodestar_bls_pipeline_bubble_seconds_count" in metrics.reg.expose().decode()


def test_one_real_torch_profiler_window_on_the_cpu(tmp_path):
    """The default hooks: torch.profiler (CPU activity on this machine)
    started and stopped on the profiler's own thread, exported to the JAX
    layout, read by the port's parser.  The CPU activity of another
    thread is not recorded and the profiler's instants are no device
    evidence: the parse keeps the window span alone, the window merges
    with no device event, and says so."""
    tr = SpanTracer()
    tr.enable()
    cap = pxprof.ProfileCapture(str(tmp_path), tracer=tr)

    def work():
        t0 = tr.now()
        x = torch.arange(64.0).reshape(8, 8)
        (x @ x).sum()
        tr.add_span("bls.dispatch", "bls", t0, cid=1, device="cpu")
        return 7

    assert cap.run_window(work, label="cpu") == 7
    snap = cap.snapshot()
    assert snap["last_error"] is None and cap.windows == 1
    files = pxprof.find_trace_files(os.path.join(str(tmp_path), "window-0"))
    assert len(files) == 1 and files[0].endswith(".trace.json")
    assert os.path.basename(os.path.dirname(os.path.dirname(files[0]))) == "profile"
    raw = pxprof.load_trace_events(files[0])
    assert any(e.get("ph") == "i" for e in raw)
    parsed = pxprof.parse_profile_dir(os.path.join(str(tmp_path), "window-0"))
    assert parsed["files"] == files
    kept = [e for e in parsed["events"] if e.get("ph") != "M"]
    assert [e.get("cat") for e in kept] == [pxprof.WINDOW_CATEGORY]
    doc = cap.last_window()["trace"]
    assert not [e for e in doc["traceEvents"] if e["pid"] >= pxprof.DEVICE_PID_BASE
                and e["ph"] == "X"]
    assert any("no complete device events" in e for e in check_trace.validate_device_merge(doc))
    # a second window on the same owner thread works as the first
    assert cap.run_window(lambda: 8) == 8 and cap.snapshot()["last_error"] is None
