"""The port's analysis layer (``lodestar_tpu_torch/analysis``) on the CPU.

For each rule: its known-bad fixture (``tests/torch_analysis_fixtures/``)
fires exactly on the lines marked ``VIOLATION``; a mutation of the live
tree turns it red; the live tree is clean.  Against the JAX package's
layer (``lodestar_tpu/analysis``): the port's AST checkers give the JAX
checkers' (rule, line) pairs on the JAX fixtures, the lock audit with
``_stats_lock`` stripped flags the JAX audit's counters under the same
mutation, and the proven output interval of each shared ``limbs`` entry
equals the JAX analyzer's (exactly), but for ``fp_reduce_full``, built on
``carry_ripple_exact``, which differs from the JAX scan by design.

Torch is pinned to one intra-op thread for the module: the graph audit and
the bound proofs run the plain versions' glue.
"""

import ast
import os
import subprocess
import sys
import threading

import pytest
import torch

from analysis_fixtures import fixture_source as jax_fixture_source
from lodestar_tpu_torch.analysis import (
    LAYERS,
    ast_lint,
    graph_audit,
    kernel_audit,
    limb_interval,
    lock_audit,
    metrics_coverage,
    test_cost,
)
from lodestar_tpu_torch.analysis.report import (
    Violation,
    filter_suppressed,
    format_report,
    suppressed_rules,
)
from torch_analysis_fixtures import fixture_path, fixture_source, violation_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lines_of(violations, rule):
    return sorted(v.line for v in violations if v.rule == rule)


# -- report ----------------------------------------------------------------------


def test_report_format_and_suppression_are_the_jax_layers():
    assert format_report([]) == "lint OK: 0 violations"
    v = Violation("r", "f.py", 3, "m")
    assert str(v) == "f.py:3: [r] m" and "1 violation(s)" in format_report([v])
    assert suppressed_rules("x = 1  # lint: disable=a,b") == {"a", "b"}
    assert suppressed_rules("x = 1  # lint: disable") == set()
    assert suppressed_rules("x = 1  # lint: disable async-blocking-sync") is None
    kept = filter_suppressed([Violation("other", "f.py", 1, "m")],
                             {"f.py": "x  # lint: disable=async-blocking-sync"})
    assert len(kept) == 1


# -- ast_lint, metrics coverage ----------------------------------------------------


def test_ast_lint_live_tree_is_clean():
    vs = ast_lint.run_ast_lint(REPO)
    assert vs == [], format_report(vs)


def test_async_blocking_sync_fires_on_the_ports_blocking_calls():
    src = fixture_source("bad_async_blocking.py")
    vs = ast_lint.lint_source(src, "lodestar_tpu_torch/chain/_fixture.py",
                              [ast_lint.AsyncBlockingSyncChecker()])
    assert lines_of(vs, "async-blocking-sync") == violation_lines(src)


# the JAX fixtures and the path each rule scopes on
JAX_FIXTURES = {
    "async-blocking-sync": ("bad_async_blocking.py", "chain/_fixture.py",
                            "AsyncBlockingSyncChecker"),
    "await-holding-lock": ("bad_await_holding_lock.py", "chain/_fixture.py",
                           "AwaitHoldingLockChecker"),
    "bls-silent-except": ("bad_bls_silent_except.py", "crypto/bls/_fixture.py",
                          "BlsSilentExceptChecker"),
    "tracing-wallclock": ("bad_tracing_wallclock.py", "chain/_fixture.py",
                          "TracingWallclockChecker"),
}


@pytest.mark.parametrize("rule", sorted(JAX_FIXTURES))
def test_ast_lint_gives_the_jax_checkers_pairs_on_the_jax_fixtures(rule):
    from lodestar_tpu.analysis import ast_lint as jax_lint

    name, rel, checker = JAX_FIXTURES[rule]
    src = jax_fixture_source(name)
    want = jax_lint.lint_source(src, f"lodestar_tpu/{rel}", [getattr(jax_lint, checker)()])
    got = ast_lint.lint_source(src, f"lodestar_tpu_torch/{rel}", [getattr(ast_lint, checker)()])
    assert [(v.rule, v.line) for v in got] == [(v.rule, v.line) for v in want]
    assert any(v.rule == rule for v in got)


def test_a_sync_in_the_pools_flush_turns_the_lint_red():
    rel = "lodestar_tpu_torch/chain/bls_pool.py"
    src = open(os.path.join(REPO, rel), encoding="utf-8").read()
    checker = [ast_lint.AsyncBlockingSyncChecker()]
    assert ast_lint.lint_source(src, rel, checker) == []
    target = "ok = await verdict"
    assert target in src, "the mutation's anchor moved"
    mutated = src.replace(target, "ok = verdict.result()")
    assert [v.rule for v in ast_lint.lint_source(mutated, rel, checker)] == ["async-blocking-sync"]


def test_metrics_coverage_reads_the_port_registry_docs_and_readme(tmp_path):
    reg = tmp_path / "lodestar_tpu_torch" / "metrics"
    reg.mkdir(parents=True)
    text = 'g = r.gauge("lodestar_port_only_metric", "nobody can see me")\n'
    (reg / "registry.py").write_text(text)
    checker = ast_lint.MetricsCoverageChecker(str(tmp_path))
    rel = "lodestar_tpu_torch/metrics/registry.py"
    vs = checker.check(rel, ast.parse(text), text)
    assert [v.rule for v in vs] == ["metrics-coverage"] and vs[0].line == 1
    # the JAX package's sections of README.md do not count; the port's does
    (tmp_path / "README.md").write_text("## The TPU part\nlodestar_port_only_metric\n"
                                        "## The PyTorch/CUDA port (`x`)\nnothing\n## Later\n")
    assert len(checker.check(rel, ast.parse(text), text)) == 1
    (tmp_path / "README.md").write_text("## The PyTorch/CUDA port (`x`)\n"
                                        "`lodestar_port_only_metric`\n## Later\n")
    assert checker.check(rel, ast.parse(text), text) == []
    assert metrics_coverage.check(str(tmp_path))["lodestar_port_only_metric"]["docs"] == [
        "README.md#port"]


# -- test_cost ---------------------------------------------------------------------


def test_test_cost_live_tree_is_clean():
    vs = test_cost.audit_test_cost(REPO)
    assert vs == [], format_report(vs)
    census = test_cost.census(REPO)
    names = {(t.path, t.test) for t in census}
    assert ("tests/test_torch_health.py",
            "test_a_lost_batch_is_requeued_and_verified_on_the_other_executor") in names
    assert all(t.pinned for t in census)


def test_test_threads_fixture_fires_on_the_marked_lines():
    src = fixture_source("bad_test_threads.py")
    vs = test_cost.check_source(src, "tests/test_torch_fixture.py")
    assert lines_of(vs, "torch-test-threads") == violation_lines(src)


def test_the_health_file_without_its_pin_turns_the_rule_red():
    rel = "tests/test_torch_health.py"
    src = open(os.path.join(REPO, rel), encoding="utf-8").read()
    start = src.index('@pytest.fixture(autouse=True, scope="module")\ndef _one_torch_thread')
    end = src.index("@pytest.fixture", start + 10)
    vs = test_cost.check_source(src[:start] + src[end:], rel)
    assert [v.rule for v in vs] == ["torch-test-threads"]
    assert "test_a_lost_batch_is_requeued_and_verified_on_the_other_executor" in vs[0].message


# -- lock audit --------------------------------------------------------------------


def test_lock_audit_live_tree_is_clean():
    vs = lock_audit.audit_bls_pipeline()
    assert vs == [], format_report(vs)


def _counters(vs):
    return sorted(v.message.split(" write")[0].lstrip(".") for v in vs
                  if v.rule == "lock-unguarded-mutation" and v.message.startswith("."))


def _strip_stats_lock(v):
    v._stats_lock = threading.Lock()


def test_stripping_the_stats_lock_flags_the_jax_audits_counters():
    """The same mutation through both audits, the port's without its mesh
    (the JAX harness's one tier): the same counters; with the mesh the
    tier's own counter too."""
    from lodestar_tpu.analysis import lock_audit as jax_lock_audit

    want = _counters(jax_lock_audit.audit_bls_pipeline(verifier_mutator=_strip_stats_lock))
    got = _counters(lock_audit.audit_bls_pipeline(verifier_mutator=_strip_stats_lock,
                                                  mesh=False))
    assert got == want and "dispatches" in got
    meshed = _counters(lock_audit.audit_bls_pipeline(verifier_mutator=_strip_stats_lock))
    assert meshed == sorted(want + ["sharded_batches"])


def test_an_unlocked_point_cache_put_is_flagged():
    def strip_put_lock(v):
        def unlocked_put(self, key, value):
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

        type(v.point_cache).put = unlocked_put

    vs = lock_audit.audit_bls_pipeline(verifier_mutator=strip_put_lock)
    assert any(v.rule == "lock-unguarded-mutation" and "point_cache._data" in v.path
               for v in vs), format_report(vs)


def test_lock_order_inversion_is_detected_and_a_consistent_order_is_clean():
    aud = lock_audit.LockAuditor()
    a, b = lock_audit.AuditLock(aud, "card[cuda:0]"), lock_audit.AuditLock(aud, "card[cuda:1]")

    def take(first, second):
        with first:
            with second:
                pass

    take(a, b)
    assert aud.lock_order_violations() == []
    t = threading.Thread(target=take, args=(b, a))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    vs = aud.lock_order_violations()
    assert [v.rule for v in vs] == ["lock-order-inversion"] and "card[cuda:1]" in vs[0].message


# -- limb_interval -----------------------------------------------------------------


@pytest.fixture(scope="module")
def plain_reports():
    reports = {}
    vs = limb_interval.audit_plain(reports=reports)
    return vs, reports


def test_limb_interval_live_tree_is_clean(plain_reports):
    vs, reports = plain_reports
    assert vs == [], format_report(vs)
    assert len(reports) == len(limb_interval.all_entries()) >= 30
    for name, rep in reports.items():
        assert rep.coverage == 1.0, name  # every digit node proven, none TOP
    vs = limb_interval.audit_headers(limb_interval.plain_steps(reports))
    assert vs == [], format_report(vs)


def _jax_output_intervals():
    """The JAX analyzer's output interval of each limbs entry; its walk of
    a nested ``jit`` equation (the primitive's name in this JAX) is given
    here, as the analyzer gives its ``pjit``."""
    import jax
    import jax.numpy as jnp
    from lodestar_tpu.analysis import limb_interval as jli

    class Analyzer(jli._Analyzer):
        def _eval_eqn(self, eqn, env, defs):
            if eqn.primitive.name == "jit":
                closed = eqn.params["jaxpr"]
                self._seed_consts(self, eqn.invars, closed.jaxpr.invars)
                return self._subjaxpr(closed, [self._read(env, defs, v) for v in eqn.invars])
            return super()._eval_eqn(eqn, env, defs)

    out = {}
    for e in jli.limb_entries():
        closed = jax.make_jaxpr(e.fn)(*(jax.ShapeDtypeStruct(s, jnp.float32) for s in e.in_shapes))
        a = Analyzer()
        out[e.name] = a.run(closed.jaxpr, closed.consts, list(e.in_intervals))[0]
        assert not a.findings and a.bounded_outputs == a.float_outputs, e.name
    return out


@pytest.fixture(scope="module")
def jax_intervals():
    return _jax_output_intervals()


SHARED = ("fp_strict", "fp_add", "fp_sub", "fp_mul", "fp_sqr", "fp_mul_small", "carry_exact")


@pytest.mark.parametrize("name", SHARED)
def test_proven_interval_equals_the_jax_analyzers(name, plain_reports, jax_intervals):
    assert plain_reports[1][name].outputs[0] == jax_intervals[name]


def test_the_ripple_and_the_full_reduction_differ_by_design(plain_reports, jax_intervals):
    """carry_ripple_exact is no scan (ROADMAP Queue 3): its Kogge-Stone flags
    widen the propagated interval, and fp_reduce_full, built on it, takes
    its output from the ripple's contract (strict digits and the carry
    out), so it is proven canonical where the JAX analyzer's uniform walk
    of the scan gives a wider interval."""
    reports = plain_reports[1]
    assert reports["fp_reduce_full"].outputs[0] == (0.0, 255.0)
    lo, hi = jax_intervals["fp_reduce_full"]
    assert lo < 0 and hi > 255
    lo, hi = reports["carry_ripple_exact"].outputs[0]
    assert -limb_interval.EXACT < lo < 0 < hi < limb_interval.EXACT
    assert "carry_ripple_exact" not in jax_intervals  # no JAX entry to equal


def _fixture_programs():
    sys.path.insert(0, os.path.dirname(fixture_path("x")))
    import bad_limb_overflow

    return bad_limb_overflow


@pytest.mark.parametrize("index", range(3))
def test_limb_overflow_fixture_fires_on_the_marked_line(index):
    fx = _fixture_programs()
    fn, shapes, ivs = fx.BAD_PROGRAMS[index]
    rep = limb_interval.analyze(fn, [torch.zeros(s) for s in shapes], ivs)
    src = fixture_source("bad_limb_overflow.py")
    first = src.index(f"def {fn.__name__}(")
    end = src.index("\ndef ", first + 1)
    want = [ln for ln in violation_lines(src)
            if src[:first].count("\n") < ln <= src[:end].count("\n") + 1]
    assert sorted({f.line for f in rep.findings}) == want
    assert all(f.file == fixture_path("bad_limb_overflow.py") for f in rep.findings)


def test_limb_overflow_good_fixture_programs_are_proven():
    fx = _fixture_programs()
    for fn, shapes, ivs in fx.GOOD_PROGRAMS:
        rep = limb_interval.analyze(fn, [torch.zeros(s) for s in shapes], ivs)
        assert rep.findings == [] and rep.coverage == 1.0, fn.__name__
    rep = limb_interval.analyze(fx.split_idiom, [torch.zeros(50)], [(0.0, float((1 << 24) - 1))])
    assert rep.outputs[0] == (0.0, 255.0)


def test_an_entry_not_proven_whole_is_a_violation():
    """A digit op the analyzer does not know leaves its node at TOP: the
    entry is not proven, and the rule says so at the op's line."""
    def unknown_op(x):
        return torch.special.erfcx(x) + x

    entry = limb_interval.LimbEntry("erfcx", unknown_op, [(50,)], [limb_interval.STRICT],
                                    "strict digits")
    vs = limb_interval.audit_plain([entry])
    assert [v.rule for v in vs] == ["torch-limb-overflow"]
    assert vs[0].path == os.path.relpath(__file__, REPO) and "not bounded" in vs[0].message
    assert vs[0].line == unknown_op.__code__.co_firstlineno + 1


def test_widening_m_folds_bound_turns_the_rule_red():
    """m_fold's entry at bound_bits 22 given digits up to 2^25: the input
    the fold pads is past the exact range, at its line."""
    from lodestar_tpu_torch.ops import fused_core as fc

    (entry,) = [e for e in limb_interval.fused_entries() if e.name == "m_fold@22"]
    wide = limb_interval.LimbEntry("m_fold@22", entry.fn, entry.shapes,
                                   [(0.0, float((1 << 25) - 1))], "widened", "int64")
    vs = limb_interval.audit_plain([wide])
    assert vs and all(v.rule == "torch-limb-overflow" for v in vs)
    assert any(v.path == os.path.relpath(fc.__file__, REPO) for v in vs)


def test_header_obligations_are_named_reached_and_held():
    reached = limb_interval.header_obligations()
    assert sorted(reached) == sorted(limb_interval.PLAIN_STEPS)
    for name, (lo, hi) in reached.items():
        assert 0 <= lo <= hi <= limb_interval.fold_limit(name), name
    assert reached["mul.column"][1] == 50 * 512 * 512  # the contract's extreme is reached
    assert reached["fold.input<22>"][1] == (1 << 22) - 1


def test_a_fold_past_its_bound_breaks_an_obligation():
    """lad2's e = 3a doubled to 5a: fold<10>'s input reaches 1,280 > 1,023."""
    anchor = "scale2<10>(c, r.in[6 + 2 * d], 3, r.out[4 + 4 * d]);"
    mutation = ("field_coop.cuh", anchor, anchor.replace(" 3,", " 5,"))
    reached = limb_interval.header_obligations(mutation=mutation, kernels=("lad2",))
    assert reached["fold.input<10>"] == (0.0, 5 * 256.0)
    steps = {s: (0.0, 1e9) for steps in limb_interval.PLAIN_STEPS.values() for s in steps}
    vs = limb_interval.audit_headers(steps, {"fold.input<10>": reached["fold.input<10>"]})
    assert [(v.rule, v.path, v.line) for v in vs] == [
        ("torch-limb-overflow", limb_interval.HEADER,
         limb_interval._obligation_line("fold.input<10>"))]
    assert "outside [0, 1023]" in vs[0].message


# -- graph_audit -------------------------------------------------------------------


def test_graph_audit_of_the_default_program_is_clean_at_two_buckets():
    vs = graph_audit.audit_programs(entries=["fused_verify.miller_product_fused"])
    assert vs == [], format_report(vs)


def _programs():
    sys.path.insert(0, os.path.dirname(fixture_path("x")))
    import bad_programs

    return bad_programs


def _trace_fixture(fn, fake):
    fx = _programs()
    return graph_audit.trace_entry(lambda rec: fn(*fx.inputs(4)), fake)


PROGRAM_RULES = {"host_read": "torch-host-sync", "host_list": "torch-host-sync",
                 "host_array": "torch-host-sync", "data_branch": "torch-host-sync",
                 "wide_digits": "torch-wide-dtype", "digit_matmul": "torch-matmul-in-program"}


@pytest.mark.parametrize("fake", [False, True], ids=["zeros", "fake"])
@pytest.mark.parametrize("program", sorted(PROGRAM_RULES))
def test_graph_fixture_fires_on_the_marked_lines(program, fake):
    fx = _programs()
    trace = _trace_fixture(getattr(fx, program), fake)
    vs = graph_audit.check_trace(program, trace)
    src = fixture_source("bad_programs.py")
    first = src.index(f"def {program}(")
    end = src.index("\ndef ", first + 1)
    want = [ln for ln in violation_lines(src) if src[:first].count("\n") < ln
            <= src[:end].count("\n") + 1]
    assert sorted(v.line for v in vs) == want
    assert {v.rule for v in vs} == {PROGRAM_RULES[program]}
    assert all(v.path == os.path.relpath(fixture_path("bad_programs.py"), REPO) for v in vs)


def test_an_unstable_program_is_flagged_and_a_stable_one_is_not():
    fx = _programs()
    for fn, want in ((fx.unstable, ["torch-unstable-program"]), (fx.clean, [])):
        vs = graph_audit.audit_entry(fn.__name__, lambda b, d, fn=fn: (
            lambda rec: fn(*fx.inputs(b, d))), buckets=(4,))
        assert [v.rule for v in vs] == want, format_report(vs)


def test_a_local_body_reading_another_shards_inputs_is_flagged():
    fx = _programs()

    def run(body):
        def go(rec):
            ins = [fx.inputs(2), fx.inputs(2)]
            for s, x in enumerate(ins):
                rec.mark(x, s)
            parts = []
            for s in range(2):
                rec.shard = s
                parts.append(body(s, ins[s], ins[1 - s]))
            rec.shard = None
            rec.in_finish = True
            return parts[0] + parts[1]

        return graph_audit.check_trace("fixture", graph_audit.trace_entry(go), sharded=True)

    src = fixture_source("bad_programs.py")
    line = [ln for ln in violation_lines(src) if "torch-sharded-entry" in src.splitlines()[ln - 1]]
    assert [(v.rule, v.line) for v in run(fx.local_body_reading_another_shard)] == [
        ("torch-sharded-entry", line[0])]
    assert run(fx.local_body) == []


def test_an_item_in_the_live_program_turns_the_audit_red(monkeypatch):
    from lodestar_tpu_torch.ops import fused_verify

    neg = fused_verify._neg_point

    def reads_a_value(p):
        float(p[0].a.sum().item())
        return neg(p)

    monkeypatch.setattr(fused_verify, "_neg_point", reads_a_value)
    vs = graph_audit.audit_programs(buckets=(4,), entries=["fused_verify.miller_product_fused"],
                                    twice=False)
    assert [v.rule for v in vs] == ["torch-host-sync"]
    assert vs[0].path == os.path.relpath(__file__, REPO)


# -- kernel_audit ------------------------------------------------------------------


def test_kernel_audit_host_half_is_clean():
    """The CPU layer without its walks is clean, and the walks are
    registered: ``tests/test_torch_kernel_host.py`` runs
    ``audit_host_walks`` one (kernel, rows, order) a case over every
    cooperative kernel, every walk row count and both orders, so the suite
    runs each walk once."""
    import test_torch_kernel_host as host

    vs = kernel_audit.audit_kernels("cpu", host_walks=False)
    assert vs == [], format_report(vs)
    fn = host.test_cooperative_ladder_bodies_equal_plain_versions_bitwise
    params = {m.args[0]: list(m.args[1]) for m in fn.pytestmark if m.name == "parametrize"}
    assert params == {"name": list(kernel_audit.COOP), "rows": list(kernel_audit.WALK_ROWS),
                      "order": list(kernel_audit.WALK_ORDERS)}
    assert kernel_audit.PARTIAL_ROWS in kernel_audit.WALK_ROWS


def test_stage_race_fixture_fires_on_the_marked_line():
    path = fixture_path("bad_stage_race.cuh")
    text = fixture_source("bad_stage_race.cuh")
    mutation = kernel_audit.definition_mutation("field_coop.cuh", "struct Fq2MulStages", text)
    vs = kernel_audit.audit_host_walks(kernels=("fq2mul",), rows=(kernel_audit.PARTIAL_ROWS,),
                                       mutation=mutation,
                                       mutation_path=os.path.relpath(path, REPO))
    assert [(v.rule, v.path, v.line) for v in vs] == [
        ("cuda-smem-race", os.path.relpath(path, REPO), violation_lines(text)[0])]
    assert "forward walk" in vs[0].message and "reversed walk" in vs[0].message


@pytest.mark.parametrize("n", kernel_audit.RING_SHARDS)
def test_ring_plan_is_the_jax_rings(n):
    """The port's hop schedule against pallas_ring's: shard s sends chunk
    (s - k) mod n to its right neighbour at hop k, the same neighbour map."""
    from lodestar_tpu.ops import pallas_ring as jring
    from lodestar_tpu_torch.ops import ring_gather

    assert kernel_audit.check_ring_plan(n) == []
    want = {s: int(jring._right_neighbor(s, n)) for s in range(n)}
    assert kernel_audit.ring_neighbors(n) == want
    jax_hops = sorted((k, s, int(jring._chunk_index(s, k, n)))
                      for k in range(n - 1) for s in range(n))
    assert sorted(ring_gather.hop_order(n)) == jax_hops


def test_a_broken_ring_plan_is_flagged():
    from lodestar_tpu_torch.ops import ring_gather

    hops = ring_gather.hop_order(4)
    assert kernel_audit.check_ring_plan(4, hops[:-1])  # a hop missing
    bad = [(k, s, (s + k) % 4) for k, s, _ in hops]  # the slot the right neighbour holds
    vs = kernel_audit.check_ring_plan(4, bad)
    assert vs and {v.rule for v in vs} == {"ring-plan"}


def test_launch_resources_rule_on_the_attributes():
    ok = {"name": "mul", "source": "fused_kernels.cu", "registers": 64, "local_bytes": 0,
          "static_shared_bytes": 0, "max_threads": 1024, "max_dynamic_shared": 0,
          "threads": 128, "dynamic_shared_bytes": 21000, "rows_per_block": 2, "optin": 232448}
    assert kernel_audit.check_resources([ok]) == []
    bad = [dict(ok, local_bytes=16), dict(ok, threads=2048),
           dict(ok, dynamic_shared_bytes=232449), dict(ok, name="lad3", local_bytes=304)]
    vs = kernel_audit.check_resources(bad)
    assert [v.rule for v in vs] == ["cuda-launch-resources"] * 4
    assert "spill" in vs[0].message and "threads" in vs[1].message and "opt-in" in vs[2].message
    assert "above its 296" in vs[3].message  # the ladder kernels' measured spill, no more
    held = dict(ok, name="lad3", local_bytes=296)
    assert kernel_audit.check_resources([held]) == []
    # ... which is reported as a known violation, not as clean
    known = kernel_audit.known_spills([ok, held, dict(ok, name="lad1", local_bytes=88)])
    assert [v.rule for v in known] == ["cuda-launch-resources"] * 2
    assert "lad3: 296 local (spill) bytes" in known[0].message
    assert "known violation" in known[1].message


def _fake_sanitizer(tmp_path, output: str, rc: int) -> str:
    path = tmp_path / "compute-sanitizer"
    path.write_text("#!/bin/sh\nif [ \"$1\" = --version ]; then echo 'Version 9.9'; exit 0; fi\n"
                    f"cat <<'EOF'\n{output}\nEOF\nexit {rc}\n")
    path.chmod(0o755)
    return str(path)


def test_sanitizer_outcomes_are_read_not_waved_through(tmp_path):
    """A sanitizer that refuses the device is reported as such; a hazard or
    an error is a violation; no toolkit leaves the half out, said so."""
    refused = _fake_sanitizer(tmp_path, "========= Error: Device not supported.", 11)
    assert kernel_audit.run_sanitizer(refused, "racecheck", timeout=30)["status"] == "unsupported"
    hazard = _fake_sanitizer(tmp_path, "========= RACECHECK SUMMARY: 2 hazards displayed", 99)
    res = kernel_audit.run_sanitizer(hazard, "racecheck", timeout=30)
    assert res["status"] == "found" and res["errors"] == 2
    clean = _fake_sanitizer(tmp_path, "launched 16 kernels\n========= ERROR SUMMARY: 0 errors", 0)
    assert kernel_audit.run_sanitizer(clean, "memcheck", timeout=30)["status"] == "clean"


# -- the command -------------------------------------------------------------------


def test_the_command_exits_zero_on_the_tree_and_nonzero_on_a_violation(tmp_path):
    skip = [f"--skip-{name}" for name in LAYERS if name not in ("lint", "test-cost")]
    env = dict(os.environ, PYTHONPATH=REPO)
    ok = subprocess.run([sys.executable, "-m", "lodestar_tpu_torch.analysis", *skip],
                        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0 and "lint OK: 0 violations" in ok.stdout, ok.stdout + ok.stderr
    bad = tmp_path / "lodestar_tpu_torch" / "chain"
    bad.mkdir(parents=True)
    (bad / "x.py").write_text("import torch\n\n\nasync def f():\n    torch.cuda.synchronize()\n")
    red = subprocess.run([sys.executable, "-m", "lodestar_tpu_torch.analysis", *skip, "--json",
                          "--repo", str(tmp_path)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert red.returncode == 1 and '"async-blocking-sync"' in red.stdout, red.stdout + red.stderr
