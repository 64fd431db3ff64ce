"""The port's static analysis: the invariants its kernels, programs, locks
and tests rest on, checked by machine.

The counterpart of ``lodestar_tpu/analysis/``, as the port's own copy (no
``jax``, nothing of ``lodestar_tpu``).  One report format
(``report.Violation``), seven layers:

- ``ast_lint``        the JAX package's four AST checkers (blocking syncs in
  ``async def`` with the port's blocking calls, wall clock in tracing,
  await holding a lock, silent excepts on the BLS path) and
  ``metrics_coverage``, over ``lodestar_tpu_torch/``;
- ``test_cost``       the census of the port's CPU tests that run a whole
  device program's plain versions (``torch-test-threads``: pinned to one
  intra-op thread), the counterpart of ``compile_cost``;
- ``lock_audit``      instrumented locks and guarded state over
  ``BlsBatchPool`` -> ``TorchBlsVerifier`` with stubbed programs
  (``lock-unguarded-mutation``, ``lock-order-inversion``);
- ``limb_interval``   interval proofs of the digit bounds over the plain
  versions' aten graphs, and the kernel headers' named 2^24 obligations
  held by the g++ audit build (``torch-limb-overflow``);
- ``graph_audit``     the device programs' traces: no host sync, no wide
  dtype, stable censuses, the sharded pieces' shards, no matrix product
  (``torch-host-sync``, ``torch-wide-dtype``, ``torch-unstable-program``,
  ``torch-sharded-entry``, ``torch-matmul-in-program``);
- ``kernel_audit``    the CUDA kernels: shared-memory races (the g++
  walks; ``compute-sanitizer`` on the card), launch resources against the
  launch configuration (the card), the ring's hop plan
  (``cuda-smem-race``, ``cuda-launch-resources``, ``ring-plan``).

``python -m lodestar_tpu_torch.analysis`` runs them all and exits nonzero
on a violation (the counterpart of ``tools/lint.py``); ``--device cuda``
adds the halves that run on the card, as ``chip_smoke.py`` phase 16 does.
Suppression: ``# lint: disable=<rule>`` on the flagged line.
"""

from typing import List, Optional, Sequence

from .report import Violation, format_report  # noqa: F401

LAYERS = ("lint", "test-cost", "locks", "limbs", "graphs", "kernels")


def run_all(repo: Optional[str] = None, device: str = "cpu", skip: Sequence[str] = (),
            buckets: Optional[Sequence[int]] = None, report: Optional[dict] = None,
            log=None) -> List[Violation]:
    """Every layer not in ``skip`` (names in ``LAYERS``), one violation
    list.  ``device="cuda"``: the graph audit at bucket 128 on the card
    (once a bucket), the launch resources and the sanitizer tools;
    ``"cpu"``: the graph audit at buckets 4 and 128 (twice a bucket), the
    host halves.  ``report`` receives each layer's seconds, the kernel
    audit's details and ``known``: the known violations, open faults held
    at their measured size, which are not in the returned list;
    ``log(line)`` each layer's summary."""
    import os
    import time

    if repo is None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    report = {} if report is None else report
    report.setdefault("seconds", {})
    report.setdefault("known", [])
    out: List[Violation] = []

    def layer(name, fn):
        if name in skip:
            return
        t0 = time.perf_counter()
        found = fn()
        report["seconds"][name] = round(time.perf_counter() - t0, 2)
        if log is not None:
            log(f"analysis {name}: {len(found)} violation(s) in {report['seconds'][name]} s")
        out.extend(found)

    def lint():
        from .ast_lint import run_ast_lint

        return run_ast_lint(repo)

    def test_cost():
        from .test_cost import audit_test_cost

        return audit_test_cost(repo)

    def locks():
        from .lock_audit import audit_bls_pipeline

        return audit_bls_pipeline()

    def limbs():
        from .limb_interval import audit_limb_overflow

        return audit_limb_overflow(repo)

    def graphs():
        from .graph_audit import audit_programs

        if device == "cuda":
            return audit_programs(buckets or (128,), "cuda", twice=False)
        return audit_programs(buckets or (4, 128), "cpu")

    def kernels():
        from .kernel_audit import audit_kernels

        return audit_kernels(device, report)

    for name, fn in (("lint", lint), ("test-cost", test_cost), ("locks", locks),
                     ("limbs", limbs), ("graphs", graphs), ("kernels", kernels)):
        layer(name, fn)
    return out
