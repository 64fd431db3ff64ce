"""Prometheus-backed metrics registry (the port's copy of the JAX
package's ``metrics/registry.py``: the metrics the port reports, with the
JAX registry's names letter for letter).

Reference: packages/beacon-node/src/metrics/metrics/lodestar.ts (the
framework-internal metric groups; blsThreadPool.* at :385 is the model for
the device-pool metrics here) and metrics/server/http.ts (exposition).

``prometheus_client`` is optional: without it (the machine with the card
does not install it) every metric is a no-op and ``expose()`` is empty.
"""

from __future__ import annotations

from typing import Sequence

try:  # optional: every metric is a no-op without it
    from prometheus_client import (
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )

    HAVE_PROM = True
except Exception:  # pragma: no cover
    HAVE_PROM = False


#: the compile-time histogram's bucket ladder (seconds), the JAX
#: package's ``observatory/latency.COMPILE_BUCKETS_S``
COMPILE_BUCKETS_S = (0.1, 0.5, 1, 5, 10, 30, 60, 120, 300, 600)


class _NoopMetric:
    def labels(self, *a, **k):
        return self

    def inc(self, *a, **k):
        pass

    def dec(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass


class MetricsRegistry:
    """Thin factory over a CollectorRegistry."""

    def __init__(self):
        self.registry = CollectorRegistry() if HAVE_PROM else None

    def counter(self, name: str, help: str, labels: Sequence[str] = ()):
        if not HAVE_PROM:
            return _NoopMetric()
        return Counter(name, help, labelnames=list(labels), registry=self.registry)

    def gauge(self, name: str, help: str, labels: Sequence[str] = ()):
        if not HAVE_PROM:
            return _NoopMetric()
        return Gauge(name, help, labelnames=list(labels), registry=self.registry)

    def histogram(self, name: str, help: str, buckets, labels: Sequence[str] = ()):
        if not HAVE_PROM:
            return _NoopMetric()
        return Histogram(name, help, labelnames=list(labels), buckets=buckets, registry=self.registry)

    def expose(self) -> bytes:
        """Prometheus text exposition (server/http.ts GET /metrics body)."""
        if not HAVE_PROM:
            return b""
        return generate_latest(self.registry)


class Metrics:
    """The JAX registry's metrics that the port reports: the verifier's
    stages, executors, self-healing pool and pack caches, the watchdog,
    the recorder and the tracer.  Left out: the pool's metrics (the pool
    reports none yet), the node's chain, network and database groups,
    the degrade ladder's counter (the port has no ladder), and the
    memory-sampler and mesh-observatory metrics, whose bindings are not
    ported.  The compile ledger (``observatory.compile_ledger``) observes
    ``bls_compile_seconds``."""

    def __init__(self):
        self.reg = MetricsRegistry()
        r = self.reg
        # the verifier's stages (pack -> device -> final exp)
        self.bls_pool_pack_seconds = r.histogram(
            "lodestar_bls_pool_pack_seconds",
            "host packing stage (bytes -> limb arrays) per dispatch",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5),
        )
        self.bls_pool_final_exp_seconds = r.histogram(
            "lodestar_bls_pool_final_exp_seconds",
            "device readback + host final exponentiation per dispatch",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1),
        )
        # the executors + pack-side caches
        self.bls_device_inflight = r.gauge(
            "lodestar_bls_device_inflight",
            "merged batches in flight per device executor "
            "(the least-loaded scheduler's placement signal)",
            labels=("device",),
        )
        self.bls_pack_cache_hits_total = r.counter(
            "lodestar_bls_pack_cache_hits_total",
            "pack-stage point-cache hits (affine point reused, "
            "decompression/aggregation/inversion skipped)",
        )
        self.bls_pack_cache_misses_total = r.counter(
            "lodestar_bls_pack_cache_misses_total",
            "pack-stage point-cache misses (full decompression + batched "
            "inversion paid)",
        )
        self.bls_pack_rejected_total = r.counter(
            "lodestar_bls_pack_rejected_total",
            "pack-stage rejections (malformed bytes or infinity point; "
            "the batch never dispatched)",
        )
        self.bls_verifier_stage_duration_seconds = r.histogram(
            "lodestar_bls_verifier_stage_duration_seconds",
            "per-call verifier stage duration (pack/dispatch/final_exp) — "
            "the histogram the deprecated bls_verifier_stage_seconds gauge "
            "snapshot could never be",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
            labels=("stage",),
        )
        self.bls_sharded_batches_total = r.counter(
            "lodestar_bls_sharded_batches_total",
            "merged batches dispatched as ONE mesh-spanning shard_map "
            "program (the sharded verifier tier, docs/multichip.md) — "
            "zero on a busy multi-device pool means big batches are "
            "fanning out per-device instead of using the whole mesh",
        )
        # self-healing device pool (docs/chaos.md)
        self.bls_batch_requeues_total = r.counter(
            "lodestar_bls_batch_requeues_total",
            "failed in-flight batches re-dispatched (same packed payload) "
            "onto a surviving executor before any per-job retry",
        )
        self.bls_device_quarantines_total = r.counter(
            "lodestar_bls_device_quarantines_total",
            "executor quarantine entries (threshold consecutive failures, "
            "or a failed re-admission probe) per device",
            labels=("device",),
        )
        self.bls_device_health = r.gauge(
            "lodestar_bls_device_health",
            "executor health state per device: 0 healthy, 1 suspect, "
            "2 probing (one re-admission batch in flight), 3 quarantined",
            labels=("device",),
        )
        # the compile ledger: what making a program cost, by entry and kind
        self.bls_compile_seconds = r.histogram(
            "lodestar_bls_compile_seconds",
            "program materialization cost by entry and kind: build = nvcc "
            "built the kernel library, build_cache = a built library "
            "loaded from build/, aot_load = the durable store served the "
            "library, capture = a CUDA graph made (eager run, capture, "
            "instantiation), hit = already live in-process (compile "
            "ledger, persisted in compile_ledger.json)",
            buckets=COMPILE_BUCKETS_S,
            labels=("entry", "kind"),
        )
        # flight recorder & failure forensics
        self.bls_watchdog_stalls_total = r.counter(
            "lodestar_bls_watchdog_stalls_total",
            "dispatched batches flagged by the watchdog as unresolved past "
            "the deadline (a silent device wedge made visible)",
            labels=("device",),
        )
        self.tracing_spans_dropped_total = r.gauge(
            "lodestar_tracing_spans_dropped_total",
            "spans evicted from the tracer ring buffer (history a trace "
            "dump is missing)",
        )
        self.forensics_journal_dropped_total = r.gauge(
            "lodestar_forensics_journal_dropped_total",
            "events evicted from the forensics journal ring (history a "
            "diagnostic bundle is missing)",
        )
        self.forensics_bundles_written_total = r.counter(
            "lodestar_forensics_bundles_written_total",
            "diagnostic bundles written, by trigger reason "
            "(watchdog/sigterm/sigusr2/crash-*/api)",
            labels=("reason",),
        )


def create_metrics() -> Metrics:
    return Metrics()
