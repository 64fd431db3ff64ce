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

#: the queue-wait / e2e verify latency ladder (seconds), the JAX
#: package's ``observatory/latency.SLO_LATENCY_BUCKETS_S``: the 100 ms
#: queue-wait SLO and the 400 ms / 1000 ms lane deadlines are bucket edges
SLO_LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.0,
    2.0, 5.0, 10.0,
)


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
    """The JAX registry's metrics that the port reports: the batch pool's,
    the verifier's stages, executors, self-healing pool and pack caches,
    the device sampler's, the profile windows' attribution, the watchdog,
    the recorder and the tracer; the chain's (block import, state
    transition, state caches and regen, op pools, the next-slot
    precompute, the clock), the database controller's and the validator
    monitor's.  Left out: the network, sync and REST API groups (their
    modules are not ported yet), and the degrade ladder's counter (the
    port has no ladder).  The compile ledger
    (``observatory.compile_ledger``) observes ``bls_compile_seconds``."""

    def __init__(self):
        self.reg = MetricsRegistry()
        r = self.reg
        # the batch pool (blsThreadPool.* analog, lodestar.ts:385)
        self.bls_pool_queue_length = r.gauge(
            "lodestar_bls_pool_queue_length", "pending signature sets in the device pool"
        )
        self.bls_pool_dispatches_total = r.counter(
            "lodestar_bls_pool_dispatches_total", "device batch-verify dispatches"
        )
        self.bls_pool_sets_total = r.counter(
            "lodestar_bls_pool_sets_total", "signature sets verified", labels=("result",)
        )
        self.bls_pool_batch_size = r.histogram(
            "lodestar_bls_pool_batch_size",
            "live sets per dispatch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
        )
        self.bls_pool_dispatch_seconds = r.histogram(
            "lodestar_bls_pool_dispatch_seconds",
            "device dispatch latency",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self.bls_pool_job_wait_seconds = r.histogram(
            "lodestar_bls_pool_job_wait_seconds",
            "time a set waits in the buffer before dispatch",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1),
        )
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
        self.bls_pool_inflight_depth = r.gauge(
            "lodestar_bls_pool_inflight_depth",
            "merged batches concurrently in flight on the device pipeline",
        )
        # span-derived pipeline observability (docs/observability.md)
        self.bls_pool_queue_wait_seconds = r.histogram(
            "lodestar_bls_pool_queue_wait_seconds",
            "DEPRECATED (one release, round 11): laneless queue-wait "
            "histogram on ad-hoc buckets — use bls_queue_wait_seconds "
            "(per lane, SLO-ladder buckets)",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.02, 0.05, 0.1, 0.5, 1),
        )
        self.bls_pool_overlap_ratio = r.gauge(
            "lodestar_bls_pool_overlap_ratio",
            "sum of in-flight batch busy time / flush wall time "
            "(>1 means batches overlapped; 1 is fully serial)",
        )
        self.bls_pool_inflight_peak = r.gauge(
            "lodestar_bls_pool_inflight_peak",
            "highest in-flight depth the pipeline has reached",
        )
        self.bls_verifier_stage_seconds = r.gauge(
            "lodestar_bls_verifier_stage_seconds",
            "DEPRECATED (one release, round 11): cumulative wall seconds "
            "per stage as a last-write gauge snapshot at flush — use the "
            "per-dispatch histogram bls_verifier_stage_duration_seconds",
            labels=("stage",),
        )
        # the executors + pack-side caches
        self.bls_device_inflight = r.gauge(
            "lodestar_bls_device_inflight",
            "merged batches in flight per device executor "
            "(the least-loaded scheduler's placement signal)",
            labels=("device",),
        )
        self.bls_sets_per_sec_per_chip = r.gauge(
            "lodestar_bls_sets_per_sec_per_chip",
            "signature sets resolved per second per device in the last "
            "pool flush — the BASELINE.json north star, live",
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
        # overload survival: QoS lanes, shedding, backpressure (round 10,
        # docs/overload.md)
        self.bls_pool_dropped_total = r.counter(
            "lodestar_bls_pool_dropped_total",
            "signature sets dropped by the overload policy instead of "
            "verified (deadline shed / overflow eviction / shutdown), "
            "by reason and QoS lane — every drop is accounted here",
            labels=("reason", "lane"),
        )
        self.bls_pool_backpressure = r.gauge(
            "lodestar_bls_pool_backpressure",
            "1 while pending sets sit above the pool high-water mark "
            "(gossip intake slows its sheddable topics), 0 once drained "
            "below the low-water release point",
        )
        self.bls_pool_lane_pending = r.gauge(
            "lodestar_bls_pool_lane_pending",
            "pending verification jobs per QoS lane "
            "(block_proposal/aggregate/unaggregated/sync_committee)",
            labels=("lane",),
        )
        # performance observatory (round 11, docs/observability.md
        # §Performance observatory)
        self.bls_queue_wait_seconds = r.histogram(
            "lodestar_bls_queue_wait_seconds",
            "per-job pool buffer wait by QoS lane, on the firehose SLO "
            "bucket ladder — p50/p99 here, in firehose reports, and in "
            "bls.queue_wait spans agree to one bucket "
            "(replaces the deprecated laneless bls_pool_queue_wait_seconds)",
            buckets=SLO_LATENCY_BUCKETS_S,
            labels=("lane",),
        )
        self.bls_e2e_verify_seconds = r.histogram(
            "lodestar_bls_e2e_verify_seconds",
            "end-to-end verify latency by QoS lane: job enqueue -> "
            "verdict resolved (drops excluded — they land in "
            "bls_pool_dropped_total), SLO-ladder buckets",
            buckets=SLO_LATENCY_BUCKETS_S,
            labels=("lane",),
        )
        self.bls_verifier_stage_duration_seconds = r.histogram(
            "lodestar_bls_verifier_stage_duration_seconds",
            "per-call verifier stage duration (pack/dispatch/final_exp) — "
            "the histogram the deprecated bls_verifier_stage_seconds gauge "
            "snapshot could never be",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
            labels=("stage",),
        )
        self.bls_device_hbm_bytes = r.gauge(
            "lodestar_bls_device_hbm_bytes",
            "per-executor card memory from the allocator's counters "
            "(torch.cuda.memory_stats) by kind "
            "(bytes_in_use/peak_bytes_in_use/bytes_limit/bytes_reserved), "
            "sampled by the observatory device sampler",
            labels=("device", "kind"),
        )
        self.bls_device_busy_ratio = r.gauge(
            "lodestar_bls_device_busy_ratio",
            "fraction of recent sampler ticks each device had >= 1 "
            "unresolved batch in flight — the is-the-mesh-actually-full "
            "signal roadmap item 1 is judged by",
            labels=("device",),
        )
        self.bls_sets_per_sec_mesh = r.gauge(
            "lodestar_bls_sets_per_sec_mesh",
            "whole-mesh signature sets resolved per second in the last "
            "pool flush (sets/wall, NOT divided by device count) — the "
            "headline the sharded-kernel roadmap item is measured against",
        )
        self.bls_sharded_batches_total = r.counter(
            "lodestar_bls_sharded_batches_total",
            "merged batches dispatched as ONE mesh-spanning shard_map "
            "program (the sharded verifier tier, docs/multichip.md) — "
            "zero on a busy multi-device pool means big batches are "
            "fanning out per-device instead of using the whole mesh",
        )
        # mesh observatory: profile-window attribution (ISSUE 20,
        # docs/observability.md §Mesh observatory)
        self.bls_mesh_overlap_ratio = r.gauge(
            "lodestar_bls_mesh_overlap_ratio",
            "fraction of device-busy (dispatch-window) time during which "
            "the host was packing ANOTHER merged batch — 1.0 means the "
            "pipeline fully hides host pack behind device compute, 0 "
            "means the stages strictly alternate (attribution engine, "
            "updated per profile window)",
        )
        self.bls_sharded_combine_seconds = r.histogram(
            "lodestar_bls_sharded_combine_seconds",
            "per-mesh-batch cross-chip collective (GT combine) seconds "
            "attributed from profile-window device events inside the "
            "dispatch window — the communication term of the "
            "scaling-loss breakdown",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1),
        )
        self.bls_pipeline_bubble_seconds = r.histogram(
            "lodestar_bls_pipeline_bubble_seconds",
            "per-merged-batch end-to-end seconds the six-way attribution "
            "(queue/pack/device/combine/final_exp) could NOT explain — "
            "scheduler idle between pipeline stages",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1),
        )
        self.bls_scaling_loss = r.gauge(
            "lodestar_bls_scaling_loss",
            "mesh scaling loss (1 - scaling efficiency) split by "
            "component: communication (cross-chip collectives), "
            "shard_imbalance (slowest vs mean shard), serial_host "
            "(pack/final-exp the mesh waits on) — components sum to "
            "the measured gap within tolerance",
            labels=("component",),
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
        # the chain (chain/beacon_chain.py, chain/regen.py,
        # chain/prepare_next_slot.py)
        self.block_processing_seconds = r.histogram(
            "lodestar_block_processing_seconds",
            "verifyBlock+importBlock wall time",
            buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 10),
        )
        self.head_slot = r.gauge("lodestar_head_slot", "fork-choice head slot")
        self.finalized_epoch = r.gauge("lodestar_finalized_epoch", "finalized checkpoint epoch")
        self.clock_slot = r.gauge("lodestar_clock_slot", "current wall-clock slot")
        self.state_transition_seconds = r.histogram(
            "lodestar_state_transition_seconds",
            "per-block state transition wall time",
            buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self.epoch_transition_seconds = r.histogram(
            "lodestar_epoch_transition_seconds",
            "epoch transition wall time",
            buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 30),
        )
        self.state_cache_size = r.gauge(
            "lodestar_state_cache_size", "states held in the LRU state cache"
        )
        self.state_cache_hits_total = r.counter(
            "lodestar_state_cache_hits_total", "state cache hits"
        )
        self.state_cache_misses_total = r.counter(
            "lodestar_state_cache_misses_total",
            "state cache misses (regen replay needed)",
        )
        self.regen_seconds = r.histogram(
            "lodestar_regen_seconds",
            "state regeneration latency (checkpoint load + replay)",
            buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self.regen_replays_total = r.counter(
            "lodestar_regen_replayed_blocks_total",
            "blocks replayed to regenerate a state on cache miss",
        )
        self.op_pool_size = r.gauge(
            "lodestar_op_pool_size", "operations pooled", labels=("pool",)
        )
        self.prepare_next_slot_hits_total = r.counter(
            "lodestar_prepare_next_slot_hits_total",
            "block imports/productions served by the precomputed next-slot state",
        )
        # the database controller (db/controller.MeteredDbController)
        self.db_op_seconds = r.histogram(
            "lodestar_db_op_seconds",
            "db controller operation latency",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5),
            labels=("op",),
        )
        self.db_ops_total = r.counter(
            "lodestar_db_ops_total", "db controller operations", labels=("op",)
        )
        # the validator monitor (metrics/validator_monitor.py)
        self.monitor_proposals_total = r.counter(
            "lodestar_validator_monitor_proposals_total",
            "blocks proposed by registered validators",
        )
        self.monitor_attestation_hit_ratio = r.gauge(
            "lodestar_validator_monitor_attestation_hit_ratio",
            "fraction of registered validators attesting per epoch",
        )
        self.monitor_inclusion_delay = r.histogram(
            "lodestar_validator_monitor_inclusion_delay_slots",
            "attestation inclusion delay of registered validators",
            buckets=(1, 2, 3, 4, 8, 16, 32),
        )
        self.monitor_sync_committee_hit_ratio = r.gauge(
            "lodestar_validator_monitor_sync_committee_hit_ratio",
            "fraction of registered sync-committee duties fulfilled per epoch",
        )
        self.monitor_timely_total = r.counter(
            "lodestar_validator_monitor_timely_total",
            "registered validators' attestation timeliness flags",
            labels=("flag",),
        )


def create_metrics() -> Metrics:
    return Metrics()
