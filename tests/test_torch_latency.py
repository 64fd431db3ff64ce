"""The port's latency ladder and percentile helpers
(``lodestar_tpu_torch/observatory/latency.py``) held against the JAX
package's module: the JAX module's own cases (``tests/test_observatory.py``'s
``TestLatencyAgreement``) run against both modules on the same seeded
samples and give equal outputs; the port's metrics registry and REST route
read the module's ladders, not copies of them."""

import random

import pytest

from lodestar_tpu.observatory import latency as jlatency
from lodestar_tpu_torch.api import rest
from lodestar_tpu_torch.metrics import registry
from lodestar_tpu_torch.observatory import latency
from lodestar_tpu_torch.tools import firehose

MODULES = {"port": latency, "jax": jlatency}


def _samples(seed, n, scales=(20.0,)):
    rng = random.Random(seed)
    return [rng.expovariate(rng.choice(scales)) for _ in range(n)]


def test_the_ladders_equal_the_jax_modules():
    assert latency.SLO_LATENCY_BUCKETS_S == jlatency.SLO_LATENCY_BUCKETS_S
    assert latency.COMPILE_BUCKETS_S == jlatency.COMPILE_BUCKETS_S


@pytest.mark.parametrize("n", [1, 2, 7, 100, 999])
def test_nearest_rank_equals_the_jax_module_and_the_firehose(n):
    vals = _samples(1 + n, n)
    for q in (0, 50, 90, 99, 100):
        got = latency.nearest_rank(vals, q)
        assert got == jlatency.nearest_rank(vals, q)
        assert got == firehose.percentile(vals, q)


@pytest.mark.parametrize("trial", range(20))
def test_bucket_percentile_brackets_nearest_rank_as_the_jax_module(trial):
    """The /metrics histogram answer and the nearest-rank answer agree to
    one bucket: the raw percentile lies in (prev_bound, reported_bound];
    the port's counts and estimates equal the JAX module's."""
    rng = random.Random(7 + trial)
    vals = _samples(trial, rng.randrange(1, 400), (5.0, 50.0, 500.0))
    bounds = latency.SLO_LATENCY_BUCKETS_S
    cc = latency.cumulative_counts(vals, bounds)
    assert cc == jlatency.cumulative_counts(vals, bounds) and cc[-1] == len(vals)
    for q in (50, 90, 99):
        raw = latency.nearest_rank(vals, q)
        est = latency.bucket_percentile(cc, q, bounds)
        assert est == jlatency.bucket_percentile(cc, q, bounds) and est is not None
        if raw > bounds[-1]:
            assert est == bounds[-1]  # clamped to the top edge
            continue
        idx = bounds.index(est)
        assert (bounds[idx - 1] if idx else 0.0) < raw <= est


@pytest.mark.parametrize("side", MODULES)
def test_slo_edges_and_degenerate_inputs(side):
    mod = MODULES[side]
    # the queue-wait SLO (100 ms) and storm deadlines (400 ms / 1 s) are
    # exact bucket edges, so "met the SLO" is one bucket read
    for edge in (0.1, 0.4, 1.0):
        assert edge in mod.SLO_LATENCY_BUCKETS_S
    assert mod.nearest_rank([], 99) is None
    assert mod.bucket_percentile([], 99) is None
    assert mod.bucket_percentile(mod.cumulative_counts([]), 99) is None
    assert mod.cumulative_counts([0.05, 20.0], (0.1, 1.0)) == [1, 1, 2]


def test_registry_and_rest_read_the_modules_ladders(monkeypatch):
    assert registry.SLO_LATENCY_BUCKETS_S is latency.SLO_LATENCY_BUCKETS_S
    assert registry.COMPILE_BUCKETS_S is latency.COMPILE_BUCKETS_S
    server = object.__new__(rest.RestApiServer)
    out = rest.RestApiServer._observatory(server, None, {}, b"")
    assert out["data"]["latency_buckets_s"] == list(latency.SLO_LATENCY_BUCKETS_S)
    # the route reads the module's ladder at call time, not a copy
    monkeypatch.setattr(latency, "SLO_LATENCY_BUCKETS_S", (0.5, 1.5))
    out = rest.RestApiServer._observatory(server, None, {}, b"")
    assert out["data"]["latency_buckets_s"] == [0.5, 1.5]
    monkeypatch.undo()
    from lodestar_tpu_torch import observatory

    assert observatory.SLO_LATENCY_BUCKETS_S is latency.SLO_LATENCY_BUCKETS_S
    assert observatory.nearest_rank is latency.nearest_rank
