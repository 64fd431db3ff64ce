"""Latency bucket ladder + histogram percentile helpers (the port's copy
of the JAX package's ``observatory/latency.py``).

One ladder, three consumers: the Prometheus histograms in
``metrics/registry.py`` (per-lane queue-wait and e2e verify latency),
the firehose harness's SLO checks (``tools/firehose.py`` reports
nearest-rank p50/p99 over raw samples), and the span timeline.  The
point of sharing the ladder is agreement: a p99 read off ``/metrics``
via ``histogram_quantile`` lands in the same bucket that contains the
firehose's nearest-rank p99 — ``bucket_percentile`` below is the exact
arithmetic, and ``tests/test_torch_latency.py`` pins the agreement.

This module is dependency-free on purpose (no torch, no forensics): the
metrics registry imports it at module load.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

#: Histogram bucket upper bounds (seconds) for queue-wait / e2e verify
#: latency, aligned with the firehose SLO ladder: the default p99
#: queue-wait SLO (100 ms) and the storm-lane deadlines the harness
#: stamps (400 ms / 1000 ms) are all exact bucket edges, so "did we meet
#: the SLO" is a single bucket read, never an interpolation.
SLO_LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.0,
    2.0, 5.0, 10.0,
)

#: Compile / load durations (seconds): spans an nvcc build of the kernel
#: library, a graph capture, a store load and the sub-second
#: in-process hits.
COMPILE_BUCKETS_S = (0.1, 0.5, 1, 5, 10, 30, 60, 120, 300, 600)


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over raw samples — the same arithmetic as
    ``tools/firehose.percentile`` (ceil(q/100*n) as a 1-based rank), so
    the two stay in lockstep by construction."""
    if not values:
        return None
    ordered = sorted(values)
    k = max(0, min(len(ordered) - 1, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[k]


def cumulative_counts(
    values: Sequence[float], bounds: Sequence[float] = SLO_LATENCY_BUCKETS_S
) -> List[int]:
    """Prometheus-style cumulative bucket counts (le=bound) plus the
    +Inf bucket appended last — what a histogram family exposes."""
    out = []
    for b in bounds:
        out.append(sum(1 for v in values if v <= b))
    out.append(len(values))
    return out


def bucket_percentile(
    cumulative: Sequence[int],
    q: float,
    bounds: Sequence[float] = SLO_LATENCY_BUCKETS_S,
) -> Optional[float]:
    """Percentile estimate from cumulative histogram counts: the upper
    bound of the bucket containing the nearest-rank sample (the +Inf
    bucket reports the largest finite bound).

    Guarantee (pinned by tests): for any sample set, the nearest-rank
    percentile of the raw values is <= this estimate, and > the previous
    bucket's bound — /metrics and the firehose report can disagree by at
    most one bucket's width, never by a band.
    """
    if not cumulative or cumulative[-1] == 0:
        return None
    total = cumulative[-1]
    rank = max(1, math.ceil(q / 100.0 * total))  # 1-based nearest rank
    for i, c in enumerate(cumulative[:-1]):
        if c >= rank:
            return float(bounds[i])
    return float(bounds[-1])  # beyond the ladder: clamp to the top edge
