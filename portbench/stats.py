"""Percentiles and interval unions.

``nearest_rank`` is a frozen copy of the port's
``observatory/latency.nearest_rank`` (ceil(q/100 n) as a 1-based rank).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    k = max(0, min(len(ordered) - 1, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[k]


def union_seconds(intervals: Sequence[tuple]) -> float:
    """The length of the union of (start, end) intervals."""
    total = 0.0
    end = -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total
