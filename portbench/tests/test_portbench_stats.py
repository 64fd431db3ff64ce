"""The nearest-rank percentile (a frozen copy of the port's) and the
union of busy intervals."""

import random

import pytest

from portbench.stats import nearest_rank, union_seconds


def test_nearest_rank_small():
    assert nearest_rank([], 95) is None
    assert nearest_rank([5.0], 50) == 5.0
    assert nearest_rank([1, 2, 3, 4], 50) == 2
    assert nearest_rank(list(range(1, 101)), 95) == 95
    assert nearest_rank(list(range(1, 101)), 100) == 100


@pytest.mark.parametrize("seed", range(5))
def test_nearest_rank_matches_the_port(seed):
    from lodestar_tpu_torch.observatory.latency import nearest_rank as port_rank

    rng = random.Random(seed)
    values = [rng.expovariate(1.0) for _ in range(rng.randint(1, 500))]
    for q in (50, 95, 99):
        assert nearest_rank(values, q) == port_rank(values, q)


def test_union():
    assert union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert union_seconds([]) == 0.0
