"""Pool layer: the 95th percentile (nearest rank) of every job's wait in
the pool's buffer, from the pool's ``bls.queue_wait`` spans, in ms."""

from portbench.stats import nearest_rank


def read(ctx):
    waits = [s.dur_ns / 1e6 for s in ctx.spans_named("bls.queue_wait")]
    return nearest_rank(waits, 95)
