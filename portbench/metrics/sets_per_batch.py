"""Pool layer: the mean count of sets in a merged batch, from the pool's
``pool.batch`` spans."""


def read(ctx):
    sizes = [s.args["sets"] for s in ctx.spans_named("pool.batch") if s.args]
    return sum(sizes) / len(sizes) if sizes else None
