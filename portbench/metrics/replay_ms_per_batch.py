"""Per-bucket program: the card's busy time inside one batch's CUDA-graph
replay (kernels and glue), averaged over the batches that lie whole in
the profiler sub-window, in ms."""


def read(ctx):
    batches = ctx.device_batches()
    return 1e3 * sum(b["busy_s"] for b in batches) / len(batches) if batches else None
