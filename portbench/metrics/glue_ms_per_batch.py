"""Glue: the card's busy time inside one batch's replay in events that
are not the port's kernels (PyTorch's graph nodes between them), averaged
over the same batches as ``replay_ms_per_batch``, in ms."""


def read(ctx):
    batches = ctx.device_batches()
    return 1e3 * sum(b["glue_s"] for b in batches) / len(batches) if batches else None
