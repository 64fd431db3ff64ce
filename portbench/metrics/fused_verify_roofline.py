"""Kernels: the split fused program's share of its roofline.  The
numerator is the frozen work that each batch's sets need, priced at the
card's peaks (``portbench/work.py``, ``data/work_table.json``: the fixed
part of a batch plus its sets times the part per set, not its bucket's
padding lanes), the denominator the card's busy time of the same batches,
kernels and glue together, in %.  A batch whose sets are unknown leaves
the metric unread."""


def read(ctx):
    batches = ctx.device_batches()
    if not batches or any(b["bound_s"] is None for b in batches):
        return None
    busy = sum(b["busy_s"] for b in batches)
    return 100.0 * sum(b["bound_s"] for b in batches) / busy if busy > 0 else None
