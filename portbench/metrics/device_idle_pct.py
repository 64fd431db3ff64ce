"""Device: the share of the profiler sub-window in which no operation ran
on the card, 100 (1 - union of device busy intervals / sub-window), in %."""


def read(ctx):
    d = ctx.device
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
