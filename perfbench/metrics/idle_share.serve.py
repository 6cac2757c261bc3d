"""The share of the traced window in which no operation ran on the
device (the union of the trace's device intervals), in %."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
