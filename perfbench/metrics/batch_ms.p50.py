"""The median of the window's batches (one ``evaluate_perplexity`` call,
ending in the host read of its loss), in ms."""

from perfbench.stats import median


def read(ctx):
    s = ctx.spans.of("batch")
    return median((x["t1"] - x["t0"]) * 1e3 for x in s) if s else None
