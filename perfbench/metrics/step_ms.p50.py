"""The median of the window's decode steps (``decode_step``, ending in the
host copy of its tokens), in ms."""

from perfbench.stats import median


def read(ctx):
    s = ctx.spans.of("decode_step")
    return median((x["t1"] - x["t0"]) * 1e3 for x in s) if s else None
