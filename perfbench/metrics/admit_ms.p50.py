"""The median of the window's admissions (``_admit_batch``: the prefill
and its first tokens, ending in their host copy), in ms."""

from perfbench.stats import median


def read(ctx):
    s = ctx.spans.of("admit")
    return median((x["t1"] - x["t0"]) * 1e3 for x in s) if s else None
