"""The 95th percentile of every gap between successive tokens of one
request inside the window, in ms; a gap that spans an admission counts."""

from perfbench.stats import percentile, request_gaps


def read(ctx):
    r = ctx.record
    if "token_times" not in r:
        return None
    gaps = request_gaps(r["token_times"], r["t_open"], r["t_close"])
    return percentile(gaps, 95) * 1e3 if gaps else None
