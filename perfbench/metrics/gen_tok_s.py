"""Every token the engine emitted in the window, first tokens included,
over the window's whole time (host clock)."""

from perfbench.stats import rate


def read(ctx):
    r = ctx.record
    if "token_times" not in r:
        return None
    lo, hi = r["t_open"], r["t_close"]
    n = sum(1 for ts in r["token_times"].values() for t in ts if lo < t <= hi)
    return rate(n, hi - lo)
