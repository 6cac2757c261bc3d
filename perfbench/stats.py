"""The metric arithmetic: rates over a whole window, percentiles over
every sample (``statistics.quantiles``, inclusive method), and the union
of device intervals."""

from __future__ import annotations

import statistics


def rate(count: float, seconds: float) -> float:
    """Work over the whole window's time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values, p: int) -> float:
    """The ``p``-th percentile (1..99) of every value, linear between
    order statistics (``statistics.quantiles(n=100, method="inclusive")``)."""
    values = list(values)
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


def median(values) -> float:
    return float(statistics.median(list(values)))


def union(intervals, lo: float, hi: float):
    """Merged ``[start, end)`` intervals clipped to ``[lo, hi]``, sorted."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def request_gaps(token_times: dict, t_open: float, t_close: float) -> list:
    """Every gap between successive tokens of one request whose two tokens
    both fall inside ``(t_open, t_close]``: ``token_times`` maps a request
    to its tokens' host times, in order."""
    gaps = []
    for times in token_times.values():
        inside = [t for t in times if t_open < t <= t_close]
        gaps += [b - a for a, b in zip(inside, inside[1:])]
    return gaps
