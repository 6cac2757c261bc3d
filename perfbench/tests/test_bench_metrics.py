"""The metric arithmetic: a rate over every token and the whole window, a
95th percentile over every gap that a single stall moves, the union of
device intervals."""

import importlib.util
import statistics
import types
from pathlib import Path

import pytest

from perfbench import stats

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def steady(n_req=64, steps=100, dt=0.05, stall_at=None, stall=0.5):
    """Token times of ``n_req`` requests decoding together every ``dt``,
    with one stall of ``stall`` s before step ``stall_at``."""
    times, t = {i: [] for i in range(n_req)}, 0.0
    for s in range(steps):
        t += dt + (stall if s == stall_at else 0.0)
        for i in range(n_req):
            times[i].append(t)
    return times, t


def ctx(times, lo, hi):
    return types.SimpleNamespace(record={"token_times": times, "t_open": lo,
                                         "t_close": hi})


def test_rate_counts_every_token_over_the_whole_window():
    times, end = steady()
    c = ctx(times, 0.0, end)
    assert reader("gen_tok_s")(c) == pytest.approx(64 * 100 / end)
    # tokens outside the window do not count; the window's time does
    c = ctx(times, 0.0, end + 5.0)
    assert reader("gen_tok_s")(c) == pytest.approx(64 * 100 / (end + 5.0))
    c = ctx(times, times[0][49], end)
    assert reader("gen_tok_s")(c) == pytest.approx(
        64 * 50 / (end - times[0][49]))


def test_p95_is_over_every_gap_and_a_stall_moves_it():
    times, end = steady(steps=15)
    base = reader("itl_p95_ms")(ctx(times, 0.0, end))
    assert base == pytest.approx(50.0)
    times, end = steady(steps=15, stall_at=7)
    stalled = reader("itl_p95_ms")(ctx(times, 0.0, end))
    # 64 of 896 gaps (7%) span the stall: the 95th percentile lands on it
    assert stalled == pytest.approx(550.0)
    gaps = stats.request_gaps(times, 0.0, end)
    assert len(gaps) == 64 * 14


def test_percentile_and_median_match_statistics():
    vals = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0]
    assert stats.percentile(vals, 95) == pytest.approx(
        statistics.quantiles(vals, n=100, method="inclusive")[94])
    assert stats.median(vals) == 3.0


def test_union_merges_and_clips():
    u = stats.union([(5, 7), (0, 2), (1, 3), (6, 9)], 0.5, 8)
    assert u == [[0.5, 3], [5, 8]]


def test_setup_is_what_the_run_measured():
    assert reader("setup_s")(types.SimpleNamespace(setup_s=12.5)) == 12.5
