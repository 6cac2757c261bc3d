"""Tokens of the batches ``evaluate_perplexity`` evaluated in the window
(batch size times sequence length, as it weights them), over the window's
whole time (host clock)."""

from perfbench.stats import rate


def read(ctx):
    spans = ctx.spans.of("batch")
    if not spans:
        return None
    r = ctx.record
    return rate(sum(s["tokens"] for s in spans), r["t_close"] - r["t_open"])
