"""The whole step's share of the chip's peak: the roofline time
(``perfbench/roofline.py``: weights, cache and operations at the recipe's
logical formats) of every decode step and admission in the window, over
the window's time (host clock), in %. An admission's work is that of
its prompts, each at its own length, the head over each last row
(``roofline.admission``): padding is not model work."""

from perfbench import roofline


def read(ctx):
    r, spec, peaks = ctx.record, ctx.spec, ctx.peaks
    steps = ctx.spans.of("decode_step")
    if not steps:
        return None
    t = sum(roofline.bound_s(*roofline.total(
        roofline.decode_step(spec, x["rows"], x["lengths"])), peaks)
        for x in steps)
    t += sum(roofline.bound_s(*roofline.total(
        roofline.admission(spec, x["prompts"])), peaks)
        for x in ctx.spans.of("admit"))
    return 100.0 * t / (r["t_close"] - r["t_open"])
