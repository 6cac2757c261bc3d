"""Shared by the ``*_roofline.*`` readers: summed bound time of a group's
work in the traced spans of one name over the group's device time there,
in %."""

from perfbench import roofline


def decode_bounds(ctx, group):
    """Bound seconds of ``group``'s work over the traced decode steps."""
    return sum(roofline.bound_s(*roofline.decode_step(
        ctx.spec, x["rows"], x["lengths"])[group], ctx.peaks)
        for x in ctx.spans.of("decode_step", phase="trace"))


def batch_bounds(ctx, group):
    mix = ctx.mix
    return sum(roofline.bound_s(*roofline.prefill(
        ctx.spec, mix["batch_size"], mix["seq_len"],
        mix["batch_size"] * mix["seq_len"], w8_head=False)[group], ctx.peaks)
        for _ in ctx.spans.of("batch", phase="trace"))


def share(ctx, span, group, bound_fn):
    t = ctx.trace and ctx.trace["spans"].get(span)
    if not t:
        return None
    dev = t["groups"].get(group, 0.0)
    if dev <= 0:
        return None
    return 100.0 * bound_fn(ctx, group) / dev
