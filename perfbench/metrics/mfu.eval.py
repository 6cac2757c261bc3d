"""The forward's model operations over the window (every linear with its
correction, the causal attention, the head) against the chip's dense bf16
peak, over the window's time (host clock), in %."""

from perfbench import roofline


def read(ctx):
    spans, r, mix = ctx.spans.of("batch"), ctx.record, ctx.mix
    if not spans:
        return None
    ops, _ = roofline.total(roofline.prefill(
        ctx.spec, mix["batch_size"], mix["seq_len"],
        mix["batch_size"] * mix["seq_len"], w8_head=False))
    return 100.0 * ops * len(spans) / (ctx.peaks[1]
                                       * (r["t_close"] - r["t_open"]))
