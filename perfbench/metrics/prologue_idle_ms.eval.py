"""The device's idle time per traced batch whose middle falls inside the
forward's ``lqer.prologue`` span (the embedding, the rotary tables, the
positions and masks, built while the device waits), in ms."""

from perfbench import program_spans


def read(ctx):
    s = program_spans.of(ctx)
    if not s or "lqer.prologue" not in s["names"]:
        return None
    return 1e3 * s["idle"].get("lqer.prologue", 0.0) / s["batches"]
