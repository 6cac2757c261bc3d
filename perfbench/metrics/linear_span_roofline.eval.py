"""The linears' share of their roofline measured from inside the program:
the bound time of each traced batch's linear work, the head included
(``perfbench/roofline.py``, the bound of ``linear_roofline.eval``), over
the device time of every kernel launched inside the ``lqer.linear:*``,
``lqer.mlp:*`` and ``lqer.head`` spans (their quantizers, corrections and
unpacks included), in %."""

from perfbench import program_spans
from perfbench.metrics._roofline import batch_bounds

LAYERS = ("lqer.linear", "lqer.mlp", "lqer.head")


def read(ctx):
    s = program_spans.of(ctx)
    if not s:
        return None
    dev = program_spans.inside(
        s, lambda n: program_spans.layer(n) in LAYERS)
    if dev <= 0:
        return None
    return 100.0 * batch_bounds(ctx, "linear") / dev
