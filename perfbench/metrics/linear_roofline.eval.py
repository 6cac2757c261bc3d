"""The linear kernels' share of their roofline in the traced batches: the
bound time of each batch's linear work (``perfbench/roofline.py``) over the
device time of the kernels ``kernel_groups.json`` puts in ``linear``,
in %."""

from perfbench.metrics._roofline import batch_bounds, share


def read(ctx):
    return share(ctx, "batch", "linear", batch_bounds)
