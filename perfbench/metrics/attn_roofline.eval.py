"""The attn kernels' share of their roofline in the traced batches: the
bound time of each batch's attn work (``perfbench/roofline.py``) over the
device time of the kernels ``kernel_groups.json`` puts in ``attn``,
in %."""

from perfbench.metrics._roofline import batch_bounds, share


def read(ctx):
    return share(ctx, "batch", "attn", batch_bounds)
