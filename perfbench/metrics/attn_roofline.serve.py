"""The attn kernels' share of their roofline in the traced decode steps:
the bound time of the step's attn work (``perfbench/roofline.py``) over
the device time of the kernels ``kernel_groups.json`` puts in
``attn``, in %."""

from perfbench.metrics._roofline import decode_bounds, share


def read(ctx):
    return share(ctx, "decode_step", "attn", decode_bounds)
