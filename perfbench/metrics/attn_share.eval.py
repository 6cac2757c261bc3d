"""The device time of the kernels launched inside the program's
``lqer.attention:*`` spans (the attention's quantizers included) as a share
of the kernel time of the traced batches, in %."""

from perfbench import program_spans


def read(ctx):
    s = program_spans.of(ctx)
    if not s or s["kernel_s"] <= 0:
        return None
    names = program_spans.by_name(s)
    if "lqer.attention" not in names:
        return None
    return 100.0 * names["lqer.attention"] / s["kernel_s"]
