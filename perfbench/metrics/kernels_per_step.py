"""Device kernels launched inside each traced decode step, from the
trace."""


def read(ctx):
    t = ctx.trace and ctx.trace["spans"].get("decode_step")
    return t["kernels"] / t["n"] if t and t["n"] else None
