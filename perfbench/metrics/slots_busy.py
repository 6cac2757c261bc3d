"""The mean share of slots holding a request at each decode step of the
window, in %."""


def read(ctx):
    s = ctx.spans.of("decode_step")
    if not s:
        return None
    return 100.0 * sum(x["active"] / x["rows"] for x in s) / len(s)
