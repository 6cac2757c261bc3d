"""From the process's start to the window's opening (host clock): imports,
the kernels' build where it is missing, the draw and pack of every layer,
the first admissions or batch and the warm-up. In a run that builds, the
build stays in (the set-up of a run that compiles holds the compilation);
its own seconds are reported beside, as ``device.build_s``."""


def read(ctx):
    return ctx.setup_s
