"""PyTorch's own kernels (quantizers, norms, rotary, the loss: neither the
port's kernels, in the anonymous namespaces of ``csrc/``, nor a library
GEMM) as a share of the kernel time of the traced batches, in %."""


def read(ctx):
    t = ctx.trace and ctx.trace["spans"].get("batch")
    if not t or t["kernel_s"] <= 0:
        return None
    torch_s = t["kernel_s"] - t["port_s"] - t["groups"].get("library_gemm", 0)
    return 100.0 * torch_s / t["kernel_s"]
