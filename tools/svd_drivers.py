#!/usr/bin/env python3
"""Accuracy and time of ``torch.linalg.svd``'s cuSOLVER drivers on an
L²QER target at Llama-2-7B's shapes, held against an f64 SVD on the card.

For each weight shape (q|k|v|o 4096 x 4096, gate/up 11008 x 4096, down
4096 x 11008) the script draws a seeded random weight of scale 0.01 (bf16
values) and a per-channel scale, forms the scaled MXINT4 quantization
error ``diag(s) (W - W_q)^T`` as ``approximate/approximator.py`` does, and
prints, per driver (the default, ``gesvd``, ``gesvdj``, ``gesvda``), the
time of one f32 SVD and the relative Frobenius error of the rank-32
product ``A B`` against the f64 SVD's, raw and after the 8-bit A and B
quantizers; also the relative gap between sigma_32 and sigma_33.

Run from the repository root on a machine with a CUDA card:
``python3 tools/svd_drivers.py``.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

RANK = 32
SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))


def quantizer(width, block):
    from lqer_tpu_torch.ops.quantizers import make_quantizer

    return make_quantizer({"name": "block_fp", "width": width,
                           "exponent_width": 8, "exponent_bias": None,
                           "block_size": block, "skip_first_dim": False})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("svd_drivers: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    wq, aq, bq = quantizer(4, [1, 16]), quantizer(8, [16, 1]), \
        quantizer(8, [16, 1])
    for out, inn in SHAPES:
        w = (torch.randn(out, inn, generator=g, device="cuda")
             * 0.01).bfloat16().float()
        s = torch.rand(inn, generator=g, device="cuda") * 2 + 0.2
        s = s / torch.sqrt(s.min() * s.max())
        target = s[:, None] * (w - wq(w)).T
        u, sv, vt = torch.linalg.svd(target.double(), full_matrices=False)
        a = u[:, :RANK] / s[:, None].double()
        b = sv[:RANK, None] * vt[:RANK]
        ref_q = aq(a.float()).double() @ bq(b.float()).double()
        ref = a @ b
        gap = float((sv[RANK - 1] - sv[RANK]) / sv[RANK - 1])
        line = [f"{out}x{inn}: sigma_{RANK}/sigma_{RANK + 1} gap {gap:.2e}"]
        for driver in (None, "gesvd", "gesvdj", "gesvda"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            u, sv1, vt = torch.linalg.svd(target, full_matrices=False,
                                          driver=driver)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            a1 = u[:, :RANK] / s[:, None]
            b1 = sv1[:RANK, None] * vt[:RANK]
            err_q = (aq(a1).double() @ bq(b1).double() - ref_q).norm() \
                / ref_q.norm()
            err = ((a1 @ b1).double() - ref).norm() / ref.norm()
            line.append(f"{driver}: {dt:.2f}s, rel err quantized "
                        f"{float(err_q):.2e} raw {float(err):.2e}")
        print("; ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
