"""Emulated LLM.int8() / LLM.int4() linear (port of
``lqer_tpu/ops/llm_int8.py``): bitsandbytes' semantics computed in
software.

* Outlier decomposition: the activation columns whose ``|x|`` reaches
  ``threshold`` (6.0 by default) anywhere in the call stay in full
  precision and multiply the full-precision weight.
* Vector-wise quantization of the rest: per-activation-row absmax int8 (or
  int4) for X, per-output-row absmax for W, dequantized before the matmul
  (the int GEMM's result, reproduced exactly).
"""

from __future__ import annotations

import torch


def llm_int_linear(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None, *, bits: int = 8,
                   threshold: float = 6.0) -> torch.Tensor:
    """``Y = Xq_lo @ Wq^T + X_hi @ W^T (+ b)`` with the outlier split made
    on this call's activations. ``weight`` is (out, in)."""
    qmax = 2.0 ** (bits - 1) - 1
    absx = x.abs().reshape(-1, x.shape[-1]).amax(0)
    outlier = absx >= threshold
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x_hi = torch.where(outlier, x, zero)
    x_lo = torch.where(outlier, zero, x)

    def fake_quant(t):
        # a tensor divisor: PyTorch's CUDA kernels multiply by the
        # reciprocal of a Python scalar, a quotient one ulp off the CPU's
        # (and numpy's) for some rows, which then round to other codes
        s = (t.abs().amax(-1, keepdim=True) / t.new_tensor(qmax)
             ).clamp_min(1e-12)
        return torch.clamp(torch.round(t / s), -qmax, qmax) * s

    # x_hi is zero outside the outlier columns, so its product with the
    # whole W is the product over the outlier columns alone
    y = (torch.matmul(fake_quant(x_lo), fake_quant(weight).T)
         + torch.matmul(x_hi, weight.T))
    if bias is not None:
        y = y + bias
    return y
