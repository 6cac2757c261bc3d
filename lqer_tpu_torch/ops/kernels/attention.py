"""Kernel 2: causal prefill attention over pre-quantized Q/K/V.

Port of ``lqer_tpu/ops/pallas/attention.py``. The CUDA kernel is
``csrc/attention.cu``; :func:`quantized_attention_plain` is its plain
PyTorch version: f32 scores, an exact softmax over the full row, P
quantized per 16 keys (:func:`_quantize_sublane_groups`, ``p <= 1e-8``
passes through), then P·V.
"""

from __future__ import annotations

import torch

from ...parallel.collectives import fill_zero_groups, mx_values
from . import _build

# the head dims rows 4 and 5 (csrc/attention.cu, csrc/decode_attention_fp.cu)
# are instantiated for
HEAD_DIMS = (64, 80, 96, 128)
SCRATCH_FLOATS = 64 * 2 ** 20  # the f32 scores of one call: 256 MB at most


def _quantize_sublane_groups(p: torch.Tensor, mb: int, group: int
                             ) -> torch.Tensor:
    """block_fp quantize-dequantize with one shared exponent per group of
    ``group`` along the LAST axis (the JAX kernel's sublane axis)."""
    *lead, n = p.shape
    v = p.reshape(*lead, n // group, group)
    bmax = fill_zero_groups(v.abs().amax(-1, keepdim=True), None)
    return mx_values(v, bmax, mb).reshape(*lead, n)


def prefill_scores(q_q: torch.Tensor, k_q: torch.Tensor, *, scale: float,
                   causal: bool = True) -> torch.Tensor:
    """``(q · k^T) · scale`` in f32, (BH, S, L); with ``causal``, keys past
    the query row are -inf."""
    s = torch.matmul(q_q.to(torch.float32),
                     k_q.to(torch.float32).transpose(-1, -2)) * scale
    if causal:
        S, L = s.shape[-2:]
        ok = (torch.arange(L, device=s.device)[None, :]
              <= torch.arange(S, device=s.device)[:, None])
        s = torch.where(ok, s, torch.full_like(s, float("-inf")))
    return s


def attend_plain(s: torch.Tensor, v: torch.Tensor, p_width: int | None,
                 group: int = 16) -> torch.Tensor:
    """``p = exp(s − max) / sum`` over the last axis of ``s (..., S, L)``,
    p quantized per ``group`` keys (``p <= 1e-8`` passes through), then
    ``p · v`` with ``v (..., L, D)``, all in f32."""
    p = torch.softmax(s, dim=-1)
    if p_width is not None:
        p = _quantize_sublane_groups(p, p_width - 1, group)
    return torch.matmul(p, v.to(torch.float32))


def quantized_attention_plain(q_q, k_q, v_q, *, scale: float,
                              p_width: int | None = 8, group: int = 16,
                              causal: bool = True) -> torch.Tensor:
    return attend_plain(prefill_scores(q_q, k_q, scale=scale, causal=causal),
                        v_q, p_width, group)


def quantized_attention(q_q: torch.Tensor, k_q: torch.Tensor,
                        v_q: torch.Tensor, *, scale: float,
                        p_width: int | None = 8, group: int = 16,
                        causal: bool = True) -> torch.Tensor:
    """q_q (BH, S, D), k_q and v_q (BH, L, D), bf16-exact pre-quantized
    values → (BH, S, D) f32. CPU tensors run the plain version; CUDA tensors
    launch ``csrc/attention.cu``."""
    BH, S, D = q_q.shape
    L = k_q.shape[1]
    if L % group:
        raise ValueError(f"key length {L} is not a multiple of {group}")
    if q_q.device.type == "cpu":
        return quantized_attention_plain(q_q, k_q, v_q, scale=scale,
                                         p_width=p_width, group=group,
                                         causal=causal)
    if not q_q.is_cuda:
        raise ValueError(f"unsupported device {q_q.device}")
    if group != 16 or D not in HEAD_DIMS:
        raise ValueError(f"unsupported attention shape D={D} group={group}")
    for name, t, shape in (("q", q_q, (BH, S, D)), ("k", k_q, (BH, L, D)),
                           ("v", v_q, (BH, L, D))):
        if not t.is_cuda or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need a CUDA tensor of shape {shape}")
    q, k, v = (t.to(torch.bfloat16).contiguous() for t in (q_q, k_q, v_q))
    out = torch.empty(BH, S, D, dtype=torch.float32, device=q.device)
    heads = max(1, min(BH, SCRATCH_FLOATS // (S * L)))  # per pass of kernels
    scores = torch.empty(heads * S * L, dtype=torch.float32, device=q.device)
    _build.launch("attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), scores.data_ptr(), BH, S, L, D,
                  float(scale), int(causal),
                  -1 if p_width is None else p_width - 1, heads)
    quantized_attention.launches += 1
    return out


quantized_attention.launches = 0
