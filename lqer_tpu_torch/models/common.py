"""Shared building blocks of the decoder models (port of
``lqer_tpu/models/common.py``): LayerNorm, RMSNorm, rotary tables, the
causal mask, GQA head repetition, the eager quantized attention, head
projection and merging, the resolved attention config and the fused
quantized prefill attention."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops.qlinear import QLinearConfig, qlinear
from ..utils import tracing


def layer_norm(x: torch.Tensor, params: dict, eps: float = 1e-5
               ) -> torch.Tensor:
    """OPT's LayerNorm as the JAX package computes it: normalised in f32,
    rounded to ``x``'s dtype, then the affine in that dtype (or promoted
    to the parameters' dtype). ``torch.nn.functional.layer_norm`` applies
    the affine in f32 before the one rounding, another function in
    bf16."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if params.get("weight") is not None:
        y = y * params["weight"]
    if params.get("bias") is not None:
        y = y + params["bias"]
    return y


def randn_init(generator: torch.Generator, dtype, device, scale=0.02):
    """``randn(shape)``: normal values at ``scale`` from ``generator``
    (drawn in f32 on its device), in ``dtype`` on ``device``; on the
    ``meta`` device shapes only, nothing drawn."""
    def randn(shape):
        if torch.device(device).type == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        x = torch.randn(shape, generator=generator,
                        device=generator.device) * scale
        return x.to(device=device, dtype=dtype)

    return randn


def stack_layers(params: dict, num_layers: int, layer_prefix, rel_keys
                 ) -> tuple[dict, dict]:
    """Per-layer params → ``(stacked {rel.suffix: (L, ...)}, rest)`` for the
    modules ``rel_keys`` of each ``layer_prefix(i)``; every layer must carry
    the same key set. A module's ``shard`` hooks (a tensor-parallel rank's
    callables, ``parallel/step.py``) stack as a list. ``rest`` holds every
    other param."""
    stacked: dict[str, torch.Tensor] = {}
    consumed = set()
    for rel in rel_keys:
        for suffix in ("weight", "bias", "A", "B", "shard"):
            if f"{layer_prefix(0)}.{rel}.{suffix}" not in params:
                continue
            per_layer = []
            for i in range(num_layers):
                n = f"{layer_prefix(i)}.{rel}.{suffix}"
                if n not in params:
                    raise KeyError(f"layer {i} missing {rel}.{suffix}")
                per_layer.append(params[n])
                consumed.add(n)
            stacked[f"{rel}.{suffix}"] = (per_layer if suffix == "shard"
                                          else torch.stack(per_layer))
    rest = {k: v for k, v in params.items() if k not in consumed}
    return stacked, rest


def rms_norm(x: torch.Tensor, params: dict, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return params["weight"] * y.to(x.dtype)


def rotary_tables(head_dim: int, max_pos: int, theta: float = 10000.0,
                  device=None):
    """HF-convention cos/sin tables (max_pos, head_dim) in f32, frequencies
    duplicated across the two halves."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32)
    emb = torch.outer(t, inv_freq)
    emb = torch.cat([emb, emb], dim=-1)
    return torch.cos(emb).to(device), torch.sin(emb).to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q, k, cos, sin, positions):
    """q, k: (b, h, s, d); positions: (b, s) or (s,) int64."""
    c, s = cos[positions], sin[positions]
    if c.ndim == 2:
        c, s = c[None, None], s[None, None]
    else:
        c, s = c[:, None], s[:, None]
    c, s = c.to(q.dtype), s.to(q.dtype)
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s


def causal_mask(seq_len: int, dtype=torch.float32, offset: int = 0,
                device=None) -> torch.Tensor:
    """(1, 1, s, s + offset) additive mask: 0 where key <= query, the
    dtype's lowest value elsewhere; ``offset`` > 0 for queries after a
    cached prefix."""
    q_idx = torch.arange(seq_len, device=device)[:, None] + offset
    k_idx = torch.arange(seq_len + offset, device=device)[None, :]
    mask = torch.where(k_idx <= q_idx, 0.0, torch.finfo(dtype).min)
    return mask.to(dtype)[None, None]


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, kv_heads, s, d) → (b, kv_heads·n_rep, s, d) for GQA."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


@tracing.annotate(tracing.ATTENTION["eager"])
def eager_attention(q, k, v, mask, qk_matmul: Callable, pv_matmul: Callable,
                    scaling: float, *, scale_query: bool = False
                    ) -> torch.Tensor:
    """Eager attention with quantized QK^T and P·V on 3-D ``(b·h, s, d)``
    operands, so that no shared-exponent block of an activation quantizer
    spans heads. ``scale_query`` (OPT) multiplies q by ``scaling`` before
    QK^T; otherwise the scores are scaled after it (Llama, Mistral); the
    scalar is rounded to the operand's dtype first, as JAX's weakly typed
    one. The additive ``mask`` (or None), then the softmax in f32, the
    probabilities back in q's dtype. (b, h, s, d) in and out."""
    b, h, s, d = q.shape
    kv_len = k.shape[2]
    q3 = q.reshape(b * h, s, d)
    k3 = k.reshape(b * h, kv_len, d)
    v3 = v.reshape(b * h, kv_len, d)
    if scale_query:
        q3 = q3 * torch.tensor(scaling, dtype=q3.dtype)
        scores = qk_matmul(q3, k3.transpose(-1, -2))
    else:
        scores = qk_matmul(q3, k3.transpose(-1, -2))
        scores = scores * torch.tensor(scaling, dtype=scores.dtype)
    scores = scores.reshape(b, h, s, kv_len)
    if mask is not None:
        scores = scores + mask
        scores = scores.clamp_min(torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = pv_matmul(probs.reshape(b * h, s, kv_len), v3)
    return out.reshape(b, h, s, d)


def project_heads(x: torch.Tensor, params: dict, cfg: QLinearConfig,
                  num_heads: int) -> torch.Tensor:
    """``qlinear`` then (b, s, e) → (b, h, s, d)."""
    b, s, _ = x.shape
    y = qlinear(x, params, cfg)
    return y.reshape(b, s, num_heads, -1).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, h, s, d) → (b, s, h·d)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


@dataclasses.dataclass(frozen=True)
class AttnQConfig:
    """Resolved quantization of one attention block; ``qk_cfg``/``pv_cfg``
    keep the raw matmul q_configs for the kernels' eligibility checks."""

    q_proj: QLinearConfig
    k_proj: QLinearConfig
    v_proj: QLinearConfig
    o_proj: QLinearConfig
    qk_matmul: Callable
    pv_matmul: Callable
    qk_cfg: dict | None = None
    pv_cfg: dict | None = None


def _std_a8(cfg: dict | None) -> bool:
    """The standard activation format the fused kernels implement:
    block_fp, exponent_width 8, block [1,16], skip_first_dim."""
    if not cfg:
        return False
    return (cfg.get("name") == "block_fp"
            and cfg.get("exponent_width") == 8
            and list(cfg.get("block_size", [])) == [1, 16]
            and cfg.get("skip_first_dim") is True
            and cfg.get("exponent_bias") in (None, "NA"))


def supports_fused_attention(attn_cfg: AttnQConfig,
                             kv_pre_quantized: bool = False) -> bool:
    """Both matmuls in the standard activation format with one common
    width; with ``kv_pre_quantized`` (K/V already on their cache grid) only
    the q- and p-side formats count."""
    cfgs = []
    for mm in (attn_cfg.qk_cfg, attn_cfg.pv_cfg):
        if mm is None:
            return False
        x = mm.get("x_quantizer") or mm.get("default")
        w = mm.get("w_quantizer") or mm.get("default")
        cfgs += [x] if kv_pre_quantized else [x, w]
    if not all(_std_a8(c) for c in cfgs):
        return False
    return len({c["width"] for c in cfgs}) == 1


@tracing.annotate(tracing.ATTENTION["kernel"])
def fused_quantized_attention(q, k, v, attn_cfg: AttnQConfig, scaling: float,
                              *, scale_query: bool = False,
                              kv_values_pre_quantized: bool = False):
    """Causal attention through the prefill kernel: q (and K^T along tokens,
    V along d, unless ``kv_values_pre_quantized``) quantized to the
    activation format, P quantized in the kernel. (b, h, s, d) in and
    out. ``scale_query`` (OPT) multiplies q by ``scaling`` in q's dtype
    (the scalar rounded to it first, as JAX's weakly typed scalar is)
    before its quantizer, and the kernel scales the scores by 1.0."""
    from ..ops.kernels.attention import quantized_attention
    from ..ops.quantizers import block_fp_quantizer

    width = (attn_cfg.qk_cfg.get("x_quantizer")
             or attn_cfg.qk_cfg.get("default"))["width"]

    def aq(x):
        return block_fp_quantizer(x, width=width, exponent_width=8,
                                  block_size=[1, 16], skip_first_dim=True)

    b, h, s, d = q.shape
    kv_len = k.shape[2]
    q3 = q.reshape(b * h, s, d)
    k3 = k.reshape(b * h, kv_len, d)
    v3 = v.reshape(b * h, kv_len, d)
    kernel_scale = scaling
    if scale_query:
        q3 = q3 * torch.tensor(scaling, dtype=q3.dtype)
        kernel_scale = 1.0
    q_q = aq(q3)
    if kv_values_pre_quantized:
        k_q, v_q = k3, v3
    else:
        k_q = aq(k3.transpose(1, 2)).transpose(1, 2)
        v_q = aq(v3)
    out = quantized_attention(
        q_q.to(torch.bfloat16).contiguous(), k_q.to(torch.bfloat16).contiguous(),
        v_q.to(torch.bfloat16).contiguous(), scale=kernel_scale,
        p_width=width, group=16, causal=True)
    return out.reshape(b, h, s, d).to(q.dtype)
