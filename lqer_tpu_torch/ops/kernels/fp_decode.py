"""Decode attention over the bf16 or f32 (fp) KV cache.

Port of ``decode_attention`` (body ``_kernel``) of
``lqer_tpu/ops/pallas/decode_attention.py``, with the eligibility rule
``supports_decode_attention`` and ``decode_attention_widths``. The CUDA
kernel is ``csrc/decode_attention_fp.cu``; :func:`fp_decode_plain` is its
plain PyTorch version.

Every operand quantizes at use time: q per 16 along d, K^T per 16 TOKENS of
each d column (a group's exponent depends on all 16 cached rows, those past
the query's position included), p per 16 tokens (unsigned), V per token in
16-wide d groups. Scores scale after the dot (or, with ``scale_query``,
q before its quantizer: ``decode_attention.scaled_query``); columns past the
position are masked, and under a sliding window (``window``, Mistral) the
columns at or below ``pos - window`` too (``decode_attention.key_mask``).
One layer per call, read in place from the layer-stacked cache
``(NL, B, KVH, L, d)`` at ``layer_index``.

The CUDA kernel splits the context over blocks of ``split_plan.CHUNK``
tokens (scores and chunk stats, then P·V with the final stats), so it takes
every length the JAX package's one-pass kernel takes (``L % 16 == 0``; the
serving regime is ``decode._check_cache_regime``'s) and any head dim of
:data:`HEAD_DIMS`; its f32 scratch is ``split_plan.scratch_floats`` long.
A ``float32`` cache launches the kernel's f32 entry
(``lqer_decode_attention_fp32``: the same design over f32 rows, as the JAX
kernel reads an f32 cache), counted apart in ``launches_f32``.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import HEAD_DIMS, attend_plain
from .decode_attention import (
    _quantize_sublane_groups_signed,
    key_mask,
    scaled_query,
    window_arg,
)
from .split_plan import scratch_floats

def supports_decode_attention(attn_cfg, cache_width: int = 8) -> bool:
    """The decode kernels' eligibility: both attention matmuls in the MXINT
    activation format ([1, 16] groups, block_fp, width <= 9) on both
    operands, the K/V-side widths equal to the cache's code width (8 for the
    bf16 and MXINT8 caches, 4 for MXINT4)."""

    def mx(c, width_ok=lambda w: w <= 9):
        return bool(
            c and c.get("name") == "block_fp"
            and list(c.get("block_size", ())) == [1, 16]
            and c.get("skip_first_dim", False)
            and c.get("exponent_width") == 8
            and c.get("exponent_bias") is None
            and width_ok(c.get("width", 99)))

    qk, pv = attn_cfg.qk_cfg, attn_cfg.pv_cfg
    if qk is None or pv is None:
        return False
    qx = qk.get("x_quantizer") or qk.get("default")
    kx = qk.get("w_quantizer") or qk.get("default")
    px = pv.get("x_quantizer") or pv.get("default")
    vx = pv.get("w_quantizer") or pv.get("default")
    return (mx(qx) and mx(px)
            and mx(kx, lambda w: w == cache_width)
            and mx(vx, lambda w: w == cache_width))


def decode_attention_widths(attn_cfg) -> dict:
    """Widths of the fp-cache kernel's four operand quantizers; an fp
    attention config (no matmul quantizers: the ``LQER_FP_ATTN_KERNEL``
    route) gives all four None."""
    qk, pv = attn_cfg.qk_cfg, attn_cfg.pv_cfg
    if qk is None and pv is None:
        return dict.fromkeys(("q_width", "k_width", "p_width", "v_width"))
    return {
        "q_width": (qk.get("x_quantizer") or qk.get("default"))["width"],
        "k_width": (qk.get("w_quantizer") or qk.get("default"))["width"],
        "p_width": (pv.get("x_quantizer") or pv.get("default"))["width"],
        "v_width": (pv.get("w_quantizer") or pv.get("default"))["width"],
    }


def _mb(width: int | None) -> int:
    return -1 if width is None else width - 1


def fp_scores(q, k_cache, v_cache, positions, layer_index: int, *,
              scaling: float, group: int = 16, q_width: int | None = 8,
              k_width: int | None = 8, v_width: int | None = 8,
              scale_query: bool = False, window: int | None = None):
    """Masked scores (B, H, 1, L) and quantized values (B, H, L, d) of one
    layer."""
    B, H, _, d = q.shape
    k = k_cache[layer_index].to(torch.float32)           # (B, KVH, L, d)
    v = v_cache[layer_index].to(torch.float32)
    n_rep = H // k.shape[1]
    qf, score_scale = scaled_query(q, scaling, scale_query)
    qs = qf[:, :, 0, :]
    if q_width is not None:
        qs = _quantize_sublane_groups_signed(qs, q_width - 1, group)
    if k_width is not None:
        k = _quantize_sublane_groups_signed(
            k.transpose(-1, -2), k_width - 1, group).transpose(-1, -2)
    if v_width is not None:
        v = _quantize_sublane_groups_signed(v, v_width - 1, group)
    k, v = (t.repeat_interleave(n_rep, dim=1) for t in (k, v))
    s = torch.matmul(qs[:, :, None, :], k.transpose(-1, -2)) * score_scale
    ok = key_mask(k.shape[2], positions, window)
    return torch.where(ok[:, None, None, :], s, float("-inf")), v


def fp_decode_plain(q, k_cache, v_cache, positions, layer_index: int, *,
                    scaling: float, group: int = 16,
                    q_width: int | None = 8, k_width: int | None = 8,
                    p_width: int | None = 8, v_width: int | None = 8,
                    scale_query: bool = False,
                    window: int | None = None) -> torch.Tensor:
    s, v = fp_scores(q, k_cache, v_cache, positions, layer_index,
                     scaling=scaling, group=group, q_width=q_width,
                     k_width=k_width, v_width=v_width,
                     scale_query=scale_query, window=window)
    return attend_plain(s, v, p_width, group)


def decode_attention_fp(q, k_cache, v_cache, positions, layer_index: int, *,
                        scaling: float, group: int = 16,
                        q_width: int | None = 8, k_width: int | None = 8,
                        p_width: int | None = 8, v_width: int | None = 8,
                        scale_query: bool = False,
                        window: int | None = None) -> torch.Tensor:
    """One layer of decode attention over the fp cache.

    q (B, H, 1, d) raw queries (rope applied); k_cache, v_cache
    (NL, B, KVH, L, d), read at ``layer_index``; positions (B,);
    ``scale_query`` as ``decode_attention.scaled_query``; ``window`` the
    sliding window in tokens (None: none). Returns
    (B, H, 1, d) f32. The cache is bf16 or f32. CPU tensors run
    :func:`fp_decode_plain`; CUDA tensors launch
    ``csrc/decode_attention_fp.cu``."""
    B, H, S, d = q.shape
    NL, _, KVH, L, dc = k_cache.shape
    if S != 1 or dc != d or group != 16 or L % group:
        raise ValueError(f"fp decode attention needs s=1, d={d} and L % 16 "
                         f"== 0 (s={S}, cache {tuple(k_cache.shape)})")
    win = window_arg(window)
    kw = dict(scaling=scaling, group=group, q_width=q_width, k_width=k_width,
              p_width=p_width, v_width=v_width, scale_query=scale_query,
              window=window)
    if q.device.type == "cpu":
        return fp_decode_plain(q, k_cache, v_cache, positions, layer_index,
                               **kw)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    if (d not in HEAD_DIMS or H % KVH or not 1 <= H // KVH <= 8
            or not 0 <= layer_index < NL):
        raise ValueError(f"unsupported fp decode shape d={d} H={H} KVH={KVH} "
                         f"L={L} layer {layer_index} of {NL}")
    if any(w is not None and w > 9 for w in (k_width, v_width)):
        raise ValueError(f"the kernel takes K and V widths up to 9 "
                         f"(k_width={k_width}, v_width={v_width})")
    f32 = k_cache.dtype == torch.float32
    for a in (k_cache, v_cache):
        if not (a.is_cuda and a.dtype in (torch.bfloat16, torch.float32)
                and a.dtype == k_cache.dtype and a.is_contiguous()
                and a.shape == k_cache.shape):
            raise ValueError("k_cache, v_cache must be contiguous bf16 or "
                             "f32 CUDA tensors of one shape and dtype")
    qf, scaling = scaled_query(q, scaling, scale_query)
    qf = qf.contiguous()
    pos = positions.to(torch.int32).contiguous()
    out = torch.empty(B, H, 1, d, dtype=torch.float32, device=q.device)
    scratch = torch.empty(scratch_floats(B, H, KVH, L, d),
                          dtype=torch.float32, device=q.device)
    _build.launch("decode_attention_fp32" if f32 else "decode_attention_fp",
                  qf.data_ptr(),
                  k_cache[layer_index].data_ptr(),
                  v_cache[layer_index].data_ptr(), pos.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), B, KVH, H // KVH, d, L,
                  float(scaling),
                  _mb(q_width), _mb(k_width), _mb(p_width), _mb(v_width), win)
    decode_attention_fp.launches += 1
    decode_attention_fp.launches_f32 += f32
    return out


decode_attention_fp.launches = 0
decode_attention_fp.launches_f32 = 0
