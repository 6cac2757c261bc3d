"""Decode attention over the direct-write MXINT cache, and the same with the
fresh token's cache write in one launch.

Port of ``decode_attention_quantized`` (body ``_kernel_quantized``, codes of
width 8 or 4) and ``decode_attention_quantized_write`` (body
``_kernel_quantized_write``, width 8) of
``lqer_tpu/ops/pallas/decode_attention.py``, with
``decode_attention_widths_quantized``. Both CUDA kernels are
``csrc/decode_attention_quantized.cu``; :func:`quantized_decode_plain` and
:func:`quantized_write_plain` are their plain PyTorch versions.

Quantize once at write: the cache's MXINT values are the QK^T and P·V
operands; only q (per 16 along d) and p (per 16 tokens) quantize at use
time. Under a sliding window (``window``, Mistral) the columns at or below
``pos - window`` are masked beside those past ``pos``
(``decode_attention.key_mask``). One layer per call, read in place from the
layer-stacked cache at ``layer_index``. The write variant MXINT8-encodes the fresh K/V rows into
column ``positions[b]`` of that layer in place (where the JAX kernel
aliases the cache to its outputs), then attends over ``[0, pos]`` with the
fresh column: bitwise the write followed by the read-only kernel.

The CUDA kernels split the context over blocks of ``split_plan.CHUNK``
tokens (scores and chunk stats, then P·V with the final stats: row 5's
scheme), so nothing limits the length but ``L % 16 == 0``; they take any
head dim of :data:`HEAD_DIMS` (width 4: ``d % 32 == 0``, as the cache
needs) and share row 5's scratch layout (``split_plan.scratch_floats``),
and their kernels with rows 7 and 8 (``csrc/decode_mx_split.cuh``).
"""

from __future__ import annotations

import torch

from . import _build
from .attention import HEAD_DIMS, attend_plain
from .cache_write import encode_write_plain
from .decode_attention import (
    _decode_cache_block,
    _quantize_sublane_groups_signed,
    key_mask,
    scaled_query,
    window_arg,
)
from .fp_decode import _mb, decode_attention_widths
from .split_plan import scratch_floats


def decode_attention_widths_quantized(attn_cfg) -> dict:
    """Widths of the MXINT-cache kernels: only q and p quantize at use time
    (the cache's format fixes the K/V operands)."""
    w = decode_attention_widths(attn_cfg)
    return {"q_width": w["q_width"], "p_width": w["p_width"]}


def quantized_scores(q, k_codes, k_exps, v_codes, v_exps, positions,
                     layer_index: int, *, scaling: float, group: int = 16,
                     q_width: int | None = 8, scale_query: bool = False,
                     window: int | None = None):
    """Masked scores (B, H, 1, L) and decoded values (B, H, L, d) of one
    layer."""
    B, H, _, d = q.shape
    k = _decode_cache_block(k_codes[layer_index], k_exps[layer_index], group)
    v = _decode_cache_block(v_codes[layer_index], v_exps[layer_index], group)
    n_rep = H // k.shape[1]
    k, v = (t.repeat_interleave(n_rep, dim=1) for t in (k, v))  # (B, H, d, L)
    qf, score_scale = scaled_query(q, scaling, scale_query)
    qs = qf[:, :, 0, :]
    if q_width is not None:
        qs = _quantize_sublane_groups_signed(qs, q_width - 1, group)
    s = torch.matmul(qs[:, :, None, :], k) * score_scale
    ok = key_mask(k.shape[-1], positions, window)
    return (torch.where(ok[:, None, None, :], s, float("-inf")),
            v.transpose(-1, -2))


def quantized_decode_plain(q, k_codes, k_exps, v_codes, v_exps, positions,
                           layer_index: int, *, scaling: float,
                           group: int = 16, q_width: int | None = 8,
                           p_width: int | None = 8,
                           scale_query: bool = False,
                           window: int | None = None) -> torch.Tensor:
    s, v = quantized_scores(q, k_codes, k_exps, v_codes, v_exps, positions,
                            layer_index, scaling=scaling, group=group,
                            q_width=q_width, scale_query=scale_query,
                            window=window)
    return attend_plain(s, v, p_width, group)


def quantized_write_plain(q, k_codes, k_exps, v_codes, v_exps, kh, vh,
                          positions, layer_index: int, *, scaling: float,
                          group: int = 16, q_width: int | None = 8,
                          p_width: int | None = 8,
                          scale_query: bool = False,
                          window: int | None = None) -> torch.Tensor:
    encode_write_plain((k_codes, k_exps, v_codes, v_exps), kh, vh,
                       layer_index, positions, group)
    return quantized_decode_plain(q, k_codes, k_exps, v_codes, v_exps,
                                  positions, layer_index, scaling=scaling,
                                  group=group, q_width=q_width,
                                  p_width=p_width, scale_query=scale_query,
                                  window=window)


def _check_cache(q, k_codes, k_exps, v_codes, v_exps, group) -> int:
    """Shape checks shared by both wrappers; returns the code width."""
    B, H, S, d = q.shape
    rows, L = k_codes.shape[-2], k_codes.shape[-1]
    if (S != 1 or group != 16 or k_codes.ndim != 5 or rows not in (d, d // 2)
            or k_exps.shape[-2] * group != d or k_exps.shape[-1] != L
            or L % group):
        raise ValueError(f"quantized decode attention needs s=1, codes "
                         f"(NL, B, KVH, d or d/2, L) and exps "
                         f"(NL, B, KVH, d/16, L) with L % 16 == 0 (s={S}, "
                         f"codes {tuple(k_codes.shape)}, exps "
                         f"{tuple(k_exps.shape)})")
    return 8 if rows == d else 4


def _check_cuda(q, arrays, layer_index, width):
    B, H, _, d = q.shape
    NL, KVH, L = arrays[0].shape[0], arrays[0].shape[2], arrays[0].shape[-1]
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    if (d not in HEAD_DIMS or (width == 4 and d % 32) or H % KVH
            or not 1 <= H // KVH <= 8 or not 0 <= layer_index < NL):
        raise ValueError(f"unsupported decode shape d={d} width {width} "
                         f"H={H} KVH={KVH} L={L} layer {layer_index} of {NL}")
    for a in arrays:
        if not (a.is_cuda and a.dtype == torch.int8 and a.is_contiguous()):
            raise ValueError("cache arrays must be contiguous int8 CUDA "
                             "tensors")


def _launch(q, arrays, kh, vh, positions, layer_index, width, scaling,
            q_width, p_width, scale_query, window) -> torch.Tensor:
    B, H, _, d = q.shape
    KVH, L = arrays[0].shape[2], arrays[0].shape[-1]
    qf, scaling = scaled_query(q, scaling, scale_query)
    qf = qf.contiguous()
    pos = positions.to(torch.int32).contiguous()
    new = [None if t is None else t.to(torch.float32).contiguous()
           for t in (kh, vh)]
    out = torch.empty(B, H, 1, d, dtype=torch.float32, device=q.device)
    scratch = torch.empty(scratch_floats(B, H, KVH, L, d),
                          dtype=torch.float32, device=q.device)
    _build.launch("decode_attention_quantized", qf.data_ptr(),
                  *(a[layer_index].data_ptr() for a in arrays),
                  *(_build.ptr(t) for t in new), pos.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), B, KVH, H // KVH, d, L,
                  width,
                  float(scaling), _mb(q_width), _mb(p_width),
                  window_arg(window))
    return out


def decode_attention_quantized(q, k_codes, k_exps, v_codes, v_exps,
                               positions, layer_index: int, *, scaling: float,
                               group: int = 16, q_width: int | None = 8,
                               p_width: int | None = 8,
                               scale_query: bool = False,
                               window: int | None = None) -> torch.Tensor:
    """One layer of decode attention over the MXINT8 or MXINT4 cache.

    q (B, H, 1, d) raw queries (rope applied); codes (NL, B, KVH, d, L) or
    (NL, B, KVH, d/2, L) and exps (NL, B, KVH, d/16, L) int8, read at
    ``layer_index``; positions (B,); ``scale_query`` as
    ``decode_attention.scaled_query``; ``window`` the sliding window in
    tokens (None: none). Returns (B, H, 1, d) f32. CPU tensors
    run :func:`quantized_decode_plain`; CUDA tensors launch
    ``csrc/decode_attention_quantized.cu``."""
    width = _check_cache(q, k_codes, k_exps, v_codes, v_exps, group)
    arrays = (k_codes, k_exps, v_codes, v_exps)
    window_arg(window)
    kw = dict(scaling=scaling, group=group, q_width=q_width, p_width=p_width,
              scale_query=scale_query, window=window)
    if q.device.type == "cpu":
        return quantized_decode_plain(q, *arrays, positions, layer_index,
                                      **kw)
    _check_cuda(q, arrays, layer_index, width)
    out = _launch(q, arrays, None, None, positions, layer_index, width,
                  scaling, q_width, p_width, scale_query, window)
    decode_attention_quantized.launches += 1
    return out


def decode_attention_quantized_write(q, k_codes, k_exps, v_codes, v_exps, kh,
                                     vh, positions, layer_index: int, *,
                                     scaling: float, group: int = 16,
                                     q_width: int | None = 8,
                                     p_width: int | None = 8,
                                     scale_query: bool = False,
                                     window: int | None = None
                                     ) -> torch.Tensor:
    """:func:`decode_attention_quantized` over the MXINT8 cache, with the
    fresh rows kh, vh (B, KVH, 1, d) encoded into column ``positions[b]``
    of layer ``layer_index`` in place first (one launch on the card)."""
    width = _check_cache(q, k_codes, k_exps, v_codes, v_exps, group)
    arrays = (k_codes, k_exps, v_codes, v_exps)
    if width != 8 or tuple(kh.shape) != (q.shape[0], k_codes.shape[2], 1,
                                         q.shape[-1]) or kh.shape != vh.shape:
        raise ValueError(f"the fused write takes the MXINT8 cache and rows "
                         f"(B, KVH, 1, d) (width {width}, rows "
                         f"{tuple(kh.shape)})")
    window_arg(window)
    kw = dict(scaling=scaling, group=group, q_width=q_width, p_width=p_width,
              scale_query=scale_query, window=window)
    if q.device.type == "cpu":
        return quantized_write_plain(q, *arrays, kh, vh, positions,
                                     layer_index, **kw)
    _check_cuda(q, arrays, layer_index, width)
    out = _launch(q, arrays, kh, vh, positions, layer_index, width, scaling,
                  q_width, p_width, scale_query, window)
    decode_attention_quantized_write.launches += 1
    return out


decode_attention_quantized.launches = 0
decode_attention_quantized_write.launches = 0
