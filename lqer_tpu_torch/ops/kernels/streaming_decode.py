"""Streaming decode attention over the MXINT cache, past the one-pass
length: the direct-write cache and the ring-staged one.

Port of ``decode_attention_quantized_streaming`` (bodies ``_stats_kernel``
and ``_out_kernel``, codes of width 8 or 4, layer-stacked with
``layer_index``) and ``decode_attention_quantized_streaming_staged`` (bodies
``_stats_kernel_staged`` and ``_out_kernel_staged``, widths 8 and 4) of
``lqer_tpu/ops/pallas/decode_attention.py``. The direct-write entry takes a
sliding window (``window``, Mistral) as the one-pass kernels do; the staged
one takes none, as in the JAX package.

They compute the one-pass kernels' functions, so their plain versions are
those kernels' own: :func:`~.quantized_decode.quantized_decode_plain` for
the direct-write cache and :func:`~.decode_attention.staged_decode_plain`
(with the ring write) for the staged one. The two differ from the one-pass
kernels only in f32 summation order. The JAX package's
``streaming_l_chunk`` is a Mosaic tiling choice; the CUDA kernels split L
their own way, each the one-pass kernel's split over L
(``csrc/decode_mx_split.cuh``) with each block walking
``split_plan.chunks_per_block`` chunks of ``split_plan.CHUNK`` tokens
through two shared-memory tiles, in two launches: the direct-write kernel
(row 8) is row 6's (``csrc/decode_attention_streaming.cu``), the staged one
(row 9) row 7's (``csrc/decode_attention.cu``, the ring a block of its
own).
"""

from __future__ import annotations

import torch

from . import _build
from .attention import HEAD_DIMS
from .decode_attention import (
    code_width_of,
    launch_staged,
    scaled_query,
    staged_decode_plain,
    window_arg,
)
from .fp_decode import _mb
from .quantized_decode import _check_cache, quantized_decode_plain
from .split_plan import chunks_per_block, scratch_floats


def _check_launch(q, arrays, width):
    B, H, _, d = q.shape
    KVH = arrays[0].shape[1]
    if (d not in HEAD_DIMS or (width == 4 and d % 32) or H % KVH
            or not 1 <= H // KVH <= 8):
        raise ValueError(f"unsupported streaming decode shape d={d} width "
                         f"{width} H={H} KVH={KVH}")
    for a in arrays:
        if not (a.is_cuda and a.dtype == torch.int8 and a.is_contiguous()):
            raise ValueError("cache arrays must be contiguous int8 CUDA "
                             "tensors")


def _launch_direct(q, main, positions, width, scaling, q_width, p_width,
                   scale_query, window) -> torch.Tensor:
    """Row 8 on the layer's four (B, KVH, rows, L) arrays, each block
    walking :func:`~.split_plan.chunks_per_block` chunks."""
    B, H, _, d = q.shape
    KVH, L = main[0].shape[1], main[0].shape[-1]
    _check_launch(q, main, width)
    cpb = chunks_per_block(B, KVH, L, window)
    qf, scaling = scaled_query(q, scaling, scale_query)
    qf = qf.contiguous()
    pos = positions.to(torch.int32).contiguous()
    out = torch.empty(B, H, 1, d, dtype=torch.float32, device=q.device)
    scratch = torch.empty(scratch_floats(B, H, KVH, L, d, cpb=cpb),
                          dtype=torch.float32, device=q.device)
    _build.launch("decode_attention_streaming", qf.data_ptr(),
                  *(a.data_ptr() for a in main), pos.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), B, KVH, H // KVH, d, L,
                  width, cpb, float(scaling), _mb(q_width), _mb(p_width),
                  window_arg(window))
    return out


def decode_attention_quantized_streaming(
        q, k_codes, k_exps, v_codes, v_exps, positions, layer_index: int, *,
        scaling: float, group: int = 16, q_width: int | None = 8,
        p_width: int | None = 8, scale_query: bool = False,
        window: int | None = None) -> torch.Tensor:
    """One layer of decode attention over the MXINT8 or MXINT4 cache, split
    along L for the card.

    q (B, H, 1, d) raw queries (rope applied); codes (NL, B, KVH, d, L) or
    (NL, B, KVH, d/2, L) and exps (NL, B, KVH, d/16, L) int8, read at
    ``layer_index``; positions (B,); ``scale_query`` as
    :func:`~.decode_attention.scaled_query`; ``window`` the sliding window
    in tokens (None: none). Returns (B, H, 1, d) f32. CPU
    tensors run :func:`~.quantized_decode.quantized_decode_plain`; CUDA tensors
    launch ``csrc/decode_attention_streaming.cu``."""
    width = _check_cache(q, k_codes, k_exps, v_codes, v_exps, group)
    arrays = (k_codes, k_exps, v_codes, v_exps)
    window_arg(window)
    if q.device.type == "cpu":
        return quantized_decode_plain(q, *arrays, positions, layer_index,
                                      scaling=scaling, group=group,
                                      q_width=q_width, p_width=p_width,
                                      scale_query=scale_query, window=window)
    if not q.is_cuda or not 0 <= layer_index < k_codes.shape[0]:
        raise ValueError(f"unsupported device {q.device} or layer "
                         f"{layer_index} of {k_codes.shape[0]}")
    out = _launch_direct(q, [a[layer_index] for a in arrays], positions,
                         width, scaling, q_width, p_width, scale_query,
                         window)
    decode_attention_quantized_streaming.launches += 1
    return out


def decode_attention_quantized_streaming_staged(
        q, k_codes, k_exps, v_codes, v_exps, ks_codes, ks_exps, vs_codes,
        vs_exps, kh, vh, positions, flushed, *, scaling: float,
        group: int = 16, q_width: int | None = 8, p_width: int | None = 8,
        scale_query: bool = False) -> torch.Tensor:
    """One layer of staged decode attention, split along L for the card.

    The arguments of :func:`~.decode_attention.decode_attention_quantized_
    staged`: main cache codes (B, KVH, d, L) (MXINT8) or (B, KVH, d/2, L)
    (MXINT4) and exps (B, KVH, d/16, L) int8; rings of the same rows
    (B, KVH, ·, 64) and (B, KVH, d/16, 64) int8, updated in place at lane
    ``pos % 64``; kh, vh (B, KVH, 1, d) raw new rows;
    positions, flushed (B,). Returns (B, H, 1, d) f32. CPU tensors run
    :func:`~.decode_attention.staged_decode_plain`; CUDA tensors launch
    ``csrc/decode_attention.cu`` with :func:`~.split_plan.chunks_per_block`
    chunks a block."""
    B, H, S, d = q.shape
    SW = ks_codes.shape[-1]
    if S != 1 or SW != 64 or group != 16 or k_codes.shape[-1] % 16 \
            or ks_codes.shape[2] != k_codes.shape[2]:
        raise ValueError(f"staged streaming decode needs s=1, an MXINT "
                         f"cache of L % 16 == 0 and a 64-lane ring of its "
                         f"rows (s={S}, SW={SW}, codes "
                         f"{tuple(k_codes.shape)}, ring "
                         f"{tuple(ks_codes.shape)})")
    width = code_width_of(k_codes, d)
    main = (k_codes, k_exps, v_codes, v_exps)
    ring = (ks_codes, ks_exps, vs_codes, vs_exps)
    if q.device.type == "cpu":
        return staged_decode_plain(q, *main, *ring, kh, vh, positions,
                                   flushed, scaling=scaling, group=group,
                                   q_width=q_width, p_width=p_width,
                                   scale_query=scale_query)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    out = launch_staged(q, main, ring, kh, vh, positions, flushed,
                        scaling=scaling, q_width=q_width, p_width=p_width,
                        scale_query=scale_query,
                        cpb=chunks_per_block(B, k_codes.shape[1],
                                             k_codes.shape[-1]))
    decode_attention_quantized_streaming_staged.launches += 1
    decode_attention_quantized_streaming_staged.launches_width4 += width == 4
    return out


decode_attention_quantized_streaming.launches = 0
decode_attention_quantized_streaming_staged.launches = 0
decode_attention_quantized_streaming_staged.launches_width4 = 0
