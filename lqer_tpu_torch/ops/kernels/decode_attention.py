"""Kernel 3: staged decode attention over the MXINT8 or MXINT4 KV cache.

Port of the staged entry of ``lqer_tpu/ops/pallas/decode_attention.py``
(``decode_attention_quantized_staged``, body ``_kernel_quantized_staged``,
with ``_decode_cache_block`` and ``_quantize_sublane_groups_signed``). The
code width is the cache's, read off the code rows as the JAX kernel reads
it: ``d`` rows for MXINT8, ``d/2`` nibble-packed rows for MXINT4 (the
``mxint4-staged`` cache). The CUDA kernel is ``csrc/decode_attention.cu``;
:func:`staged_decode_plain` is its plain PyTorch version.

One layer per call, on per-layer views of the layer-stacked cache
(``cache[key][li]`` is a zero-copy view). The fresh token's K/V rows are
encoded into ring lane ``pos % 64`` IN PLACE, where the JAX kernel aliases
the ring arrays to its outputs. Scores run over main ``[0, flushed)`` and
the ring's ``[flushed, pos]`` with one exact f32 softmax; P is quantized
per 16 along the concatenated ``[main L | ring 64]`` axis, then P·V. The
fresh rows are encoded at the cache's width (``cache_write._encode_t``).

The CUDA kernel splits ``[0, flushed)`` over blocks of ``split_plan.CHUNK``
tokens and gives the ring a block of its own, the last chunk of every
combine (``split_plan.slot_chunks``), so nothing in shared memory grows
with L: any ``L % 16 == 0`` is served. :func:`launch_staged` is that launch;
the streaming staged kernel (row 9, ``streaming_decode``) is the same launch
with blocks of several chunks.
"""

from __future__ import annotations

import torch

from ...parallel.collectives import (
    fill_zero_groups,
    mx4_decode,
    mx8_decode,
    mx_values,
)
from . import _build
from .attention import HEAD_DIMS, attend_plain
from .cache_write import _encode_t
from .split_plan import RING, scratch_floats


def _quantize_sublane_groups_signed(x: torch.Tensor, mb: int, group: int
                                    ) -> torch.Tensor:
    """Signed block_fp quantize-dequantize, one exponent per group of
    ``group`` along the last axis."""
    *lead, n = x.shape
    v = x.reshape(*lead, n // group, group)
    bmax = fill_zero_groups(v.abs().amax(-1, keepdim=True), None)
    return mx_values(v, bmax, mb).reshape(*lead, n)


def scaled_query(q: torch.Tensor, scaling: float, scale_query: bool):
    """(f32 queries, score scale) of the decode kernels: with
    ``scale_query`` (OPT) q times ``scaling`` in f32, before q's quantizer,
    and the scores unscaled (times 1.0, exact); else q as it is and the
    scores times ``scaling`` after the dot."""
    qf = q.to(torch.float32)
    return (qf * scaling, 1.0) if scale_query else (qf, scaling)


def key_mask(length: int, positions: torch.Tensor, window: int | None
             ) -> torch.Tensor:
    """(..., length) keys each query at ``positions`` (B,) or (B, S) sees:
    ``j <= pos`` and, under a sliding window (Mistral), ``j > pos -
    window``: the TPU kernels' ``kv_idx`` mask."""
    j = torch.arange(length, device=positions.device)
    pos = positions.to(torch.int64)[..., None]
    ok = j <= pos
    if window is not None:
        ok = ok & (j > pos - window)
    return ok


def window_arg(window: int | None) -> int:
    """The kernels' window argument: the window in tokens, -1 for none."""
    if window is None:
        return -1
    if int(window) < 1:
        raise ValueError(f"a sliding window holds at least one key "
                         f"(window={window})")
    return int(window)


def _decode_cache_block(codes: torch.Tensor, exps: torch.Tensor,
                        group: int = 16) -> torch.Tensor:
    """Token-axis-last MXINT codes + exps (…, d/g, N) → f32 values
    (…, d, N): MXINT8 codes (…, d, N), or nibble-packed d-split MXINT4
    codes (…, d/2, N) (low nibble of packed row i is value i, high nibble
    value i + d/2)."""
    dec = mx8_decode if codes.shape[-2] == exps.shape[-2] * group \
        else mx4_decode
    return dec(codes.transpose(-1, -2), exps.transpose(-1, -2),
               group).transpose(-1, -2)


def code_width_of(codes: torch.Tensor, head_dim: int) -> int:
    """The code width of a token-axis-last MXINT cache: 8 where the codes
    hold ``head_dim`` rows, 4 where they hold ``head_dim // 2`` packed
    ones; anything else raises."""
    rows = codes.shape[-2]
    if rows == head_dim:
        return 8
    if 2 * rows == head_dim and head_dim % 32 == 0:
        return 4
    raise ValueError(f"codes of {rows} rows for head_dim {head_dim} are "
                     "neither MXINT8 nor MXINT4")


def _write_ring(ring_codes, ring_exps, new_codes, new_exps, lane):
    """Store (B, KVH, rows) columns (MXINT8 rows or packed MXINT4 ones) at
    ring lane ``lane[b]``, in place."""
    for arr, new in ((ring_codes, new_codes), (ring_exps, new_exps)):
        idx = lane.to(torch.int64)[:, None, None, None].expand(
            *arr.shape[:3], 1)
        arr.scatter_(3, idx, new[..., None])


def staged_scores(q, k_codes, k_exps, v_codes, v_exps, ks_codes, ks_exps,
                  vs_codes, vs_exps, positions, flushed, *, scaling: float,
                  group: int = 16, q_width: int | None = 8,
                  scale_query: bool = False):
    """Masked scores (B, H, L + 64) and values (B, H, L + 64, d) over the
    concatenated ``[main L | ring 64]`` axis, read after the ring write:
    main columns count below ``flushed``, ring lanes where the position
    they hold is at least ``flushed``."""
    B, H, _, d = q.shape
    KVH, L = k_codes.shape[1], k_codes.shape[-1]
    SW = ks_codes.shape[-1]
    n_rep = H // KVH
    qf, score_scale = scaled_query(q, scaling, scale_query)
    qs = qf[:, :, 0, :]
    if q_width is not None:
        qs = _quantize_sublane_groups_signed(qs, q_width - 1, group)
    kv = []
    for mc, me, rc, re in ((k_codes, k_exps, ks_codes, ks_exps),
                           (v_codes, v_exps, vs_codes, vs_exps)):
        cat = torch.cat([_decode_cache_block(mc, me, group),
                         _decode_cache_block(rc, re, group)], dim=-1)
        kv.append(cat.repeat_interleave(n_rep, dim=1))     # (B, H, d, L + SW)
    s = torch.matmul(qs[:, :, None, :], kv[0])[:, :, 0, :] * score_scale
    j = torch.arange(L + SW, device=q.device)
    t_lane = positions[:, None] - torch.remainder(
        positions[:, None] - (j[None, :] - L), SW)
    ok = torch.where(j[None, :] < L, j[None, :] < flushed[:, None],
                     t_lane >= flushed[:, None])
    s = torch.where(ok[:, None, :], s, torch.full_like(s, float("-inf")))
    return s, kv[1].transpose(-1, -2)


def staged_decode_plain(q, k_codes, k_exps, v_codes, v_exps, ks_codes,
                        ks_exps, vs_codes, vs_exps, kh, vh, positions,
                        flushed, *, scaling: float, group: int = 16,
                        q_width: int | None = 8, p_width: int | None = 8,
                        scale_query: bool = False) -> torch.Tensor:
    lane = positions % ks_codes.shape[-1]
    width = code_width_of(ks_codes, q.shape[-1])
    for rc, re, new in ((ks_codes, ks_exps, kh), (vs_codes, vs_exps, vh)):
        codes, exps = _encode_t(new[:, :, 0, :].to(torch.float32)[..., None],
                                group, width)
        _write_ring(rc, re, codes[..., 0], exps[..., 0], lane)
    s, v = staged_scores(q, k_codes, k_exps, v_codes, v_exps, ks_codes,
                         ks_exps, vs_codes, vs_exps, positions, flushed,
                         scaling=scaling, group=group, q_width=q_width,
                         scale_query=scale_query)
    return attend_plain(s[:, :, None, :], v, p_width, group)


def decode_attention_quantized_staged(
        q, k_codes, k_exps, v_codes, v_exps, ks_codes, ks_exps, vs_codes,
        vs_exps, kh, vh, positions, flushed, *, scaling: float,
        group: int = 16, q_width: int | None = 8, p_width: int | None = 8,
        scale_query: bool = False) -> torch.Tensor:
    """One layer of staged decode attention.

    q (B, H, 1, d) raw queries (rope applied); main cache codes
    (B, KVH, d, L) (MXINT8) or (B, KVH, d/2, L) (MXINT4, nibble-packed
    d-split) and exps (B, KVH, d/16, L) int8; rings of the same rows
    (B, KVH, ·, 64) and (B, KVH, d/16, 64) int8, updated in place at lane
    ``pos % 64``;
    kh, vh (B, KVH, 1, d) raw new rows; positions, flushed (B,);
    ``scale_query`` as :func:`scaled_query`. Returns (B, H, 1, d) f32. CPU
    tensors run :func:`staged_decode_plain`; CUDA tensors launch
    ``csrc/decode_attention.cu``."""
    B, H, S, d = q.shape
    KVH, L = k_codes.shape[1], k_codes.shape[-1]
    SW = ks_codes.shape[-1]
    if S != 1 or SW != RING or group != 16 \
            or ks_codes.shape[2] != k_codes.shape[2]:
        raise ValueError(f"staged decode needs s=1, an MXINT cache and a "
                         f"64-lane ring of its rows (s={S}, SW={SW}, rows="
                         f"{k_codes.shape[2]}, ring rows {ks_codes.shape[2]})")
    width = code_width_of(k_codes, d)
    if q.device.type == "cpu":
        return staged_decode_plain(
            q, k_codes, k_exps, v_codes, v_exps, ks_codes, ks_exps, vs_codes,
            vs_exps, kh, vh, positions, flushed, scaling=scaling, group=group,
            q_width=q_width, p_width=p_width, scale_query=scale_query)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    out = launch_staged(
        q, (k_codes, k_exps, v_codes, v_exps),
        (ks_codes, ks_exps, vs_codes, vs_exps), kh, vh, positions, flushed,
        scaling=scaling, q_width=q_width, p_width=p_width,
        scale_query=scale_query)
    decode_attention_quantized_staged.launches += 1
    decode_attention_quantized_staged.launches_width4 += width == 4
    return out


def launch_staged(q, main, ring, kh, vh, positions, flushed, *,
                  scaling: float, q_width: int | None, p_width: int | None,
                  scale_query: bool, cpb: int = 1) -> torch.Tensor:
    """One launch of ``csrc/decode_attention.cu`` on CUDA tensors: the main
    cache's four (B, KVH, rows, L) arrays, the rings' four (B, KVH, rows,
    64), each block of ``[0, flushed)`` walking ``cpb`` chunks of
    ``split_plan.CHUNK`` tokens (row 7: 1; row 9: more)."""
    B, H, _, d = q.shape
    KVH, L = main[0].shape[1], main[0].shape[-1]
    width = code_width_of(main[0], d)
    if (d not in HEAD_DIMS or (width == 4 and d % 32) or L % 16 or H % KVH
            or not 1 <= H // KVH <= 8 or cpb < 1):
        raise ValueError(f"unsupported staged decode shape d={d} L={L} "
                         f"H={H} KVH={KVH} cpb={cpb}")
    for a in (*main, *ring):
        if not (a.is_cuda and a.dtype == torch.int8 and a.is_contiguous()):
            raise ValueError("cache arrays must be contiguous int8 CUDA tensors")
    qf, scaling = scaled_query(q, scaling, scale_query)
    qf = qf.contiguous()
    khf = kh.to(torch.float32).contiguous()
    vhf = vh.to(torch.float32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    fl = flushed.to(torch.int32).contiguous()
    out = torch.empty(B, H, 1, d, dtype=torch.float32, device=q.device)
    scratch = torch.empty(scratch_floats(B, H, KVH, L, d, cpb=cpb,
                                         staged=True),
                          dtype=torch.float32, device=q.device)
    _build.launch("decode_attention", qf.data_ptr(),
                  *(a.data_ptr() for a in (*main, *ring)), khf.data_ptr(),
                  vhf.data_ptr(), pos.data_ptr(), fl.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), B, KVH, H // KVH, d, L,
                  width, cpb, float(scaling),
                  -1 if q_width is None else q_width - 1,
                  -1 if p_width is None else p_width - 1)
    return out


decode_attention_quantized_staged.launches = 0
decode_attention_quantized_staged.launches_width4 = 0
