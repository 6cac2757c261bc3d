"""Kernel 4: flush of the staging ring into the main KV cache, and the
cache-row encode the staged decode kernel uses.

Port of the flush and ``_encode_t`` of ``lqer_tpu/ops/pallas/cache_write.py``.
The CUDA kernel is ``csrc/cache_write.cu``; :func:`flush_plain` is its
plain PyTorch version. Both write in place: for every layer, slot, kv head
and row, ``main[..., t] = ring[..., t % SW]`` for ``t`` in
``[flushed[b], new_flushed[b])``. The copy is bit-exact.
"""

from __future__ import annotations

import torch

from ...parallel.collectives import mx8_encode
from . import _build


def _encode_t(vals_t: torch.Tensor, group: int = 16):
    """MXINT8 encode of TRANSPOSED values ``(…, d, N)``: groups of ``group``
    along d, exact exponents, all-zero groups take exponent 0 (fill 1.0).
    Returns (codes int8 (…, d, N), exps int8 (…, d/group, N)); the bytes of
    ``mx8_encode(zero_fill=1.0)`` on the untransposed values."""
    codes, exps = mx8_encode(vals_t.transpose(-1, -2), group, zero_fill=1.0)
    return codes.transpose(-1, -2), exps.transpose(-1, -2)


def flush_plain(cache_arrays, stage_arrays, flushed, new_flushed) -> tuple:
    L = cache_arrays[0].shape[-1]
    SW = stage_arrays[0].shape[-1]
    t = torch.arange(L, device=flushed.device)
    valid = (t[None, :] >= flushed[:, None]) & (t[None, :] < new_flushed[:, None])
    for main, ring in zip(cache_arrays, stage_arrays):
        tiled = ring[..., t % SW]
        main.copy_(torch.where(valid[None, :, None, None, :], tiled, main))
    return tuple(cache_arrays)


def flush_stage_to_main(cache_arrays: tuple, stage_arrays: tuple,
                        flushed: torch.Tensor, new_flushed: torch.Tensor
                        ) -> tuple:
    """Migrate every layer's staged tokens ``[flushed, new_flushed)`` from
    the 4 rings ``(NL, B, KVH, rows, SW)`` into the 4 main arrays
    ``(NL, B, KVH, rows, L)``, in place; returns the main arrays.
    Precondition: ``new_flushed - flushed < SW`` per slot."""
    main0 = cache_arrays[0]
    if main0.device.type == "cpu":
        return flush_plain(cache_arrays, stage_arrays, flushed, new_flushed)
    if not main0.is_cuda:
        raise ValueError(f"unsupported device {main0.device}")
    NL, B, KVH, _, L = main0.shape
    SW = stage_arrays[0].shape[-1]
    for m, s in zip(cache_arrays, stage_arrays):
        if not (m.is_cuda and s.is_cuda and m.dtype == s.dtype == torch.int8
                and m.is_contiguous() and s.is_contiguous()
                and m.shape[:4] == s.shape[:4] and m.shape[-1] == L
                and s.shape[-1] == SW):
            raise ValueError("flush needs contiguous int8 CUDA arrays of "
                             "matching (NL, B, KVH, rows) shapes")
    fl = flushed.to(torch.int32).contiguous()
    nf = new_flushed.to(torch.int32).contiguous()
    _build.launch("cache_write", *(m.data_ptr() for m in cache_arrays),
                  *(s.data_ptr() for s in stage_arrays),
                  *(m.shape[3] for m in cache_arrays), fl.data_ptr(),
                  nf.data_ptr(), NL, B, KVH, L, SW)
    flush_stage_to_main.launches += 1
    return tuple(cache_arrays)


flush_stage_to_main.launches = 0
