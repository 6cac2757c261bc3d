"""The block formats of the recipe in plain PyTorch f32: MXINT
quantize-dequantize over groups of 16 along the last axis, one 8-bit
shared exponent per group.

A frozen statement of the function the recipe names (the block_fp
quantizer of the LQER reference): the exponent is ``ceil(log2(group
absmax))`` read exactly from the float's bits and clipped to [-127, 128];
each value keeps ``sign(v + 1e-9) * 2^e * m / 2^(w-1)`` with ``m =
clip(rint((|v| + 1e-9) / 2^e * 2^(w-1)), 0, 2^(w-1) - 1)``; values of
magnitude at most 1e-8 pass unquantized; an all-zero group takes the
smallest non-zero group absmax of the tensor (1 if there is none), which
leaves its values zero. The cache grid (:func:`cache_grid`) is the same
rounding without the pass-through, as a cache's codes store it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

ZERO_ATOL = 1e-8


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """``clip(ceil(log2(x)), -127, 128)`` of positive f32 ``x`` as int32,
    from the exponent and mantissa bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    be = (bits >> 23) & 0xFF
    m = bits & 0x7FFFFF
    e = torch.where(be == 0, torch.full_like(be, -127),
                    be - 127 + (m != 0).to(torch.int32))
    return e.clamp(-127, 128)


def exp2(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2^e`` as f32 for integer ``e`` in [-149, 128]."""
    e = e.to(torch.int32)
    normal = ((e + 127).clamp(1, 255) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 22)).view(torch.float32)
    return torch.where(e >= -126, normal, sub)


def _grouped(x: torch.Tensor, group: int):
    xf = x.to(torch.float32)
    f = xf.shape[-1]
    pad = -f % group
    if pad:
        xf = F.pad(xf, (0, pad))
    return xf.reshape(*xf.shape[:-1], -1, group), f


def _round(v: torch.Tensor, bmax: torch.Tensor, width: int) -> torch.Tensor:
    e = ceil_log2(bmax)
    scale = exp2(e)
    shift = float(2 ** (width - 1))
    mant = torch.round((v.abs() + 1e-9) / scale * shift).clamp(0, shift - 1)
    return torch.sign(v + 1e-9) * scale * (mant / shift)


def mx(x: torch.Tensor, width: int, group: int = 16) -> torch.Tensor:
    """Quantize-dequantize ``x`` along its last axis (f32 out)."""
    v, f = _grouped(x, group)
    bmax = v.abs().amax(-1, keepdim=True)
    nz = torch.where(bmax != 0, bmax, torch.full_like(bmax, float("inf")))
    fill = nz.amin()
    fill = torch.where(torch.isinf(fill), torch.ones_like(fill), fill)
    bmax = torch.where(bmax == 0, fill, bmax)
    q = torch.where(v.abs() <= ZERO_ATOL, v, _round(v, bmax, width))
    return q.reshape(*q.shape[:-2], -1)[..., :f]


def mx_weight(w: torch.Tensor, width: int) -> torch.Tensor:
    """A weight ``(out, in)`` on its grid: groups of 16 along ``in``."""
    return mx(w, width)


def cache_grid(x: torch.Tensor, width: int, group: int = 16) -> torch.Tensor:
    """The values a K or V row keeps in an MXINT cache: groups of 16 along
    the head dim of each token, all-zero groups zero."""
    v, f = _grouped(x, group)
    bmax = v.abs().amax(-1, keepdim=True)
    bmax = torch.where(bmax == 0, torch.ones_like(bmax), bmax)
    q = _round(v, bmax, width)
    return q.reshape(*q.shape[:-2], -1)[..., :f]
