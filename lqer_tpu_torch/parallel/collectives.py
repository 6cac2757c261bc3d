"""MXINT codec: exact exponents and the MXINT8/MXINT4 encode and decode.

Port of the codec part of ``lqer_tpu/parallel/collectives.py``
(``ceil_log2_exact``, ``mx8_encode``/``mx8_decode``,
``mx4_encode``/``mx4_decode``). The quantized collectives themselves are
not ported yet.

Exponent contract of the whole port: every shared exponent is computed
exactly from the float's bits (:func:`ceil_log2_exact`), never from a float
``ceil(log2(x))``, in every plain version and every CUDA kernel. Powers of
two are built from bits too (:func:`exp2_int`), so no libm rounding enters.
"""

from __future__ import annotations

import torch

ZERO_ATOL = 1e-8  # |x| <= 1e-8 passes through every quantizer unquantized


def ceil_log2_exact(x: torch.Tensor) -> torch.Tensor:
    """``clip(ceil(log2(x)), -127, 128)`` for positive finite f32 ``x`` as
    int32, from the exponent field: a subnormal ``x`` gives -127 (the
    clamp), a power of two ``2^k`` gives ``k``, anything above it ``k+1``.
    A float ``ceil(log2(x))`` can round down to ``k`` for ``x`` an ulp
    above ``2^k``; this helper cannot."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    be = (bits >> 23) & 0xFF
    m = bits & 0x7FFFFF
    e = torch.where(be == 0, torch.full_like(be, -127),
                    be - 127 + (m != 0).to(torch.int32))
    return e.clamp(-127, 128)


def floor_log2_exact(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(x))`` for positive finite f32 ``x`` as int32, clamped
    below at -127 (every caller clips at or above that)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    be = (bits >> 23) & 0xFF
    return torch.where(be == 0, torch.full_like(be, -127), be - 127)


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2^e`` as f32 for integer ``e`` in [-149, 128] (128 gives
    inf, below -126 a subnormal), built from bits."""
    e = e.to(torch.int32)
    normal = ((e + 127).clamp(1, 255) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 22)).view(torch.float32)
    return torch.where(e >= -126, normal, sub)


def fill_zero_groups(bmax: torch.Tensor, zero_fill: float | None
                     ) -> torch.Tensor:
    """All-zero groups get ``zero_fill`` as absmax, or with ``None`` the
    smallest non-zero absmax of the whole tensor (1.0 when there is none).
    Their codes are 0 either way; only the stored exponent depends on it."""
    if zero_fill is None:
        nz_min = torch.where(bmax != 0, bmax,
                             torch.full_like(bmax, float("inf"))).amin()
        fill = torch.where(torch.isinf(nz_min), torch.ones_like(nz_min),
                           nz_min)
    else:
        fill = torch.full((), zero_fill, dtype=bmax.dtype, device=bmax.device)
    return torch.where(bmax == 0, fill, bmax)


def mx_mantissa(v: torch.Tensor, e: torch.Tensor, mb: int):
    """``(sign, mant, scale)`` of the block_fp grid: ``sign(v + 1e-9)``,
    ``clip(rint((|v| + 1e-9) / 2^e * 2^mb), 0, 2^mb - 1)`` and ``2^e``, in
    the reference's f32 operation order."""
    scale = exp2_int(e)
    shift = float(2 ** mb)
    sign = torch.sign(v + 1e-9)
    mant = torch.round((v.abs() + 1e-9) / scale * shift).clamp(0, shift - 1)
    return sign, mant, scale


def mx_values(v: torch.Tensor, bmax: torch.Tensor, mb: int,
              e_min: int = -127, e_max: int = 128) -> torch.Tensor:
    """Quantize-dequantize ``v`` against its (zero-filled, broadcastable)
    group absmax: ``sign · 2^e · mant / 2^mb`` with the ``|v| <= 1e-8``
    passthrough."""
    e = ceil_log2_exact(bmax).clamp(e_min, e_max)
    sign, mant, scale = mx_mantissa(v, e, mb)
    q = sign * scale * (mant / float(2 ** mb))
    return torch.where(v.abs() <= ZERO_ATOL, v, q)


def _group_encode(x: torch.Tensor, group: int, mb: int,
                  zero_fill: float | None):
    *lead, f = x.shape
    assert f % group == 0, (f, group)
    xf = x.to(torch.float32).reshape(*lead, f // group, group)
    bmax = fill_zero_groups(xf.abs().amax(-1, keepdim=True), zero_fill)
    e = ceil_log2_exact(bmax)
    sign, mant, _ = mx_mantissa(xf, e, mb)
    codes = (sign * mant).to(torch.int32).reshape(*lead, f)
    return codes, e.to(torch.int8).reshape(*lead, f // group)


def mx8_encode(x: torch.Tensor, group: int = 16,
               zero_fill: float | None = None):
    """(…, F) float → (codes int8 (…, F), exps int8 (…, F/group))."""
    codes, exps = _group_encode(x, group, 7, zero_fill)
    return codes.to(torch.int8), exps


def mx4_encode(x: torch.Tensor, group: int = 16,
               zero_fill: float | None = None):
    """(…, F) float → (codes int8 (…, F/2) nibble-packed F-split: element
    ``i`` holds value ``i`` low and ``i + F/2`` high; exps (…, F/group))."""
    f = x.shape[-1]
    assert f % (2 * group) == 0, (f, group)
    codes, exps = _group_encode(x, group, 3, zero_fill)
    half = f // 2
    packed = ((codes[..., half:] & 0xF) << 4) | (codes[..., :half] & 0xF)
    packed = torch.where(packed >= 128, packed - 256, packed)
    return packed.to(torch.int8), exps


def mx8_decode(codes: torch.Tensor, exps: torch.Tensor, group: int = 16,
               dtype=torch.float32) -> torch.Tensor:
    *lead, f = codes.shape
    scale = exp2_int(exps.to(torch.int32) - 7)
    v = codes.to(torch.float32).reshape(*lead, f // group, group)
    return (v * scale[..., None]).reshape(*lead, f).to(dtype)


def unpack_nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-extended (low, high) nibbles of int8-held bytes as int32."""
    c = packed.to(torch.int32)
    return (c << 28) >> 28, (c << 24) >> 28


def mx4_decode(codes: torch.Tensor, exps: torch.Tensor, group: int = 16,
               dtype=torch.float32) -> torch.Tensor:
    *lead, half = codes.shape
    f = half * 2
    low, high = unpack_nibbles(codes)
    vals = torch.cat([low, high], dim=-1).to(torch.float32)
    scale = exp2_int(exps.to(torch.int32) - 3)
    v = vals.reshape(*lead, f // group, group) * scale[..., None]
    return v.reshape(*lead, f).to(dtype)
