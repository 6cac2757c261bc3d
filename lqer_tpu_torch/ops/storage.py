"""Packed MXINT storage for serving, and the converter from the JAX layout.

Port of ``lqer_tpu/ops/storage.py``: ``MXFormat``, ``quantize_mx`` and
``dequantize_mx`` keep their semantics (codes ``sign·mant`` and one int8
shared exponent per group of 16 along K; dequant = ``code · 2^(e − mb)``,
exact in bf16 for widths <= 9).

Hopper layout of a packed (K, N) weight, chosen for the decode GEMV in
``csrc/dequant_gemm.cu``: a thread owns four adjacent output columns and
streams 16 contiguous bytes per load.

* W4 ``codes`` int32 ``(K/8, N)``: word ``(o, n)`` holds the codes of
  ``k = 8o .. 8o+7`` of column ``n``, nibble ``i`` (bits ``4i..4i+3``,
  two's complement) for ``k = 8o + i``.
* W8 ``codes`` int32 ``(K/4, N)``: byte ``i`` of word ``(o, n)`` is the
  int8 code of ``k = 4o + i``.
* ``exps`` int8 ``(K/16, N)`` in both.

The JAX package stores tile-major slabs ``(K/tk, N/tn, S, tn)`` with the
K-split nibble order inside each ``tile_k`` (rows ``j`` and ``j + tk/2``
share a byte); :func:`codes_exps_from_jax_tiles` reads that layout back to
plain codes and exponents.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.collectives import (
    ceil_log2_exact,
    exp2_int,
    fill_zero_groups,
    mx_mantissa,
    unpack_nibbles,
)


@dataclasses.dataclass(frozen=True)
class MXFormat:
    width: int = 4  # sign + (width-1) mantissa bits
    exponent_width: int = 8
    group_size: int = 16

    @property
    def mantissa_bits(self) -> int:
        return self.width - 1

    @property
    def exponent_bias(self) -> int:
        return 2 ** (self.exponent_width - 1) - 1

    @property
    def codes_per_word(self) -> int:
        return 32 // self.width


MXINT4 = MXFormat(width=4)
MXINT8 = MXFormat(width=8)


def quantize_mx(w: torch.Tensor, fmt: MXFormat = MXINT4):
    """``w (K, N)`` → ``(codes int8 (K, N), exps int8 (K/g, N))``, groups of
    ``fmt.group_size`` along K, block_fp semantics (global min-non-zero
    fill for all-zero groups)."""
    K, N = w.shape
    g = fmt.group_size
    assert K % g == 0, (K, g)
    v = w.to(torch.float32).reshape(K // g, g, N)
    bmax = fill_zero_groups(v.abs().amax(1, keepdim=True), None)
    bias = fmt.exponent_bias
    e = ceil_log2_exact(bmax).clamp(-bias, 2 ** fmt.exponent_width - 1 - bias)
    sign, mant, _ = mx_mantissa(v, e, fmt.mantissa_bits)
    codes = (sign * mant).to(torch.int8).reshape(K, N)
    return codes, e.to(torch.int8).reshape(K // g, N)


def dequantize_mx(codes: torch.Tensor, exps: torch.Tensor,
                  fmt: MXFormat = MXINT4, dtype=torch.bfloat16):
    """codes (K, N) int8, exps (K/g, N) int8 → values (K, N)."""
    K, N = codes.shape
    g = fmt.group_size
    scale = exp2_int(exps.to(torch.int32) - fmt.mantissa_bits)
    v = codes.to(torch.float32).reshape(K // g, g, N) * scale[:, None, :]
    return v.reshape(K, N).to(dtype)


def _to_int32_words(w64: torch.Tensor) -> torch.Tensor:
    return torch.where(w64 >= 2 ** 31, w64 - 2 ** 32, w64).to(torch.int32)


def pack_words(codes: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """int8 codes (K, N) → int32 words (K/per_word, N) (module layout)."""
    K, N = codes.shape
    per = fmt.codes_per_word
    assert K % per == 0, (K, per)
    bits = fmt.width
    c = (codes.to(torch.int64) & (2 ** bits - 1)).reshape(K // per, per, N)
    shifts = torch.arange(per, device=codes.device, dtype=torch.int64) * bits
    return _to_int32_words((c << shifts[None, :, None]).sum(1))


def unpack_words(words: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """int32 words (K/per_word, N) → int32 codes (K, N), sign-extended."""
    W, N = words.shape
    per, bits = fmt.codes_per_word, fmt.width
    w = words.to(torch.int32)
    parts = [(w << (32 - bits * (i + 1))) >> (32 - bits) for i in range(per)]
    return torch.stack(parts, dim=1).reshape(W * per, N)


def pack_weight(codes: torch.Tensor, exps: torch.Tensor, fmt: MXFormat
                ) -> dict:
    return {"codes": pack_words(codes, fmt).contiguous(),
            "exps": exps.to(torch.int8).contiguous()}


def dequantize_packed(words: torch.Tensor, exps: torch.Tensor,
                      fmt: MXFormat) -> torch.Tensor:
    """Packed words + exps → f32 (K, N): ``code · 2^(e − mb)``, exact."""
    codes = unpack_words(words, fmt)
    K, N = codes.shape
    g = fmt.group_size
    scale = exp2_int(exps.to(torch.int32) - fmt.mantissa_bits)
    v = codes.to(torch.float32).reshape(K // g, g, N) * scale[:, None, :]
    return v.reshape(K, N)


def codes_exps_from_jax_tiles(tiles: torch.Tensor, tile_k: int,
                              fmt: MXFormat):
    """JAX tile-major slabs ``(K/tk, N/tn, S, tn)`` int8 → ``(codes int8
    (K, N), exps int8 (K/g, N))``. W4 slabs hold ``tk/2`` K-split packed
    rows (low nibble = row ``j``, high = row ``j + tk/2`` of the K tile),
    W8 slabs ``tk`` code rows; then ``tk/g`` exponent rows, then padding."""
    nk, nn, _, tn = tiles.shape
    ge = tile_k // fmt.group_size
    t = tiles.to(torch.int8)
    if fmt.width == 4:
        half = tile_k // 2
        low, high = unpack_nibbles(t[:, :, :half, :])
        codes = torch.cat([low, high], dim=2)          # (nk, nn, tk, tn)
        e = t[:, :, half:half + ge, :]
    else:
        codes = t[:, :, :tile_k, :].to(torch.int32)
        e = t[:, :, tile_k:tile_k + ge, :]
    K, N = nk * tile_k, nn * tn
    codes = codes.permute(0, 2, 1, 3).reshape(K, N).to(torch.int8)
    exps = e.permute(0, 2, 1, 3).reshape(K // fmt.group_size, N)
    return codes, exps.contiguous()
