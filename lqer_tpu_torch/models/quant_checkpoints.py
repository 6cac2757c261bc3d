"""Dequantize-to-fp loaders for GPTQ and AWQ 4-bit checkpoints (port of
``lqer_tpu/models/quant_checkpoints.py``, on tensors).

The baseline rows of the reference evaluate AWQ and GPTQ checkpoints. Their
weights-only formats need only the numbers they represent: this module
decodes the packed tensors to full-precision weights, which then run
through the standard forward (the dequantized model is the model those
kernels compute, up to their matmul precision).

* **GPTQ** (AutoGPTQ / gptqmodel, 4-bit, row-packed): ``qweight (in/8,
  out) int32``, eight 4-bit codes per int32 along in_features, the low
  nibble first; ``qzeros (groups, out/8) int32`` packed the same way;
  ``scales (groups, out) f16``; optional ``g_idx (in,) int32`` (the group of
  each input channel, ``k // group_size`` by default).
  ``W[n, k] = scales[g, n] * (code[k, n] - zero[g, n])``, with AutoGPTQ's
  ``+1`` on the stored zero when ``zero_offset=True`` (the checkpoint
  stores ``z - 1``, masked to a nibble: a zero of 0 is stored as 15 and
  reads back as 16, as in AutoGPTQ checkpoints and the JAX package).
* **AWQ** (AutoAWQ "GEMM", 4-bit): ``qweight (in, out/8) int32``, eight
  codes per int32 along out_features in the interleaved order
  ``[0, 2, 4, 6, 1, 3, 5, 7]``; ``qzeros (in/group, out/8)`` packed the same
  way; ``scales (in/group, out) f16``.

Every output is ``(out_features, in_features) float32`` on the device of
its inputs. Codes unpack from int32 words by an arithmetic shift and a
nibble mask, so nibble 7 of a negative word reads right; the packers round
half to even (``torch.round``, as ``np.round``).
"""

from __future__ import annotations

import torch

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
_PACKED_SUFFIXES = (".qweight", ".qzeros", ".scales", ".g_idx")


def _unpack_int32_nibbles(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """int32 words → eight 4-bit codes per word along ``axis`` (the low
    nibble first), as int32."""
    p = torch.as_tensor(packed).to(torch.int32)
    axis = axis % p.ndim
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=p.device)
    shape = [1] * (p.ndim + 1)
    shape[axis + 1] = 8
    codes = (p.unsqueeze(axis + 1) >> shifts.reshape(shape)) & 0xF
    new_shape = list(p.shape)
    new_shape[axis] *= 8
    return codes.reshape(new_shape)


def _pack_int32_nibbles(codes: torch.Tensor, axis: int) -> torch.Tensor:
    """Codes (their low nibble) → int32 words of eight along ``axis``."""
    c = torch.as_tensor(codes).to(torch.int64) & 0xF
    axis = axis % c.ndim
    c = c.movedim(axis, -1)
    c = c.reshape(*c.shape[:-1], c.shape[-1] // 8, 8)
    shifts = torch.arange(0, 32, 4, dtype=torch.int64, device=c.device)
    words = (c << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).movedim(-1, axis)


def _groups_to_weight(codes, zeros, scales, g_idx) -> torch.Tensor:
    """``scales[g] * (codes - zeros[g])`` per input channel → (out, in):
    the f32 product of a scale and a small integer, rounded once."""
    g = g_idx.to(torch.int64)
    w = scales.to(torch.float32)[g] * (codes.to(torch.float32)
                                       - zeros[g].to(torch.float32))
    return w.T.contiguous()


def dequantize_gptq_weight(qweight, qzeros, scales, g_idx=None,
                           bits: int = 4, zero_offset: bool = True
                           ) -> torch.Tensor:
    """AutoGPTQ 4-bit tensors → (out, in) float32."""
    if bits != 4:
        raise NotImplementedError("only 4-bit GPTQ checkpoints supported")
    codes = _unpack_int32_nibbles(qweight, axis=0)      # (in, out)
    zeros = _unpack_int32_nibbles(qzeros, axis=1)       # (groups, out)
    if zero_offset:
        zeros = zeros + 1
    scales = torch.as_tensor(scales)
    in_features = codes.shape[0]
    if g_idx is None:
        group_size = in_features // scales.shape[0]
        g_idx = torch.arange(in_features, device=codes.device) // group_size
    return _groups_to_weight(codes, zeros, scales,
                             torch.as_tensor(g_idx, device=codes.device))


def _unpack_awq(packed) -> torch.Tensor:
    """AWQ words → codes in natural order along out_features (the kernel
    interleave undone)."""
    codes = _unpack_int32_nibbles(packed, axis=1)
    c = codes.reshape(codes.shape[0], -1, 8)
    undone = torch.empty_like(c)
    undone[:, :, list(AWQ_ORDER)] = c
    return undone.reshape(codes.shape)


def dequantize_awq_weight(qweight, qzeros, scales, bits: int = 4
                          ) -> torch.Tensor:
    """AutoAWQ GEMM 4-bit tensors → (out, in) float32."""
    if bits != 4:
        raise NotImplementedError("only 4-bit AWQ checkpoints supported")
    codes = _unpack_awq(qweight)                        # (in, out)
    zeros = _unpack_awq(qzeros)                         # (groups, out)
    scales = torch.as_tensor(scales)
    group_size = codes.shape[0] // scales.shape[0]
    g_idx = torch.arange(codes.shape[0], device=codes.device) // group_size
    return _groups_to_weight(codes, zeros, scales, g_idx)


def dequantize_checkpoint(tensors: dict, fmt: str, zero_offset: bool = True
                          ) -> dict:
    """Flat checkpoint dict with ``<module>.qweight/qzeros/scales[/g_idx]``
    groups → flat fp dict with ``<module>.weight``, every other tensor
    passed through. ``fmt``: ``"gptq"`` or ``"awq"``."""
    if fmt not in ("gptq", "awq"):
        raise ValueError(f"unknown quantized checkpoint format {fmt!r}")
    out = {}
    modules = sorted({k[:-len(".qweight")] for k in tensors
                      if k.endswith(".qweight")})
    for mod in modules:
        qweight, qzeros, scales = (tensors[mod + s] for s in
                                   (".qweight", ".qzeros", ".scales"))
        if fmt == "gptq":
            w = dequantize_gptq_weight(qweight, qzeros, scales,
                                       tensors.get(mod + ".g_idx"),
                                       zero_offset=zero_offset)
        else:
            w = dequantize_awq_weight(qweight, qzeros, scales)
        out[mod + ".weight"] = w
    for k, v in tensors.items():
        if not k.endswith(_PACKED_SUFFIXES):
            out[k] = torch.as_tensor(v)
    return out


def _minmax_groups(w: torch.Tensor, group_size: int):
    """Asymmetric min-max 4-bit quantization of (out, in) ``w`` per group of
    ``group_size`` input channels, in f32 as numpy computes it: (codes
    (in, out), zeros (groups, out), scales (groups, out) f32)."""
    wt = torch.as_tensor(w).to(torch.float32).T         # (in, out)
    in_f, out_f = wt.shape
    blk = wt.reshape(in_f // group_size, group_size, out_f)
    lo, hi = blk.amin(1), blk.amax(1)
    # a tensor divisor: on the card a Python scalar's is a multiplication
    # by its reciprocal, one ulp off numpy's quotient for some groups
    scale = ((hi - lo) / hi.new_tensor(15.0)).clamp_min(1e-8)
    zero = torch.round(-lo / scale).clamp(0, 15)
    codes = torch.round(blk / scale[:, None] + zero[:, None]).clamp(0, 15)
    return (codes.reshape(in_f, out_f).to(torch.int32),
            zero.to(torch.int32), scale)


def pack_gptq_weight(w, group_size: int = 128, zero_offset: bool = True):
    """Quantize (out, in) fp → AutoGPTQ-format tensors (asymmetric min-max
    per group): ``(qweight, qzeros, scales f16, g_idx int32)``."""
    codes, zeros, scales = _minmax_groups(w, group_size)
    g_idx = torch.arange(codes.shape[0], device=codes.device) // group_size
    qweight = _pack_int32_nibbles(codes, axis=0)
    qzeros = _pack_int32_nibbles(zeros - (1 if zero_offset else 0), axis=1)
    return qweight, qzeros, scales.to(torch.float16), g_idx.to(torch.int32)


def pack_awq_weight(w, group_size: int = 128):
    """Quantize (out, in) fp → AutoAWQ GEMM-format tensors: ``(qweight,
    qzeros, scales f16)``."""
    codes, zeros, scales = _minmax_groups(w, group_size)

    def pack_awq(c):
        r = c.reshape(c.shape[0], -1, 8)[:, :, list(AWQ_ORDER)]
        return _pack_int32_nibbles(r.reshape(c.shape), axis=1)

    return pack_awq(codes), pack_awq(zeros), scales.to(torch.float16)


__all__ = ["AWQ_ORDER", "dequantize_awq_weight", "dequantize_checkpoint",
           "dequantize_gptq_weight", "pack_awq_weight", "pack_gptq_weight"]
