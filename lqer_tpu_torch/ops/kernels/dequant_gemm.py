"""Kernel 1: MXINT4/MXINT8 dequant-GEMM with the rank-k LQER epilogue, and
the unpack kernel of the large-M route.

Port of ``lqer_tpu/ops/pallas/dequant_gemm.py``. The CUDA kernel is
``csrc/dequant_gemm.cu``; :func:`qlinear_w4_plain` is its plain PyTorch
version and the counterpart of ``qlinear_w4_fused_emulation``:

    Y = X_q · deq(W)^T + q_out(bf16(q_xa(X_q · A)) · B) + bias

``q_xa``/``q_out`` are the per-row block_fp quantizers in groups of 16
(:func:`_quantize_rows_mx`; one whole-row group when the width is not a
multiple of 16). Every product is exact in f32; the kernel and the plain
version sum in different orders (allclose, see ``lqer_tpu_torch/testing.py``
for the limit). X·A alone is summed in f64 on both sides and rounded to
f32 once (:func:`lqer_correction`): its q_xa quantizer then sees the same
value whatever the order, where an f32 sum of 4096 terms can land one ulp
off, on a rounding tie, and move a whole output row a q_out step.

:func:`qlinear_w4_fused` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors. With ``quant_x_width`` it takes the raw
activation and quantizes it in the kernel (the TPU kernel's
``quant_x_mb``; the plain version takes ``quant_x_width`` too:
``_quantize_rows_mx``, then the product).

The large-M route (:func:`qlinear_w4_dense_largeM`, 512 rows and more)
dequantizes the packed weight once to a dense bf16 ``(K, N)`` with
kernel 6 (``csrc/unpack.cu``, wrapper :func:`unpack_packed_to_bf16`,
plain version :func:`unpack_plain`; bit-exact), then runs one dense
product with f32 output (:func:`dense_f32`), as the JAX package leaves it
to XLA.
"""

from __future__ import annotations

import torch

from ...parallel.collectives import fill_zero_groups, mx_values
from ...utils import tracing
from ..storage import MXINT4, MXFormat, dequantize_packed, pack_weight, quantize_mx
from . import _build

# The launch plan of kernel 1 and the megakernel (csrc/w4_gemm.cuh)
TILE_DECODE = (8, 256)     # (rows, columns) of a GEMM block at M <= 8
TILE_PREFILL = (64, 128)   # above
MIN_SPLIT_GROUPS = 8       # fewest 16-groups of K a split streams
XA_RC = 64                 # rank columns per X·A block


def rank_supported(r: int) -> bool:
    """The ranks the kernel takes: any (a multiple of 16 is quantized per
    16 columns, any other width as one whole-row q_xa group, as the JAX
    kernel does)."""
    return r >= 0


def gemm_plan(M: int, N: int, K: int, sms: int, halves: int = 1,
              reserve: int = 0) -> dict:
    """The GEMM launch of ``x (M, K)`` times an (K, N) packed weight on a
    card of ``sms`` SMs: the tile (8 x 256 at M <= 8, else 64 x 128), and
    K's 16-groups split so that the blocks fill two an SM without a
    partial second wave (``halves`` weights of the same shape share the
    blocks: the megakernel's gate and up; ``reserve`` blocks go to other
    work of the same launch, where that leaves a block an SM), each split
    at least :data:`MIN_SPLIT_GROUPS` groups, none empty."""
    rows, cols = TILE_DECODE if M <= TILE_DECODE[0] else TILE_PREFILL
    m_tiles, n_tiles = -(-M // rows), -(-N // cols)
    groups = K // 16
    tiles = m_tiles * n_tiles * halves
    want = (2 * sms - reserve) // tiles   # one wave with the other work
    if want * tiles < sms:   # unless that leaves SMs idle: short other
        want = 2 * sms // tiles   # work may share them
    splits = max(1, min(want, groups // MIN_SPLIT_GROUPS))
    gps = -(-groups // splits)
    return dict(rows=rows, cols=cols, m_tiles=m_tiles, n_tiles=n_tiles,
                splits=-(-groups // gps), groups_per_split=gps)


def xa_plan(M: int, K: int, W: int, sms: int, max_ranges: int = 16
            ) -> dict:
    """The X·A launch of ``x (M, K)`` times ``a (K, W)``: 8-row tiles,
    rank chunks of :data:`XA_RC` columns, and K in ranges (multiples of 16)
    that give about eight blocks an SM (short blocks whose loads wait: more
    of them keep more in flight), at most ``max_ranges`` of them (the
    partials a finishing sum reads per value)."""
    row_tiles, rank_chunks = -(-M // 8), max(1, -(-W // XA_RC))
    want = -(-8 * sms // (row_tiles * rank_chunks))
    ranges = max(1, min(want, max_ranges, K // 16))
    kr = (-(-K // ranges) + 15) // 16 * 16
    return dict(row_tiles=row_tiles, rank_chunks=rank_chunks, k_range=kr,
                k_ranges=-(-K // kr))


def plan(M: int, N: int, K: int, R: int, sms: int) -> dict:
    """Kernel 1's two launches (``gemm``, ``xa``: :func:`gemm_plan`,
    :func:`xa_plan`) and the element counts of their scratch:
    ``xa_part`` (f64 X·A chunk partials), ``xa_values`` (f32 quantized X·A
    rows), ``gemm_part`` (f32 split-K partials, none for one split) and
    ``counters`` (int32: the count of quantized X ranges and of the GEMM
    blocks past it, then the tickets of the GEMM tiles and of the X·A
    chunks)."""
    g, xa = gemm_plan(M, N, K, sms), xa_plan(M, K, R, sms)
    rows8 = xa["row_tiles"] * 8
    return dict(
        gemm=g, xa=xa,
        xa_part=rows8 * xa["k_ranges"] * R,
        xa_values=rows8 * R,
        gemm_part=(0 if g["splits"] == 1
                   else g["splits"] * g["m_tiles"] * g["rows"] * N),
        counters=2 + g["m_tiles"] * g["n_tiles"]
        + xa["row_tiles"] * xa["rank_chunks"])


_SMS: dict = {}
_COUNTERS: dict = {}


def sm_count(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def counters(device: torch.device, n: int, owner: str = "dequant_gemm"
             ) -> torch.Tensor:
    """``n`` int32 ticket counters on ``device``, zero at the first launch.
    Kernel 1 leaves its counters at zero; the megakernel resets its own
    where its phases allow. So one buffer per device and kernel
    (``owner``) serves every launch on its stream."""
    buf = _COUNTERS.get((device, owner))
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[device, owner] = torch.zeros(
            max(n, 4096), dtype=torch.int32, device=device)
    return buf


@tracing.annotate(tracing.QUANTIZE)
def _quantize_rows_mx(x: torch.Tensor, mb: int, group: int = 16
                      ) -> torch.Tensor:
    """Per (row, group of ``group`` along the last dim) block_fp
    quantize-dequantize at ``mb`` mantissa bits; a last dim that is not a
    multiple of ``group`` is one whole-row group."""
    m, n = x.shape
    if n % group:
        group = n
    v = x.reshape(m, n // group, group)
    bmax = fill_zero_groups(v.abs().amax(-1, keepdim=True), None)
    return mx_values(v, bmax, mb).reshape(m, n)


@tracing.annotate(tracing.CORRECTION)
def lqer_correction(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                    quant_xa_width: int | None = 8,
                    quant_out_width: int | None = 8) -> torch.Tensor:
    """``q_out(bf16(q_xa(x · a)) · b)`` in f32: the rank-k epilogue of
    kernel 1 for ``x (M, K)``, ``a (K, R)``, ``b (R, N)``. ``x · a`` (exact
    products of bf16-exact values) is summed in f64 and rounded to f32 once,
    as the kernels sum it: the f32 value q_xa sees does not depend on the
    summation order."""
    xa = torch.matmul(x.to(torch.float64), a.to(torch.float64)).to(
        torch.float32)
    if quant_xa_width is not None:
        xa = _quantize_rows_mx(xa, quant_xa_width - 1)
    corr = torch.matmul(xa.to(torch.bfloat16).to(torch.float32),
                        b.to(torch.float32))
    if quant_out_width is not None:
        corr = _quantize_rows_mx(corr, quant_out_width - 1)
    return corr


def prepare_w4_weights(w: torch.Tensor, a=None, b=None, bias=None,
                       fmt: MXFormat = MXINT4) -> dict:
    """Offline prep: ``w (out, in)`` → packed serving operands
    ``{codes, exps, a (K, R) bf16, b (R, N) bf16, bias (N,) f32}`` in the
    module layout of ``ops/storage.py`` (K = in, N = out)."""
    codes, exps = quantize_mx(w.to(torch.float32).T, fmt)
    out = pack_weight(codes, exps, fmt)
    out["a"] = None if a is None else a.to(torch.bfloat16).contiguous()
    out["b"] = None if b is None else b.to(torch.bfloat16).contiguous()
    out["bias"] = None if bias is None else bias.to(torch.float32).contiguous()
    return out


def qlinear_w4_plain(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                     quant_xa_width: int | None = 8,
                     quant_out_width: int | None = 8,
                     quant_x_width: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel; ``x_q (M, K)`` holds
    bf16-exact values, or with ``quant_x_width`` the raw activation, first
    quantized as the kernel quantizes it (:func:`quantize_x_plain`).
    Returns (M, N) f32."""
    if quant_x_width is not None:
        x_q = quantize_x_plain(x_q, quant_x_width)
    w = dequantize_packed(prep["codes"], prep["exps"], fmt)
    xf = x_q.to(torch.bfloat16).to(torch.float32)
    y = torch.matmul(xf, w)
    if prep.get("a") is not None:
        y = y + lqer_correction(xf, prep["a"], prep["b"],
                                quant_xa_width=quant_xa_width,
                                quant_out_width=quant_out_width)
    if prep.get("bias") is not None:
        y = y + prep["bias"].to(torch.float32)
    return y


def unpack_plain(codes: torch.Tensor, exps: torch.Tensor, fmt: MXFormat
                 ) -> torch.Tensor:
    """Plain version of the unpack kernel: ``code · 2^(e − mb)`` as bf16
    (exact for widths <= 9)."""
    return dequantize_packed(codes, exps, fmt).to(torch.bfloat16)


@tracing.annotate(tracing.UNPACK)
def unpack_packed_to_bf16(codes: torch.Tensor, exps: torch.Tensor,
                          fmt: MXFormat) -> torch.Tensor:
    """Packed words ``(K/per, N)`` + exps ``(K/16, N)`` (one layer's views
    of a stacked prep pass as they are) → dense bf16 ``(K, N)``. CPU
    tensors run :func:`unpack_plain`; CUDA tensors launch
    ``csrc/unpack.cu``."""
    if codes.device.type == "cpu":
        return unpack_plain(codes, exps, fmt)
    if not codes.is_cuda:
        raise ValueError(f"unsupported device {codes.device}")
    W, N = codes.shape
    K = W * fmt.codes_per_word
    if N % 8 or fmt.width not in (4, 8):
        raise ValueError(f"unsupported unpack shape K={K} N={N} "
                         f"width={fmt.width}")
    _check_cuda("codes", codes, torch.int32, (W, N))
    _check_cuda("exps", exps, torch.int8, (K // 16, N))
    if codes.data_ptr() % 16 or exps.data_ptr() % 8:
        raise ValueError("unpack reads words 16 and exponents 8 bytes at a "
                         "time; their views must be aligned to that")
    out = torch.empty(K, N, dtype=torch.bfloat16, device=codes.device)
    _build.launch("unpack", codes.data_ptr(), exps.data_ptr(),
                  out.data_ptr(), K, N, fmt.mantissa_bits)
    unpack_packed_to_bf16.launches += 1
    return out


unpack_packed_to_bf16.launches = 0


def dense_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (M, K) · w (K, N)`` of bf16 operands with f32 output, as
    ``jnp.dot(..., preferred_element_type=f32)``: every product is exact,
    only the f32 summation order is the library's. On the card one bf16
    GEMM with an f32 output; the CPU has no such kernel, so it upcasts."""
    if x.is_cuda:
        return torch.mm(x.to(torch.bfloat16), w, out_dtype=torch.float32)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def qlinear_w4_dense_largeM(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                            quant_xa_width: int | None = 8,
                            quant_out_width: int | None = 8) -> torch.Tensor:
    """Large-M route (counterpart of ``qlinear_w4_dense_largeM``): unpack
    once, one dense product, then the rank-k correction and the bias.
    Returns (M, N) f32; the same function as :func:`qlinear_w4_plain`."""
    w = unpack_packed_to_bf16(prep["codes"], prep["exps"], fmt)
    y = dense_f32(x_q, w)
    if prep.get("a") is not None:
        y = y + lqer_correction(x_q, prep["a"], prep["b"],
                                quant_xa_width=quant_xa_width,
                                quant_out_width=quant_out_width)
    if prep.get("bias") is not None:
        y = y + prep["bias"].to(torch.float32)
    return y


def _check_cuda(name: str, t: torch.Tensor | None, dtype, shape) -> None:
    if t is None:
        return
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, need {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_quant_x(x: torch.Tensor, quant_x_width: int) -> None:
    """Raise unless the in-kernel activation quantizer takes ``x (M, K)``
    at this width: whole 16-groups along K, a grid exact in bf16 (widths 2
    to 9), as the serving backend's eligibility test asks."""
    if x.ndim != 2 or x.shape[1] % 16 or not 2 <= quant_x_width <= 9:
        raise ValueError(f"the in-kernel activation quantizer takes (M, K) "
                         f"with K % 16 == 0 at widths 2..9 (x "
                         f"{tuple(x.shape)}, width {quant_x_width})")


def quantize_x_plain(x: torch.Tensor, quant_x_width: int) -> torch.Tensor:
    """The in-kernel activation quantizer's function: ``x`` as f32,
    quantized per (row, 16 along K) at ``quant_x_width - 1`` mantissa
    bits."""
    return _quantize_rows_mx(x.to(torch.float32), quant_x_width - 1)


def _launch(x: torch.Tensor, prep: dict, fmt: MXFormat, quant_xa_width,
            quant_out_width, quant_x_width=None) -> torch.Tensor:
    """Check the operands and launch ``csrc/dequant_gemm.cu`` (one or two
    kernels); with ``quant_x_width`` ``x`` is the raw activation."""
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    M, K = x.shape
    per = fmt.codes_per_word
    N = prep["codes"].shape[-1]
    a, b, bias = prep.get("a"), prep.get("b"), prep.get("bias")
    R = 0 if a is None else a.shape[-1]
    if K % 16 or N % 32 or not rank_supported(R) or fmt.width not in (4, 8):
        raise ValueError(f"unsupported dequant-GEMM shape K={K} N={N} R={R} "
                         f"width={fmt.width}")
    _check_cuda("codes", prep["codes"], torch.int32, (K // per, N))
    _check_cuda("exps", prep["exps"], torch.int8, (K // 16, N))
    _check_cuda("a", a, torch.bfloat16, (K, R))
    _check_cuda("b", b, torch.bfloat16, (R, N))
    _check_cuda("bias", bias, torch.float32, (N,))
    x_raw = None
    if quant_x_width is None:
        x = x.to(torch.bfloat16).contiguous()
    else:
        x_raw = x.to(torch.float32).contiguous()
        x = torch.empty(M, K, dtype=torch.bfloat16, device=x.device)
    dev = x.device
    pl = plan(M, N, K, R, sm_count(dev))
    out = torch.empty(M, N, dtype=torch.float32, device=dev)

    def scratch(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev) if n else None

    xa_part = scratch(pl["xa_part"], torch.float64)
    xa = scratch(pl["xa_values"], torch.float32)
    gpart = scratch(pl["gemm_part"], torch.float32)
    _build.launch(
        "dequant_gemm", x.data_ptr(), _build.ptr(x_raw),
        prep["codes"].data_ptr(), prep["exps"].data_ptr(), _build.ptr(a),
        _build.ptr(b), _build.ptr(bias), out.data_ptr(), _build.ptr(xa_part),
        _build.ptr(xa), _build.ptr(gpart),
        counters(dev, pl["counters"]).data_ptr(), M, N, K, R,
        fmt.mantissa_bits,
        -1 if quant_xa_width is None else quant_xa_width - 1,
        -1 if quant_out_width is None else quant_out_width - 1,
        -1 if quant_x_width is None else quant_x_width - 1,
        pl["gemm"]["splits"], pl["gemm"]["groups_per_split"],
        pl["xa"]["k_range"])
    return out


def qlinear_w4_fused(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                     quant_xa_width: int | None = 8,
                     quant_out_width: int | None = 8,
                     quant_x_width: int | None = None) -> torch.Tensor:
    """``x_q (M, K)`` (bf16-exact activation values) through the packed
    weights of ``prep`` (one layer's operands; stacked preps pass
    ``prep[...][li]`` views). Returns (M, N) f32. With ``quant_x_width``,
    ``x_q`` is the raw activation (f32 or bf16), quantized in the kernel
    per 16 along K at that width (:func:`check_quant_x` raises for a shape
    or width it does not take). CPU tensors run :func:`qlinear_w4_plain`;
    CUDA tensors launch ``csrc/dequant_gemm.cu``."""
    kw = dict(quant_xa_width=quant_xa_width, quant_out_width=quant_out_width,
              quant_x_width=quant_x_width)
    if quant_x_width is not None:
        check_quant_x(x_q, quant_x_width)
    if x_q.device.type == "cpu":
        return qlinear_w4_plain(x_q, prep, fmt, **kw)
    out = _launch(x_q, prep, fmt, **kw)
    qlinear_w4_fused.launches += 1
    return out


qlinear_w4_fused.launches = 0
