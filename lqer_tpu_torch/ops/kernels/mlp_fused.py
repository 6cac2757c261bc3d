"""Kernel 5: the whole-MLP megakernel (gated silu variant with LQER
corrections), and the MLP's large-M route.

Port of ``lqer_tpu/ops/pallas/mlp_fused.py``. The CUDA kernel is
``csrc/mlp_fused.cu``; :func:`mlp_w4_plain` is its plain PyTorch version
and states the function (``mlp_fused.py:4-12`` of the JAX package):

    y_g = X W_g^T + q_out(bf16(q_xa(X A_g)) B_g)
    y_u = X W_u^T + q_out(bf16(q_xa(X A_u)) B_u)
    H   = bf16(q_act(silu(y_g) · y_u))
    Y   = H W_d^T + q_out(bf16(q_xa(H A_d)) B_d)

``y_g`` and ``y_u`` stay f32 through ``silu · mul`` and the activation
quantizer ``q_act`` (MXINT8, groups of 16 along I); only the quantized
``H`` is rounded to bf16, which is exact on its grid. (The unfused path
rounds gate and up to the hidden dtype first, a different function.)

:func:`mlp_w4_fused` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; the serving backend sends it fewer than
``kernel_backend._LARGEM_THRESHOLD`` (512) rows.
:func:`mlp_w4_dense_largeM` is the 512-rows-and-more route: three unpacks
and three dense products (``dequant_gemm.unpack_packed_to_bf16``,
``dequant_gemm.dense_f32``).
"""

from __future__ import annotations

import torch
from torch.nn.functional import silu

from ..storage import MXFormat, dequantize_packed
from . import _build
from . import dequant_gemm as k1


def prepare_mlp_weights(w_gate: torch.Tensor, w_up: torch.Tensor,
                        w_down: torch.Tensor, *, a_gate=None, b_gate=None,
                        a_up=None, b_up=None, a_down=None, b_down=None,
                        pad_i: int) -> dict:
    """Offline prep: ``w_gate``/``w_up (I, K)``, ``w_down (N, I)`` →
    MXINT4 ``{codes_g, exps_g, codes_u, exps_u, codes_d, exps_d, a_gu, b_g,
    b_u, a_d, b_d}``. A_gate|A_up concatenate along rank (one X·A for both
    halves); B stays per half. The intermediate dim is zero-padded to
    ``pad_i``, as the JAX package does (exact: zero columns give
    silu(0)·0 = 0)."""
    p = pad_i - w_gate.shape[0]
    pad = torch.nn.functional.pad
    if p:
        w_gate, w_up = pad(w_gate, (0, 0, 0, p)), pad(w_up, (0, 0, 0, p))
        w_down = pad(w_down, (0, p))
        if a_gate is not None:
            b_gate, b_up = pad(b_gate, (0, p)), pad(b_up, (0, p))
            a_down = pad(a_down, (0, 0, 0, p))
    out = {}
    for half, w in (("g", w_gate), ("u", w_up), ("d", w_down)):
        prep = k1.prepare_w4_weights(w)
        out[f"codes_{half}"], out[f"exps_{half}"] = prep["codes"], prep["exps"]

    def bf(t):
        return None if t is None else t.to(torch.bfloat16).contiguous()

    out["a_gu"] = (None if a_gate is None
                   else bf(torch.cat([a_gate, a_up], dim=1)))
    out.update(b_g=bf(b_gate), b_u=bf(b_up), a_d=bf(a_down), b_d=bf(b_down))
    return out


def _plain_product(x, codes, exps, fmt):
    return torch.matmul(x.to(torch.float32),
                        dequantize_packed(codes, exps, fmt))


def _unpacked_product(x, codes, exps, fmt):
    return k1.dense_f32(x, k1.unpack_packed_to_bf16(codes, exps, fmt))


def _gate_up(x, prep, fmt, product, quant_xa_width, quant_out_width):
    """(y_g, y_u) in f32 for ``x (M, K)``; ``product(x, codes, exps, fmt)``
    is the W4 product (plain, or unpack + dense)."""
    y_g = product(x, prep["codes_g"], prep["exps_g"], fmt)
    y_u = product(x, prep["codes_u"], prep["exps_u"], fmt)
    if prep.get("a_gu") is not None:
        r = prep["a_gu"].shape[-1] // 2
        kw = dict(quant_xa_width=quant_xa_width,
                  quant_out_width=quant_out_width)
        y_g = y_g + k1.lqer_correction(x, prep["a_gu"][:, :r], prep["b_g"],
                                       **kw)
        y_u = y_u + k1.lqer_correction(x, prep["a_gu"][:, r:], prep["b_u"],
                                       **kw)
    return y_g, y_u


def hidden(y_g: torch.Tensor, y_u: torch.Tensor, act_width: int | None
           ) -> torch.Tensor:
    """``bf16(q_act(silu(y_g) · y_u))`` as f32 values."""
    h = silu(y_g) * y_u
    if act_width is not None:
        h = k1._quantize_rows_mx(h, act_width - 1)
    return h.to(torch.bfloat16).to(torch.float32)


def down_prep(prep: dict) -> dict:
    """The down projection's operands in kernel 1's prep layout."""
    return {"codes": prep["codes_d"], "exps": prep["exps_d"],
            "a": prep.get("a_d"), "b": prep.get("b_d"), "bias": None}


def hidden_plain(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                 act_width: int | None, quant_xa_width: int | None,
                 quant_out_width: int | None) -> torch.Tensor:
    """H of the plain version for ``x_q (M, K)``, as f32 values."""
    xf = x_q.to(torch.bfloat16).to(torch.float32)
    return hidden(*_gate_up(xf, prep, fmt, _plain_product, quant_xa_width,
                            quant_out_width), act_width)


def mlp_w4_plain(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                 act_width: int | None = 8,
                 quant_xa_width: int | None = 8,
                 quant_out_width: int | None = 8) -> torch.Tensor:
    """Plain PyTorch version of the megakernel; ``x_q (M, K)`` holds
    bf16-exact values. Returns (M, N) f32."""
    h = hidden_plain(x_q, prep, fmt, act_width=act_width,
                     quant_xa_width=quant_xa_width,
                     quant_out_width=quant_out_width)
    return k1.qlinear_w4_plain(h, down_prep(prep), fmt,
                               quant_xa_width=quant_xa_width,
                               quant_out_width=quant_out_width)


def mlp_w4_fused(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                 act_width: int | None = 8,
                 quant_xa_width: int | None = 8,
                 quant_out_width: int | None = 8) -> torch.Tensor:
    """``x_q (M, K)`` (bf16-exact activation values) through one
    layer's packed MLP ``prep`` (stacked preps pass ``prep[...][li]``
    views). Returns (M, N) f32. CPU tensors run :func:`mlp_w4_plain`; CUDA
    tensors launch ``csrc/mlp_fused.cu`` once."""
    kw = dict(act_width=act_width, quant_xa_width=quant_xa_width,
              quant_out_width=quant_out_width)
    if x_q.device.type == "cpu":
        return mlp_w4_plain(x_q, prep, fmt, **kw)
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    M, K = x_q.shape
    N = prep["codes_d"].shape[-1]
    I = prep["codes_g"].shape[-1]
    a_gu = prep.get("a_gu")
    R = 0 if a_gu is None else a_gu.shape[-1] // 2
    if (M < 1 or K % 16 or I % 32 or N % 32
            or R not in (0, 32) or fmt.width != 4):
        raise ValueError(f"unsupported megakernel shape M={M} K={K} I={I} "
                         f"N={N} R={R} width={fmt.width}")
    if act_width is None or act_width > 9:
        raise ValueError(f"the megakernel quantizes H at <= 9 bits "
                         f"(act_width={act_width})")
    per = fmt.codes_per_word
    for half in "gu":
        k1._check_cuda(f"codes_{half}", prep[f"codes_{half}"], torch.int32,
                       (K // per, I))
        k1._check_cuda(f"exps_{half}", prep[f"exps_{half}"], torch.int8,
                       (K // 16, I))
    k1._check_cuda("codes_d", prep["codes_d"], torch.int32, (I // per, N))
    k1._check_cuda("exps_d", prep["exps_d"], torch.int8, (I // 16, N))
    if R:
        k1._check_cuda("a_gu", a_gu, torch.bfloat16, (K, 2 * R))
        k1._check_cuda("b_g", prep["b_g"], torch.bfloat16, (R, I))
        k1._check_cuda("b_u", prep["b_u"], torch.bfloat16, (R, I))
        k1._check_cuda("a_d", prep["a_d"], torch.bfloat16, (I, R))
        k1._check_cuda("b_d", prep["b_d"], torch.bfloat16, (R, N))
    x = x_q.to(torch.bfloat16).contiguous()
    dev = x.device
    mt = -(-M // 8)
    out = torch.empty(M, N, dtype=torch.float32, device=dev)
    h = torch.empty(mt * 8, I, dtype=torch.bfloat16, device=dev)
    # X·A partials of each 8-row tile and 256-wide K chunk, then the
    # quantized X·A of every row: gate|up (2R wide), then down (R wide)
    part = torch.empty(mt, -(-max(K, I) // k1.XA_KC), 8, max(2 * R, 1),
                       dtype=torch.float32, device=dev)
    xa = torch.empty(mt * 8, max(3 * R, 1), dtype=torch.float32, device=dev)
    _build.launch(
        "mlp_fused", x.data_ptr(), prep["codes_g"].data_ptr(),
        prep["exps_g"].data_ptr(), prep["codes_u"].data_ptr(),
        prep["exps_u"].data_ptr(), prep["codes_d"].data_ptr(),
        prep["exps_d"].data_ptr(), _build.ptr(a_gu), _build.ptr(prep.get("b_g")),
        _build.ptr(prep.get("b_u")), _build.ptr(prep.get("a_d")),
        _build.ptr(prep.get("b_d")), h.data_ptr(), part.data_ptr(),
        xa.data_ptr(), out.data_ptr(), M, K, I, N, R, act_width - 1,
        -1 if quant_xa_width is None else quant_xa_width - 1,
        -1 if quant_out_width is None else quant_out_width - 1)
    mlp_w4_fused.launches += 1
    return out


mlp_w4_fused.launches = 0


def mlp_w4_dense_largeM(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                        act_width: int | None = 8,
                        quant_xa_width: int | None = 8,
                        quant_out_width: int | None = 8) -> torch.Tensor:
    """Large-M route (counterpart of ``mlp_w4_dense_largeM``): gate, up and
    down each unpacked once to bf16 and run as one dense product with f32
    output; the same function as :func:`mlp_w4_plain`."""
    y_g, y_u = _gate_up(x_q.to(torch.bfloat16), prep, fmt, _unpacked_product,
                        quant_xa_width, quant_out_width)
    h = hidden(y_g, y_u, act_width)
    return k1.qlinear_w4_dense_largeM(h, down_prep(prep), fmt,
                                      quant_xa_width=quant_xa_width,
                                      quant_out_width=quant_out_width)
