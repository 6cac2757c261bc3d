"""Kernel 5: the whole-MLP megakernel with LQER corrections, gated silu
(Llama) and un-gated relu with biases (OPT), and the MLP's large-M route.

Port of ``lqer_tpu/ops/pallas/mlp_fused.py``. The CUDA kernel is
``csrc/mlp_fused.cu``; :func:`mlp_w4_plain` is its plain PyTorch version
and states the function (``mlp_fused.py:4-12`` of the JAX package):

    y_g = X W_g^T + q_out(bf16(q_xa(X A_g)) B_g) [+ b_g]
    y_u = X W_u^T + q_out(bf16(q_xa(X A_u)) B_u) [+ b_u]   (gated only)
    H   = bf16(q_act(silu(y_g) · y_u))   or   bf16(q_act(relu(y_g)))
    Y   = H W_d^T + q_out(bf16(q_xa(H A_d)) B_d) [+ b_d]

``y_g`` and ``y_u`` stay f32 through the activation and its quantizer
``q_act`` (MXINT8, groups of 16 along I); only the quantized ``H`` is
rounded to bf16, which is exact on its grid. (The unfused path rounds gate
and up to the hidden dtype first, a different function.) Each bias (f32,
already on its ``b_quantizer``'s grid) comes after its correction.

:func:`mlp_w4_fused` (the gated variant) and :func:`mlp_w4_fused_relu`
(the relu variant; :func:`mlp_w4_fused` hands an un-gated prep to it)
launch the kernel for CUDA tensors and run the plain version for CPU
tensors; each counts its own launches. With ``quant_x_width`` the first
input arrives raw and the kernel quantizes it (the TPU kernel's
``quant_x_mb``; :func:`mlp_w4_plain` takes ``quant_x_width`` too). The
serving
backend sends them
fewer than ``kernel_backend._LARGEM_THRESHOLD`` (512) rows.
:func:`mlp_w4_dense_largeM` is the 512-rows-and-more route: two or three
unpacks and as many dense products (``dequant_gemm.unpack_packed_to_bf16``,
``dequant_gemm.dense_f32``).
"""

from __future__ import annotations

import torch
from torch.nn.functional import relu, silu

from ..storage import MXFormat, dequantize_packed
from . import _build
from . import dequant_gemm as k1


def prepare_mlp_weights(w_gate: torch.Tensor, w_up: torch.Tensor | None,
                        w_down: torch.Tensor, *, a_gate=None, b_gate=None,
                        a_up=None, b_up=None, a_down=None, b_down=None,
                        bias_gate=None, bias_up=None, bias_down=None,
                        pad_i: int) -> dict:
    """Offline prep: ``w_gate``/``w_up (I, K)`` (``w_up`` None for the relu
    variant, ``w_gate`` its fc1), ``w_down (N, I)`` → MXINT4 ``{codes_g,
    exps_g, codes_u, exps_u, codes_d, exps_d, a_gu, b_g, b_u, a_d, b_d,
    bias_g, bias_u, bias_d}`` (absent parts None). Gated, A_gate|A_up
    concatenate along rank (one X·A for both halves); un-gated, ``a_gu`` is
    A_gate alone. B stays per half; biases are f32. The intermediate dim is
    zero-padded to ``pad_i``, as the JAX package does (exact: zero columns
    give silu(0)·0 = relu(0 + 0) = 0)."""
    gated = w_up is not None
    p = pad_i - w_gate.shape[0]
    if p:
        def rows(t):
            return None if t is None else torch.nn.functional.pad(
                t, (0, 0, 0, p))

        def cols(t):
            return None if t is None else torch.nn.functional.pad(t, (0, p))

        w_gate, w_up, a_down = rows(w_gate), rows(w_up), rows(a_down)
        w_down, b_gate, b_up, bias_gate, bias_up = (
            cols(t) for t in (w_down, b_gate, b_up, bias_gate, bias_up))
    out = {}
    for half, w in (("g", w_gate), ("u", w_up), ("d", w_down)):
        prep = k1.prepare_w4_weights(w) if w is not None else {}
        out[f"codes_{half}"] = prep.get("codes")
        out[f"exps_{half}"] = prep.get("exps")

    def bf(t):
        return None if t is None else t.to(torch.bfloat16).contiguous()

    def f32(t):
        return None if t is None else t.to(torch.float32).contiguous()

    out["a_gu"] = bf(a_gate if a_gate is None or not gated
                     else torch.cat([a_gate, a_up], dim=1))
    out.update(b_g=bf(b_gate), b_u=bf(b_up), a_d=bf(a_down), b_d=bf(b_down),
               bias_g=f32(bias_gate), bias_u=f32(bias_up),
               bias_d=f32(bias_down))
    return out


def _plain_product(x, codes, exps, fmt):
    return torch.matmul(x.to(torch.float32),
                        dequantize_packed(codes, exps, fmt))


def _unpacked_product(x, codes, exps, fmt):
    return k1.dense_f32(x, k1.unpack_packed_to_bf16(codes, exps, fmt))


def _gate_up(x, prep, fmt, product, quant_xa_width, quant_out_width):
    """(y_g, y_u) in f32 for ``x (M, K)``, y_u None for the relu variant;
    ``product(x, codes, exps, fmt)`` is the W4 product (plain, or unpack +
    dense)."""
    gated = prep.get("codes_u") is not None
    y_g = product(x, prep["codes_g"], prep["exps_g"], fmt)
    y_u = product(x, prep["codes_u"], prep["exps_u"], fmt) if gated else None
    if prep.get("a_gu") is not None:
        r = prep["b_g"].shape[0]
        kw = dict(quant_xa_width=quant_xa_width,
                  quant_out_width=quant_out_width)
        y_g = y_g + k1.lqer_correction(x, prep["a_gu"][:, :r], prep["b_g"],
                                       **kw)
        if gated:
            y_u = y_u + k1.lqer_correction(x, prep["a_gu"][:, r:],
                                           prep["b_u"], **kw)
    if prep.get("bias_g") is not None:
        y_g = y_g + prep["bias_g"]
    if prep.get("bias_u") is not None:
        y_u = y_u + prep["bias_u"]
    return y_g, y_u


def hidden(y_g: torch.Tensor, y_u: torch.Tensor | None,
           act_width: int | None) -> torch.Tensor:
    """``bf16(q_act(silu(y_g) · y_u))``, or ``bf16(q_act(relu(y_g)))`` with
    ``y_u`` None, as f32 values."""
    h = relu(y_g) if y_u is None else silu(y_g) * y_u
    if act_width is not None:
        h = k1._quantize_rows_mx(h, act_width - 1)
    return h.to(torch.bfloat16).to(torch.float32)


def down_prep(prep: dict) -> dict:
    """The down projection's operands in kernel 1's prep layout."""
    return {"codes": prep["codes_d"], "exps": prep["exps_d"],
            "a": prep.get("a_d"), "b": prep.get("b_d"),
            "bias": prep.get("bias_d")}


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
                 quant_out_width: int | None = 8,
                 quant_x_width: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the megakernel (either variant); ``x_q
    (M, K)`` holds bf16-exact values, or with ``quant_x_width`` the raw
    activation, first quantized as the kernel quantizes it
    (``dequant_gemm.quantize_x_plain``). Returns (M, N) f32."""
    if quant_x_width is not None:
        x_q = k1.quantize_x_plain(x_q, quant_x_width)
    h = hidden_plain(x_q, prep, fmt, act_width=act_width,
                     quant_xa_width=quant_xa_width,
                     quant_out_width=quant_out_width)
    return k1.qlinear_w4_plain(h, down_prep(prep), fmt,
                               quant_xa_width=quant_xa_width,
                               quant_out_width=quant_out_width)


def _launch(x_q: torch.Tensor, prep: dict, fmt: MXFormat, act_width,
            quant_xa_width, quant_out_width, quant_x_width=None
            ) -> torch.Tensor:
    """Check the operands and launch ``csrc/mlp_fused.cu`` once; with
    ``quant_x_width`` ``x_q`` is the raw activation."""
    if not x_q.is_cuda:
        raise ValueError(f"unsupported device {x_q.device}")
    M, K = x_q.shape
    N = prep["codes_d"].shape[-1]
    I = prep["codes_g"].shape[-1]
    gated = prep.get("codes_u") is not None
    R = 0 if prep.get("a_gu") is None else prep["b_g"].shape[0]
    wgu = 2 * R if gated else R
    if (M < 1 or K % 16 or I % 32 or N % 32
            or R % 16 or fmt.width != 4):
        raise ValueError(f"unsupported megakernel shape M={M} K={K} I={I} "
                         f"N={N} R={R} width={fmt.width}")
    if act_width is None or act_width > 9:
        raise ValueError(f"the megakernel quantizes H at <= 9 bits "
                         f"(act_width={act_width})")
    per = fmt.codes_per_word
    for half in "gu" if gated else "g":
        k1._check_cuda(f"codes_{half}", prep[f"codes_{half}"], torch.int32,
                       (K // per, I))
        k1._check_cuda(f"exps_{half}", prep[f"exps_{half}"], torch.int8,
                       (K // 16, I))
    k1._check_cuda("codes_d", prep["codes_d"], torch.int32, (I // per, N))
    k1._check_cuda("exps_d", prep["exps_d"], torch.int8, (I // 16, N))
    if R:
        k1._check_cuda("a_gu", prep["a_gu"], torch.bfloat16, (K, wgu))
        for name, shape in (("b_g", (R, I)), ("b_u", (R, I)),
                            ("a_d", (I, R)), ("b_d", (R, N))):
            if name != "b_u" or gated:
                k1._check_cuda(name, prep[name], torch.bfloat16, shape)
    for name, n in (("bias_g", I), ("bias_u", I), ("bias_d", N)):
        k1._check_cuda(name, prep.get(name), torch.float32, (n,))
    if not gated and prep.get("bias_u") is not None:
        raise ValueError("bias_u without an up half")
    x_raw = None
    if quant_x_width is None:
        x = x_q.to(torch.bfloat16).contiguous()
    else:
        x_raw = x_q.to(torch.float32).contiguous()
        x = torch.empty(M, K, dtype=torch.bfloat16, device=x_q.device)
    dev = x.device
    pl = plan(M, K, I, N, R, gated, k1.sm_count(dev))
    out = torch.empty(M, N, dtype=torch.float32, device=dev)
    h = torch.empty(pl["h"], dtype=torch.bfloat16, device=dev)
    part = torch.empty(max(pl["xa_part"], 1), dtype=torch.float64,
                       device=dev)
    xa = torch.empty(max(pl["xa_values"], 1), dtype=torch.float32,
                     device=dev)
    gpart = torch.empty(max(pl["gemm_part"], 1), dtype=torch.float32,
                        device=dev)
    _build.launch(
        "mlp_fused", x.data_ptr(), _build.ptr(x_raw),
        *(_build.ptr(prep.get(k)) for k in (
            "codes_g", "exps_g", "codes_u", "exps_u", "codes_d", "exps_d",
            "a_gu", "b_g", "b_u", "a_d", "b_d", "bias_g", "bias_u",
            "bias_d")),
        h.data_ptr(), part.data_ptr(), xa.data_ptr(), gpart.data_ptr(),
        k1.counters(dev, pl["counters"], "mlp_fused").data_ptr(), out.data_ptr(), M, K,
        I, N, R, act_width - 1,
        -1 if quant_xa_width is None else quant_xa_width - 1,
        -1 if quant_out_width is None else quant_out_width - 1,
        -1 if quant_x_width is None else quant_x_width - 1,
        pl["gate_up"]["splits"], pl["gate_up"]["groups_per_split"],
        pl["down"]["splits"], pl["down"]["groups_per_split"],
        pl["xa_gate_up"]["k_range"], pl["xa_down"]["k_range"])
    return out


def plan(M: int, K: int, I: int, N: int, R: int, gated: bool, sms: int
         ) -> dict:
    """The megakernel's phases on a card of ``sms`` SMs: the GEMMs of
    phases B (``gate_up``: gate and up share the blocks) and D (``down``),
    :func:`dequant_gemm.gemm_plan`, their K splits leaving room for the X·A
    items that run beside them; the X·A of phases A and C
    (``xa_gate_up``, ``xa_down``), :func:`dequant_gemm.xa_plan` (finished
    across the grid, so up to 32 K ranges); and the element counts of the
    scratch: ``h`` (bf16 H rows), ``xa_part`` (f64 X·A partials of either
    phase), ``xa_values`` (f32 quantized X·A_gu | H·A_d rows),
    ``gemm_part`` (f32 split-K partials of either GEMM phase: B's when
    gated, whose halves meet in the last block of a tile, or split; D's
    when split) and ``counters`` (int32: the counts of A's and C's
    finished X·A chunks, then the tickets of B's tiles, D's tiles, A's and
    C's chunks)."""
    halves = 2 if gated else 1
    wgu = halves * R
    xa_gu = k1.xa_plan(M, K, wgu, sms, max_ranges=32)
    xa_dn = k1.xa_plan(M, I, R, sms, max_ranges=32)

    def items(xa):   # the X·A items that share a phase's blocks
        return xa["row_tiles"] * xa["k_ranges"] * xa["rank_chunks"] if R else 0

    gu = k1.gemm_plan(M, I, K, sms, halves=halves, reserve=items(xa_gu))
    dn = k1.gemm_plan(M, N, I, sms, reserve=items(xa_dn))
    rows8 = -(-M // 8) * 8
    tile_rows = gu["m_tiles"] * gu["rows"]
    part_b = (halves * gu["splits"] * tile_rows * I
              if gated or gu["splits"] > 1 else 0)
    part_d = dn["splits"] * tile_rows * N if dn["splits"] > 1 else 0
    return dict(
        gate_up=gu, down=dn, xa_gate_up=xa_gu, xa_down=xa_dn,
        h=rows8 * I,
        xa_part=rows8 * max(xa_gu["k_ranges"] * wgu, xa_dn["k_ranges"] * R),
        xa_values=rows8 * (wgu + R),
        gemm_part=max(part_b, part_d),
        counters=gu["m_tiles"] * (gu["n_tiles"] + dn["n_tiles"])
        + xa_gu["row_tiles"] * xa_gu["rank_chunks"]
        + xa_dn["row_tiles"] * xa_dn["rank_chunks"] + 2)


def _run(x_q, prep, fmt, kw) -> torch.Tensor:
    """The plain version for CPU tensors, else one launch of the kernel
    (which its caller counts)."""
    if kw["quant_x_width"] is not None:
        k1.check_quant_x(x_q, kw["quant_x_width"])
    if x_q.device.type == "cpu":
        return mlp_w4_plain(x_q, prep, fmt, **kw)
    return _launch(x_q, prep, fmt, **kw)


def mlp_w4_fused(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                 act_width: int | None = 8,
                 quant_xa_width: int | None = 8,
                 quant_out_width: int | None = 8,
                 quant_x_width: int | None = None) -> torch.Tensor:
    """``x_q (M, K)`` (bf16-exact activation values) through one
    layer's packed MLP ``prep`` (stacked preps pass ``prep[...][li]``
    views). Returns (M, N) f32. With ``quant_x_width``, ``x_q`` is the raw
    activation, quantized in the kernel (``dequant_gemm.check_quant_x``
    raises for a shape or width it does not take). CPU tensors run
    :func:`mlp_w4_plain`; CUDA tensors launch ``csrc/mlp_fused.cu`` once.
    An un-gated (relu) prep goes to :func:`mlp_w4_fused_relu`."""
    kw = dict(act_width=act_width, quant_xa_width=quant_xa_width,
              quant_out_width=quant_out_width, quant_x_width=quant_x_width)
    if prep.get("codes_u") is None:
        return mlp_w4_fused_relu(x_q, prep, fmt, **kw)
    out = _run(x_q, prep, fmt, kw)
    if x_q.is_cuda:
        mlp_w4_fused.launches += 1
    return out


def mlp_w4_fused_relu(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                      act_width: int | None = 8,
                      quant_xa_width: int | None = 8,
                      quant_out_width: int | None = 8,
                      quant_x_width: int | None = None) -> torch.Tensor:
    """:func:`mlp_w4_fused` for the un-gated relu variant with biases (an
    OPT layer's fc1 and fc2), counted apart."""
    kw = dict(act_width=act_width, quant_xa_width=quant_xa_width,
              quant_out_width=quant_out_width, quant_x_width=quant_x_width)
    if prep.get("codes_u") is not None:
        raise ValueError("a gated MLP prep: use mlp_w4_fused")
    out = _run(x_q, prep, fmt, kw)
    if x_q.is_cuda:
        mlp_w4_fused_relu.launches += 1
    return out


mlp_w4_fused.launches = 0
mlp_w4_fused_relu.launches = 0


def mlp_w4_dense_largeM(x_q: torch.Tensor, prep: dict, fmt: MXFormat, *,
                        act_width: int | None = 8,
                        quant_xa_width: int | None = 8,
                        quant_out_width: int | None = 8) -> torch.Tensor:
    """Large-M route (counterpart of ``mlp_w4_dense_largeM``): gate (up) and
    down each unpacked once to bf16 and run as one dense product with f32
    output; the same function as :func:`mlp_w4_plain`."""
    y_g, y_u = _gate_up(x_q.to(torch.bfloat16), prep, fmt, _unpacked_product,
                        quant_xa_width, quant_out_width)
    h = hidden(y_g, y_u, act_width)
    return k1.qlinear_w4_dense_largeM(h, down_prep(prep), fmt,
                                      quant_xa_width=quant_xa_width,
                                      quant_out_width=quant_out_width)
