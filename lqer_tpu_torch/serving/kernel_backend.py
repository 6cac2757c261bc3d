"""Kernel serving backend: every quantized linear runs through the
dequant-GEMM kernel (``ops/kernels/dequant_gemm.py``) on packed MXINT4
weights, the lm_head optionally on packed MXINT8 weights, and each layer's
whole MLP through the megakernel (``ops/kernels/mlp_fused.py``: Llama's
gated silu MLP, or OPT's relu MLP with biases). At 512
rows and more the linears and the MLP take the large-M route instead:
unpack each weight once (kernel 6), then one dense product.

Port of ``lqer_tpu/serving/pallas_backend.py``: the same eligibility checks
decide which linears are packed (an ineligible one is not packed, and the
step runs it through the software emulation, ``decode._lin``), the MLP is
packed whole (``{layer}.mlp_fused``, ``fuse_mlp=True``, the default) where
:func:`_mlp_fusable` allows, the same fuse groups (q|k|v, and for Llama gate|up
when the MLP is not packed whole) share one launch, and ``pad_to_tile``
pads the vocab to 32768 and the intermediate dim (11008 to 11264) as the
JAX package does. A bias passes through its linear's ``b_quantizer`` at
pack time.

A linear or MLP below 512 rows whose activation quantizer is the
canonical MXINT8 format (:func:`_is_mx8_act`, width <= 9, K % 16 == 0: the
JAX package's test for its opt-in ``LQER_INKERNEL_XQ`` route) hands its raw
activation to the kernel, which quantizes it itself (kernel 1's and the
megakernel's ``quant_x_width``): the same values as the separate
quantizer, without its ops. Other formats, and 512 rows and more, keep the
separate quantizer; the lm_head keeps its unquantized bf16 input.
"""

from __future__ import annotations

import logging

import torch

from .. import models
from ..ops.kernels.dequant_gemm import (
    prepare_w4_weights,
    qlinear_w4_dense_largeM,
    qlinear_w4_fused,
)
from ..ops.kernels.mlp_fused import (
    mlp_w4_dense_largeM,
    mlp_w4_fused,
    prepare_mlp_weights,
)
from ..ops.qlinear import bf16_exact
from ..ops.storage import MXINT4, MXFormat
from ..utils import tracing

logger = logging.getLogger(__name__)

TILE_K = 2048
# Token count at which the linears and the MLP switch from kernel 1 and the
# megakernel (which re-dequantize the weights in every 8-row tile) to the
# dequantize-once + dense-product route, as in the JAX package.
_LARGEM_THRESHOLD = 512

_FUSE_GROUPS_OPT = (
    ("self_attn.qkv_proj",
     ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")),
)
_FUSE_GROUPS_LLAMA = (
    *_FUSE_GROUPS_OPT,
    ("mlp.gateup_proj", ("mlp.gate_proj", "mlp.up_proj")),
)

_INELIGIBLE = "ineligible"


def fuse_groups_for(cfg):
    """Projections sharing one input, packed as one launch: q|k|v, and
    Llama's gate|up (OPT's fc1 and fc2 have different inputs)."""
    return _FUSE_GROUPS_OPT if cfg.arch == "opt" else _FUSE_GROUPS_LLAMA


def mlp_members_for(cfg):
    """(gate, up, down) rel-prefixes of the megakernel's linears; up is None
    for the un-gated (OPT relu) variant."""
    if cfg.arch == "opt":
        return ("fc1", None, "fc2")
    return ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _is_mx4_weight(w_cfg: dict | None) -> bool:
    return bool(
        w_cfg
        and w_cfg.get("name") == "block_fp"
        and w_cfg.get("width") == 4
        and w_cfg.get("exponent_width") == 8
        and w_cfg.get("exponent_bias") is None
        and list(w_cfg.get("block_size", ())) == [1, 16]
        and not w_cfg.get("skip_first_dim", False)
    )


def _is_mx8_act(x_cfg: dict | None) -> bool:
    """The activation format the kernels' in-kernel quantizer implements:
    block_fp, [1, 16] groups along the features, 8-bit exponent, no bias
    override."""
    return bool(
        x_cfg
        and x_cfg.get("name") == "block_fp"
        and list(x_cfg.get("block_size", ())) == [1, 16]
        and x_cfg.get("skip_first_dim", False)
        and x_cfg.get("exponent_width") == 8
        and x_cfg.get("exponent_bias") is None
    )


def inkernel_x_width(x_cfg: dict | None, k: int) -> int | None:
    """The width the kernel quantizes the raw activation at, where the
    in-kernel quantizer takes this activation format and K (the JAX
    package's eligibility test); else None."""
    if (_is_mx8_act(x_cfg) and x_cfg.get("width", 99) <= 9
            and k % 16 == 0):
        return int(x_cfg["width"])
    return None


def _partial_quant_width(cfg: dict | None, last_dim: int):
    """None (passthrough), the int width the kernel's row quantizer
    reproduces, or ``_INELIGIBLE``."""
    if cfg is None or cfg.get("name") == "passthrough":
        return None
    if not (cfg.get("name") == "block_fp"
            and cfg.get("exponent_width") == 8
            and cfg.get("exponent_bias") is None
            and list(cfg.get("block_size", ())) == [1, 16]
            and cfg.get("skip_first_dim", False)
            and cfg.get("width", 99) <= 9):
        return _INELIGIBLE
    if last_dim > 16 and last_dim % 16 != 0:
        return _INELIGIBLE
    return int(cfg["width"])


def _bf16_exact_values(arr: torch.Tensor) -> bool:
    a32 = arr.to(torch.float32)
    return bool(torch.equal(a32.to(torch.bfloat16).to(torch.float32), a32))


def _eligibility(qc, w, a, b, tile_k: int):
    """(ok, reason, xa_width, out_width) for packing one linear."""
    n_out, k_in = w.shape
    if not _is_mx4_weight(qc.w_cfg):
        return False, f"w_quantizer {qc.w_cfg} is not canonical MXINT4", None, None
    if not bf16_exact(qc.x_cfg):
        return False, f"x_quantizer {qc.x_cfg} not exact in bf16", None, None
    if _pick_tile_k(k_in, tile_k) == 0:
        return False, f"in_features {k_in} not tileable (cap {tile_k})", None, None
    if n_out % 128 != 0:
        return False, f"out_features {n_out} % 128 != 0", None, None
    xa_width = out_width = None
    if a is not None:
        rank = a.shape[1]
        xa_width = _partial_quant_width(qc.a_out_cfg, rank)
        if xa_width is _INELIGIBLE:
            return False, f"A_out_quantizer {qc.a_out_cfg} (rank {rank})", None, None
        out_width = _partial_quant_width(qc.b_out_cfg, n_out)
        if out_width is _INELIGIBLE:
            return False, f"B_out_quantizer {qc.b_out_cfg}", None, None
        if not (_bf16_exact_values(a) and _bf16_exact_values(b)):
            return False, "A/B values not exact in bf16", None, None
    return True, "", xa_width, out_width


def _member_widths(layer_prefix, members, params, layer_qcfg, tile_k):
    widths = set()
    for m in members:
        qc = models._proj_qcfg(layer_qcfg, m.rsplit(".", 1)[-1])
        ok, _, xa_w, out_w = _eligibility(
            qc, params[f"{layer_prefix}.{m}.weight"],
            params.get(f"{layer_prefix}.{m}.A"),
            params.get(f"{layer_prefix}.{m}.B"), tile_k)
        if not ok:
            return None
        widths.add((xa_w, out_w))
    return widths.pop() if len(widths) == 1 else None


def _mlp_fusable(layer_prefix, cfg, params, layer_qcfg, tile_k):
    """(xa_width, out_width, act_width) when the layer's whole MLP can run
    through the megakernel, else None: its linears (gate, up, down; or
    fc1, fc2) fuse (:func:`_fusable`) and pack alike, down's activation
    quantizer is one the kernel reproduces on H (``act_width``), and the
    dims tile. Biases may be present."""
    gate, up, down = mlp_members_for(cfg)
    members = [m for m in (gate, up, down) if m is not None]
    if not _fusable(layer_prefix, members, params, layer_qcfg):
        return None
    widths = _member_widths(layer_prefix, members, params, layer_qcfg,
                            tile_k)
    if widths is None:
        return None
    w_gate = params[f"{layer_prefix}.{gate}.weight"]
    w_down = params[f"{layer_prefix}.{down}.weight"]
    act_width = _partial_quant_width(
        models._proj_qcfg(layer_qcfg, down.rsplit(".", 1)[-1]).x_cfg,
        w_down.shape[1])
    if act_width is None or act_width is _INELIGIBLE:
        return None
    if (_pick_tile_k(w_down.shape[1], tile_k) == 0 or w_down.shape[0] % 128
            or w_gate.shape[0] % 128):
        return None
    return (*widths, act_width)


def _pack_mlp(layer_prefix, cfg, params, layer_qcfg, arrays, meta, xa_width,
              out_width, act_width) -> set:
    """Pack a layer's whole MLP under ``{layer}.mlp_fused``, the
    intermediate dim zero-padded by :func:`pad_to_tile` and each bias on
    its linear's ``b_quantizer`` grid; returns the packed members'
    prefixes."""
    rels = mlp_members_for(cfg)
    gate, up, down = (None if m is None else f"{layer_prefix}.{m}"
                      for m in rels)

    def get(prefix, suffix):
        return None if prefix is None else params.get(f"{prefix}.{suffix}")

    def qbias(prefix, rel):
        b = get(prefix, "bias")
        return None if b is None else models._proj_qcfg(
            layer_qcfg, rel.rsplit(".", 1)[-1]).b_quantizer(b)

    key = f"{layer_prefix}.mlp_fused"
    arrays[key] = prepare_mlp_weights(
        get(gate, "weight"), get(up, "weight"), get(down, "weight"),
        a_gate=get(gate, "A"), b_gate=get(gate, "B"), a_up=get(up, "A"),
        b_up=get(up, "B"), a_down=get(down, "A"), b_down=get(down, "B"),
        bias_gate=qbias(gate, rels[0]),
        bias_up=qbias(up, rels[1]),
        bias_down=qbias(down, rels[2]),
        pad_i=pad_to_tile(get(gate, "weight").shape[0])[0])
    meta[key] = {"kind": "mlp", "fmt": MXINT4, "act_width": act_width,
                 "xa_width": xa_width, "out_width": out_width}
    return {p for p in (gate, up, down) if p is not None}


def pad_to_tile(n: int, cap: int = 1024, max_overhead: float = 0.06):
    """(padded_n, tile): smallest zero padding of ``n`` that admits a large
    tile (the vocab 32000 pads to 32768). Zero rows are exact: they add 0
    to every dot and quantize to 0."""
    for t in (1024, 512, 256, 128):
        pad = -n % t
        if n >= t and pad / n <= max_overhead:
            return n + pad, t
    return n, _pick_tile_n(n)


def _pick_tile_n(n: int) -> int:
    for tn in (1024, 512, 256, 128):
        if n % tn == 0:
            return tn
    raise ValueError(f"out_features {n} not divisible by a supported tile")


def _pick_tile_k(k_in: int, cap: int) -> int:
    for tk in (2048, 1024, 512, 256, 128):
        if tk <= cap and k_in % tk == 0:
            return tk
    return 0


def _fusable(layer_prefix: str, members, params, layer_qcfg) -> bool:
    """Identical activation-side quantizers, uniform A/B presence, member
    ranks and out_features multiples of 16 (no shared-exponent group spans
    two members) and a total out_features multiple of 128."""
    qcs = [models._proj_qcfg(layer_qcfg, m.rsplit(".", 1)[-1])
           for m in members]
    q0 = qcs[0]
    for qc in qcs[1:]:
        if (qc.x_quantizer is not q0.x_quantizer
                or qc.a_out_quantizer is not q0.a_out_quantizer
                or qc.b_out_quantizer is not q0.b_out_quantizer):
            return False
    has_a = [params.get(f"{layer_prefix}.{m}.A") is not None for m in members]
    if any(has_a) != all(has_a):
        return False
    total_n = 0
    for m in members:
        w = params[f"{layer_prefix}.{m}.weight"]
        if w.shape[0] % 16 != 0:
            return False
        total_n += w.shape[0]
        a = params.get(f"{layer_prefix}.{m}.A")
        if a is not None and a.shape[1] % 16 != 0:
            return False
    return total_n % 128 == 0


def _fuse_members(layer_prefix: str, members, params, layer_qcfg):
    """Member weights concatenated along out_features, A along rank, B
    block-diagonally (exact zeros off the diagonal)."""
    full = [f"{layer_prefix}.{m}" for m in members]
    w = torch.cat([params[p + ".weight"] for p in full], dim=0)
    bias = None
    if all(params.get(p + ".bias") is not None for p in full):
        bias = torch.cat([
            models._proj_qcfg(layer_qcfg, m.rsplit(".", 1)[-1]).b_quantizer(
                params[f"{layer_prefix}.{m}.bias"]) for m in members])
    a = b = None
    if params.get(full[0] + ".A") is not None:
        a_list = [params[p + ".A"] for p in full]
        b_list = [params[p + ".B"] for p in full]
        a = torch.cat(a_list, dim=1)
        b = torch.zeros(sum(x.shape[1] for x in a_list),
                        sum(x.shape[1] for x in b_list), dtype=b_list[0].dtype,
                        device=b_list[0].device)
        r0 = n0 = 0
        for ai, bi in zip(a_list, b_list):
            b[r0:r0 + ai.shape[1], n0:n0 + bi.shape[1]] = bi
            r0 += ai.shape[1]
            n0 += bi.shape[1]
    splits = tuple(params[p + ".weight"].shape[0] for p in full)
    return w, a, b, bias, splits


def prepare_serving_params(params: dict, cfg, layer_qcfgs,
                           tile_k: int = TILE_K,
                           fuse_mlp: bool = True) -> dict:
    """Pack every quantized linear: ``{"arrays": {prefix: {codes, exps, a,
    b, bias}}, "meta": {prefix: {fmt, xa_width, out_width[, splits]}}}``.
    ``params`` holds the original (un-PTQ'd) weights; packing runs on their
    device. With ``fuse_mlp`` a layer's whole MLP packs as one megakernel
    entry ``{layer}.mlp_fused`` (``{codes,exps}_{g,u,d}, a_gu, b_g, b_u,
    a_d, b_d``; meta ``kind="mlp"`` and ``act_width``) where
    :func:`_mlp_fusable` allows. A fusable group (q|k|v, gate|up: identical
    activation-side quantizers, see :func:`_fusable`) packs as one entry
    (``{layer}.self_attn.qkv_proj``, ``{layer}.mlp.gateup_proj``); other
    members pack one by one. Llama and OPT (whose ``mlp_fused`` entry is
    the relu variant: no up half, biases ``bias_g``, ``bias_d``) pack
    alike."""
    arrays: dict = {}
    meta: dict = {}
    skipped: list[str] = []

    def pack_one(key, w, a, b, bias, xa_width, out_width, splits=None):
        arrays[key] = prepare_w4_weights(w, a=a, b=b, bias=bias, fmt=MXINT4)
        meta[key] = {"fmt": MXINT4, "xa_width": xa_width,
                     "out_width": out_width}
        if splits is not None:
            meta[key]["splits"] = splits

    arch = models.get_arch_module(cfg)
    for i in range(cfg.num_hidden_layers):
        fused_members: set[str] = set()
        lp = arch.layer_prefix(i)
        if fuse_mlp:
            widths = _mlp_fusable(lp, cfg, params, layer_qcfgs[i], tile_k)
            if widths is not None:
                fused_members |= _pack_mlp(lp, cfg, params, layer_qcfgs[i],
                                           arrays, meta, *widths)
        for fused_rel, member_rels in fuse_groups_for(cfg):
            if any(f"{lp}.{m}" in fused_members for m in member_rels):
                continue
            if not _fusable(lp, member_rels, params, layer_qcfgs[i]):
                continue
            widths = _member_widths(lp, member_rels, params,
                                    layer_qcfgs[i], tile_k)
            if widths is None:
                continue
            w, a, b, bias, splits = _fuse_members(lp, member_rels, params,
                                                  layer_qcfgs[i])
            pack_one(f"{lp}.{fused_rel}", w, a, b, bias, widths[0],
                     widths[1], splits=splits)
            fused_members.update(f"{lp}.{m}" for m in member_rels)
        for prefix, proj in models.quantizable_module_prefixes(cfg, i):
            if prefix in fused_members:
                continue
            w = params[prefix + ".weight"]
            qc = models._proj_qcfg(layer_qcfgs[i], proj)
            a, b = params.get(prefix + ".A"), params.get(prefix + ".B")
            ok, reason, xa_width, out_width = _eligibility(qc, w, a, b, tile_k)
            if not ok:
                skipped.append(prefix)
                if i == 0:
                    logger.info("not packing %s: %s", prefix, reason)
                continue
            bias = params.get(prefix + ".bias")
            if bias is not None:
                bias = qc.b_quantizer(bias)
            pack_one(prefix, w, a, b, bias, xa_width, out_width)
    logger.info("packed %d linears (%d ineligible)", len(meta), len(skipped))
    return {"arrays": arrays, "meta": meta}


def pack_lm_head(backend: dict, params: dict, width: int = 8,
                 embed_key: str | None = None) -> dict:
    """A new backend with the lm_head packed for the W8 dequant-GEMM under
    ``"lm_head"`` (the caller's dicts are not mutated). The weight comes
    from ``params[embed_key]``, else ``lm_head.weight``, else the tied
    ``model.embed_tokens.weight`` (Llama) or
    ``model.decoder.embed_tokens.weight`` (OPT); the vocab is zero-padded to
    a large tile and sliced back in ``decode._lm_head_logits``. A head
    whose vocab is not a multiple of 128 (OPT's 50272) stays dense, as in
    the JAX package: the backend comes back without ``lm_head``."""
    if embed_key is None:
        cands = ("lm_head.weight", "model.embed_tokens.weight",
                 "model.decoder.embed_tokens.weight")
        embed_key = next((c for c in cands if c in params), None)
        if embed_key is None:
            raise KeyError(f"pack_lm_head: params hold none of {cands}")
    w = params[embed_key]
    V, K = w.shape
    out = {"arrays": dict(backend["arrays"]), "meta": dict(backend["meta"])}
    if V % 128 or _pick_tile_k(K, TILE_K) == 0:
        logger.info("lm_head (%d, %d) not tileable; keeping dense", V, K)
        return out
    v_pad, _ = pad_to_tile(V)
    if v_pad != V:
        w = torch.nn.functional.pad(w, (0, 0, 0, v_pad - V))
    fmt = MXFormat(width=width)
    out["arrays"]["lm_head"] = prepare_w4_weights(w, fmt=fmt)
    out["meta"]["lm_head"] = {"fmt": fmt, "xa_width": None, "out_width": None,
                              "n_real": V}
    return out


def layer_prep(prep: dict, layer_index: int | None) -> dict:
    """One layer's operands of a (possibly layer-stacked) prep: zero-copy
    views ``stacked[li]``."""
    if layer_index is None:
        return prep
    return {k: (None if v is None else v[layer_index]) for k, v in prep.items()}


def serving_mlp(x: torch.Tensor, key: str, backend: dict, qc_first, *,
                layer_index: int | None = None) -> torch.Tensor:
    """A layer's whole MLP: quantize the activations with the gate's (fc1's)
    quantizer, then one megakernel launch (fewer than 512 rows) or the
    large-M route; below 512 rows, where :func:`inkernel_x_width` allows,
    the megakernel quantizes the raw activations itself. ``x (b, s,
    hidden)`` → ``(b, s, hidden)`` in x's dtype."""
    prep = layer_prep(backend["arrays"][key], layer_index)
    meta = backend["meta"][key]
    b, s, k = x.shape
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    large = b * s >= _LARGEM_THRESHOLD
    with tracing.MLP["largeM" if large else "kernel"]:
        qxw = inkernel_x_width(qc_first.x_cfg, k)
        if not large and qxw is not None:
            y = mlp_w4_fused(x.reshape(b * s, k), prep, meta["fmt"],
                             quant_x_width=qxw, **kw)
            return y.reshape(b, s, -1).to(x.dtype)
        x_q = qc_first.x_quantizer(x).to(torch.bfloat16).reshape(b * s, k)
        route = mlp_w4_dense_largeM if large else mlp_w4_fused
        y = route(x_q, prep, meta["fmt"], **kw)
        return y.reshape(b, s, -1).to(x.dtype)


def serving_linear(x: torch.Tensor, prefix: str, backend: dict, qc, *,
                   layer_index: int | None = None) -> torch.Tensor:
    """Quantize the activations (exact-in-bf16 MXINT8 values), then run the
    dequant-GEMM kernel (fewer than 512 rows) or the large-M route; below
    512 rows, where :func:`inkernel_x_width` allows, the kernel quantizes
    the raw activations itself. ``x (b, s, in)`` → ``(b, s,
    out)`` in x's dtype."""
    if prefix not in backend["meta"]:
        raise NotImplementedError(
            f"{prefix} is not packed for the kernel (ineligible quantizer "
            "format or shape); decode._lin runs such a linear through the "
            "emulation (ops/qlinear.py::qlinear)")
    prep = layer_prep(backend["arrays"][prefix], layer_index)
    meta = backend["meta"][prefix]
    b, s, k = x.shape
    kw = dict(quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    large = b * s >= _LARGEM_THRESHOLD
    with tracing.LINEAR["largeM" if large else "kernel"]:
        qxw = inkernel_x_width(qc.x_cfg, k)
        if not large and qxw is not None:
            y = qlinear_w4_fused(x.reshape(b * s, k), prep, meta["fmt"],
                                 quant_x_width=qxw, **kw)
            return y.reshape(b, s, -1).to(x.dtype)
        x_q = qc.x_quantizer(x).to(torch.bfloat16).reshape(b * s, k)
        route = qlinear_w4_dense_largeM if large else qlinear_w4_fused
        y = route(x_q, prep, meta["fmt"], **kw)
        return y.reshape(b, s, -1).to(x.dtype)


def serving_linear_split(x: torch.Tensor, fused_prefix: str, backend: dict,
                         qc, *, layer_index: int | None = None) -> list:
    """One launch for a fused group, split back into its members."""
    y = serving_linear(x, fused_prefix, backend, qc, layer_index=layer_index)
    return list(torch.split(y, list(backend["meta"][fused_prefix]["splits"]),
                            dim=-1))
