"""Seeded random Llama, Mistral and OPT weights at any registry width and
correction rank, packed layer by layer on the device (port of
``experiments/bench_e2e_llama7b.py::build_7b_backend_and_params``).

Each layer's fp32 weights (and bf16-exact rank-``rank`` A/B factors) are
drawn on the device from a ``torch.Generator`` seeded with
``seed * 1000 + layer``, packed into the kernel backend (by default as the
JAX package packs: each MLP whole, for the megakernel; ``fuse_mlp=False``
packs Llama's gate|up and down for kernel 1) and freed, so only
one layer's fp32 weights exist at a time; :func:`build_random_dense_model`
keeps the same weights dense instead, for the emulated linears. The returned params keep the
embeddings, the norms and nothing else: every linear is served from the
backend, and the head is the tied embedding (``pack_lm_head``; OPT's
stays dense). An OPT layer's linears carry biases of scale 0.02 (the JAX
package's ``init_params`` zeroes them, which would leave every bias path
untested), its LayerNorms weight 1 and bias 0, and its embeddings are
bf16 (a bf16 residual stream, as a half-precision checkpoint gives).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import models
from ..device import resolve_device
from .kernel_backend import prepare_serving_params


def _q(width, block, skip):
    return {"name": "block_fp", "width": width, "exponent_width": 8,
            "exponent_bias": None, "block_size": block, "skip_first_dim": skip}


# W4A8 L²QER: MXINT4 weights, MXINT8 activations and attention operands
Q_CONFIG = {
    "linear": {
        "name": "flexible_lqer", "is_ptq": True,
        "x_quantizer": _q(8, [1, 16], True),
        "w_quantizer": _q(4, [1, 16], False),
        "b_quantizer": _q(8, [1, 16], False),
    },
    "matmul": {"name": "flexible", "x_quantizer": _q(8, [1, 16], True),
               "w_quantizer": _q(8, [1, 16], True)},
}

# The same linears with KV4 attention: q and p at width 8, K and V at width
# 4, the write grid of the MXINT4 cache (the JAX package's
# tests/test_kv4_cache.py::_kv4_qconfig). The linears pack identically.
KV4_Q_CONFIG = {
    "linear": Q_CONFIG["linear"],
    "matmul": {"name": "flexible", "x_quantizer": _q(8, [1, 16], True),
               "w_quantizer": _q(4, [1, 16], True)},
}


def q_config_for(cfg, kv4: bool = False) -> dict:
    """:data:`Q_CONFIG` (or :data:`KV4_Q_CONFIG`) under the architecture's
    keys: OPT names its attention matmuls ``bmm``."""
    q = KV4_Q_CONFIG if kv4 else Q_CONFIG
    if cfg.arch == "opt":
        return {"linear": q["linear"], "bmm": q["matmul"]}
    return q


def layer_shapes(cfg) -> dict:
    h = cfg.hidden_size
    if cfg.arch == "opt":
        return {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h),
                "self_attn.v_proj": (h, h), "self_attn.out_proj": (h, h),
                "fc1": (cfg.ffn_dim, h), "fc2": (h, cfg.ffn_dim)}
    inter = cfg.intermediate_size
    kv = cfg.kv_heads * cfg.head_dim
    return {"self_attn.q_proj": (h, h), "self_attn.k_proj": (kv, h),
            "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, h),
            "mlp.gate_proj": (inter, h), "mlp.up_proj": (inter, h),
            "mlp.down_proj": (h, inter)}


def _non_layer_params(cfg, gen, dev) -> dict:
    """Embeddings and final norm (the Llama embedding in f32, OPT's
    embeddings and norm in bf16)."""
    h = cfg.hidden_size
    if cfg.arch != "opt":
        return {"model.embed_tokens.weight": torch.randn(
                    cfg.vocab_size, h, generator=gen, device=dev) * 0.02,
                "model.norm.weight": torch.ones(h, device=dev)}
    bf = torch.bfloat16
    out = {"model.decoder.embed_tokens.weight": (torch.randn(
               cfg.vocab_size, cfg.embed_dim, generator=gen, device=dev)
               * 0.02).to(bf),
           "model.decoder.embed_positions.weight": (torch.randn(
               cfg.max_position_embeddings + 2, h, generator=gen,
               device=dev) * 0.02).to(bf)}
    if cfg.embed_dim != h:
        out["model.decoder.project_in.weight"] = (torch.randn(
            h, cfg.embed_dim, generator=gen, device=dev) * 0.02).to(bf)
        out["model.decoder.project_out.weight"] = (torch.randn(
            cfg.embed_dim, h, generator=gen, device=dev) * 0.02).to(bf)
    if cfg.do_layer_norm_before:
        out["model.decoder.final_layer_norm.weight"] = torch.ones(
            h, dtype=bf, device=dev)
        out["model.decoder.final_layer_norm.bias"] = torch.zeros(
            h, dtype=bf, device=dev)
    return out


def _layer_norms(cfg, prefix, dev) -> dict:
    h = cfg.hidden_size
    if cfg.arch != "opt":
        return {f"{prefix}.{n}.weight": torch.ones(h, device=dev)
                for n in ("input_layernorm", "post_attention_layernorm")}
    out = {}
    for n in ("self_attn_layer_norm", "final_layer_norm"):
        out[f"{prefix}.{n}.weight"] = torch.ones(h, dtype=torch.bfloat16,
                                                 device=dev)
        out[f"{prefix}.{n}.bias"] = torch.zeros(h, dtype=torch.bfloat16,
                                                device=dev)
    return out


def _layer_weights(cfg, prefix: str, rank: int, gen, dev) -> dict:
    """One layer's linears drawn from ``gen``: fp32 weights of scale 0.01,
    OPT's biases of scale 0.02, and bf16-exact rank-``rank`` A/B factors
    of scale 0.01."""
    layer = {}
    for rel, (o, ic) in sorted(layer_shapes(cfg).items()):
        layer[f"{prefix}.{rel}.weight"] = torch.randn(
            o, ic, generator=gen, device=dev) * 0.01
        if cfg.arch == "opt":
            layer[f"{prefix}.{rel}.bias"] = torch.randn(
                o, generator=gen, device=dev) * 0.02
        if rank > 0:
            for name, shape in (("A", (ic, rank)), ("B", (rank, o))):
                layer[f"{prefix}.{rel}.{name}"] = (torch.randn(
                    *shape, generator=gen, device=dev) * 0.01).to(
                    torch.bfloat16).to(torch.float32)
    return layer


def build_random_model(cfg, rank: int = 32, seed: int = 0, device="cuda",
                       fuse_mlp: bool = True):
    """``(backend, params, layer_qcfgs)`` for ``cfg`` (Llama, Mistral: GQA
    k/v widths from ``cfg.kv_heads``, or OPT) with random weights at
    correction rank ``rank`` (the reference's templates use 128);
    ``rank=0`` leaves out the low-rank correction."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = _non_layer_params(cfg, gen, dev)
    qcfgs = models.quantize_model(cfg, q_config_for(cfg),
                                  {"linear": {"rank": rank}})
    one_layer = dataclasses.replace(cfg, num_hidden_layers=1)
    arch = models.get_arch_module(cfg)
    p0 = arch.layer_prefix(0)
    arrays, meta = {}, {}
    for i in range(cfg.num_hidden_layers):
        p = arch.layer_prefix(i)
        params.update(_layer_norms(cfg, p, dev))
        gen.manual_seed(seed * 1000 + i)
        layer = _layer_weights(cfg, p0, rank, gen, dev)
        packed = prepare_serving_params(layer, one_layer, [qcfgs[i]],
                                        fuse_mlp=fuse_mlp)
        del layer
        arrays.update({k.replace(p0, p, 1): v
                       for k, v in packed["arrays"].items()})
        meta.update({k.replace(p0, p, 1): v for k, v in packed["meta"].items()})
    return {"arrays": arrays, "meta": meta}, params, qcfgs


def build_random_dense_model(cfg, rank: int = 32, seed: int = 0,
                             device="cuda"):
    """``(params, layer_qcfgs)``: the dense counterpart of
    :func:`build_random_model` with the same arguments, the same draws from
    the same seeds (so ``prepare_serving_params`` of these params packs its
    backend), every linear's fp32 weight and A/B factors kept in
    ``params``, unprepared (``models.prepare_ptq`` quantizes them for the
    emulated linears)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = _non_layer_params(cfg, gen, dev)
    qcfgs = models.quantize_model(cfg, q_config_for(cfg),
                                  {"linear": {"rank": rank}})
    arch = models.get_arch_module(cfg)
    for i in range(cfg.num_hidden_layers):
        p = arch.layer_prefix(i)
        params.update(_layer_norms(cfg, p, dev))
        gen.manual_seed(seed * 1000 + i)
        params.update(_layer_weights(cfg, p, rank, gen, dev))
    return params, qcfgs
