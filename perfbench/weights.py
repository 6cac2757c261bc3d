"""The seeded random weights of a configuration, drawn on the device.

A frozen copy of the scheme of ``lqer_tpu_torch/serving/random_model.py``
(itself a copy of the JAX ``bench_e2e_llama7b.py`` one): layer ``i``'s
linears are drawn from a ``torch.Generator`` seeded with
``seed * 1000 + i``, in the sorted order of their names: each weight
``randn(out, in) * 0.01`` in f32, OPT's bias ``randn(out) * 0.02``, then
the rank-``r`` factors ``A (in, r)`` and ``B (r, out)`` at scale 0.01,
rounded to bf16 (the kernels take them as bf16). The embeddings (and the
separate head of an untied configuration) come from the generator seeded
with ``seed``, at scale 0.02: in f32 for Llama and Mistral, in bf16 for
OPT, whose positions table and LayerNorms (weight 1, bias 0) are bf16 too.
Norm weights are one.

The benchmark builds the program's model from these draws and the
reference draws them again: neither takes the other's tensors."""

from __future__ import annotations

import torch

from .spec import ModelSpec

SCALES = {"linear": 0.01, "bias": 0.02, "factor": 0.01, "embedding": 0.02}


def _scale(spec: ModelSpec, key: str) -> float:
    """A draw's scale: the configuration's ``init`` entry, else the
    scheme's."""
    return spec.raw.get("init", {}).get(key, SCALES[key])


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def non_layer(spec: ModelSpec, seed: int, device) -> dict:
    """Embeddings, the final norm and (untied) the head, under the
    program's parameter names."""
    g = _gen(device, seed)
    h, v = spec.hidden, spec.vocab
    e = _scale(spec, "embedding")
    if spec.arch != "opt":
        out = {"model.embed_tokens.weight":
               torch.randn(v, h, generator=g, device=device) * e,
               "model.norm.weight": torch.ones(h, device=device)}
        if not spec.tied_head:
            out["lm_head.weight"] = torch.randn(
                v, h, generator=g, device=device) * e
        return out
    bf = torch.bfloat16
    return {
        "model.decoder.embed_tokens.weight": (torch.randn(
            v, h, generator=g, device=device) * e).to(bf),
        "model.decoder.embed_positions.weight": (torch.randn(
            spec.max_pos + 2, h, generator=g, device=device) * e).to(bf),
        "model.decoder.final_layer_norm.weight": torch.ones(
            h, dtype=bf, device=device),
        "model.decoder.final_layer_norm.bias": torch.zeros(
            h, dtype=bf, device=device)}


def layer_prefix(spec: ModelSpec, i: int) -> str:
    return (f"model.decoder.layers.{i}" if spec.arch == "opt"
            else f"model.layers.{i}")


def layer_norms(spec: ModelSpec, i: int, device) -> dict:
    p, h = layer_prefix(spec, i), spec.hidden
    if spec.arch != "opt":
        return {f"{p}.{n}.weight": torch.ones(h, device=device)
                for n in ("input_layernorm", "post_attention_layernorm")}
    out = {}
    for n in ("self_attn_layer_norm", "final_layer_norm"):
        out[f"{p}.{n}.weight"] = torch.ones(h, dtype=torch.bfloat16,
                                            device=device)
        out[f"{p}.{n}.bias"] = torch.zeros(h, dtype=torch.bfloat16,
                                           device=device)
    return out


def layer(spec: ModelSpec, seed: int, i: int, device) -> dict:
    """Layer ``i``'s linears as ``{rel: {"weight", "bias", "A", "B"}}``
    (``bias`` only for OPT)."""
    g = _gen(device, seed * 1000 + i)
    w, b, f = (_scale(spec, k) for k in ("linear", "bias", "factor"))
    out = {}
    for rel, (o, ic) in sorted(spec.linear_shapes().items()):
        d = {"weight": torch.randn(o, ic, generator=g, device=device) * w}
        if spec.arch == "opt":
            d["bias"] = torch.randn(o, generator=g, device=device) * b
        if spec.rank > 0:
            for name, shape in (("A", (ic, spec.rank)),
                                ("B", (spec.rank, o))):
                d[name] = (torch.randn(*shape, generator=g, device=device)
                           * f).to(torch.bfloat16).to(torch.float32)
        out[rel] = d
    return out


def flat_layer(drawn: dict, prefix: str) -> dict:
    """``layer``'s draws under flat names ``{prefix}.{rel}.{suffix}``."""
    return {f"{prefix}.{rel}.{k}": t for rel, d in drawn.items()
            for k, t in d.items()}
