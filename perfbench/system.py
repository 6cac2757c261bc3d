"""The system under test, built from a configuration and a seed: the
port's model configuration, its per-layer quantizer configs for the
recipe, and the kernel backend packed layer by layer from the benchmark's
own draws (``weights.py``) through
``lqer_tpu_torch.serving.kernel_backend.prepare_serving_params``, as the
port's ``random_model.build_random_model`` packs (each MLP whole, for the
megakernel). Each layer's f32 draws are freed once packed."""

from __future__ import annotations

import dataclasses

from . import weights
from .spec import ModelSpec


def _q(width: int, skip: bool) -> dict:
    return {"name": "block_fp", "width": width, "exponent_width": 8,
            "exponent_bias": None, "block_size": [1, 16],
            "skip_first_dim": skip}


def q_config(spec: ModelSpec) -> dict:
    """The recipe as the program's q_config: MXINT4 weights, MXINT8
    activations and biases; the attention matmuls' q and P at width 8, K
    and V at the cache's width (OPT names them ``bmm``)."""
    linear = {"name": "flexible_lqer", "is_ptq": True,
              "x_quantizer": _q(8, True), "w_quantizer": _q(4, False),
              "b_quantizer": _q(8, False)}
    matmul = {"name": "flexible", "x_quantizer": _q(8, True),
              "w_quantizer": _q(spec.kv_width, True)}
    return {"linear": linear, "bmm" if spec.arch == "opt" else "matmul": matmul}


def model_config(spec: ModelSpec):
    """The port's ``LlamaConfig`` (Llama, Mistral) or ``OPTConfig``."""
    if spec.arch == "opt":
        from lqer_tpu_torch.models.opt import OPTConfig

        return OPTConfig(
            vocab_size=spec.vocab, hidden_size=spec.hidden,
            ffn_dim=spec.inter, num_hidden_layers=spec.layers,
            num_attention_heads=spec.heads,
            max_position_embeddings=spec.max_pos,
            do_layer_norm_before=spec.raw.get("do_layer_norm_before", True),
            word_embed_proj_dim=spec.raw.get("word_embed_proj_dim"))
    from lqer_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=spec.vocab, hidden_size=spec.hidden,
        intermediate_size=spec.inter, num_hidden_layers=spec.layers,
        num_attention_heads=spec.heads, num_key_value_heads=spec.kv_heads,
        max_position_embeddings=spec.max_pos, rms_norm_eps=spec.eps,
        rope_theta=spec.theta, sliding_window=spec.window,
        tie_word_embeddings=spec.tied_head, arch=spec.arch)


def build(spec: ModelSpec, seed: int, device):
    """``(cfg, params, backend, layer_qcfgs)``: params hold the
    embeddings, norms and (untied) head; every linear lives in the
    backend."""
    from lqer_tpu_torch import models
    from lqer_tpu_torch.serving.kernel_backend import prepare_serving_params

    cfg = model_config(spec)
    qcfgs = models.quantize_model(cfg, q_config(spec),
                                  {"linear": {"rank": spec.rank}})
    one = dataclasses.replace(cfg, num_hidden_layers=1)
    p0 = weights.layer_prefix(spec, 0)
    params = weights.non_layer(spec, seed, device)
    arrays, meta = {}, {}
    for i in range(spec.layers):
        p = weights.layer_prefix(spec, i)
        params.update(weights.layer_norms(spec, i, device))
        flat = weights.flat_layer(weights.layer(spec, seed, i, device), p0)
        packed = prepare_serving_params(flat, one, [qcfgs[i]], fuse_mlp=True)
        del flat
        arrays.update({k.replace(p0, p, 1): v
                       for k, v in packed["arrays"].items()})
        meta.update({k.replace(p0, p, 1): v
                     for k, v in packed["meta"].items()})
    return cfg, params, {"arrays": arrays, "meta": meta}, qcfgs
