"""Model registry, quantizer resolution and the functional "model surgery"
(port of ``lqer_tpu/models/__init__.py``): a quantized model is (arch
config, flat param dict, resolved per-layer quantizer configs);
:func:`prepare_ptq` quantizes its weights once, :func:`load_low_rank_dict`
fills its ``.A``/``.B`` factors, :func:`forward` runs its architecture's
forward and :func:`forward_sequence_classification` its classification
head."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import llama as llama_mod
from . import opt as opt_mod
from .config_expand import (
    LLAMA_ATTN_PROJS,
    LLAMA_MLP_PROJS,
    OPT_ATTN_PROJS,
    OPT_MLP_PROJS,
    resolve_model_configs,
)
from .llama import LlamaConfig
from .opt import OPTConfig

ARCH_MODULES = {"opt": opt_mod, "llama": llama_mod, "mistral": llama_mod}


def _llama(**kw) -> Callable:
    return lambda: LlamaConfig(**kw)


_LLAMA_13B = _llama(hidden_size=5120, intermediate_size=13824,
                    num_hidden_layers=40, num_attention_heads=40)

# model name -> config factory: the JAX package's registry
# (``lqer_tpu/models/__init__.py``), OPT's kept in ``opt.MODEL_CONFIGS``
MODEL_CONFIGS: dict[str, Callable] = {
    **opt_mod.MODEL_CONFIGS,
    "huggyllama/llama-7b": LlamaConfig.llama_7b,
    "huggyllama/llama-13b": _LLAMA_13B,
    "huggyllama/llama-30b": _llama(
        hidden_size=6656, intermediate_size=17920, num_hidden_layers=60,
        num_attention_heads=52),
    "huggyllama/llama-65b": _llama(
        hidden_size=8192, intermediate_size=22016, num_hidden_layers=80,
        num_attention_heads=64),
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0": _llama(
        hidden_size=2048, intermediate_size=5632, num_hidden_layers=22,
        num_attention_heads=32, num_key_value_heads=4,
        max_position_embeddings=2048, rms_norm_eps=1e-5),
    "meta-llama/Llama-2-7b-hf": LlamaConfig.llama_7b,
    "meta-llama/Llama-2-13b-hf": _LLAMA_13B,
    "meta-llama/Llama-2-70b-hf": _llama(
        hidden_size=8192, intermediate_size=28672, num_hidden_layers=80,
        num_attention_heads=64, num_key_value_heads=8,
        max_position_embeddings=4096, rms_norm_eps=1e-5),
    "lmsys/vicuna-7b-v1.5": LlamaConfig.llama_7b,
    "lmsys/vicuna-13b-v1.5": _LLAMA_13B,
    "mistralai/Mistral-7B-v0.1": LlamaConfig.mistral_7b,
    # the reference's Mistral template serves the OpenOrca fine-tune: the
    # same architecture, two more tokens
    "Open-Orca/Mistral-7B-OpenOrca": lambda: dataclasses.replace(
        LlamaConfig.mistral_7b(), vocab_size=32002),
}


def get_model_config(model_name: str):
    if model_name in MODEL_CONFIGS:
        return MODEL_CONFIGS[model_name]()
    raise ValueError(
        f"Unknown model {model_name!r}. Known: {sorted(MODEL_CONFIGS)}")


def get_arch_module(cfg):
    try:
        return ARCH_MODULES[cfg.arch]
    except KeyError:
        raise NotImplementedError(
            f"architecture {cfg.arch!r} is not ported yet") from None


def quantizable_module_prefixes(cfg, layer_idx: int) -> list[tuple[str, str]]:
    """(module_prefix, proj_key) of the quantized linears of one layer."""
    p = get_arch_module(cfg).layer_prefix(layer_idx)
    if cfg.arch == "opt":
        pairs = [(f"{p}.self_attn.{proj}", proj) for proj in OPT_ATTN_PROJS]
        return pairs + [(f"{p}.{proj}", proj) for proj in OPT_MLP_PROJS]
    pairs = [(f"{p}.self_attn.{proj}", proj) for proj in LLAMA_ATTN_PROJS]
    pairs += [(f"{p}.mlp.{proj}", proj) for proj in LLAMA_MLP_PROJS]
    return pairs


def _proj_qcfg(layer_qcfg: dict, proj: str):
    if proj in ("q_proj", "k_proj", "v_proj"):
        return getattr(layer_qcfg["attn"], proj)
    if proj in ("o_proj", "out_proj"):
        return layer_qcfg["attn"].o_proj
    return layer_qcfg[proj]


def quantize_model(cfg, q_config: dict | None, l_config: dict | None):
    """Resolve per-layer quantizer configs (None q_config → FP model)."""
    return resolve_model_configs(cfg.num_hidden_layers, q_config, l_config,
                                 cfg.arch)


def prepare_ptq(params: dict, cfg, layer_qcfgs) -> dict:
    """One-time PTQ weight and bias quantization of every quantized linear
    whose config is ``is_ptq`` (the emulated linear then takes the weights
    as prepared); a new dict, the input left as it is. ``layer_qcfgs``
    None (the unquantized model) returns ``params``."""
    if layer_qcfgs is None:
        return params
    params = dict(params)
    for i in range(cfg.num_hidden_layers):
        for prefix, proj in quantizable_module_prefixes(cfg, i):
            qc = _proj_qcfg(layer_qcfgs[i], proj)
            if not qc.is_ptq:
                continue
            wk, bk = prefix + ".weight", prefix + ".bias"
            params[wk] = qc.w_quantizer(params[wk])
            if params.get(bk) is not None:
                params[bk] = qc.b_quantizer(params[bk])
    return params


def load_low_rank_dict(params: dict, low_rank_dict: dict, dtype=None) -> dict:
    """Fill every ``.A``/``.B`` of ``low_rank_dict`` (numpy arrays or
    tensors) into a new params dict, cast to ``dtype`` when given."""
    params = dict(params)
    for k, v in low_rank_dict.items():
        t = torch.as_tensor(v)
        params[k] = t if dtype is None else t.to(dtype)
    return params


def forward(params, input_ids, cfg, layer_qcfgs=None, tap=None):
    """The architecture's full-sequence forward: logits (b, s, vocab)."""
    return get_arch_module(cfg).forward(params, input_ids, cfg, layer_qcfgs,
                                        tap=tap)


def forward_sequence_classification(params, input_ids, cfg, layer_qcfgs=None,
                                    pad_token_id: int | None = None
                                    ) -> torch.Tensor:
    """Sequence classification over the (quantized) decoder: the bias-free
    ``score`` head (``params["score.weight"]``, (labels, hidden)) over the
    final hidden state of each row's last non-pad token; (b, labels).

    The JAX package's rule picks that token: ``sum(ids != pad) - 1``,
    clamped at 0 (the last position without a pad id, from the argument or
    ``cfg.pad_token_id``). On a left-padded row it differs from HF's
    first-pad-minus-one; the port keeps JAX's rule."""
    from ..ops.qlinear import promoted_matmul

    h = get_arch_module(cfg).forward(params, input_ids, cfg, layer_qcfgs,
                                     return_hidden=True)
    logits = promoted_matmul(h, params["score.weight"].T)   # (b, s, labels)
    pad = pad_token_id if pad_token_id is not None else getattr(
        cfg, "pad_token_id", None)
    b, s = input_ids.shape
    if pad is None:
        last = torch.full((b,), s - 1, device=logits.device)
    else:
        last = ((input_ids != pad).sum(-1) - 1).clamp_min(0)
    return logits[torch.arange(b, device=logits.device), last.to(
        logits.device)]


def init_params(cfg, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> dict:
    """Random-init params of ``cfg``'s architecture drawn from
    ``generator`` (the JAX package's ``init_params`` draws from
    ``jax.random``: the same shapes and scales, other values)."""
    return get_arch_module(cfg).init_params(cfg, generator, dtype, device)


__all__ = ["LlamaConfig", "MODEL_CONFIGS", "OPTConfig", "OPT_ATTN_PROJS",
           "OPT_MLP_PROJS", "forward", "forward_sequence_classification",
           "get_arch_module", "get_model_config",
           "init_params", "load_low_rank_dict", "prepare_ptq",
           "quantize_model", "quantizable_module_prefixes"]
