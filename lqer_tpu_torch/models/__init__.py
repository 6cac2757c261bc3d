"""Model registry and quantizer resolution (port of the parts of
``lqer_tpu/models/__init__.py`` the serving path uses)."""

from __future__ import annotations

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

ARCH_MODULES = {"opt": opt_mod, "llama": llama_mod}


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


__all__ = ["LlamaConfig", "OPTConfig", "OPT_ATTN_PROJS", "OPT_MLP_PROJS",
           "get_arch_module", "quantize_model",
           "quantizable_module_prefixes"]
