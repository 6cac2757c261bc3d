"""Model construction from a pipeline config (port of the part of
``lqer_tpu/runners.py`` the serving CLI uses): the arch config from
``model_name`` or a ``[model]`` section, and the params from a local
checkpoint or, without one, a seeded random init."""

from __future__ import annotations

import torch

from . import models
from .models.checkpoint import load_hf_pretrained, resolve_model_source
from .utils import get_logger

logger = get_logger("runners")

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def _get_dtype(name: str | None, default: str = "float32"):
    return _DTYPES[name or default]


def build_model_config(config: dict):
    """Arch config from ``model_name``, or from a ``[model]`` section
    (``arch`` and the config's fields: tiny offline models)."""
    m = config.get("model")
    if m:
        arch = m.get("arch", "opt")
        kwargs = {k: v for k, v in m.items() if k != "arch"}
        if arch == "opt":
            return models.OPTConfig(**kwargs)
        return models.LlamaConfig(arch=arch, **kwargs)
    return models.get_model_config(config["model_name"])


def build_params(config: dict, cfg, dtype=torch.float32) -> dict:
    """Params from the local checkpoint of ``model_name`` (``model_dir``,
    or the local HF hub cache), else random init from a
    ``torch.Generator`` seeded with ``init_seed`` (the JAX package seeds
    ``jax.random``: the same shapes, other values). On the CPU."""
    src = resolve_model_source(config["model_name"], config.get("model_dir"))
    if src is not None:
        logger.info("Loading pretrained params from %s", src)
        raw = load_hf_pretrained(src)
        return {k: torch.as_tensor(v).to(dtype) for k, v in raw.items()}
    seed = int(config.get("init_seed", 0))
    logger.warning(
        "No local checkpoint for %s — using random init (seed=%d). "
        "Set `model_dir` in the config to load real weights.",
        config["model_name"], seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return models.init_params(cfg, gen, dtype)
