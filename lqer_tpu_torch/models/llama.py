"""Llama-family configuration (Llama and Mistral), random init and
parameter stacking (port of the parts of ``lqer_tpu/models/llama.py`` the
serving path uses). Params are a flat ``{hf_name: tensor}`` dict
(``model.layers.N.self_attn.q_proj.weight``...)."""

from __future__ import annotations

import dataclasses

import torch

from .common import randn_init, stack_layers


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None  # None -> MHA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    sliding_window: int | None = None  # Mistral
    tie_word_embeddings: bool = False
    arch: str = "llama"

    @property
    def kv_heads(self):
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=None,
             inter=128, max_pos=128, **kw) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, hidden_size=hidden, intermediate_size=inter,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=kv_heads, max_position_embeddings=max_pos, **kw,
        )

    @staticmethod
    def llama_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        """Mistral-7B-v0.1: GQA (8 kv heads), a sliding window as long as
        its positions."""
        return LlamaConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=4096,
            rms_norm_eps=1e-5, sliding_window=4096, arch="mistral")


def layer_prefix(i: int) -> str:
    return f"model.layers.{i}"


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> dict:
    """Random-init params (offline tests, no checkpoint): weights normal
    at scale 0.02 drawn from ``generator`` in the JAX package's order,
    norms one; the head apart unless ``tie_word_embeddings``."""
    randn = randn_init(generator, dtype, device)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    kv_dim = cfg.kv_heads * cfg.head_dim

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    params = {"model.embed_tokens.weight": randn((cfg.vocab_size, h)),
              "model.norm.weight": ones(h)}
    if not cfg.tie_word_embeddings:
        params["lm_head.weight"] = randn((cfg.vocab_size, h))
    for i in range(cfg.num_hidden_layers):
        p = layer_prefix(i)
        for rel, shape in (("self_attn.q_proj", (h, h)),
                           ("self_attn.k_proj", (kv_dim, h)),
                           ("self_attn.v_proj", (kv_dim, h)),
                           ("self_attn.o_proj", (h, h)),
                           ("mlp.gate_proj", (inter, h)),
                           ("mlp.up_proj", (inter, h)),
                           ("mlp.down_proj", (h, inter))):
            params[f"{p}.{rel}.weight"] = randn(shape)
        params[f"{p}.input_layernorm.weight"] = ones(h)
        params[f"{p}.post_attention_layernorm.weight"] = ones(h)
    return params


LAYER_REL_KEYS = (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
    "input_layernorm", "post_attention_layernorm",
)


def stack_layer_params(params: dict, cfg: LlamaConfig) -> tuple[dict, dict]:
    """Per-layer params → ``(stacked {rel.suffix: (L, ...)}, rest)``;
    ``rest`` holds embeddings, the final norm and the head."""
    return stack_layers(params, cfg.num_hidden_layers, layer_prefix,
                        LAYER_REL_KEYS)
