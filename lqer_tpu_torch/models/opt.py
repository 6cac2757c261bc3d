"""OPT configuration, random init and parameter stacking (port of the
parts of ``lqer_tpu/models/opt.py`` the serving path uses). Params are a flat
``{hf_name: tensor}`` dict (``model.decoder.layers.N.self_attn.q_proj.weight``
...): learned positions with offset 2 (``embed_positions[pos + 2]``), the
query scaled before QK^T, pre-LN (``do_layer_norm_before``) or post-LN, a
ReLU MLP with biases on every linear, the head tied to ``embed_tokens``."""

from __future__ import annotations

import dataclasses

import torch

from .common import randn_init, stack_layers


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    enable_bias: bool = True
    layer_norm_elementwise_affine: bool = True
    pad_token_id: int = 1
    # OPT-350m: embeddings live in a smaller space with project_in/out
    # linears around the decoder stack (HF ``word_embed_proj_dim``)
    word_embed_proj_dim: int | None = None
    arch: str = "opt"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self):
        return self.num_attention_heads   # MHA

    @property
    def embed_dim(self):
        return self.word_embed_proj_dim or self.hidden_size

    @staticmethod
    def tiny(vocab_size: int = 512, hidden: int = 64, layers: int = 2,
             heads: int = 4, ffn: int = 128, max_pos: int = 128,
             **kw) -> "OPTConfig":
        return OPTConfig(
            vocab_size=vocab_size, hidden_size=hidden, ffn_dim=ffn,
            num_hidden_layers=layers, num_attention_heads=heads,
            max_position_embeddings=max_pos, **kw,
        )


# The JAX package's registry entries (``lqer_tpu/models/__init__.py``)
MODEL_CONFIGS = {
    "facebook/opt-125m": OPTConfig,
    "facebook/opt-350m": lambda: OPTConfig(
        hidden_size=1024, ffn_dim=4096, num_hidden_layers=24,
        num_attention_heads=16, do_layer_norm_before=False,
        word_embed_proj_dim=512),
    "facebook/opt-1.3b": lambda: OPTConfig(
        hidden_size=2048, ffn_dim=8192, num_hidden_layers=24,
        num_attention_heads=32),
    "facebook/opt-2.7b": lambda: OPTConfig(
        hidden_size=2560, ffn_dim=10240, num_hidden_layers=32,
        num_attention_heads=32),
    "facebook/opt-6.7b": lambda: OPTConfig(
        hidden_size=4096, ffn_dim=16384, num_hidden_layers=32,
        num_attention_heads=32),
    "facebook/opt-13b": lambda: OPTConfig(
        hidden_size=5120, ffn_dim=20480, num_hidden_layers=40,
        num_attention_heads=40),
    "facebook/opt-30b": lambda: OPTConfig(
        hidden_size=7168, ffn_dim=28672, num_hidden_layers=48,
        num_attention_heads=56),
}


def layer_prefix(i: int) -> str:
    return f"model.decoder.layers.{i}"


def init_params(cfg: OPTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> dict:
    """Random-init params (offline tests, no checkpoint): weights and
    positions normal at scale 0.02 drawn from ``generator`` in the JAX
    package's order, biases zero, LayerNorms weight one and bias zero;
    ``project_in``/``project_out`` where ``embed_dim`` differs from the
    hidden size; the head tied to the embedding."""
    randn = randn_init(generator, dtype, device)
    h, f, e = cfg.hidden_size, cfg.ffn_dim, cfg.embed_dim

    def const(n, v):
        return torch.full((n,), float(v), dtype=dtype, device=device)

    params = {"model.decoder.embed_tokens.weight": randn((cfg.vocab_size, e)),
              "model.decoder.embed_positions.weight": randn(
                  (cfg.max_position_embeddings + 2, h))}
    if e != h:
        params["model.decoder.project_in.weight"] = randn((h, e))
        params["model.decoder.project_out.weight"] = randn((e, h))
    if cfg.do_layer_norm_before:
        params["model.decoder.final_layer_norm.weight"] = const(h, 1)
        params["model.decoder.final_layer_norm.bias"] = const(h, 0)
    for i in range(cfg.num_hidden_layers):
        p = layer_prefix(i)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            params[f"{p}.self_attn.{proj}.weight"] = randn((h, h))
            params[f"{p}.self_attn.{proj}.bias"] = const(h, 0)
        params[f"{p}.fc1.weight"] = randn((f, h))
        params[f"{p}.fc1.bias"] = const(f, 0)
        params[f"{p}.fc2.weight"] = randn((h, f))
        params[f"{p}.fc2.bias"] = const(h, 0)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            params[f"{p}.{ln}.weight"] = const(h, 1)
            params[f"{p}.{ln}.bias"] = const(h, 0)
    return params


def _mod(params: dict, prefix: str) -> dict:
    """``{weight, bias, A, B}`` of a module prefix from the flat dict."""
    return {k: params.get(f"{prefix}.{k}") for k in ("weight", "bias", "A",
                                                      "B")}


LAYER_REL_KEYS = (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "self_attn.out_proj", "fc1", "fc2",
    "self_attn_layer_norm", "final_layer_norm",
)


def stack_layer_params(params: dict, cfg: OPTConfig) -> tuple[dict, dict]:
    """Per-layer params → ``(stacked {rel.suffix: (L, ...)}, rest)``;
    ``rest`` holds the embeddings, the final norm and
    ``project_in``/``project_out``."""
    return stack_layers(params, cfg.num_hidden_layers, layer_prefix,
                        LAYER_REL_KEYS)
