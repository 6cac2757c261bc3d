"""OPT decoder (port of ``lqer_tpu/models/opt.py``): configuration,
random init, parameter stacking and the full-sequence forward with
quantized ops. Params are a flat
``{hf_name: tensor}`` dict (``model.decoder.layers.N.self_attn.q_proj.weight``
...): learned positions with offset 2 (``embed_positions[pos + 2]``), the
query scaled before QK^T, pre-LN (``do_layer_norm_before``) or post-LN, a
ReLU MLP with biases on every linear, the head tied to ``embed_tokens``."""

from __future__ import annotations

import dataclasses

import torch

from torch.nn.functional import relu

from ..ops.qlinear import promoted_matmul, qlinear
from ..utils import tracing
from .common import (
    causal_mask,
    eager_attention,
    layer_norm,
    merge_heads,
    project_heads,
    randn_init,
    stack_layers,
)


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
    """``{weight, bias, A, B, shard}`` of a module prefix from the flat
    dict (``shard``: a tensor-parallel linear's callable, in
    ``parallel/step.py``'s params views only)."""
    return {k: params.get(f"{prefix}.{k}") for k in ("weight", "bias", "A",
                                                      "B", "shard")}


def decoder_layer(h: torch.Tensor, params: dict, cfg: OPTConfig, i: int,
                  qcfg: dict | None, mask: torch.Tensor, tap=None,
                  backend: dict | None = None) -> torch.Tensor:
    """One OPT decoder layer. ``tap(module_prefix, x)`` receives the input
    of each linear (the profiler's hook). With a ``backend`` every linear
    it packed runs through the kernels (``serving/decode.py::_lin_group``,
    ``_lin``, ``_mlp_fused_or_none``), the others through the emulation;
    without, every linear through ``qlinear``."""
    from .fp_config import FP_LAYER_OPT

    q = qcfg if qcfg is not None else FP_LAYER_OPT
    tap = tap or (lambda name, x: None)
    p = layer_prefix(i)
    attn_cfg = q["attn"]

    residual = h
    if cfg.do_layer_norm_before:
        h = layer_norm(h, _mod(params, f"{p}.self_attn_layer_norm"))
    for proj in ("q_proj", "k_proj", "v_proj"):
        tap(f"{p}.self_attn.{proj}", h)
    if backend is not None:
        from ..serving.decode import _heads, _lin, _lin_group, \
            _mlp_fused_or_none

        qy, ky, vy = _lin_group(
            h, params, p, "self_attn.qkv_proj",
            ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
            (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj), backend)
        qh, kh, vh = (_heads(y, cfg.num_attention_heads)
                      for y in (qy, ky, vy))
    else:
        qh, kh, vh = (
            project_heads(h, _mod(params, f"{p}.self_attn.{proj}"),
                          getattr(attn_cfg, proj), cfg.num_attention_heads)
            for proj in ("q_proj", "k_proj", "v_proj"))
    attn = eager_attention(qh, kh, vh, mask, attn_cfg.qk_matmul,
                           attn_cfg.pv_matmul, scaling=cfg.head_dim ** -0.5,
                           scale_query=True)
    attn = merge_heads(attn)
    tap(f"{p}.self_attn.out_proj", attn)
    if backend is not None:
        attn = _lin(attn, params, f"{p}.self_attn.out_proj",
                    attn_cfg.o_proj, backend)
    else:
        attn = qlinear(attn, _mod(params, f"{p}.self_attn.out_proj"),
                       attn_cfg.o_proj)
    h = residual + attn
    if not cfg.do_layer_norm_before:
        h = layer_norm(h, _mod(params, f"{p}.self_attn_layer_norm"))

    residual = h
    if cfg.do_layer_norm_before:
        h = layer_norm(h, _mod(params, f"{p}.final_layer_norm"))
    tap(f"{p}.fc1", h)
    if backend is not None:
        y = _mlp_fused_or_none(h, p, q["fc1"], backend)
        if y is None:
            y = relu(_lin(h, params, f"{p}.fc1", q["fc1"], backend))
            y = _lin(y, params, f"{p}.fc2", q["fc2"], backend)
        h = y
    else:
        h = relu(qlinear(h, _mod(params, f"{p}.fc1"), q["fc1"]))
        tap(f"{p}.fc2", h)
        h = qlinear(h, _mod(params, f"{p}.fc2"), q["fc2"])
    h = residual + h
    if not cfg.do_layer_norm_before:
        h = layer_norm(h, _mod(params, f"{p}.final_layer_norm"))
    return h


@tracing.annotate(tracing.FORWARD)
def forward(params: dict, input_ids: torch.Tensor, cfg: OPTConfig,
            layer_qcfgs: list | None = None, tap=None,
            return_hidden: bool = False, backend: dict | None = None
            ) -> torch.Tensor:
    """Causal-LM forward over the whole sequence: logits (b, s, vocab), or
    with ``return_hidden`` the final hidden state. ``project_in`` /
    ``project_out`` where the params hold them (OPT-350m)."""
    b, s = input_ids.shape
    embed = params["model.decoder.embed_tokens.weight"]
    with tracing.PROLOGUE:
        h = embed[input_ids]
        if params.get("model.decoder.project_in.weight") is not None:
            h = promoted_matmul(h,
                                params["model.decoder.project_in.weight"].T)
        positions = torch.arange(s, device=h.device) + 2
        h = h + params["model.decoder.embed_positions.weight"][positions]
        mask = causal_mask(s, dtype=h.dtype, device=h.device)
    for i in range(cfg.num_hidden_layers):
        qcfg = layer_qcfgs[i] if layer_qcfgs is not None else None
        with tracing.LAYER:
            h = decoder_layer(h, params, cfg, i, qcfg, mask, tap=tap,
                              backend=backend)
    if params.get("model.decoder.final_layer_norm.weight") is not None:
        h = layer_norm(h, _mod(params, "model.decoder.final_layer_norm"))
    if params.get("model.decoder.project_out.weight") is not None:
        h = promoted_matmul(h, params["model.decoder.project_out.weight"].T)
    if return_hidden:
        return h
    if tap is not None:
        tap("lm_head", h)
    with tracing.HEAD:
        return promoted_matmul(h, params.get("lm_head.weight", embed).T)


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
