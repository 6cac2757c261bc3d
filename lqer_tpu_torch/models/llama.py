"""Llama-family decoder (Llama and Mistral; port of
``lqer_tpu/models/llama.py``): configuration, random init, parameter
stacking and the full-sequence forward with quantized ops (RMSNorm, HF
rotary, GQA through ``repeat_kv`` before the quantized matmuls, Mistral's
sliding window in the additive mask, the SiLU-gated MLP). Params are a
flat ``{hf_name: tensor}`` dict (``model.layers.N.self_attn.q_proj.weight``
...)."""

from __future__ import annotations

import dataclasses

import torch

from torch.nn.functional import silu

from ..ops.qlinear import promoted_matmul, qlinear
from ..utils import tracing
from .common import (
    apply_rotary,
    causal_mask,
    eager_attention,
    fused_quantized_attention,
    merge_heads,
    project_heads,
    randn_init,
    repeat_kv,
    rms_norm,
    rotary_tables,
    stack_layers,
    supports_fused_attention,
)


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


def _mod(params: dict, prefix: str) -> dict:
    """``{weight, bias, A, B, shard}`` of a module prefix from the flat
    dict (``shard``: a tensor-parallel linear's callable, in
    ``parallel/step.py``'s params views only)."""
    return {k: params.get(f"{prefix}.{k}") for k in ("weight", "bias", "A",
                                                      "B", "shard")}


def _sliding_window_mask(s: int, window: int, dtype, device=None
                         ) -> torch.Tensor:
    """(1, 1, s, s) additive mask: a query sees the ``window`` keys up to
    and including itself."""
    q_idx = torch.arange(s, device=device)[:, None]
    k_idx = torch.arange(s, device=device)[None, :]
    ok = (k_idx <= q_idx) & (k_idx > q_idx - window)
    mask = torch.where(ok, 0.0, torch.finfo(dtype).min)
    return mask.to(dtype)[None, None]


def _masks(cfg: LlamaConfig, s: int, dtype, device):
    """The sequence's additive mask and whether it is the sliding one."""
    sliding = cfg.sliding_window is not None and s > cfg.sliding_window
    if sliding:
        return _sliding_window_mask(s, cfg.sliding_window, dtype,
                                    device), True
    return causal_mask(s, dtype=dtype, device=device), False


def decoder_layer(h: torch.Tensor, params: dict, cfg: LlamaConfig, i: int,
                  qcfg: dict | None, mask: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, positions: torch.Tensor, tap=None,
                  fused_attention: bool = False,
                  backend: dict | None = None) -> torch.Tensor:
    """One Llama decoder layer. ``tap(module_prefix, x)`` receives the
    input of each linear (the profiler's hook). With a ``backend`` every
    linear it packed runs through the kernels (``serving/decode.py::
    _lin_group``, ``_lin``, ``_mlp_fused_or_none``), the others through
    the emulation; with ``fused_attention`` the attention runs through the
    prefill kernel (``common.fused_quantized_attention``), otherwise
    eagerly."""
    from .fp_config import FP_LAYER_LLAMA

    q = qcfg if qcfg is not None else FP_LAYER_LLAMA
    tap = tap or (lambda name, x: None)
    p = layer_prefix(i)
    attn_cfg = q["attn"]

    residual = h
    h = rms_norm(h, _mod(params, f"{p}.input_layernorm"), cfg.rms_norm_eps)
    for proj in ("q_proj", "k_proj", "v_proj"):
        tap(f"{p}.self_attn.{proj}", h)
    if backend is not None:
        from ..serving.decode import _heads, _lin, _lin_group, \
            _mlp_fused_or_none

        qy, ky, vy = _lin_group(
            h, params, p, "self_attn.qkv_proj",
            ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
            (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj), backend)
        qh = _heads(qy, cfg.num_attention_heads)
        kh = _heads(ky, cfg.kv_heads)
        vh = _heads(vy, cfg.kv_heads)
    else:
        qh = project_heads(h, _mod(params, f"{p}.self_attn.q_proj"),
                           attn_cfg.q_proj, cfg.num_attention_heads)
        kh = project_heads(h, _mod(params, f"{p}.self_attn.k_proj"),
                           attn_cfg.k_proj, cfg.kv_heads)
        vh = project_heads(h, _mod(params, f"{p}.self_attn.v_proj"),
                           attn_cfg.v_proj, cfg.kv_heads)
    qh, kh = apply_rotary(qh, kh, cos, sin, positions)
    n_rep = cfg.num_attention_heads // cfg.kv_heads
    kh = repeat_kv(kh, n_rep)
    vh = repeat_kv(vh, n_rep)
    if fused_attention:
        attn = fused_quantized_attention(qh, kh, vh, attn_cfg,
                                         scaling=cfg.head_dim ** -0.5)
    else:
        attn = eager_attention(qh, kh, vh, mask, attn_cfg.qk_matmul,
                               attn_cfg.pv_matmul,
                               scaling=cfg.head_dim ** -0.5)
    attn = merge_heads(attn)
    tap(f"{p}.self_attn.o_proj", attn)
    if backend is not None:
        attn = _lin(attn, params, f"{p}.self_attn.o_proj", attn_cfg.o_proj,
                    backend)
    else:
        attn = qlinear(attn, _mod(params, f"{p}.self_attn.o_proj"),
                       attn_cfg.o_proj)
    h = residual + attn

    residual = h
    h = rms_norm(h, _mod(params, f"{p}.post_attention_layernorm"),
                 cfg.rms_norm_eps)
    tap(f"{p}.mlp.gate_proj", h)
    tap(f"{p}.mlp.up_proj", h)
    if backend is not None:
        y = _mlp_fused_or_none(h, p, q["gate_proj"], backend)
        if y is None:
            gate, up = _lin_group(h, params, p, "mlp.gateup_proj",
                                  ("mlp.gate_proj", "mlp.up_proj"),
                                  (q["gate_proj"], q["up_proj"]), backend)
            y = _lin(silu(gate) * up, params, f"{p}.mlp.down_proj",
                     q["down_proj"], backend)
        return residual + y
    gate = qlinear(h, _mod(params, f"{p}.mlp.gate_proj"), q["gate_proj"])
    up = qlinear(h, _mod(params, f"{p}.mlp.up_proj"), q["up_proj"])
    h = silu(gate) * up
    tap(f"{p}.mlp.down_proj", h)
    h = qlinear(h, _mod(params, f"{p}.mlp.down_proj"), q["down_proj"])
    return residual + h


@tracing.annotate(tracing.FORWARD)
def forward(params: dict, input_ids: torch.Tensor, cfg: LlamaConfig,
            layer_qcfgs: list | None = None, tap=None,
            fused_attention: bool = False, return_hidden: bool = False,
            backend: dict | None = None) -> torch.Tensor:
    """Causal-LM forward over the whole sequence: logits (b, s, vocab), or
    with ``return_hidden`` the final hidden state; the head tied to the
    embedding when the params hold no ``lm_head.weight``.
    ``fused_attention`` takes effect only where the prefill kernel
    applies: a causal mask (no sliding window within ``s``) and every
    layer's attention in its format (``supports_fused_attention``)."""
    b, s = input_ids.shape
    embed = params["model.embed_tokens.weight"]
    with tracing.PROLOGUE:
        h = embed[input_ids]
        cos, sin = rotary_tables(cfg.head_dim,
                                 max(s, cfg.max_position_embeddings),
                                 cfg.rope_theta, device=h.device)
        positions = torch.arange(s, device=h.device)
        mask, sliding = _masks(cfg, s, h.dtype, h.device)
    if fused_attention:
        fused_attention = (not sliding and layer_qcfgs is not None and all(
            supports_fused_attention(qc["attn"]) for qc in layer_qcfgs))
    for i in range(cfg.num_hidden_layers):
        qcfg = layer_qcfgs[i] if layer_qcfgs is not None else None
        with tracing.LAYER:
            h = decoder_layer(h, params, cfg, i, qcfg, mask, cos, sin,
                              positions, tap=tap,
                              fused_attention=fused_attention,
                              backend=backend)
    h = rms_norm(h, _mod(params, "model.norm"), cfg.rms_norm_eps)
    if return_hidden:
        return h
    if tap is not None:
        tap("lm_head", h)
    with tracing.HEAD:
        return promoted_matmul(h, params.get("lm_head.weight", embed).T)


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


def forward_scan(params: dict, input_ids: torch.Tensor, cfg: LlamaConfig,
                 layer_qcfg: dict | list | None = None,
                 stacked: dict | None = None, rest: dict | None = None
                 ) -> torch.Tensor:
    """:func:`forward` over layer-stacked params (the JAX package's
    ``lax.scan``): each layer reads its zero-copy views ``stacked[rel][li]``.
    ``layer_qcfg`` is one resolved layer config for every layer, or the
    per-layer list. Pass ``(stacked, rest)`` from :func:`stack_layer_params`
    to stack once."""
    if stacked is None or rest is None:
        stacked, rest = stack_layer_params(params, cfg)
    view = dict(rest)
    for key, t in stacked.items():
        for li in range(cfg.num_hidden_layers):
            view[f"{layer_prefix(li)}.{key}"] = t[li]
    if layer_qcfg is not None and not isinstance(layer_qcfg, (list, tuple)):
        layer_qcfg = [layer_qcfg] * cfg.num_hidden_layers
    return forward(view, input_ids, cfg,
                   list(layer_qcfg) if layer_qcfg is not None else None)
