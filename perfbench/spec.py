"""A configuration file of ``perfbench/configs/`` read into the sizes the
harness, the yardstick and the reference need. Plain Python: nothing of
the program is imported here."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    arch: str            # "llama", "mistral" or "opt"
    hidden: int
    inter: int           # intermediate_size (Llama, Mistral) or ffn_dim (OPT)
    layers: int
    heads: int
    kv_heads: int
    vocab: int
    max_pos: int
    eps: float
    theta: float
    window: int | None
    tied_head: bool
    rank: int
    residual_dtype: str  # "float32" or "bfloat16"
    kv_cache: str        # the program's cache name
    kv_width: int
    w8_head: bool        # the head packed at MXINT8 (else dense)
    raw: dict = dataclasses.field(compare=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def n_rep(self) -> int:
        return self.heads // self.kv_heads

    def linear_shapes(self) -> dict:
        """``{rel: (out, in)}`` of one layer's linears, the program's
        parameter names."""
        h, kv = self.hidden, self.kv_heads * self.head_dim
        if self.arch == "opt":
            return {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h),
                    "self_attn.v_proj": (h, h), "self_attn.out_proj": (h, h),
                    "fc1": (self.inter, h), "fc2": (h, self.inter)}
        return {"self_attn.q_proj": (h, h), "self_attn.k_proj": (kv, h),
                "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, h),
                "mlp.gate_proj": (self.inter, h),
                "mlp.up_proj": (self.inter, h),
                "mlp.down_proj": (h, self.inter)}


def parse(raw: dict, name: str) -> ModelSpec:
    recipe = raw["recipe"]
    arch = raw["model_type"]
    opt = arch == "opt"
    head = recipe["lm_head"]
    return ModelSpec(
        name=name, arch=arch, hidden=raw["hidden_size"],
        inter=raw["ffn_dim"] if opt else raw["intermediate_size"],
        layers=raw["num_hidden_layers"], heads=raw["num_attention_heads"],
        kv_heads=raw.get("num_key_value_heads") or raw["num_attention_heads"],
        vocab=raw["vocab_size"], max_pos=raw["max_position_embeddings"],
        eps=raw.get("rms_norm_eps", 1e-5), theta=raw.get("rope_theta", 1e4),
        window=raw.get("sliding_window"),
        tied_head=bool(raw.get("tie_word_embeddings", opt)),
        rank=int(recipe["rank"]),
        residual_dtype=recipe.get("residual_dtype", "float32"),
        kv_cache=recipe["kv_cache"]["format"],
        kv_width=int(recipe["kv_cache"]["width"]),
        w8_head=isinstance(head, dict) and head.get("width") == 8,
        raw=raw)


def load_config(name: str, path: str | Path | None = None) -> ModelSpec:
    """The configuration ``name`` from ``path`` (default
    ``perfbench/configs/<name>.json``)."""
    path = Path(path) if path is not None else ROOT / "configs" / f"{name}.json"
    return parse(json.loads(path.read_text()), name)


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())
