"""Per-layer quantization-config expansion (port of
``lqer_tpu/models/config_expand.py``; pure Python, kept as its own copy).

Mirrors `_layer_q_config_builder` / `_layer_l_config_builder`
(the reference's `src/lqer/models/llama_decoder.py:423-482`,
`opt_decoder.py:326-372`): a flat ``q_config`` with ``linear`` and
``matmul``/``bmm`` entries expands to one entry per decoder layer, with
``model_layer_{i}`` keys overriding individual layers and ``model_layer``
overriding the default template. The expanded dict is then *resolved* into
concrete quantizer callables per layer. (The JAX module's scan-segment
helpers are not needed: the port's layer loop takes each layer's config.)
"""

from __future__ import annotations

from copy import deepcopy

from ..ops.qlinear import QLinearConfig, resolve_qmatmul
from .common import AttnQConfig

# proj-name layout per architecture family
OPT_ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "out_proj")
OPT_MLP_PROJS = ("fc1", "fc2")
LLAMA_ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
LLAMA_MLP_PROJS = ("gate_proj", "up_proj", "down_proj")


def _default_layer_template(q_config: dict, arch: str) -> dict:
    if arch == "opt":
        assert "linear" in q_config and "bmm" in q_config
        linear_cfg, mm_cfg = q_config["linear"], q_config["bmm"]
        return {
            "self_attn": {
                **{p: linear_cfg for p in OPT_ATTN_PROJS},
                "bmm_0": mm_cfg,
                "bmm_1": mm_cfg,
            },
            **{p: linear_cfg for p in OPT_MLP_PROJS},
        }
    else:  # llama / mistral
        assert "linear" in q_config and "matmul" in q_config
        linear_cfg, mm_cfg = q_config["linear"], q_config["matmul"]
        return {
            "self_attn": {
                **{p: linear_cfg for p in LLAMA_ATTN_PROJS},
                "matmul_0": mm_cfg,
                "matmul_1": mm_cfg,
            },
            "mlp": {p: linear_cfg for p in LLAMA_MLP_PROJS},
        }


def _default_layer_l_template(l_config: dict, arch: str) -> dict:
    assert "linear" in l_config
    lin = l_config["linear"]
    if arch == "opt":
        return {
            "self_attn": {p: lin for p in OPT_ATTN_PROJS},
            **{p: lin for p in OPT_MLP_PROJS},
        }
    return {
        "self_attn": {p: lin for p in LLAMA_ATTN_PROJS},
        "mlp": {p: lin for p in LLAMA_MLP_PROJS},
    }


def expand_layer_configs(
    num_layers: int, q_config: dict | None, arch: str
) -> list[dict] | None:
    """Expand to a list of per-layer raw config dicts
    (`llama_decoder.py:444-452`)."""
    if q_config is None:
        return None
    template = q_config.get("model_layer") or _default_layer_template(q_config, arch)
    out = []
    for i in range(num_layers):
        key = f"model_layer_{i}"
        out.append(deepcopy(q_config[key] if key in q_config else template))
    return out


def expand_layer_l_configs(
    num_layers: int, l_config: dict | None, arch: str
) -> list[dict] | None:
    if l_config is None:
        return None
    template = l_config.get("model_layer") or _default_layer_l_template(l_config, arch)
    out = []
    for i in range(num_layers):
        key = f"model_layer_{i}"
        out.append(deepcopy(l_config[key] if key in l_config else template))
    return out


def _lcfg(l_layer: dict | None, *path):
    if l_layer is None:
        return None
    cur = l_layer
    for p in path:
        if cur is None:
            return None
        cur = cur.get(p)
    return cur


def resolve_layer(q_layer: dict, l_layer: dict | None, arch: str) -> dict:
    """Resolve one expanded layer config into callables.

    Returns {"attn": AttnQConfig, "<mlp proj>": QLinearConfig, ...}.
    """
    attn_q = q_layer["self_attn"]
    if arch == "opt":
        attn = AttnQConfig(
            q_proj=QLinearConfig.from_q_config(
                attn_q["q_proj"], _lcfg(l_layer, "self_attn", "q_proj")
            ),
            k_proj=QLinearConfig.from_q_config(
                attn_q["k_proj"], _lcfg(l_layer, "self_attn", "k_proj")
            ),
            v_proj=QLinearConfig.from_q_config(
                attn_q["v_proj"], _lcfg(l_layer, "self_attn", "v_proj")
            ),
            o_proj=QLinearConfig.from_q_config(
                attn_q["out_proj"], _lcfg(l_layer, "self_attn", "out_proj")
            ),
            qk_matmul=resolve_qmatmul(attn_q.get("bmm_0")),
            pv_matmul=resolve_qmatmul(attn_q.get("bmm_1")),
            qk_cfg=attn_q.get("bmm_0"),
            pv_cfg=attn_q.get("bmm_1"),
        )
        return {
            "attn": attn,
            "fc1": QLinearConfig.from_q_config(q_layer["fc1"], _lcfg(l_layer, "fc1")),
            "fc2": QLinearConfig.from_q_config(q_layer["fc2"], _lcfg(l_layer, "fc2")),
        }
    else:
        mlp_q = q_layer["mlp"]
        attn = AttnQConfig(
            q_proj=QLinearConfig.from_q_config(
                attn_q["q_proj"], _lcfg(l_layer, "self_attn", "q_proj")
            ),
            k_proj=QLinearConfig.from_q_config(
                attn_q["k_proj"], _lcfg(l_layer, "self_attn", "k_proj")
            ),
            v_proj=QLinearConfig.from_q_config(
                attn_q["v_proj"], _lcfg(l_layer, "self_attn", "v_proj")
            ),
            o_proj=QLinearConfig.from_q_config(
                attn_q["o_proj"], _lcfg(l_layer, "self_attn", "o_proj")
            ),
            qk_matmul=resolve_qmatmul(attn_q.get("matmul_0")),
            pv_matmul=resolve_qmatmul(attn_q.get("matmul_1")),
            qk_cfg=attn_q.get("matmul_0"),
            pv_cfg=attn_q.get("matmul_1"),
        )
        return {
            "attn": attn,
            **{
                p: QLinearConfig.from_q_config(mlp_q[p], _lcfg(l_layer, "mlp", p))
                for p in LLAMA_MLP_PROJS
            },
        }


def resolve_model_configs(
    num_layers: int, q_config: dict | None, l_config: dict | None, arch: str
) -> list[dict] | None:
    """Full expansion + resolution for a model. None q_config → FP model."""
    if q_config is None:
        return None
    q_layers = expand_layer_configs(num_layers, q_config, arch)
    l_layers = expand_layer_l_configs(num_layers, l_config, arch)
    return [
        resolve_layer(q_layers[i], l_layers[i] if l_layers else None, arch)
        for i in range(num_layers)
    ]
