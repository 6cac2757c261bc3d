"""Registries of quantized layers and functions (port of
``lqer_tpu/ops/registry.py``)."""

from __future__ import annotations

from .qlinear import QLinearConfig, qlinear, qmatmul, resolve_qmatmul


def get_quantized_layer_cls(kind: str, q_config: dict):
    """"linear" with name flexible/flexible_lqer → ``build(l_config)``
    returning ``(apply_fn, QLinearConfig)``."""
    if kind != "linear":
        raise ValueError(f"quantized layer kind {kind!r} not supported")
    name = q_config.get("name", "flexible")
    if name not in ("flexible", "flexible_lqer"):
        raise ValueError(f"quantized layer {name!r} not supported")

    def build(l_config: dict | None = None):
        cfg = QLinearConfig.from_q_config(q_config, l_config)
        return (lambda x, params: qlinear(x, params, cfg)), cfg

    return build


def get_quantized_func(kind: str, q_config: dict):
    if kind not in ("matmul", "bmm"):
        raise ValueError(f"quantized function {kind!r} not supported")
    name = q_config.get("name", "flexible")
    if name != "flexible":
        raise ValueError(f"quantized {kind} {name!r} not supported")
    return resolve_qmatmul(q_config)


__all__ = ["get_quantized_layer_cls", "get_quantized_func", "qmatmul"]
