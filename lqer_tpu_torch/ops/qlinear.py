"""Quantized linear with the optional low-rank LQER correction.

Port of ``lqer_tpu/ops/qlinear.py``: :class:`QLinearConfig` resolves a
reference-schema q_config (+ l_config) into quantizer callables, with the
A_out/B_out quantizers falling back to the x-quantizer config, and
:func:`qlinear` computes ``Y = X_q W_q^T + b_q [+ B_out_q(A_out_q(X_q A) B)]``.
A q_config named ``llm_int8`` (or ``llm_int4``) resolves to the emulated
LLM.int8() linear (``ops/llm_int8.py``), which quantizes per call
(``is_ptq`` False).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils import tracing
from .quantizers import make_quantizer, passthrough_quantizer


@dataclasses.dataclass(frozen=True)
class QLinearConfig:
    x_quantizer: Callable = passthrough_quantizer
    w_quantizer: Callable = passthrough_quantizer
    b_quantizer: Callable = passthrough_quantizer
    a_out_quantizer: Callable = passthrough_quantizer
    b_out_quantizer: Callable = passthrough_quantizer
    is_ptq: bool = True
    is_lqer: bool = False
    rank: int = 0
    # "flexible", or "llm_int8": the emulated outlier-decomposition linear
    mode: str = "flexible"
    int_bits: int = 8
    int_threshold: float = 6.0
    # raw resolved config dicts, kept for the serving backend's
    # kernel-eligibility checks and the tensor-parallel shards' group checks
    # (compared by the memoized callables above)
    x_cfg: dict | None = dataclasses.field(default=None, compare=False)
    w_cfg: dict | None = dataclasses.field(default=None, compare=False)
    b_cfg: dict | None = dataclasses.field(default=None, compare=False)
    a_out_cfg: dict | None = dataclasses.field(default=None, compare=False)
    b_out_cfg: dict | None = dataclasses.field(default=None, compare=False)

    @staticmethod
    def from_q_config(q_config: dict, l_config: dict | None = None
                      ) -> "QLinearConfig":
        if q_config.get("name") in ("llm_int8", "llm_int4"):
            bits = (4 if q_config["name"].endswith("4")
                    else int(q_config.get("width", 8)))
            return QLinearConfig(
                mode="llm_int8", int_bits=bits,
                int_threshold=float(q_config.get("threshold", 6.0)),
                is_ptq=False)

        def cfg(key, fallback_keys=()):
            c = q_config.get(key)
            for fk in fallback_keys:
                if c is None:
                    c = q_config.get(fk)
            if c is None or c is False:
                c = q_config.get("default")
            return c

        x_cfg = cfg("x_quantizer")
        w_cfg = cfg("w_quantizer")
        b_cfg = cfg("b_quantizer")
        a_out_cfg = cfg("A_out_quantizer", fallback_keys=("x_quantizer",))
        b_out_cfg = cfg("B_out_quantizer", fallback_keys=("x_quantizer",))
        is_lqer = q_config.get("name") == "flexible_lqer"
        rank = int(l_config.get("rank", 0)) if (l_config and is_lqer) else 0
        return QLinearConfig(
            x_quantizer=make_quantizer(x_cfg),
            w_quantizer=make_quantizer(w_cfg),
            b_quantizer=make_quantizer(b_cfg),
            a_out_quantizer=make_quantizer(a_out_cfg),
            b_out_quantizer=make_quantizer(b_out_cfg),
            is_ptq=bool(q_config.get("is_ptq", False)),
            is_lqer=is_lqer,
            rank=rank,
            x_cfg=x_cfg, w_cfg=w_cfg, b_cfg=b_cfg, a_out_cfg=a_out_cfg,
            b_out_cfg=b_out_cfg,
        )


@tracing.annotate(tracing.LINEAR["emulated"])
def qlinear(x: torch.Tensor, params: dict, cfg: QLinearConfig, *,
            weights_prepared: bool | None = None) -> torch.Tensor:
    """``Y = X_q W_q^T + b_q [+ B_out_q(A_out_q(X_q A) B)]``; a module dict
    with a ``shard`` callable (a tensor-parallel shard, ``parallel/
    step.py``) runs it instead: ``shard(x, params, cfg)``."""
    if params.get("shard") is not None:
        return params["shard"](x, params, cfg)
    if cfg.mode == "llm_int8":
        from .llm_int8 import llm_int_linear

        return llm_int_linear(x, params["weight"], params.get("bias"),
                              bits=cfg.int_bits,
                              threshold=cfg.int_threshold)
    if weights_prepared is None:
        weights_prepared = cfg.is_ptq
    w, b = params["weight"], params.get("bias")
    if not weights_prepared:
        w = cfg.w_quantizer(w)
        if b is not None:
            b = cfg.b_quantizer(b)
    x_q = cfg.x_quantizer(x)
    y = promoted_matmul(x_q, w.T)
    if b is not None:
        y = y + b
    if cfg.is_lqer and params.get("A") is not None:
        xa = cfg.a_out_quantizer(promoted_matmul(x_q, params["A"]))
        y = y + cfg.b_out_quantizer(promoted_matmul(xa, params["B"]))
    return y


def promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.matmul``'s dtype rule: both operands promoted to their common
    dtype first (a bf16 activation against f32 weights is an f32
    product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def bf16_exact(cfg: dict | None) -> bool:
    """True when the quantizer's output grid is exact in bfloat16
    (block_fp / integer with width <= 9)."""
    return bool(cfg and cfg.get("name") in ("block_fp", "integer")
                and cfg.get("width", 99) <= 9)


def resolve_qmatmul(q_config: dict | None) -> Callable:
    """Quantize both operands, then matmul. Bf16-exact grids run on f32
    operands with f32 accumulation (the products are exact either way).
    No config: the plain product of the promoted operands."""
    if not q_config:
        return promoted_matmul
    x_cfg = q_config.get("x_quantizer") or q_config.get("default")
    y_cfg = q_config.get("w_quantizer") or q_config.get("default")
    xq, yq = make_quantizer(x_cfg), make_quantizer(y_cfg)

    def fn(a, b):
        qa, qb = xq(a), yq(b)
        return torch.matmul(qa.to(torch.float32),
                            qb.to(torch.float32)).to(qa.dtype)

    return fn


def qmatmul(x: torch.Tensor, y: torch.Tensor, q_config: dict) -> torch.Tensor:
    return resolve_qmatmul(q_config)(x, y)
