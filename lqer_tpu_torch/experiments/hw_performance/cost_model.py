#!/usr/bin/env python
"""Comparative circuit-cost model for quantized linear schemes (the port's
copy of ``experiments/hw_performance/cost_model.py``: pure arithmetic, the
same functions and numbers).

The reference delegates area estimation to the external DeepWok/MASE
project and ships only the scheme specs. This module is a self-contained
comparative estimator: its absolute numbers differ from MASE's synthesis
results; its purpose is the relative ordering (per-token unrolled
multiplier area for a linear, the quantity behind BASELINE.md's hw-perf
table).

Model: area of a multiplier ≈ k · bits_a · bits_b (array multiplier);
adders/casts amortized into a fixed per-MAC overhead. Per-token unrolling:
one row of X against all of W per cycle.

    python -m lqer_tpu_torch.experiments.hw_performance.cost_model
"""

from __future__ import annotations

MULT_K = 1.0          # area units per bit^2 of a multiplier
MAC_OVERHEAD = 0.15   # adders + registers as fraction of mult area


def _macs_area(n_macs: int, bits_a: int, bits_b: int) -> float:
    return n_macs * MULT_K * bits_a * bits_b * (1.0 + MAC_OVERHEAD)


def estimate_area_fp16(X_shape, W_shape) -> float:
    """Dense FP16 baseline. FP16 multiplier ≈ 11x11 significand array plus
    exponent add — model as 11-bit × 11-bit + overhead."""
    _, hidden_in = X_shape
    _, hidden_out = W_shape
    return _macs_area(hidden_in * hidden_out, 11, 11) * 1.4


def estimate_area_llm_int8(X_shape, W_shape, num_high_precision_cols) -> float:
    """LLM.int8(): int8 MACs for the low-precision cols + FP16 MACs for the
    outlier cols (README spec: l=int8, h=FP16, tau=6.0)."""
    _, hidden_in = X_shape
    hidden_out = W_shape[1]
    hp = num_high_precision_cols
    lp = hidden_in - hp
    return (
        _macs_area(lp * hidden_out, 8, 8)
        + _macs_area(hp * hidden_out, 11, 11) * 1.4
    )


def estimate_area_llm_int4(X_shape, W_shape, num_high_precision_cols) -> float:
    _, hidden_in = X_shape
    hidden_out = W_shape[1]
    hp = num_high_precision_cols
    lp = hidden_in - hp
    return (
        _macs_area(lp * hidden_out, 4, 4)
        + _macs_area(hp * hidden_out, 11, 11) * 1.4
    )


def estimate_area_awq(X_shape, W_shape, num_groups) -> float:
    """AWQ/GPTQ W4 g128: FP16 activations × dequantized weights — compute
    stays FP16 (README: "only saves memory bandwidth, not compute"), plus the
    per-group dequant multipliers."""
    _, hidden_in = X_shape
    hidden_out = W_shape[1]
    main = _macs_area(hidden_in * hidden_out, 11, 11) * 1.4
    dequant = _macs_area(num_groups * hidden_out, 11, 4) * 1.4
    return main + dequant


def estimate_area_lqer_int(Xh_shape, Wl_shape, Ah_shape, Bh_shape,
                           w_bits: int = 4, h_bits: int = 16) -> float:
    """LQER-int: main GEMM at h_bits × w_bits fixed point; A/B path at
    h_bits × h_bits."""
    _, hidden_in = Xh_shape
    hidden_out = Wl_shape[1]
    r = Ah_shape[1]
    main = _macs_area(hidden_in * hidden_out, h_bits, w_bits)
    lowrank = _macs_area((hidden_in + hidden_out) * r, h_bits, h_bits)
    return main + lowrank


def estimate_area_lqer_mxint(Xh_shape, Wl_shape, Ah_shape, Bh_shape,
                             w_bits: int = 4, h_bits: int = 8,
                             group: int = 16) -> float:
    """LQER-MXINT: mantissa-only integer MACs (shared exponent amortized over
    the group: one exponent adder + shift per group)."""
    _, hidden_in = Xh_shape
    hidden_out = Wl_shape[1]
    r = Ah_shape[1]
    main = _macs_area(hidden_in * hidden_out, h_bits - 1, w_bits - 1)
    main += _macs_area(hidden_in * hidden_out // group, 8, 1)  # exp adders
    lowrank = _macs_area((hidden_in + hidden_out) * r, h_bits - 1, h_bits - 1)
    lowrank += _macs_area((hidden_in + hidden_out) * r // group, 8, 1)
    return main + lowrank


def headline_table(hidden_in=4096, hidden_out=11008, rank=32, seq_len=1,
                   num_hp_cols=300):
    """Reproduce the structure of BASELINE.md's hw-perf comparison for the
    per-token 4096→11008 linear."""
    X = (seq_len, hidden_in)
    W = (hidden_in, hidden_out)
    A = (hidden_in, rank)
    B = (rank, hidden_out)
    fp16 = estimate_area_fp16(X, W)
    rows = {
        "FP16": fp16,
        "LLM.int8()": estimate_area_llm_int8(X, W, num_hp_cols),
        "LLM.int4()": estimate_area_llm_int4(X, W, num_hp_cols),
        "AWQ/GPTQ W4 g128": estimate_area_awq(X, W, hidden_in // 128),
        "LQER int (16b x 4b)": estimate_area_lqer_int(X, W, A, B),
        "LQER MXINT (8b x 4b)": estimate_area_lqer_mxint(X, W, A, B),
    }
    return {k: {"area": v, "x_fp16": v / fp16} for k, v in rows.items()}


if __name__ == "__main__":
    import json

    print(json.dumps(headline_table(), indent=2))
