"""Software-emulated quantizers (fake-quant) on torch tensors.

Port of ``lqer_tpu/ops/quantizers.py``: ``block_fp`` (MXINT / MSFP shared
exponents), ``integer`` (fixed point), the two minifloat flavours and
``passthrough``. Each public quantizer is a ``torch.autograd.Function``
with a straight-through (identity) backward. Math runs in float32 whatever
the input dtype; the result is cast back.

Numeric corner cases kept from the reference:

* all-zero blocks: if every block max is 0 the maxes become 1, otherwise
  zero maxes take the smallest non-zero max;
* ``sign(x + 1e-9)`` and ``|x| + 1e-9`` inside the mantissa;
* mantissa ``clamp(round_half_even(m · 2^mb), 0, 2^mb − 1)``;
* ``|x| <= 1e-8`` passes through unquantized.

Exponent contract: the shared exponent is ``ceil_log2_exact`` of the block
max (bit arithmetic), not a float ``ceil(log2)``. The JAX quantizer uses
the float path, so the two differ by one exponent step on blocks whose max
lies a float-ulp above a power of two (``tests/test_torch_quantizers.py``
pins those cases); everywhere else they are bit-exact.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..parallel.collectives import (
    ZERO_ATOL,
    ceil_log2_exact,
    exp2_int,
    fill_zero_groups,
    floor_log2_exact,
    mx_values,
)
from ..utils import tracing
from .blocking import per_block_absmax, unblock


def _ste(core: Callable) -> Callable:
    """Wrap ``core(x, **kwargs)`` in an autograd.Function whose backward is
    the identity (straight-through estimator)."""

    class _Quantize(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, kwargs):
            return core(x, **kwargs)

        @staticmethod
        def backward(ctx, g):
            return g, None

    @functools.wraps(core)
    def call(x, **kwargs):
        with tracing.QUANTIZE:
            return _Quantize.apply(x, kwargs)

    return call


def _resolve_exponent_bias(exponent_bias, exponent_width: int) -> int:
    if exponent_bias in (None, "none", "None", "NA"):
        return 2 ** (exponent_width - 1) - 1
    return exponent_bias


def _block_fp_core(x, width=12, exponent_width=8, exponent_bias=None,
                   block_size=(16,), skip_first_dim=True):
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    v, bmax, eff = per_block_absmax(xf, block_size, skip_first_dim)
    bmax = fill_zero_groups(bmax, None)
    bias = _resolve_exponent_bias(exponent_bias, exponent_width)
    q_blocked = mx_values(v, bmax, width - 1, e_min=-bias,
                          e_max=2 ** exponent_width - 1 - bias)
    q = unblock(q_blocked, xf.shape, eff)
    return torch.where(xf.abs() <= ZERO_ATOL, xf, q).to(orig_dtype)


def _integer_core(x, width: int, frac_width: int, is_signed: bool = True):
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    if is_signed:
        int_min, int_max = -(2 ** (width - 1)), 2 ** (width - 1) - 1
    else:
        int_min, int_max = 0, 2 ** width - 1
    scale = float(2 ** frac_width)
    q = torch.round(xf * scale).clamp(int_min, int_max) / scale
    return q.to(orig_dtype)


def _minifloat_denorm_core(x, width: int, exponent_width: int,
                           exponent_bias=None):
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    mb = width - exponent_width - 1
    bias = _resolve_exponent_bias(exponent_bias, exponent_width)
    exp_max, exp_min = 2 ** exponent_width - 1 - bias, -bias
    sign = torch.sign(xf + 1e-9)
    value = xf.abs()
    exponent = ceil_log2_exact(value + 1e-9).clamp(exp_min, exp_max)
    scale = exp2_int(exponent)
    shift = float(2 ** mb)
    mant = torch.round(value / scale * shift).clamp(0, 2 ** mb - 1)
    q = sign * scale * (mant / shift)
    return torch.where(value <= ZERO_ATOL, xf, q).to(orig_dtype)


def _minifloat_ieee_core(x, width: int, exponent_width: int,
                         exponent_bias=None):
    orig_dtype = x.dtype
    xf = x.to(torch.float32)
    mb = width - exponent_width - 1
    bias = _resolve_exponent_bias(exponent_bias, exponent_width)
    exp_max, exp_min = 2 ** exponent_width - 1 - bias, -bias
    mant_int_max = 2 ** mb - 1
    shift = float(2 ** mb)
    sign = torch.sign(xf + 1e-9)
    value = xf.abs()
    exponent = floor_log2_exact(value + 1e-9).clamp(exp_min, exp_max)
    scale = exp2_int(exponent)
    mantissa = value / scale
    # subnormal branch where the clipped exponent hit the minimum
    is_normal = exponent != exp_min
    m_normal = torch.round(mantissa * shift - shift).clamp(0, mant_int_max)
    m_subnormal = torch.round(mantissa * shift / 2).clamp(0, mant_int_max)
    shifted = torch.where(is_normal, m_normal, m_subnormal)
    mantissa_q = torch.where(is_normal, 1.0 + shifted / shift,
                             shifted / shift * 2.0)
    q = sign * scale * mantissa_q
    return torch.where(value <= ZERO_ATOL, xf, q).to(orig_dtype)


def passthrough_quantizer(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """Identity: fp activations in weight-only configs."""
    return x


block_fp_quantizer = _ste(_block_fp_core)
integer_quantizer = _ste(_integer_core)
minifloat_denorm_quantizer = _ste(_minifloat_denorm_core)
minifloat_ieee_quantizer = _ste(_minifloat_ieee_core)

_QUANTIZER_MAP = {
    "passthrough": passthrough_quantizer,
    "block_fp": block_fp_quantizer,
    "integer": integer_quantizer,
    "minifloat": minifloat_ieee_quantizer,
    "minifloat_denorm": minifloat_denorm_quantizer,
}


def get_quantizer(name: str) -> Callable:
    try:
        return _QUANTIZER_MAP[name]
    except KeyError:
        raise ValueError(f"quantizer {name!r} not supported") from None


_QUANTIZER_CACHE: dict = {}


def make_quantizer(config: dict | None) -> Callable:
    """1-arg quantizer from ``{"name": ..., **params}``. Identical configs
    return the same memoized callable, so ``QLinearConfig`` equality by
    identity is equality by config."""
    if config is None:
        return passthrough_quantizer
    cfg = dict(config)
    name = cfg.pop("name")
    fn = get_quantizer(name)
    if fn is passthrough_quantizer:
        return passthrough_quantizer
    key = (name, tuple(sorted((k, repr(v)) for k, v in cfg.items())))
    cached = _QUANTIZER_CACHE.get(key)
    if cached is None:
        cached = functools.partial(fn, **cfg)
        _QUANTIZER_CACHE[key] = cached
    return cached
