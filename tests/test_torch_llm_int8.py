"""The port's emulated LLM.int8() / LLM.int4() linear
(``ops/llm_int8.py::llm_int_linear``) and its route in ``qlinear`` against
the JAX package's on the same inputs: outlier columns on both sides of the
threshold (one column exactly at it counts as an outlier, as ``>=`` says),
widths 8 and 4, with and without a bias, 2-D and 3-D activations.

Limit: rtol = atol = 2e-4 (``ROADMAP.md`` "North star": the vector-wise
rounding is the same elementwise function on both sides; only the f32 sums
of the two matmuls differ in order). The resolved configs are equal
field for field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.llm_int8 import llm_int_linear as jllm
from lqer_tpu.ops.qlinear import QLinearConfig as JQLinearConfig
from lqer_tpu.ops.qlinear import qlinear as jqlinear
from lqer_tpu_torch.ops.llm_int8 import llm_int_linear
from lqer_tpu_torch.ops.qlinear import QLinearConfig, qlinear
from lqer_tpu_torch.testing import ATOL, RTOL, one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

THRESHOLD = 6.0


def _inputs(shape, seed, outliers=True):
    """Activations with columns just under, exactly at and well over the
    threshold."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    w = (rng.standard_normal((48, shape[-1])) * 0.1).astype(np.float32)
    b = (rng.standard_normal(48) * 0.1).astype(np.float32)
    if outliers:
        flat = x.reshape(-1, shape[-1])
        flat[:, 3] = np.clip(flat[:, 3], -5.9, 5.9)     # under: no outlier
        flat[0, 5] = THRESHOLD                          # at: an outlier
        flat[1, 7] = -25.0                              # over: an outlier
        flat[:, 9] *= 10.0
    return x, w, b


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 64)])
@pytest.mark.parametrize("bias", [False, True])
def test_llm_int_linear_matches_jax(bits, shape, bias):
    x, w, b = _inputs(shape, seed=bits + len(shape))
    b = b if bias else None
    want = jllm(jnp.asarray(x), jnp.asarray(w),
                None if b is None else jnp.asarray(b), bits=bits,
                threshold=THRESHOLD)
    got = llm_int_linear(torch.as_tensor(x), torch.as_tensor(w),
                         None if b is None else torch.as_tensor(b),
                         bits=bits, threshold=THRESHOLD)
    torch.testing.assert_close(got, torch.as_tensor(np.array(want)),
                               rtol=RTOL, atol=ATOL)


def test_outlier_columns_multiply_full_precision():
    """Only the outlier columns (>= threshold) bypass the quantizer: the
    difference of two calls that differ in one outlier column is that
    column's full-precision product."""
    x, w, _ = _inputs((6, 64), seed=0)
    x = torch.as_tensor(x)
    w = torch.as_tensor(w)
    x_lo = x.clone()
    x_lo[:, 7] = 0.0
    diff = llm_int_linear(x, w) - llm_int_linear(x_lo, w)
    want = x[:, 7:8] @ w[:, 7:8].T
    torch.testing.assert_close(diff, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_config", [
    {"name": "llm_int8", "threshold": THRESHOLD},
    {"name": "llm_int8", "threshold": 3.0, "width": 6},
    {"name": "llm_int4"},
])
def test_qlinear_route_matches_jax(q_config):
    jc = JQLinearConfig.from_q_config(q_config)
    tc = QLinearConfig.from_q_config(q_config)
    for f in ("mode", "int_bits", "int_threshold", "is_ptq", "is_lqer",
              "rank"):
        assert getattr(tc, f) == getattr(jc, f), f
    x, w, b = _inputs((2, 5, 64), seed=7)
    want = jqlinear(jnp.asarray(x), {"weight": jnp.asarray(w),
                                     "bias": jnp.asarray(b)}, jc)
    got = qlinear(torch.as_tensor(x), {"weight": torch.as_tensor(w),
                                       "bias": torch.as_tensor(b)}, tc)
    torch.testing.assert_close(got, torch.as_tensor(np.array(want)),
                               rtol=RTOL, atol=ATOL)
