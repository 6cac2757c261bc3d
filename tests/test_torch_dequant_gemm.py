"""Kernel 1 (dequant-GEMM with the rank-k epilogue): the port's plain
version against the JAX package's fused kernel (Pallas in interpret mode,
as its own tests run it) and its large-M dense route, on the same packed
weights (converted from the JAX tile-major layout).

Tolerance rtol = atol = 2e-4: the products are exact on both sides, only
the f32 summation order of X·A and of the correction differs; on these
seeds no 8-bit rounding of the partial products flips.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops import storage as jstorage
from lqer_tpu.ops.pallas.dequant_gemm import (
    _quantize_rows_mx as jax_rows_mx,
    prepare_w4_weights as jax_prepare,
    qlinear_w4_dense_largeM,
    qlinear_w4_fused as jax_fused,
)
from lqer_tpu.ops.quantizers import block_fp_quantizer
from lqer_tpu_torch.convert import backend_from_jax
from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
from lqer_tpu_torch.ops.storage import MXFormat
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

K, N = 256, 512
TOL = dict(rtol=2e-4, atol=2e-4)


def _case(width, rank, bias, m, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    a = b = bias_v = None
    if rank:
        a = (rng.standard_normal((K, rank)) * 0.05).astype(jnp.bfloat16)
        b = (rng.standard_normal((rank, N)) * 0.05).astype(jnp.bfloat16)
    if bias:
        bias_v = (rng.standard_normal(N) * 0.1).astype(np.float32)
    x = block_fp_quantizer(jnp.asarray(rng.standard_normal((m, K)),
                                       jnp.float32),
                           width=8, exponent_width=8, block_size=[1, 16],
                           skip_first_dim=True).astype(jnp.bfloat16)
    prep = jax_prepare(jnp.asarray(w), a=None if a is None else jnp.asarray(a),
                       b=None if b is None else jnp.asarray(b),
                       bias=None if bias_v is None else jnp.asarray(bias_v),
                       fmt=jstorage.MXFormat(width), tile_k=128, tile_n=256)
    meta = {"fmt": prep["fmt"], "tile_k": prep["tile_k"], "xa_width": None,
            "out_width": None}
    arrays = {k: None if prep[k] is None else np.asarray(prep[k])
              for k in ("tiles", "a", "b", "bias")}
    tprep = backend_from_jax({"w": arrays}, {"w": meta})["arrays"]["w"]
    return x, prep, tprep


@pytest.mark.parametrize("m", [8, 600])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("rank", [0, 8, 32])
@pytest.mark.parametrize("width", [4, 8])
def test_plain_matches_jax(width, rank, bias, m):
    x, prep, tprep = _case(width, rank, bias, m, seed=width * 100 + rank + m)
    kw = dict(quant_xa_width=8, quant_out_width=8)
    ours = k1.qlinear_w4_fused(torch.from_numpy(np.array(
        x.astype(jnp.float32))), tprep, MXFormat(width), **kw).numpy()
    dense = np.asarray(qlinear_w4_dense_largeM(x, prep, **kw))
    np.testing.assert_allclose(ours, dense, **TOL)
    fused = np.asarray(jax_fused(x, prep, tile_m=128, interpret=True, **kw))
    np.testing.assert_allclose(ours, fused, **TOL)


def test_partial_quantizers_off_and_w8_head_path():
    """``quant_*_width=None`` (the W8 lm_head and passthrough A_out/B_out):
    X·A is still rounded to bf16 before the product with B, as in JAX."""
    x, prep, tprep = _case(4, 16, False, 8, seed=7)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    for xa_w, out_w in ((None, None), (8, None), (None, 8)):
        ours = k1.qlinear_w4_fused(xt, tprep, MXFormat(4),
                                   quant_xa_width=xa_w,
                                   quant_out_width=out_w).numpy()
        ref = np.asarray(qlinear_w4_dense_largeM(
            x, prep, quant_xa_width=xa_w, quant_out_width=out_w))
        np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("n", [8, 32, 48])
def test_row_quantizer_matches_jax(n):
    """The A_out/B_out row quantizer: 16-groups along the row, one
    whole-row group when 16 does not divide it (rank 8); bit-exact."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((5, n)) * 0.3).astype(np.float32)
    x[1] = 0.0
    ours = k1._quantize_rows_mx(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jax_rows_mx(jnp.asarray(x), 7)))


def test_wrapper_rejects_other_devices():
    x, _, tprep = _case(4, 0, False, 8, seed=9)
    with pytest.raises(ValueError):
        k1.qlinear_w4_fused(torch.zeros(8, K, device="meta"), tprep,
                            MXFormat(4))
    assert k1.qlinear_w4_fused.launches == 0  # CPU runs count no launch
