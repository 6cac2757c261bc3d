"""The in-kernel activation quantizer (the TPU kernels' ``quant_x_mb``; the
port's ``quant_x_width`` of kernel 1 and the megakernel, the serving
backend's route below 512 rows) against the JAX package:

- its values bit-exact with the JAX ``x_quantizer`` (``block_fp``, [1, 16]
  groups, width 8) and with JAX's ``_quantize_rows_mx``;
- kernel 1 (``qlinear_w4_fused(quant_x_width=8)``, JAX in interpret mode)
  and the megakernel (``mlp_w4_fused(quant_x_width=8)``) on raw f32 X:
  within rtol = atol = 2e-4 (the megakernel within ``mlp_limit``), and the
  port's in-kernel route equal to its separate-quantizer route on the same
  X;
- the port's engine, every eligible linear and MLP below 512 rows on the
  route, against the JAX engine with its opt-in
  ``pallas_backend._INKERNEL_XQ`` on: equal greedy tokens, equal to the
  port's tokens through the separate quantizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.ops.pallas.dequant_gemm import _quantize_rows_mx as jrows_mx
from lqer_tpu.ops.pallas.dequant_gemm import qlinear_w4_fused as jax_k1
from lqer_tpu.ops.pallas.mlp_fused import mlp_w4_fused as jax_k5
from lqer_tpu.ops.quantizers import block_fp_quantizer
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu.serving import pallas_backend as jbackend
from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
from lqer_tpu_torch.ops.kernels import mlp_fused as k5
from lqer_tpu_torch.ops.quantizers import block_fp_quantizer as tblock_fp
from lqer_tpu_torch.ops.storage import MXFormat, MXINT4
from lqer_tpu_torch.serving import Request
from lqer_tpu_torch.serving import kernel_backend as tbackend
from lqer_tpu_torch.serving.random_model import Q_CONFIG
from lqer_tpu_torch.testing import (
    check_close,
    mlp_limit,
    one_torch_thread_fixture,
)
from test_torch_dequant_gemm import _case as k1_case
from test_torch_direct_cache_serving import _port_engine
from test_torch_mlp_fused import _case as k5_case
from test_torch_serving import _jax_model, _requests

_one_torch_thread = one_torch_thread_fixture()

X_CFG = dict(width=8, exponent_width=8, block_size=[1, 16],
             skip_first_dim=True)
TOL = dict(rtol=2e-4, atol=2e-4)


def _raw(m, k, seed):
    """Raw activations over a wide range of group scales, one all-zero
    group and one group of values at the passthrough size."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * np.exp2(rng.integers(-6, 7, (m, 1)))
    x[0, 16:32] = 0.0
    x[1, :16] = rng.standard_normal(16) * 1e-9
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_x_values_match_jax_quantizer(dtype):
    x = torch.from_numpy(_raw(6, 256, 1)).to(dtype)
    ours = k1.quantize_x_plain(x, 8)
    xj = jnp.asarray(x.float().numpy())
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(block_fp_quantizer(xj, **X_CFG)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jrows_mx(xj, 7)))
    # the separate quantizer of the serving path, in x's dtype, then bf16
    assert torch.equal(ours.to(torch.bfloat16),
                       tblock_fp(x, **X_CFG).to(torch.bfloat16))


@pytest.mark.parametrize("rank", [0, 32])
def test_kernel1_xq_matches_jax(rank):
    _, prep, tprep = k1_case(4, rank, False, 8, seed=20 + rank)
    x = _raw(8, 256, 2 + rank)
    kw = dict(quant_xa_width=8, quant_out_width=8)
    ours = k1.qlinear_w4_fused(torch.from_numpy(x), tprep, MXFormat(4),
                               quant_x_width=8, **kw)
    want = jax_k1(jnp.asarray(x), prep, tile_m=128, quant_x_width=8,
                  interpret=True, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), **TOL)
    ext = k1.qlinear_w4_fused(
        tblock_fp(torch.from_numpy(x), **X_CFG).to(torch.bfloat16), tprep,
        MXFormat(4), **kw)
    assert torch.equal(ours, ext)
    assert k1.qlinear_w4_fused.launches == 0   # CPU: the plain version


def test_megakernel_xq_matches_jax():
    kw = dict(act_width=8, quant_xa_width=8, quant_out_width=8)
    _, prep, _, tprep = k5_case(8, 32, seed=31)
    x = _raw(8, 256, 4)
    ours = k5.mlp_w4_fused(torch.from_numpy(x), tprep, MXINT4,
                           quant_x_width=8, **kw)
    want = torch.from_numpy(np.array(jax_k5(
        jnp.asarray(x), prep, tile_i=128, tile_n=128, quant_x_width=8,
        interpret=True)))
    xq = k1.quantize_x_plain(torch.from_numpy(x), 8)
    check_close("megakernel with quant_x_width vs JAX", want, ours,
                mlp_limit(xq, tprep, ours, **kw), 0.05)
    ext = k5.mlp_w4_fused(xq.to(torch.bfloat16), tprep, MXINT4, **kw)
    assert torch.equal(ours, ext)
    assert k5.mlp_w4_fused.launches == 0


def test_quant_x_width_refuses_what_the_kernel_cannot_take():
    """A shape or width the in-kernel quantizer cannot take raises; it is
    never quantized outside the kernel instead."""
    _, _, tprep = k1_case(4, 0, False, 8, seed=9)
    _, _, _, mprep = k5_case(8, 0, seed=9)
    for width, shape in ((10, (8, 256)), (1, (8, 256)), (8, (8, 200))):
        with pytest.raises(ValueError, match="in-kernel activation"):
            k1.qlinear_w4_fused(torch.zeros(shape), tprep, MXFormat(4),
                                quant_x_width=width)
        with pytest.raises(ValueError, match="in-kernel activation"):
            k5.mlp_w4_fused(torch.zeros(shape), mprep, MXINT4,
                            quant_x_width=width)


def test_engine_inkernel_route_matches_jax(monkeypatch):
    """Two slots, ``mxint8-staged``, the default packing (each MLP whole):
    the 128-row admission and every decode step take the route for q|k|v,
    o and the MLP; the head keeps its unquantized bf16 input."""
    jcfg, params, jq, jb = _jax_model(fuse_mlp=True)
    monkeypatch.setattr(jbackend, "_INKERNEL_XQ", True)
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=2, max_len=128,
                            cache_dtype="mxint8-staged", pallas_backend=jb,
                            scan_layers=True, lm_head_width=8)
    jreqs = _requests(JRequest, np.random.default_rng(1))
    jengine.run(jreqs)

    tokens, widths = {}, []
    for name in ("qlinear_w4_fused", "mlp_w4_fused"):
        real = getattr(tbackend, name)
        monkeypatch.setattr(tbackend, name, lambda x, *a, _r=real, **kw: (
            widths.append((x.shape[0], x.dtype, kw.get("quant_x_width")))
            or _r(x, *a, **kw)))
    for route in (True, False):
        if not route:   # every linear and MLP on the separate quantizer
            monkeypatch.setattr(tbackend, "inkernel_x_width",
                                lambda *a: None)
        engine = _port_engine(params, jb, Q_CONFIG, 128, "mxint8-staged")
        reqs = _requests(Request, np.random.default_rng(1))
        widths.clear()
        engine.run(reqs)
        tokens[route] = [r.output_ids for r in reqs]
        assert {w for _, _, w in widths} == ({8} if route else {None})
        if route:   # raw activations in the stream dtype
            assert {dt for _, dt, _ in widths} == {torch.float32}
    assert tokens[True] == tokens[False] == [r.output_ids for r in jreqs]
    assert len(set(tokens[True][0])) > 3


def test_route_eligibility():
    """The JAX package's test: the canonical MXINT8 activation format at
    width <= 9 and K % 16 == 0."""
    x_cfg = dict(name="block_fp", exponent_bias=None, **X_CFG)
    assert tbackend._is_mx8_act(x_cfg)
    assert tbackend.inkernel_x_width(x_cfg, 256) == 8
    assert tbackend.inkernel_x_width(x_cfg, 200) is None
    assert tbackend.inkernel_x_width({**x_cfg, "width": 10}, 256) is None
    assert tbackend.inkernel_x_width({**x_cfg, "block_size": [16, 1]},
                                     256) is None
