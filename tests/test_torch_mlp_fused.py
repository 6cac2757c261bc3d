"""Kernel 5 (the whole-MLP megakernel): the port's plain version and its
large-M route against the JAX package's ``mlp_w4_fused`` (Pallas in
interpret mode, as its own tests run it) and ``mlp_w4_dense_largeM``, on
weights converted from the JAX prep.

Tolerance rtol = atol = 2e-4 plus ``testing.mlp_limit``: one 8-bit code
step of each quantizer whose rounding a summation order can flip, carried
through the down projection. A run with the gate's correction left out
must fail that limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.pallas.mlp_fused import mlp_w4_dense_largeM as jax_dense
from lqer_tpu.ops.pallas.mlp_fused import mlp_w4_fused as jax_fused
from lqer_tpu.ops.pallas.mlp_fused import prepare_mlp_weights as jax_prepare
from lqer_tpu.ops.quantizers import block_fp_quantizer
from lqer_tpu_torch.convert import backend_from_jax
from lqer_tpu_torch.ops.kernels import mlp_fused as k5
from lqer_tpu_torch.ops.storage import MXINT4
from lqer_tpu_torch.testing import (
    check_close,
    mlp_limit,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()

K, I, N = 256, 512, 256
KW = dict(act_width=8, quant_xa_width=8, quant_out_width=8)


def _case(m, rank, seed):
    """JAX prep, the port's converted prep, and x (numpy → both)."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.05):
        return jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32)

    def ab(*shape):
        return jnp.asarray((rng.standard_normal(shape) * 0.05).astype(
            jnp.bfloat16).astype(np.float32))

    lr = {}
    if rank:
        lr = dict(a_gate=ab(K, rank), b_gate=ab(rank, I), a_up=ab(K, rank),
                  b_up=ab(rank, I), a_down=ab(I, rank), b_down=ab(rank, N))
    prep = jax_prepare(w(I, K), w(I, K), w(N, I), tile_i=128, tile_n=128,
                       **lr)
    x = block_fp_quantizer(jnp.asarray(rng.standard_normal((m, K)),
                                       jnp.float32),
                           width=8, exponent_width=8, block_size=[1, 16],
                           skip_first_dim=True).astype(jnp.bfloat16)
    static = ("gated", "fmt", "tile_k", "tile_k2", "tile_i", "tile_n")
    meta = {"kind": "mlp", "act_width": 8, "xa_width": 8, "out_width": 8,
            **{k: prep[k] for k in static}}
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in prep.items() if k not in static}
    tprep = backend_from_jax({"mlp": arrays}, {"mlp": meta})["arrays"]["mlp"]
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    return x, prep, xt, tprep


@pytest.mark.parametrize("rank", [0, 32])
@pytest.mark.parametrize("m", [8, 200])
def test_plain_matches_jax(m, rank):
    x, prep, xt, tprep = _case(m, rank, seed=m + rank)
    ours = k5.mlp_w4_fused(xt, tprep, MXINT4, **KW)      # CPU: plain version
    assert k5.mlp_w4_fused.launches == 0
    lim = mlp_limit(xt, tprep, ours, **KW)
    fused = torch.from_numpy(np.array(jax_fused(x, prep, tile_i=128,
                                                  tile_n=128, interpret=True)))
    check_close("plain vs JAX mlp_w4_fused", fused, ours, lim, 0.05)
    dense = torch.from_numpy(np.array(jax_dense(x, prep)))
    check_close("plain vs JAX mlp_w4_dense_largeM", dense, ours, lim, 0.05)
    port_dense = k5.mlp_w4_dense_largeM(xt, tprep, MXINT4, **KW)
    check_close("large-M vs plain", port_dense, ours, lim, 0.05)


def test_limit_rejects_missing_gate_correction():
    _, _, xt, tprep = _case(8, 32, seed=3)
    want = k5.mlp_w4_plain(xt, tprep, MXINT4, **KW)
    lim = mlp_limit(xt, tprep, want, **KW)
    assert bool((lim > 2e-4).all())
    broken = dict(tprep, b_g=torch.zeros_like(tprep["b_g"]))
    with pytest.raises(AssertionError, match="limit"):
        check_close("no gate correction",
                    k5.mlp_w4_plain(xt, broken, MXINT4, **KW), want, lim, 0.05)


def test_hidden_stays_f32_until_quantized():
    """H is silu(y_g)·y_u of the f32 gate and up, quantized, then rounded
    to bf16 (exact on its grid); rounding gate and up to bf16 first, as the
    unfused path does, is another function."""
    rng = np.random.default_rng(5)
    y_g, y_u = (torch.from_numpy(rng.standard_normal((4, 64)).astype(
        np.float32)) for _ in range(2))
    h = k5.hidden(y_g, y_u, 8)
    assert torch.equal(h, h.to(torch.bfloat16).to(torch.float32))
    jh = jax.nn.silu(jnp.asarray(y_g.numpy())) * jnp.asarray(y_u.numpy())
    jq = block_fp_quantizer(jh, width=8, exponent_width=8,
                            block_size=[1, 16], skip_first_dim=True)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jq))
    rounded = k5.hidden(y_g.to(torch.bfloat16).float(),
                        y_u.to(torch.bfloat16).float(), 8)
    assert not torch.equal(rounded, h)


def test_wrapper_rejects_other_devices():
    _, _, xt, tprep = _case(8, 0, seed=9)
    with pytest.raises(ValueError):
        k5.mlp_w4_fused(xt.to("meta"), tprep, MXINT4, **KW)
