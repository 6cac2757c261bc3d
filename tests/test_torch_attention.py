"""Kernel 2 (causal prefill attention): the port's plain version against
the JAX package's ``quantized_attention`` (Pallas in interpret mode) and the
model-level ``fused_quantized_attention`` around it.

Tolerance rtol = atol = 2e-4: scores and products are exact on both sides;
exp and the f32 summation order of the softmax sum and of P·V differ. A
one-ulp difference could flip one 8-bit rounding of p, moving an output by
one quantization step of its 16-group; none does on these seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.models.common import (
    fused_quantized_attention as jax_fused_attention,
)
from lqer_tpu.ops.pallas.attention import _quantize_sublane_groups as jax_quantize_p
from lqer_tpu.ops.pallas.attention import quantized_attention as jax_attention
from lqer_tpu.parallel.collectives import mx8_decode, mx8_encode
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.models.common import fused_quantized_attention
from lqer_tpu_torch.ops.kernels import attention as k2
from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
from lqer_tpu_torch.serving.random_model import Q_CONFIG
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, bh, s, d):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((bh, s, d)).astype(np.float32))
    q = block_fp_quantizer(q, width=8, exponent_width=8, block_size=[1, 16],
                           skip_first_dim=True).numpy()
    kv = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((bh, s, d)), jnp.float32)
        kv.append(np.array(mx8_decode(*mx8_encode(x, 16, zero_fill=1.0),
                                        16, jnp.float32)))
    return q, kv[0], kv[1]


@pytest.mark.parametrize("s,d,causal,p_width", [
    (64, 64, True, 8), (48, 128, True, 8), (32, 64, False, 8),
    (64, 64, True, None)])
def test_plain_matches_jax(s, d, causal, p_width):
    q, k, v = _qkv(s + d, 6, s, d)
    scale = d ** -0.5
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale=scale, tile_s=16,
                                   p_width=p_width, causal=causal,
                                   interpret=True))
    ours = k2.quantized_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), scale=scale,
                                  p_width=p_width, causal=causal).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_p_quantizer_and_attend_match_jax():
    """P is quantized per 16 keys exactly as the JAX kernel's
    ``_quantize_sublane_groups`` does (bit-exact on the same p; masked keys
    give p = 0, which passes through), and ``attend_plain`` is softmax, that
    quantizer, then P·V."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy((rng.standard_normal((6, 64)) * 3).astype(np.float32))
    s[:3, 40:] = float("-inf")
    p = torch.softmax(s, -1)
    ours = k2._quantize_sublane_groups(p, 7, 16)
    ref = jax_quantize_p(jnp.asarray(p.numpy().T), 7, 16).T
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert bool((ours[:3, 40:] == 0).all())
    assert torch.equal(k2.attend_plain(s, torch.eye(64), 8), ours)


@pytest.mark.parametrize("pre_quantized", [False, True])
def test_model_level_fused_attention_matches_jax(pre_quantized):
    kw = dict(vocab_size=128, hidden=256, layers=1, heads=4, kv_heads=2,
              inter=256, max_pos=128)
    jattn = jmodels.quantize_model(JLlamaConfig.tiny(**kw), Q_CONFIG,
                                   None)[0]["attn"]
    tattn = tmodels.quantize_model(LlamaConfig.tiny(**kw), Q_CONFIG,
                                   None)[0]["attn"]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 4, 32, 64)).astype(np.float32)
               for _ in range(3))
    if pre_quantized:  # K/V arrive on their MXINT8 cache grid
        k, v = (np.array(mx8_decode(*mx8_encode(jnp.asarray(t), 16, 1.0),
                                      16, jnp.float32)) for t in (k, v))
    ref = np.asarray(jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jattn, 0.125,
        interpret=True, kv_values_pre_quantized=pre_quantized))
    ours = fused_quantized_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tattn,
        0.125, kv_values_pre_quantized=pre_quantized).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
