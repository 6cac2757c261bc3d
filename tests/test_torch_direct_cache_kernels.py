"""The direct-write caches' kernels: the port's plain versions against the
JAX package's Pallas entries in interpret mode, on seeded layer-stacked
caches read at ``layer_index``, GQA with n_rep = 2, positions at and across
16-token group boundaries:

- fp-cache decode attention (``decode_attention``);
- quantized decode attention over MXINT8 and MXINT4 codes
  (``decode_attention_quantized``);
- the fused MXINT8 write + attend (``decode_attention_quantized_write``);
- the row write in both orientations (``write_kv_rows_stacked``).

Attention outputs are allclose (rtol = atol = 2e-4: exp and the f32
summation order differ, no 8-bit rounding of p flips on these seeds);
written caches and rows are bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.models.common import AttnQConfig as JAttnQConfig
from lqer_tpu.ops.pallas import cache_write as jcw
from lqer_tpu.ops.pallas import decode_attention as jda
from lqer_tpu.parallel.collectives import mx4_encode, mx8_encode
from lqer_tpu_torch.models.common import AttnQConfig
from lqer_tpu_torch.ops.kernels import cache_write as tcw
from lqer_tpu_torch.ops.kernels import fp_decode, quantized_decode
from lqer_tpu_torch.serving.random_model import KV4_Q_CONFIG, Q_CONFIG
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

NL, B, KVH, D, L = 2, 3, 2, 64, 128
NREP = 2
H = KVH * NREP
SCALING = D ** -0.5
POSITIONS = [
    [15, 16, 47],     # the last row of a group, the first of the next
    [31, 0, 127],     # a group end, the first token, the last column
    [64, 17, 95],
]


def _rng_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kh = rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
    vh = rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
    return rng, q, kh, vh


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("positions", POSITIONS)
def test_fp_decode_matches_jax(li, positions):
    """Every cached row holds a value, those past each position too: the
    K^T groups quantize whole 16-token groups."""
    rng, q, _, _ = _rng_inputs(li * 100 + positions[0])
    k, v = (np.asarray(jnp.asarray(rng.standard_normal((NL, B, KVH, L, D)),
                                   jnp.bfloat16)) for _ in range(2))
    pos = np.array(positions, np.int32)
    want = jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scaling=SCALING, layer_index=jnp.asarray([li], jnp.int32),
        interpret=True)
    got = fp_decode.decode_attention_fp(
        _t(q), _t(k.astype(np.float32)).to(torch.bfloat16),
        _t(v.astype(np.float32)).to(torch.bfloat16), _t(pos), li,
        scaling=SCALING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def _quantized_cache(rng, width):
    enc = mx8_encode if width == 8 else mx4_encode
    out = []
    for _ in range(2):
        vals = jnp.asarray(rng.standard_normal((NL, B, KVH, L, D)),
                           jnp.float32)
        c, e = enc(vals, 16, zero_fill=1.0)
        out += [np.array(jnp.swapaxes(c, -1, -2)),
                np.array(jnp.swapaxes(e, -1, -2))]
    return out


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("positions", POSITIONS)
def test_quantized_decode_matches_jax(width, li, positions):
    rng, q, _, _ = _rng_inputs(width * 10 + li * 100 + positions[0])
    cache = _quantized_cache(rng, width)
    pos = np.array(positions, np.int32)
    want = jda.decode_attention_quantized(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(pos),
        scaling=SCALING, layer_index=jnp.asarray([li], jnp.int32),
        interpret=True)
    got = quantized_decode.decode_attention_quantized(
        _t(q), *(_t(a) for a in cache), _t(pos), li, scaling=SCALING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("positions", POSITIONS)
def test_fused_write_attend_matches_jax(li, positions):
    rng, q, kh, vh = _rng_inputs(li * 100 + positions[1])
    kh[0, 0, 0, :16] = 0.0                     # an all-zero group
    cache = _quantized_cache(rng, 8)
    pos = np.array(positions, np.int32)
    attn, *written = jda.decode_attention_quantized_write(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(kh),
        jnp.asarray(vh), jnp.asarray(pos), jnp.asarray([li], jnp.int32),
        scaling=SCALING, interpret=True)
    ours = [_t(a) for a in cache]
    got = quantized_decode.decode_attention_quantized_write(
        _t(q), *ours, _t(kh), _t(vh), _t(pos), li, scaling=SCALING)
    np.testing.assert_allclose(got.numpy(), np.asarray(attn), rtol=2e-4,
                               atol=2e-4)
    for mine, theirs in zip(ours, written):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("li", [0, 1])
def test_row_write_bf16_rows_match_jax(li):
    """f32 rows into the bf16 fp cache (token axis on dim 3), rounded to
    nearest even; values one half-ulp off a bf16 grid point included."""
    rng = np.random.default_rng(li)
    cache = [np.asarray(jnp.asarray(rng.standard_normal((NL, B, KVH, L, D)),
                                    jnp.bfloat16)) for _ in range(2)]
    rows = [rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
            for _ in range(2)]
    rows[0][0, 0, 0, :4] = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                     -(1 + 2 ** -8), 2 ** -140], np.float32)
    pos = np.array([0, 77, 127], np.int32)
    want = jcw.write_kv_rows_stacked(
        tuple(jnp.asarray(a) for a in cache),
        tuple(jnp.asarray(r) for r in rows), jnp.asarray([li], jnp.int32),
        jnp.asarray(pos), interpret=True)
    ours = [_t(a.astype(np.float32)).to(torch.bfloat16) for a in cache]
    tcw.write_kv_rows_stacked(tuple(ours), tuple(_t(r) for r in rows), li,
                              _t(pos))
    for mine, theirs in zip(ours, want):
        np.testing.assert_array_equal(
            mine.view(torch.int16).numpy(),
            np.asarray(theirs).view(np.int16))


@pytest.mark.parametrize("li", [0, 1])
def test_row_write_mxint4_columns_match_jax(li):
    """The four token-axis-last MXINT4 arrays (token axis on dim 4)."""
    rng = np.random.default_rng(10 + li)
    cache = _quantized_cache(rng, 4)
    news = []
    for _ in range(2):
        c, e = mx4_encode(jnp.asarray(rng.standard_normal((B, KVH, 1, D)),
                                      jnp.float32), 16, zero_fill=1.0)
        news += [np.array(jnp.swapaxes(c, -1, -2)),
                 np.array(jnp.swapaxes(e, -1, -2))]
    pos = np.array([127, 16, 15], np.int32)
    want = jcw.write_kv_rows_stacked(
        tuple(jnp.asarray(a) for a in cache),
        tuple(jnp.asarray(n) for n in news), jnp.asarray([li], jnp.int32),
        jnp.asarray(pos), interpret=True)
    ours = [_t(a) for a in cache]
    tcw.write_kv_rows_stacked(tuple(ours), tuple(_t(n) for n in news), li,
                              _t(pos))
    for mine, theirs in zip(ours, want):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_row_write_skips_positions_past_the_cache():
    """A position outside [0, L) writes nothing (the kernel checks on the
    device; the JAX kernel takes in-range positions as a precondition)."""
    pos = torch.tensor([3, 32])
    cols = torch.ones(2, 1, 4, 1, dtype=torch.int8)
    lane = torch.zeros(1, 2, 1, 4, 32, dtype=torch.int8)
    tcw.write_kv_rows_stacked((lane,), (cols,), 0, pos)
    rows = torch.ones(2, 1, 1, 4)
    row = torch.zeros(1, 2, 1, 32, 4, dtype=torch.bfloat16)
    tcw.write_kv_rows_stacked((row,), (rows,), 0, pos)
    for arr, written in ((lane, lane[0, 0, 0, :, 3]), (row, row[0, 0, 0, 3])):
        assert written.tolist() == [1, 1, 1, 1]
        assert float(arr.float().abs().sum()) == 4


@pytest.mark.parametrize("q_config,width,ok", [
    (Q_CONFIG, 8, True), (Q_CONFIG, 4, False), (KV4_Q_CONFIG, 4, True),
    (KV4_Q_CONFIG, 8, False)])
def test_eligibility_and_widths_match_jax(q_config, width, ok):
    mm = q_config["matmul"]
    cfg = dict(qk_cfg=mm, pv_cfg=mm, q_proj=None, k_proj=None, v_proj=None,
               o_proj=None, qk_matmul=None, pv_matmul=None)
    ours, theirs = AttnQConfig(**cfg), JAttnQConfig(**cfg)
    assert fp_decode.supports_decode_attention(ours, width) is ok
    assert jda.supports_decode_attention(theirs, cache_width=width) is ok
    assert fp_decode.decode_attention_widths(ours) == \
        jda.decode_attention_widths(theirs)
    assert quantized_decode.decode_attention_widths_quantized(ours) == \
        jda.decode_attention_widths_quantized(theirs)
