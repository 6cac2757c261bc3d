"""The ``float32`` KV cache: the f32 forms of rows 5 (the fp-cache decode
attention) and 11 (the row write).

- The plain versions against the JAX package's entries in interpret mode
  (``decode_attention`` and ``write_kv_rows_stacked`` over f32 arrays), as
  ``tests/test_torch_direct_cache_kernels.py`` holds the bf16 forms: the
  attention outputs within rtol = atol = 2e-4, the written cache bit-exact
  (f32 rows stored unrounded). The cache holds values that no bf16 holds,
  and values at |v| <= 1e-8, which the quantizers pass through unrounded.
- The route of a decode step over the f32 cache: the JAX package's
  (``_use_attn_kernel``: the fp kernel within its one-pass length, which
  at 4 bytes a value is half the bf16 cache's) and the kernels it names
  (the stacked step: the row write, then row 5; the eager step: row 5).
- ``decode.check_servable`` lets the f32 cache through on the card.
  (The engines, stacked and eager, with a kernel backend on the f32 cache
  against the JAX engine: ``test_torch_serving.py::
  test_unported_options_raise``, its ``float32`` case.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.pallas import cache_write as jcw
from lqer_tpu.ops.pallas import decode_attention as jda
from lqer_tpu.serving import decode as jdecode
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.ops.kernels import cache_write as tcw
from lqer_tpu_torch.ops.kernels import fp_decode
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.testing import one_torch_thread_fixture

from test_torch_direct_cache_kernels import (
    B, D, KVH, L, NL, POSITIONS, SCALING, _rng_inputs, _t)
from test_torch_serving import Q_CONFIG, RANK, TINY, _jax_model

_one_torch_thread = one_torch_thread_fixture()


def _f32_cache(rng):
    """Layer-stacked f32 K and V with values off the bf16 grid, a run of
    values at |v| <= 1e-8 and an all-tiny 16-group in the first slot."""
    out = []
    for _ in range(2):
        a = rng.standard_normal((NL, B, KVH, L, D)).astype(np.float32)
        a[:, 0, 0, :16, :] = 5e-9          # every K^T group of 16 tokens
        a[:, 1, 1, 40, :16] = -3e-9        # one 16-wide V group
        a[:, 2, :, 70:90, 7] *= 1e-9
        out.append(a)
    return out


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("positions", POSITIONS)
def test_fp_decode_f32_matches_jax(li, positions):
    rng, q, _, _ = _rng_inputs(li * 100 + positions[0] + 7)
    k, v = _f32_cache(rng)
    pos = np.array(positions, np.int32)
    want = jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scaling=SCALING, layer_index=jnp.asarray([li], jnp.int32),
        interpret=True)
    got = fp_decode.decode_attention_fp(_t(q), _t(k), _t(v), _t(pos), li,
                                        scaling=SCALING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # not the bf16 cache's function: rounding the cache to bf16 moves it
    rounded = fp_decode.fp_decode_plain(
        _t(q), _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16), _t(pos),
        li, scaling=SCALING)
    assert not torch.equal(rounded, got)


@pytest.mark.parametrize("li", [0, 1])
def test_row_write_f32_rows_match_jax(li):
    """f32 rows into the f32 cache, unrounded (values a bf16 rounds, and
    a subnormal); a position past the cache writes nothing."""
    rng = np.random.default_rng(li + 20)
    cache = [rng.standard_normal((NL, B, KVH, L, D)).astype(np.float32)
             for _ in range(2)]
    rows = [rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
            for _ in range(2)]
    rows[0][0, 0, 0, :4] = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -9,
                                     -(1 + 2 ** -20), 2 ** -140], np.float32)
    pos = np.array([0, 77, 127], np.int32)
    want = jcw.write_kv_rows_stacked(
        tuple(jnp.asarray(a) for a in cache),
        tuple(jnp.asarray(r) for r in rows), jnp.asarray([li], jnp.int32),
        jnp.asarray(pos), interpret=True)
    ours = [_t(a) for a in cache]
    tcw.write_kv_rows_stacked(tuple(ours), tuple(_t(r) for r in rows), li,
                              _t(pos))
    for mine, theirs in zip(ours, want):
        np.testing.assert_array_equal(mine.view(torch.int32).numpy(),
                                      np.asarray(theirs).view(np.int32))
    assert ours[0][li, 0, 0, 0, 0] == rows[0][0, 0, 0, 0]
    past = [_t(a) for a in cache]
    tcw.write_kv_rows_stacked(tuple(past), tuple(_t(r) for r in rows), li,
                              torch.tensor([L, -1, L], dtype=torch.int32))
    assert all(torch.equal(p, _t(a)) for p, a in zip(past, cache))


@pytest.mark.parametrize("max_len", [128, 6144, 6160, 12288])
def test_f32_routes_follow_the_jax_package(max_len):
    """The fp kernel takes the f32 cache up to JAX's one-pass length
    (6144 tokens at d = 128, 12288 at d = 64); the stacked step writes
    each row with row 11, then attends with row 5."""
    cfg = LlamaConfig.tiny(**TINY)
    tq = tmodels.quantize_model(cfg, Q_CONFIG, {"linear": {"rank": RANK}})
    jq = _jax_model(5)[2]
    tc = tdecode.make_cache(cfg, 1, max_len, "float32", device="meta")
    jc = {"k": jnp.zeros(1, jnp.float32), "v": jnp.zeros(1, jnp.float32)}
    for d in (64, 128):
        want = jdecode._fp_cache_kernel_fits(max_len, d, 4)
        assert tdecode._fp_cache_kernel_fits(max_len, d, 4) == want
        assert tdecode._use_attn_kernel(True, 1, tq[0]["attn"], max_len, d,
                                        tc) == want
    assert jdecode._use_attn_kernel(object(), 1, jq[0]["attn"], max_len, 64,
                                    cache=jc) == \
        tdecode._use_attn_kernel(True, 1, tq[0]["attn"], max_len, 64, tc)
    assert tdecode.decode_route("float32", max_len, 128, 2) == (
        "row_write", "decode_attention_fp")
    assert tdecode.decode_route("float32", max_len, 128, 2, eager=True) == (
        "decode_attention_fp",)


def test_check_servable_takes_the_f32_cache():
    """On the card (a cache whose tensors report a CUDA device), the f32
    cache passes ``check_servable`` for the stacked and the eager step,
    with and without a backend."""
    cfg = LlamaConfig.tiny(**TINY)
    tq = tmodels.quantize_model(cfg, Q_CONFIG, {"linear": {"rank": RANK}})
    cache = tdecode.make_cache(cfg, 2, 256, "float32", device="meta")

    class OnCard:
        def __init__(self, t):
            self.t, self.device = t, torch.device("cuda", 0)

        def __getattr__(self, name):
            return getattr(self.t, name)

    card = {k: OnCard(v) for k, v in cache.items()}
    attn = [q["attn"] for q in tq]
    for scan in (False, True):
        for backend in (False, True):
            tdecode.check_servable(card, attn, cfg.head_dim, backend=backend,
                                   scan=scan)
