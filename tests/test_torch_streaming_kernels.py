"""The long-context kernels: the port's plain versions against the JAX
package's Pallas entries in interpret mode, on seeded layer-stacked caches
read at ``layer_index``, GQA with n_rep = 2, L = 512 streamed by the JAX
kernels in chunks of 128 (as ``tests/test_attention_kernel.py:328-357``),
positions at and across a chunk boundary:

- streaming decode attention over MXINT8 and MXINT4 codes
  (``decode_attention_quantized_streaming``);
- the same over the ring-staged MXINT8 cache, with the fresh token's ring
  write (``decode_attention_quantized_streaming_staged``);
- the fused MXINT8 encode + column write (``write_kv_tokens_fused``).

Attention outputs are held to rtol = atol = 2e-4 plus one 8-bit code step
of p times |v| (``testing.attention_limit``): the JAX kernels combine the
softmax stats chunk by chunk, the plain versions over the whole row, so
their f32 sums run in other orders. Ring and cache bytes are bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.pallas import cache_write as jcw
from lqer_tpu.ops.pallas import decode_attention as jda
from lqer_tpu.parallel.collectives import mx4_encode, mx8_encode
from lqer_tpu_torch.ops.kernels import cache_write as tcw
from lqer_tpu_torch.ops.kernels import decode_attention as tstaged
from lqer_tpu_torch.ops.kernels import quantized_decode, streaming_decode
from lqer_tpu_torch.testing import (
    attention_limit,
    check_close,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()

NL, B, KVH, D, L, SW = 2, 3, 2, 64, 512, 64
NREP = 2
H = KVH * NREP
SCALING = D ** -0.5
L_CHUNK = 128
POSITIONS = [
    [127, 128, 511],   # a chunk's last token, the next one's first, the end
    [0, 129, 383],
    [255, 256, 300],
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _encoded(rng, shape, width=8):
    """MXINT codes and exps of seeded values (…, N, D), token axis last."""
    enc = mx8_encode if width == 8 else mx4_encode
    c, e = enc(jnp.asarray(rng.standard_normal(shape), jnp.float32), 16,
               zero_fill=1.0)
    return [np.array(jnp.swapaxes(c, -1, -2)),
            np.array(jnp.swapaxes(e, -1, -2))]


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("positions", POSITIONS)
def test_streaming_decode_matches_jax(width, li, positions):
    rng = np.random.default_rng(width * 10 + li * 100 + positions[1])
    cache = (_encoded(rng, (NL, B, KVH, L, D), width)
             + _encoded(rng, (NL, B, KVH, L, D), width))
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    pos = np.array(positions, np.int32)
    want = jda.decode_attention_quantized_streaming(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(pos),
        scaling=SCALING, l_chunk=L_CHUNK, interpret=True,
        layer_index=jnp.asarray([li], jnp.int32))
    args = (_t(q), *(_t(a) for a in cache), _t(pos), li)
    got = streaming_decode.decode_attention_quantized_streaming(
        *args, scaling=SCALING)
    s, vals = quantized_decode.quantized_scores(*args, scaling=SCALING)
    want_t = _t(want)
    check_close(f"streaming decode width {width}", got, want_t,
                attention_limit(s, vals, want_t, p_width=8),
                max_flipped=0.05)


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("positions,flushed", [
    ([130, 300, 511], [128, 256, 480]),   # main ends at a chunk boundary
    ([37, 191, 447], [32, 160, 384]),     # a ring past a chunk's end
])
def test_streaming_staged_decode_matches_jax(li, positions, flushed):
    """The ring lanes below ``flushed`` hold older tokens than the main
    cache and must be masked; the fresh token lands in lane pos % 64 of
    layer ``li`` only."""
    rng = np.random.default_rng(li * 7 + positions[0])
    main = (_encoded(rng, (NL, B, KVH, L, D))
            + _encoded(rng, (NL, B, KVH, L, D)))
    ring = (_encoded(rng, (NL, B, KVH, SW, D))
            + _encoded(rng, (NL, B, KVH, SW, D)))
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    kh[0, 0, 0, :16] = 0.0                     # an all-zero group
    pos = np.array(positions, np.int32)
    fl = np.array(flushed, np.int32)
    attn, *rings = jda.decode_attention_quantized_streaming_staged(
        jnp.asarray(q), *(jnp.asarray(a) for a in main + ring),
        jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(pos), jnp.asarray(fl),
        jnp.asarray([li], jnp.int32), scaling=SCALING, l_chunk=L_CHUNK,
        interpret=True)
    ours = [_t(a) for a in ring]
    layer = [_t(a)[li] for a in main]
    got = streaming_decode.decode_attention_quantized_streaming_staged(
        _t(q), *layer, *(a[li] for a in ours), _t(kh), _t(vh), _t(pos),
        _t(fl), scaling=SCALING)
    for mine, theirs in zip(ours, rings):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    s, vals = tstaged.staged_scores(_t(q), *layer, *(a[li] for a in ours),
                                    _t(pos), _t(fl), scaling=SCALING)
    want_t = _t(attn)
    check_close("streaming staged decode", got, want_t,
                attention_limit(s[:, :, None, :], vals, want_t, p_width=8),
                max_flipped=0.05)


def test_streaming_staged_at_flushed_zero_matches_one_pass():
    """A slot whose main cache holds nothing yet (flushed = 0, a prompt
    shorter than 32 tokens): the JAX streaming staged kernel returns NaN
    for it (its first main chunk has no valid column, and its running
    denominator takes exp(-inf - -inf)); the port's function is the JAX
    one-pass staged kernel's there, as everywhere."""
    rng = np.random.default_rng(11)
    main = (_encoded(rng, (NL, B, KVH, L, D))
            + _encoded(rng, (NL, B, KVH, L, D)))
    ring = (_encoded(rng, (NL, B, KVH, SW, D))
            + _encoded(rng, (NL, B, KVH, SW, D)))
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([5, 31, 40], np.int32)
    fl = np.array([0, 0, 32], np.int32)
    jargs = (jnp.asarray(q), *(jnp.asarray(a) for a in main + ring),
             jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(pos),
             jnp.asarray(fl), jnp.asarray([1], jnp.int32))
    stream, *_ = jda.decode_attention_quantized_streaming_staged(
        *jargs, scaling=SCALING, l_chunk=L_CHUNK, interpret=True)
    assert np.isnan(np.asarray(stream)).any(axis=(1, 2, 3)).tolist() == \
        [True, True, False]
    attn, *rings = jda.decode_attention_quantized_staged(
        *jargs, scaling=SCALING, interpret=True)
    ours = [_t(a) for a in ring]
    layer = [_t(a)[1] for a in main]
    got = streaming_decode.decode_attention_quantized_streaming_staged(
        _t(q), *layer, *(a[1] for a in ours), _t(kh), _t(vh), _t(pos),
        _t(fl), scaling=SCALING)
    for mine, theirs in zip(ours, rings):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    s, vals = tstaged.staged_scores(_t(q), *layer, *(a[1] for a in ours),
                                    _t(pos), _t(fl), scaling=SCALING)
    want_t = _t(attn)
    # a handful of tokens per row: one flipped p moves a whole output row,
    # 1/12 of the outputs here
    check_close("streaming staged decode at flushed 0", got, want_t,
                attention_limit(s[:, :, None, :], vals, want_t, p_width=8),
                max_flipped=1 / 12)


@pytest.mark.parametrize("li", [0, 1])
def test_fused_encode_write_matches_jax(li):
    """Bit-exact with ``write_kv_tokens_fused``, on the corner rows of the
    JAX package's own test (``tests/test_serving.py:190``): exact powers of
    two, an all-zero group, values near the smallest normal (just above it:
    XLA on the CPU flushes subnormal operands to zero, the port does not,
    ``test_torch_quantizers.py::test_subnormal_group_clamps_to_minus_127``)."""
    rng = np.random.default_rng(3 + li)
    Lw = 128
    cache = [rng.integers(-90, 90, (NL, B, KVH, r, Lw)).astype(np.int8)
             for r in (D, D // 16, D, D // 16)]
    kh = rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
    vh = rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
    kh[0, 0, 0, :16] = 2.0 ** np.arange(-8, 8)
    kh[0, 1, 0, :16] = 0.0
    vh[1, 0, 0, :16] = 1.2e-38
    pos = np.array([5, 127, 64], np.int32)
    want = jcw.write_kv_tokens_fused(
        tuple(jnp.asarray(a) for a in cache), jnp.asarray(kh),
        jnp.asarray(vh), jnp.asarray([li], jnp.int32), jnp.asarray(pos),
        group=16, interpret=True)
    ours = [_t(a) for a in cache]
    tcw.write_kv_tokens_fused(tuple(ours), _t(kh), _t(vh), li, _t(pos))
    for mine, theirs in zip(ours, want):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_fused_encode_write_skips_positions_past_the_cache():
    """A position outside [0, L) writes nothing (the kernel checks on the
    device; the JAX kernel takes in-range positions as a precondition)."""
    cache = tuple(torch.zeros(1, 2, 1, r, 32, dtype=torch.int8)
                  for r in (D, D // 16, D, D // 16))
    rows = torch.full((2, 1, 1, D), 3.0)
    tcw.write_kv_tokens_fused(cache, rows, rows, 0, torch.tensor([3, 32]))
    assert cache[0][0, 0, 0, :, 3].tolist() == [96] * D    # 3 = 96 · 2^(2-7)
    assert cache[1][0, 0, 0, :, 3].tolist() == [2] * (D // 16)
    assert all(int(a[0, 1].abs().sum()) == 0 for a in cache)
