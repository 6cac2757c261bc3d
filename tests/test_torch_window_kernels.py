"""Mistral's kernels: the sliding window of the decode kernels (rows 5, 6, 8
and 10) and rank 128 in kernel 1 and the megakernel, the port's plain
versions against the JAX package's Pallas entries in interpret mode.

- fp-cache decode attention (``decode_attention``), quantized decode
  attention at widths 8 and 4 (``decode_attention_quantized``), the fused
  MXINT8 write + attend (``decode_attention_quantized_write``) and the
  streaming kernel at widths 8 and 4
  (``decode_attention_quantized_streaming``, L = 512 in chunks of 128, so
  whole chunks lie below the window) with ``window=40``: not a multiple of
  16, so a P quantizer group straddles the window's lower edge. Positions
  below the window (nothing cut), at its edge and past it; n_rep 1 and 4;
  ``scale_query`` on and off.
- kernel 1 at the fused q|k|v rank of the reference's rank 128 (384) and
  the gated megakernel at rank 128.

Attention outputs are held to rtol = atol = 2e-4 plus one 8-bit code step
of p times |v| (``testing.attention_limit``), the GEMMs to rtol = atol =
2e-4 and the MLP to ``testing.mlp_limit``: the f32 summation orders
differ, the products are exact. Written cache bytes are bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops import storage as jstorage
from lqer_tpu.ops.pallas import decode_attention as jda
from lqer_tpu.ops.pallas.dequant_gemm import prepare_w4_weights as jprep_w4
from lqer_tpu.ops.pallas.dequant_gemm import qlinear_w4_fused as jfused
from lqer_tpu.ops.pallas.mlp_fused import mlp_w4_fused as jmlp
from lqer_tpu.parallel.collectives import mx4_encode, mx8_encode
from lqer_tpu_torch.convert import backend_from_jax
from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
from lqer_tpu_torch.ops.kernels import fp_decode, quantized_decode
from lqer_tpu_torch.ops.kernels import mlp_fused as k5
from lqer_tpu_torch.ops.kernels import streaming_decode
from lqer_tpu_torch.ops.kernels.decode_attention import key_mask
from lqer_tpu_torch.ops.storage import MXINT4, MXFormat
from lqer_tpu_torch.testing import (
    attention_limit,
    check_close,
    dequant_gemm_limit,
    mlp_limit,
    one_torch_thread_fixture,
)
from test_torch_mlp_fused import KW as MLP_KW
from test_torch_mlp_fused import _case as mlp_case

_one_torch_thread = one_torch_thread_fixture()

NL, B, KVH, D = 2, 3, 2, 64
WINDOW = 40
SCALING = D ** -0.5
# (positions, n_rep, scale_query): in each case a slot below the window
# (39: no key cut), one at its edge (40: key 0 cut) and one past it (127:
# the window's first key 88 inside a 16-token group); n_rep 1 and 4, with
# the query scaled before its quantizer (OPT's mode) and without
CASES = [([39, 40, 127], 1, False), ([39, 40, 127], 4, True)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, nrep, L, width):
    """q, the fresh rows and a seeded layer-stacked cache: bf16 rows
    (width None) or MXINT codes and exps, token axis last."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH * nrep, 1, D)).astype(np.float32)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    if width is None:
        cache = [np.asarray(jnp.asarray(rng.standard_normal(
            (NL, B, KVH, L, D)), jnp.bfloat16)) for _ in range(2)]
        return q, kh, vh, cache
    enc = mx8_encode if width == 8 else mx4_encode
    cache = []
    for _ in range(2):
        c, e = enc(jnp.asarray(rng.standard_normal((NL, B, KVH, L, D)),
                               jnp.float32), 16, zero_fill=1.0)
        cache += [np.array(jnp.swapaxes(c, -1, -2)),
                  np.array(jnp.swapaxes(e, -1, -2))]
    return q, kh, vh, cache


def _held(name, got, want, scores, values):
    want = torch.from_numpy(np.array(want))
    check_close(name, got, want, attention_limit(scores, values, want,
                                                 p_width=8), 0.05)


def test_key_mask_is_the_tpu_kernels_mask():
    pos = torch.tensor([0, 39, 40, 127])
    ok = key_mask(128, pos, WINDOW)
    j = np.arange(128)[None, :]
    p = pos.numpy()[:, None]
    np.testing.assert_array_equal(ok.numpy(), (j <= p) & (j > p - WINDOW))
    np.testing.assert_array_equal(key_mask(128, pos, None).numpy(), j <= p)
    assert ok.sum(1).tolist() == [1, 40, 40, 40]


@pytest.mark.parametrize("positions,nrep,scale_query", CASES)
def test_windowed_fp_decode_matches_jax(positions, nrep, scale_query):
    q, _, _, (k, v) = _inputs(positions[1] + nrep, nrep, 128, None)
    pos = np.array(positions, np.int32)
    kw = dict(scaling=SCALING, scale_query=scale_query, window=WINDOW)
    want = jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        layer_index=jnp.asarray([1], jnp.int32), interpret=True, **kw)
    kt, vt = (_t(a.astype(np.float32)).to(torch.bfloat16) for a in (k, v))
    got = fp_decode.decode_attention_fp(_t(q), kt, vt, _t(pos), 1, **kw)
    s, vals = fp_decode.fp_scores(_t(q), kt, vt, _t(pos), 1, **kw)
    _held("windowed fp decode", got, want, s, vals)


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("positions,nrep,scale_query", CASES)
def test_windowed_quantized_decode_matches_jax(positions, nrep, width,
                                               scale_query):
    q, _, _, cache = _inputs(positions[0] * width + nrep, nrep, 128, width)
    pos = np.array(positions, np.int32)
    kw = dict(scaling=SCALING, scale_query=scale_query, window=WINDOW)
    want = jda.decode_attention_quantized(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(pos),
        layer_index=jnp.asarray([1], jnp.int32), interpret=True, **kw)
    ours = [_t(a) for a in cache]
    got = quantized_decode.decode_attention_quantized(_t(q), *ours, _t(pos),
                                                      1, **kw)
    s, vals = quantized_decode.quantized_scores(_t(q), *ours, _t(pos), 1,
                                                **kw)
    _held(f"windowed quantized decode width {width}", got, want, s, vals)


@pytest.mark.parametrize("positions,nrep,scale_query", CASES)
def test_windowed_fused_write_attend_matches_jax(positions, nrep,
                                                 scale_query):
    q, kh, vh, cache = _inputs(positions[1] * 3 + nrep, nrep, 128, 8)
    pos = np.array(positions, np.int32)
    kw = dict(scaling=SCALING, scale_query=scale_query, window=WINDOW)
    attn, *written = jda.decode_attention_quantized_write(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(kh),
        jnp.asarray(vh), jnp.asarray(pos), jnp.asarray([1], jnp.int32),
        interpret=True, **kw)
    ours = [_t(a) for a in cache]
    got = quantized_decode.decode_attention_quantized_write(
        _t(q), *ours, _t(kh), _t(vh), _t(pos), 1, **kw)
    for mine, theirs in zip(ours, written):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    s, vals = quantized_decode.quantized_scores(_t(q), *ours, _t(pos), 1,
                                                **kw)
    _held("windowed fused write + attend", got, attn, s, vals)


@pytest.mark.parametrize("nrep,width,scale_query", [(1, 8, False),
                                                     (4, 4, True)])
def test_windowed_streaming_decode_matches_jax(nrep, width, scale_query):
    """L = 512, the JAX kernel in chunks of 128. At position 30 no key is
    cut. At 300 and 511 the window's first key (261, 472; not 16-aligned)
    leaves the chunks [0, 128) and [128, 256) wholly masked, and there the
    JAX streaming kernel returns NaN: its pass 1 takes exp(-inf - -inf) for
    a first chunk without a key (``decode_attention.py:877``), a fault of
    the reference that stays there. The port computes the one-pass
    kernel's function, NaN-free: it is held to JAX's one-pass
    ``decode_attention_quantized`` with the window on every slot, and to
    the streaming kernel where that is finite."""
    q, _, _, cache = _inputs(width * 7 + nrep, nrep, 512, width)
    pos = np.array([30, 300, 511], np.int32)
    kw = dict(scaling=SCALING, scale_query=scale_query, window=WINDOW)
    jargs = (jnp.asarray(q), *(jnp.asarray(a) for a in cache),
             jnp.asarray(pos))
    stream = np.asarray(jda.decode_attention_quantized_streaming(
        *jargs, layer_index=jnp.asarray([1], jnp.int32), l_chunk=128,
        interpret=True, **kw))
    one_pass = jda.decode_attention_quantized(
        *jargs, layer_index=jnp.asarray([1], jnp.int32), interpret=True, **kw)
    assert np.isfinite(stream[0]).all() and np.isnan(stream[1:]).all()
    ours = [_t(a) for a in cache]
    got = streaming_decode.decode_attention_quantized_streaming(
        _t(q), *ours, _t(pos), 1, **kw)
    s, vals = quantized_decode.quantized_scores(_t(q), *ours, _t(pos), 1,
                                                **kw)
    _held(f"windowed streaming decode width {width}", got, one_pass, s, vals)
    _held(f"windowed streaming decode width {width}, slot 0", got[:1],
          stream[:1], s[:1], vals[:1])
    unwindowed = quantized_decode.quantized_decode_plain(
        _t(q), *ours, _t(pos), 1, scaling=SCALING, scale_query=scale_query)
    assert not torch.allclose(got[1:], unwindowed[1:], atol=1e-3)
    torch.testing.assert_close(got[0], unwindowed[0], rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, -1])
def test_window_must_hold_a_key(window):
    q, _, _, cache = _inputs(0, 1, 128, 8)
    with pytest.raises(ValueError, match="window"):
        quantized_decode.decode_attention_quantized(
            _t(q), *(_t(a) for a in cache), torch.zeros(B, dtype=torch.int32),
            1, scaling=SCALING, window=window)


@pytest.mark.parametrize("m", [8, 40])
def test_kernel1_at_fused_rank_384_matches_jax(m):
    """q|k|v of a rank-128 model: A (K, 3·128), B (3·128, N), several
    chunks of the card kernel's rank tile (any rank is taken since the
    whole-row q_xa group serves every width)."""
    K, N, R = 256, 512, 384
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((K, R)) * 0.05).astype(jnp.bfloat16)
    b = (rng.standard_normal((R, N)) * 0.05).astype(jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((m, K)), jnp.float32)
    x = jnp.asarray(k1._quantize_rows_mx(_t(x), 7).numpy(), jnp.bfloat16)
    prep = jprep_w4(jnp.asarray(w), a=jnp.asarray(a), b=jnp.asarray(b),
                    fmt=jstorage.MXFormat(4), tile_k=128, tile_n=256)
    meta = {"fmt": prep["fmt"], "tile_k": prep["tile_k"], "xa_width": 8,
            "out_width": 8}
    arrays = {k: None if prep[k] is None else np.asarray(prep[k])
              for k in ("tiles", "a", "b", "bias")}
    tprep = backend_from_jax({"w": arrays}, {"w": meta})["arrays"]["w"]
    kw = dict(quant_xa_width=8, quant_out_width=8)
    assert k1.rank_supported(R) and k1.rank_supported(136)
    xt = _t(x.astype(jnp.float32))
    ours = k1.qlinear_w4_fused(xt, tprep, MXFormat(4), **kw)
    want = torch.from_numpy(np.array(jfused(x, prep, tile_m=128,
                                            interpret=True, **kw)))
    check_close("kernel 1 at R 384", ours, want,
                dequant_gemm_limit(xt, tprep, want, **kw), 0.01)


@pytest.mark.parametrize("m", [8, 40])
def test_megakernel_at_rank_128_matches_jax(m):
    """The gated MLP of a rank-128 model: X·[A_g|A_u] is 256 wide, two
    chunks of the card kernel's rank tile, and H·A_d 128."""
    x, prep, xt, tprep = mlp_case(m, 128, seed=m + 128)
    assert tprep["a_gu"].shape[1] == 256
    ours = k5.mlp_w4_fused(xt, tprep, MXINT4, **MLP_KW)
    want = torch.from_numpy(np.array(jmlp(x, prep, tile_i=128, tile_n=128,
                                          interpret=True)))
    check_close("megakernel at rank 128", want, ours,
                mlp_limit(xt, tprep, ours, **MLP_KW), 0.05)
