"""The kernels on OPT's path in the modes OPT runs them: the port's plain
versions against the JAX package's Pallas entries in interpret mode (as its
own tests run them), on the same numpy-seeded inputs.

- the megakernel's un-gated relu variant with biases (fc1, fc2), and its
  large-M route, held to ``testing.mlp_limit`` (rtol = atol = 2e-4 plus one
  8-bit code step of each rounding a summation order can flip);
- kernel 1 with a bias (q|k|v and out_proj), rtol = atol = 2e-4;
- every decode kernel with ``scale_query=True`` (q times the scaling in f32
  before its quantizer, the scores unscaled) at d = 128, where the scaling
  is no power of two: fp cache, MXINT8 and MXINT4 caches, the fused write +
  attend, the staged cache, and the two streaming kernels; rtol = atol =
  2e-4 plus one p code step times |v| (``testing.attention_limit``);
  written bytes bit-exact;
- the prefill helper ``fused_quantized_attention(scale_query=True)`` in f32
  and bf16, rtol = atol = 2e-4;
- OPT's LayerNorm, bit-exact in bf16 (in f32 within 1e-5: XLA and torch
  sum the mean and variance in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import OPTConfig as JOPTConfig
from lqer_tpu.models.common import (
    fused_quantized_attention as jax_fused_attention,
)
from lqer_tpu.models.common import layer_norm as jax_layer_norm
from lqer_tpu.ops import storage as jstorage
from lqer_tpu.ops.pallas import decode_attention as jda
from lqer_tpu.ops.pallas.dequant_gemm import prepare_w4_weights as jax_prep_w
from lqer_tpu.ops.pallas.dequant_gemm import qlinear_w4_fused as jax_qlinear
from lqer_tpu.ops.pallas.mlp_fused import mlp_w4_dense_largeM as jax_dense
from lqer_tpu.ops.pallas.mlp_fused import mlp_w4_fused as jax_fused
from lqer_tpu.ops.pallas.mlp_fused import prepare_mlp_weights as jax_prepare
from lqer_tpu.ops.quantizers import block_fp_quantizer
from lqer_tpu.parallel.collectives import mx4_encode, mx8_decode, mx8_encode
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax
from lqer_tpu_torch.models import OPTConfig
from lqer_tpu_torch.models.common import fused_quantized_attention, layer_norm
from lqer_tpu_torch.ops.kernels import decode_attention as tstaged
from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
from lqer_tpu_torch.ops.kernels import fp_decode, quantized_decode
from lqer_tpu_torch.ops.kernels import mlp_fused as k5
from lqer_tpu_torch.ops.kernels import streaming_decode
from lqer_tpu_torch.ops.storage import MXINT4
from lqer_tpu_torch.serving.random_model import q_config_for
from lqer_tpu_torch.testing import (
    attention_limit,
    check_close,
    dequant_gemm_limit,
    mlp_limit,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()

K, I, N = 256, 512, 256
KW = dict(act_width=8, quant_xa_width=8, quant_out_width=8)
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(rng, m, k):
    x = block_fp_quantizer(jnp.asarray(rng.standard_normal((m, k)),
                                       jnp.float32),
                           width=8, exponent_width=8, block_size=[1, 16],
                           skip_first_dim=True).astype(jnp.bfloat16)
    return x, _t(x.astype(jnp.float32)).to(torch.bfloat16)


def _relu_case(m, rank, seed):
    """JAX relu/bias MLP prep, the port's converted prep, and x."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.05):
        return jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32)

    def ab(*shape):
        return jnp.asarray((rng.standard_normal(shape) * 0.05).astype(
            jnp.bfloat16).astype(np.float32))

    lr = {}
    if rank:
        lr = dict(a_gate=ab(K, rank), b_gate=ab(rank, I), a_down=ab(I, rank),
                  b_down=ab(rank, N))
    prep = jax_prepare(w(I, K), None, w(N, I), bias_gate=w(I, scale=0.2),
                       bias_down=w(N, scale=0.2), tile_i=128, tile_n=128,
                       **lr)
    assert not prep["gated"]
    x, xt = _x(rng, m, K)
    static = ("gated", "fmt", "tile_k", "tile_k2", "tile_i", "tile_n")
    meta = {"kind": "mlp", "act_width": 8, "xa_width": 8, "out_width": 8,
            **{k: prep[k] for k in static}}
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in prep.items() if k not in static}
    tprep = backend_from_jax({"mlp": arrays}, {"mlp": meta})["arrays"]["mlp"]
    return x, prep, xt, tprep


@pytest.mark.parametrize("rank", [0, 32])
@pytest.mark.parametrize("m", [8, 200])
def test_relu_megakernel_plain_matches_jax(m, rank):
    x, prep, xt, tprep = _relu_case(m, rank, seed=m + rank)
    assert tprep["codes_u"] is None and tprep["bias_g"].dtype == torch.float32
    if rank:
        assert tuple(tprep["a_gu"].shape) == (K, rank)   # fc1's A alone
    ours = k5.mlp_w4_fused(xt, tprep, MXINT4, **KW)      # CPU: plain version
    assert k5.mlp_w4_fused.launches == k5.mlp_w4_fused_relu.launches == 0
    lim = mlp_limit(xt, tprep, ours, **KW)
    fused = _t(jax_fused(x, prep, tile_i=128, tile_n=128, interpret=True))
    check_close("plain vs JAX relu mlp_w4_fused", fused, ours, lim, 0.05)
    dense = _t(jax_dense(x, prep))
    check_close("plain vs JAX relu mlp_w4_dense_largeM", dense, ours, lim,
                0.05)
    port_dense = k5.mlp_w4_dense_largeM(xt, tprep, MXINT4, **KW)
    check_close("relu large-M vs plain", port_dense, ours, lim, 0.05)


def test_relu_megakernel_limit_rejects_bias_order_and_missing_bias():
    """The bias comes after the correction and before relu: adding fc1's
    bias after relu, or leaving fc2's out, must fail the limit."""
    _, _, xt, tprep = _relu_case(8, 32, seed=3)
    want = k5.mlp_w4_plain(xt, tprep, MXINT4, **KW)
    lim = mlp_limit(xt, tprep, want, **KW)
    no_bias_d = dict(tprep, bias_d=None)
    with pytest.raises(AssertionError, match="limit"):
        check_close("no fc2 bias", k5.mlp_w4_plain(xt, no_bias_d, MXINT4,
                                                   **KW), want, lim, 0.05)
    late = dict(tprep, bias_g=None)
    y_g, _ = k5._gate_up(xt.float(), late, MXINT4, k5._plain_product, 8, 8)
    h = k5.hidden(y_g, None, 8) + tprep["bias_g"]        # bias after relu
    late_y = k1.qlinear_w4_plain(h, k5.down_prep(tprep), MXINT4,
                                 quant_xa_width=8, quant_out_width=8)
    with pytest.raises(AssertionError, match="limit"):
        check_close("fc1 bias after relu", late_y, want, lim, 0.05)


def test_relu_wrapper_refuses_gated_prep_and_other_devices():
    _, _, xt, tprep = _relu_case(8, 0, seed=9)
    with pytest.raises(ValueError):
        k5.mlp_w4_fused(xt.to("meta"), tprep, MXINT4, **KW)
    with pytest.raises(ValueError, match="gated"):
        k5.mlp_w4_fused_relu(xt, dict(tprep, codes_u=tprep["codes_g"]),
                             MXINT4, **KW)


@pytest.mark.parametrize("m", [8, 600])
def test_biased_linear_matches_jax(m):
    """Kernel 1 on OPT's fused q|k|v shape (N = 3 x 256) with a bias on the
    b_quantizer's MXINT8 grid and the rank-32 correction; at 600 rows also
    the large-M route."""
    rng = np.random.default_rng(m)
    w = jnp.asarray(rng.standard_normal((3 * 256, 256)) * 0.05, jnp.float32)
    a, b = (jnp.asarray((rng.standard_normal(s) * 0.05).astype(
        jnp.bfloat16)) for s in ((256, 32), (32, 768)))
    qc = tmodels.quantize_model(OPTConfig.tiny(hidden=256, ffn=512),
                                q_config_for(OPTConfig()),
                                {"linear": {"rank": 32}})[0]["attn"].q_proj
    bias = qc.b_quantizer(_t(rng.standard_normal(768) * 0.3).float())
    prep = jax_prep_w(w, a=a, b=b, bias=jnp.asarray(bias.numpy()),
                      fmt=jstorage.MXINT4, tile_k=128, tile_n=256)
    meta = {"fmt": prep["fmt"], "tile_k": prep["tile_k"], "xa_width": 8,
            "out_width": 8}
    arrays = {k: None if prep[k] is None else np.asarray(prep[k])
              for k in ("tiles", "a", "b", "bias")}
    tprep = backend_from_jax({"w": arrays}, {"w": meta})["arrays"]["w"]
    x, xt = _x(rng, m, 256)
    kw = dict(quant_xa_width=8, quant_out_width=8)
    ours = k1.qlinear_w4_fused(xt, tprep, MXINT4, **kw)
    want = _t(jax_qlinear(x, prep, tile_m=128, interpret=True, **kw))
    np.testing.assert_allclose(ours.numpy(), want.numpy(), **TOL)
    check_close("biased linear", ours, want,
                dequant_gemm_limit(xt, tprep, want, **kw), 0.01)
    if m >= 512:
        np.testing.assert_allclose(
            k1.qlinear_w4_dense_largeM(xt, tprep, MXINT4, **kw).numpy(),
            ours.numpy(), **TOL)
    no_bias = k1.qlinear_w4_plain(xt, dict(tprep, bias=None), MXINT4, **kw)
    assert not np.allclose(no_bias.numpy(), want.numpy(), **TOL)


# ---- decode kernels with scale_query (d = 128: scaling 0.0884, no power
# of two). OPT is MHA: n_rep = 1.
NL, B, KVH, D, L, SW = 2, 3, 2, 128, 128, 64
H = KVH
SCALING = D ** -0.5
POSITIONS = [15, 64, 127]


def _encoded(rng, shape, width=8):
    enc = mx8_encode if width == 8 else mx4_encode
    c, e = enc(jnp.asarray(rng.standard_normal(shape), jnp.float32), 16,
               zero_fill=1.0)
    return [np.array(jnp.swapaxes(c, -1, -2)),
            np.array(jnp.swapaxes(e, -1, -2))]


def _q(rng):
    return (rng.standard_normal((B, H, 1, D)) * 3).astype(np.float32)


def _differs(fn, **kw):
    """The same call with ``scale_query=False`` gives another result."""
    a = fn(scale_query=True, **kw)
    b = fn(scale_query=False, **kw)
    assert not torch.allclose(a, b, **TOL)
    return a


@pytest.mark.parametrize("li", [0, 1])
def test_fp_decode_scale_query_matches_jax(li):
    rng = np.random.default_rng(li)
    q = _q(rng)
    k, v = (np.asarray(jnp.asarray(rng.standard_normal((NL, B, KVH, L, D)),
                                   jnp.bfloat16)) for _ in range(2))
    pos = np.array(POSITIONS, np.int32)
    want = _t(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scaling=SCALING, scale_query=True,
        layer_index=jnp.asarray([li], jnp.int32), interpret=True))
    args = (_t(q), _t(k.astype(np.float32)).to(torch.bfloat16),
            _t(v.astype(np.float32)).to(torch.bfloat16), _t(pos), li)
    got = _differs(lambda **kw: fp_decode.decode_attention_fp(
        *args, scaling=SCALING, **kw))
    s, vals = fp_decode.fp_scores(*args, scaling=SCALING, scale_query=True)
    check_close("fp decode, scale_query", got, want,
                attention_limit(s, vals, want, p_width=8), 0.05)


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("li", [0, 1])
def test_quantized_decode_scale_query_matches_jax(width, li):
    rng = np.random.default_rng(width + 10 * li)
    q = _q(rng)
    cache = (_encoded(rng, (NL, B, KVH, L, D), width)
             + _encoded(rng, (NL, B, KVH, L, D), width))
    pos = np.array(POSITIONS, np.int32)
    want = _t(jda.decode_attention_quantized(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(pos),
        scaling=SCALING, scale_query=True,
        layer_index=jnp.asarray([li], jnp.int32), interpret=True))
    args = (_t(q), *(_t(a) for a in cache), _t(pos), li)
    got = _differs(lambda **kw: quantized_decode.decode_attention_quantized(
        *args, scaling=SCALING, **kw))
    s, vals = quantized_decode.quantized_scores(*args, scaling=SCALING,
                                                scale_query=True)
    check_close(f"quantized decode width {width}, scale_query", got, want,
                attention_limit(s, vals, want, p_width=8), 0.05)


@pytest.mark.parametrize("li", [0, 1])
def test_fused_write_attend_scale_query_matches_jax(li):
    rng = np.random.default_rng(20 + li)
    q = _q(rng)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    cache = _encoded(rng, (NL, B, KVH, L, D)) + _encoded(rng,
                                                         (NL, B, KVH, L, D))
    pos = np.array(POSITIONS, np.int32)
    attn, *written = jda.decode_attention_quantized_write(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(kh),
        jnp.asarray(vh), jnp.asarray(pos), jnp.asarray([li], jnp.int32),
        scaling=SCALING, scale_query=True, interpret=True)
    ours = [_t(a) for a in cache]
    got = quantized_decode.decode_attention_quantized_write(
        _t(q), *ours, _t(kh), _t(vh), _t(pos), li, scaling=SCALING,
        scale_query=True)
    for mine, theirs in zip(ours, written):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    want = _t(attn)
    s, vals = quantized_decode.quantized_scores(
        _t(q), *ours, _t(pos), li, scaling=SCALING, scale_query=True)
    check_close("fused write + attend, scale_query", got, want,
                attention_limit(s, vals, want, p_width=8), 0.05)


@pytest.mark.parametrize("li", [0, 1])
def test_staged_decode_scale_query_matches_jax(li):
    rng = np.random.default_rng(30 + li)
    main = _encoded(rng, (NL, B, KVH, L, D)) + _encoded(rng,
                                                        (NL, B, KVH, L, D))
    ring = (_encoded(rng, (NL, B, KVH, SW, D))
            + _encoded(rng, (NL, B, KVH, SW, D)))
    q = _q(rng)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([70, 37, 127], np.int32)
    fl = np.array([64, 32, 96], np.int32)
    attn, *rings = jda.decode_attention_quantized_staged(
        jnp.asarray(q), *(jnp.asarray(a) for a in main + ring),
        jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(pos), jnp.asarray(fl),
        jnp.asarray([li], jnp.int32), scaling=SCALING, scale_query=True,
        interpret=True)
    layer = [_t(a)[li] for a in main]
    ours = [_t(a)[li].clone() for a in ring]
    got = tstaged.decode_attention_quantized_staged(
        _t(q), *layer, *ours, _t(kh), _t(vh), _t(pos), _t(fl),
        scaling=SCALING, scale_query=True)
    for mine, theirs in zip(ours, rings):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs)[li])
    want = _t(attn)
    s, vals = tstaged.staged_scores(_t(q), *layer, *ours, _t(pos), _t(fl),
                                    scaling=SCALING, scale_query=True)
    check_close("staged decode, scale_query", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                0.05)


@pytest.mark.parametrize("width", [8, 4])
def test_streaming_decode_scale_query_matches_jax(width):
    """L = 256 streamed by the JAX kernel in chunks of 128."""
    rng = np.random.default_rng(40 + width)
    LL = 256
    cache = (_encoded(rng, (NL, B, KVH, LL, D), width)
             + _encoded(rng, (NL, B, KVH, LL, D), width))
    q = _q(rng)
    pos = np.array([127, 128, 255], np.int32)
    want = _t(jda.decode_attention_quantized_streaming(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(pos),
        scaling=SCALING, scale_query=True, l_chunk=128, interpret=True,
        layer_index=jnp.asarray([1], jnp.int32)))
    args = (_t(q), *(_t(a) for a in cache), _t(pos), 1)
    got = _differs(lambda **kw: streaming_decode.
                   decode_attention_quantized_streaming(
                       *args, scaling=SCALING, **kw))
    s, vals = quantized_decode.quantized_scores(*args, scaling=SCALING,
                                                scale_query=True)
    check_close(f"streaming decode width {width}, scale_query", got, want,
                attention_limit(s, vals, want, p_width=8), 0.05)


def test_streaming_staged_decode_scale_query_matches_jax():
    """Every slot holds at least 32 flushed tokens (the JAX streaming staged
    kernel returns NaN at ``flushed = 0``)."""
    rng = np.random.default_rng(50)
    LL = 256
    main = (_encoded(rng, (NL, B, KVH, LL, D))
            + _encoded(rng, (NL, B, KVH, LL, D)))
    ring = (_encoded(rng, (NL, B, KVH, SW, D))
            + _encoded(rng, (NL, B, KVH, SW, D)))
    q = _q(rng)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([130, 37, 255], np.int32)
    fl = np.array([128, 32, 224], np.int32)
    attn, *rings = jda.decode_attention_quantized_streaming_staged(
        jnp.asarray(q), *(jnp.asarray(a) for a in main + ring),
        jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(pos), jnp.asarray(fl),
        jnp.asarray([0], jnp.int32), scaling=SCALING, scale_query=True,
        l_chunk=128, interpret=True)
    layer = [_t(a)[0] for a in main]
    ours = [_t(a)[0].clone() for a in ring]
    got = streaming_decode.decode_attention_quantized_streaming_staged(
        _t(q), *layer, *ours, _t(kh), _t(vh), _t(pos), _t(fl),
        scaling=SCALING, scale_query=True)
    for mine, theirs in zip(ours, rings):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs)[0])
    want = _t(attn)
    s, vals = tstaged.staged_scores(_t(q), *layer, *ours, _t(pos), _t(fl),
                                    scaling=SCALING, scale_query=True)
    check_close("streaming staged decode, scale_query", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                0.05)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("pre_quantized", [False, True])
def test_prefill_attention_scale_query_matches_jax(dtype, pre_quantized):
    """q times the scaling in q's dtype (the scalar rounded to bf16 first,
    as JAX's weakly typed scalar is), then q's quantizer, the kernel at
    scale 1.0."""
    cfg_kw = dict(vocab_size=128, hidden=256, layers=1, heads=2, ffn=512)
    q_config = q_config_for(OPTConfig())
    jattn = jmodels.quantize_model(JOPTConfig.tiny(**cfg_kw), q_config,
                                   None)[0]["attn"]
    tattn = tmodels.quantize_model(OPTConfig.tiny(**cfg_kw), q_config,
                                   None)[0]["attn"]
    rng = np.random.default_rng(11)
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal((2, 2, 32, D)) * 2,
                                      dtype)) for _ in range(3))
    if pre_quantized:  # K/V arrive on their MXINT8 cache grid
        k, v = (np.asarray(mx8_decode(*mx8_encode(jnp.asarray(t, jnp.float32),
                                                  16, 1.0), 16, dtype))
                for t in (k, v))
    ref = _t(jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jattn, SCALING,
        scale_query=True, interpret=True,
        kv_values_pre_quantized=pre_quantized).astype(jnp.float32))

    def ours(scale_query):
        tq, tk, tv = (_t(np.asarray(jnp.asarray(t, jnp.float32))).to(
            torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
            for t in (q, k, v))
        return fused_quantized_attention(
            tq, tk, tv, tattn, SCALING, scale_query=scale_query,
            kv_values_pre_quantized=pre_quantized).float()

    got = ours(True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    assert not torch.allclose(ours(False), got, **TOL)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, np.float32])
def test_layer_norm_bit_exact(dtype):
    """Normalised in f32, rounded to the input's dtype, then the affine:
    in bf16 equal bits to the JAX package's, and unlike torch's layer_norm,
    which rounds once after the affine; in f32 the sums' order shows."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((4, 6, 256)) * 3 + 1, dtype)
    w = jnp.asarray(rng.standard_normal(256) * 0.5 + 1, dtype)
    b = jnp.asarray(rng.standard_normal(256) * 0.1, dtype)
    want = np.asarray(jax_layer_norm(x, {"weight": w, "bias": b})
                      .astype(jnp.float32))
    tdt = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    tx, tw, tb = (_t(np.asarray(jnp.asarray(a, jnp.float32))).to(tdt)
                  for a in (x, w, b))
    got = layer_norm(tx, {"weight": tw, "bias": tb})
    assert got.dtype == tdt
    if dtype is np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)
        lib = torch.nn.functional.layer_norm(tx, (256,), tw, tb, eps=1e-5)
        assert not torch.equal(lib, got)
