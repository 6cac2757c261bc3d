"""The staged MXINT4 cache (``mxint4-staged``) against the JAX package:

- the width-4 cache-row encode (``_encode_t`` with ``mb=3, pack=True``)
  bit-exact with JAX's and with ``mx4_encode(zero_fill=1.0)``, on an
  all-zero group and groups whose absmax lies one ulp above a power of two;
- the staged decode kernels at code width 4, one-pass (row 7,
  ``decode_attention_quantized_staged``) and streaming (row 9,
  ``decode_attention_quantized_streaming_staged``, JAX in chunks of 128
  with ``flushed > 0``: the JAX streaming kernel gives NaN at 0), the
  port's plain versions against the JAX entries in interpret mode: rings
  bit-exact, outputs within ``attention_limit``;
- the flush and ``stage_boundary_sync`` over packed rings, bit-exact;
- the port's ``DecodeEngine`` on ``mxint4-staged`` against the JAX engine
  (``scan_layers=True`` and its default) on the tiny KV4 model of
  ``tests/test_kv4_cache.py:149``: equal greedy tokens, equal to the port's
  ``mxint4`` tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.ops.pallas import cache_write as jcw
from lqer_tpu.ops.pallas import decode_attention as jda
from lqer_tpu.parallel.collectives import mx4_encode as jmx4_encode
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu.serving import kv_cache as jkv
from lqer_tpu.serving.pallas_backend import prepare_serving_params
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.ops.kernels import cache_write as tcw
from lqer_tpu_torch.ops.kernels import decode_attention as tstaged
from lqer_tpu_torch.ops.kernels import streaming_decode
from lqer_tpu_torch.serving import DecodeEngine, Request
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving import kv_cache as tkv
from lqer_tpu_torch.serving.random_model import KV4_Q_CONFIG
from lqer_tpu_torch.testing import (
    attention_limit,
    check_close,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()

NL, B, KVH, D, SW = 2, 3, 2, 64, 64
NREP = 2
H = KVH * NREP
SCALING = D ** -0.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _encoded(rng, shape):
    """MXINT4 codes and exps of seeded values (…, N, D), token axis last."""
    c, e = jmx4_encode(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                       16, zero_fill=1.0)
    return [np.array(jnp.swapaxes(c, -1, -2)),
            np.array(jnp.swapaxes(e, -1, -2))]


def _staged_inputs(seed, L):
    rng = np.random.default_rng(seed)
    main = (_encoded(rng, (NL, B, KVH, L, D))
            + _encoded(rng, (NL, B, KVH, L, D)))
    ring = (_encoded(rng, (NL, B, KVH, SW, D))
            + _encoded(rng, (NL, B, KVH, SW, D)))
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    kh[0, 0, 0, :16] = 0.0                      # an all-zero group
    kh[1, 1, 0, 32:48] = 0.0                    # one in the high half
    return main, ring, q, kh, vh


def test_encode_t_width4_matches_jax():
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((D, 9)).astype(np.float32)
    vals[:16, 2] = 0.0                          # all-zero groups, low half
    vals[D // 2:D // 2 + 16, 3] = 0.0           # and high half
    for col, k in enumerate((-15, -5, 3, 13), start=4):
        # absmax one ulp above 2^k: the exact exponent is k + 1
        vals[16:32, col] = np.linspace(-1, 1, 16) * 2.0 ** (k - 1)
        vals[20, col] = np.nextafter(np.float32(2.0 ** k), np.float32(np.inf))
        vals[D // 2 + 5, col] = -np.float32(2.0 ** k)
    cj, ej = jcw._encode_t(jnp.asarray(vals), 16, mb=3.0, pack=True)
    ct, et = tcw._encode_t(torch.from_numpy(vals), 16, width=4)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj).astype(np.int8))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej).astype(np.int8))
    cm, em = jmx4_encode(jnp.asarray(vals.T), 16, zero_fill=1.0)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cm).T)
    np.testing.assert_array_equal(et.numpy(), np.asarray(em).T)
    assert set(np.unique(et.numpy()[:, 2])) >= {0}


@pytest.mark.parametrize("li,positions,flushed", [
    (0, [70, 37, 128], [64, 32, 128]),      # residues 6, 5, 0
    (1, [111, 95, 200], [64, 64, 160]),     # residues 47, 31, 40
])
def test_staged_decode_width4_matches_jax(li, positions, flushed):
    main, ring, q, kh, vh = _staged_inputs(li * 10 + positions[0], 256)
    pos, fl = np.array(positions, np.int32), np.array(flushed, np.int32)
    attn, *rings = jda.decode_attention_quantized_staged(
        jnp.asarray(q), *(jnp.asarray(a) for a in main + ring),
        jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(pos), jnp.asarray(fl),
        jnp.asarray([li], jnp.int32), scaling=SCALING, interpret=True)
    ours = [_t(a) for a in ring]
    layer = [_t(a)[li] for a in main]
    got = tstaged.decode_attention_quantized_staged(
        _t(q), *layer, *(a[li] for a in ours), _t(kh), _t(vh), _t(pos),
        _t(fl), scaling=SCALING)
    for mine, theirs in zip(ours, rings):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    s, vals = tstaged.staged_scores(_t(q), *layer, *(a[li] for a in ours),
                                    _t(pos), _t(fl), scaling=SCALING)
    want = _t(attn)
    check_close("staged decode width 4", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


@pytest.mark.parametrize("li,positions,flushed", [
    (0, [130, 300, 511], [128, 256, 480]),   # main ends at a chunk boundary
    (1, [37, 191, 447], [32, 160, 384]),     # a ring past a chunk's end
])
def test_streaming_staged_width4_matches_jax(li, positions, flushed):
    main, ring, q, kh, vh = _staged_inputs(li * 7 + positions[0], 512)
    pos, fl = np.array(positions, np.int32), np.array(flushed, np.int32)
    attn, *rings = jda.decode_attention_quantized_streaming_staged(
        jnp.asarray(q), *(jnp.asarray(a) for a in main + ring),
        jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(pos), jnp.asarray(fl),
        jnp.asarray([li], jnp.int32), scaling=SCALING, l_chunk=128,
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
    want = _t(attn)
    check_close("streaming staged decode width 4", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


def test_packed_flush_and_boundary_sync_match_jax():
    """Both copy whole packed code rows: the flush of a 32-block per slot
    and the stage boundary after an admission of 63, 32 and 100 tokens."""
    L = 256
    jcache = jkv.init_quantized_kv_cache(NL, B, KVH, D, L, staged=True,
                                         code_width=4)
    tcache = tkv.init_quantized_kv_cache(NL, B, KVH, D, L, staged=True,
                                         code_width=4, device="cpu")
    rng = np.random.default_rng(9)
    for key in (*tkv.MAIN_KEYS, *tkv.STAGE_KEYS):
        a = rng.integers(-128, 128, jcache[key].shape).astype(np.int8)
        assert tuple(tcache[key].shape) == a.shape, key
        jcache[key] = jnp.asarray(a)
        tcache[key].copy_(torch.from_numpy(a))
    assert tcache["k_codes"].shape[3] == D // 2
    new_pos = np.array([63, 32, 100], np.int32)
    jsync = jkv.stage_boundary_sync(jcache, jnp.asarray(new_pos))
    tkv.stage_boundary_sync(tcache, torch.from_numpy(new_pos))
    for key in (*tkv.STAGE_KEYS, "flushed"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jsync[key]), err_msg=key)
    fl, nf = np.array([32, 0, 96], np.int32), np.array([64, 32, 128], np.int32)
    ref = jcw.flush_stage_to_main(
        tuple(jsync[k] for k in tkv.MAIN_KEYS),
        tuple(jsync[k] for k in tkv.STAGE_KEYS), jnp.asarray(fl),
        jnp.asarray(nf), interpret=True)
    tcw.flush_stage_to_main(tuple(tcache[k] for k in tkv.MAIN_KEYS),
                            tuple(tcache[k] for k in tkv.STAGE_KEYS),
                            torch.from_numpy(fl), torch.from_numpy(nf))
    for key, want in zip(tkv.MAIN_KEYS, ref):
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(want),
                                      err_msg=key)


KV4_TINY = dict(vocab_size=128, hidden=256, layers=2, heads=4, kv_heads=2,
                inter=256, max_pos=128)


def test_make_cache_mxint4_staged_matches_jax():
    cfg = LlamaConfig.tiny(**KV4_TINY)
    jcfg = JLlamaConfig.tiny(**KV4_TINY)
    for max_len in (128, 47104):       # one pass, and past it
        ours = tdecode.make_cache(cfg, 2, max_len, "mxint4-staged",
                                  device="cpu")
        theirs = jax.eval_shape(lambda: __import__(
            "lqer_tpu.serving.decode", fromlist=["make_cache"]).make_cache(
                jcfg, 2, max_len, "mxint4-staged"))
        assert sorted(ours) == sorted(theirs)
        for key, arr in ours.items():
            assert tuple(arr.shape) == theirs[key].shape, key
    assert tdecode.decode_route("mxint4-staged", 128, 64, 2) == \
        ("decode_attention",)
    assert tdecode.decode_route("mxint4-staged", 47104, 64, 2) == \
        ("decode_attention_streaming_staged",)
    # as JAX: an unaligned max_len falls back to the direct-write cache
    assert not tkv.is_staged_cache(
        tdecode.make_cache(cfg, 2, 144, "mxint4-staged", device="cpu"))


def _kv4_model():
    """The JAX KV4 test's tiny Llama (``test_kv4_engine_tokens_scan_
    matches_unrolled``: rank 16), packed by the JAX backend; returns the
    raw parameters too (the port's engine takes those)."""
    cfg = JLlamaConfig.tiny(**KV4_TINY)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    qcfgs = jmodels.quantize_model(cfg, KV4_Q_CONFIG,
                                   {"linear": {"rank": 16}})
    backend = prepare_serving_params(params, cfg, qcfgs)
    return (cfg, params, jmodels.prepare_ptq(params, cfg, qcfgs), qcfgs,
            backend)


def _requests(cls):
    return [cls(prompt_ids=[3, 9, 27, 4], max_new_tokens=6),
            cls(prompt_ids=[5, 6], max_new_tokens=4),
            cls(prompt_ids=[int(t) for t in np.random.default_rng(2)
                            .integers(0, 128, 41)], max_new_tokens=60)]


def test_engine_mxint4_staged_matches_jax_engine():
    """The third request (41 prompt tokens, 60 new) crosses a flush."""
    jcfg, params, prepared, jq, jb = _kv4_model()
    tokens = {}
    for scan in (True, False):
        jengine = JDecodeEngine(prepared, jcfg, jq, num_slots=2, max_len=128,
                                cache_dtype="mxint4-staged",
                                pallas_backend=jb, scan_layers=scan,
                                lm_head_width=8)
        reqs = _requests(JRequest)
        jengine.run(reqs)
        tokens[f"jax scan={scan}"] = [r.output_ids for r in reqs]
    cfg = LlamaConfig.tiny(**KV4_TINY)
    tq = tmodels.quantize_model(cfg, KV4_Q_CONFIG, {"linear": {"rank": 16}})
    backend = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                               jb["meta"])
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()})
    for cache_dtype in ("mxint4-staged", "mxint4"):
        engine = DecodeEngine(tparams, cfg, tq, num_slots=2, max_len=128,
                              cache_dtype=cache_dtype, pallas_backend=backend,
                              lm_head_width=8, scan_layers=True, device="cpu")
        reqs = _requests(Request)
        engine.run(reqs)
        tokens[cache_dtype] = [r.output_ids for r in reqs]
        if cache_dtype == "mxint4-staged":
            assert tkv.is_staged_cache(engine.cache)
            assert int(engine.cache["flushed"].max()) >= 64   # a flush ran
    want = tokens["mxint4-staged"]
    assert len(set(want[2])) > 3                  # not a collapsed stream
    assert all(t == want for t in tokens.values()), tokens
