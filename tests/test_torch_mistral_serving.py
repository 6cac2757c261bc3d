"""Mistral served whole: the port's ``DecodeEngine`` against the JAX
``DecodeEngine(scan_layers=True, lm_head_width=8)`` (``llama_step_scan`` on
the packed backend, its Pallas kernels in interpret mode) on a tiny Mistral
(hidden 256, 4 heads of d = 64 over 2 kv heads, ``sliding_window`` 40,
max_len 128, 2 layers, rank 32), the weights carried across by
``convert.py``, over every cache name: ``bfloat16``, ``mxint8``,
``mxint8-staged`` (which falls back to direct ``mxint8`` under a window),
``mxint4`` and ``mxint4-staged`` (falls back to ``mxint4``), both with the
KV4 configuration. Prompts are longer than the window, and decode runs
past it.

Greedy tokens must be equal; the logits of a replay of the admission and
each decode step within LOGIT_MAX_STEPS and LOGIT_RMS_STEPS 8-bit code
steps of the JAX engine's (``testing.logits_steps``). Around it: the eager
windowed admission (``_attend`` with ``_cache_mask``) against JAX's over
each cache, the JAX cache-less sliding-window pieces, the registry, the
rank-128 packing, the prompt-truncation refusal and the card's head-dim
refusal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.models import common as jcommon
from lqer_tpu.models import llama as jllama
from lqer_tpu.models.fp_config import FP_LAYER_LLAMA as JFP
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu.serving import decode as jdecode
from lqer_tpu.serving import pallas_backend as jbackend
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.models import llama as tllama
from lqer_tpu_torch.models.fp_config import FP_LAYER_LLAMA as TFP
from lqer_tpu_torch.serving import DecodeEngine, Request
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving import kernel_backend as tbackend
from lqer_tpu_torch.serving.random_model import KV4_Q_CONFIG, Q_CONFIG
from lqer_tpu_torch.testing import (
    logits_steps,
    one_torch_thread_fixture,
    shared,
)

_one_torch_thread = one_torch_thread_fixture()

MAX_LEN = 128
WINDOW = 40
TINY = dict(vocab_size=128, hidden=256, layers=2, heads=4, kv_heads=2,
            inter=256, max_pos=MAX_LEN)
RANK = 32
# the limits of the kernels against the plain versions on the card
# (chip_smoke.py, phase 4): XLA and torch sum f32 products in other orders
LOGIT_MAX_STEPS = 4.0
LOGIT_RMS_STEPS = 0.4


def _cfgs():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(**TINY),
                               sliding_window=WINDOW, arch="mistral")
    cfg = LlamaConfig.tiny(**TINY, sliding_window=WINDOW, arch="mistral")
    return jcfg, cfg


@shared
def _jax_model(q_config=Q_CONFIG, rank=RANK, seed=0):
    """The tiny Mistral's JAX config, params (rank-``rank`` A/B factors of
    bf16-exact values on every linear, a wide embedding so greedy decoding
    does not collapse) and resolved configs, and its backend packed as the
    JAX package packs by default (``fuse_mlp=True``)."""
    jcfg, _ = _cfgs()
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(seed))
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"] * 40
    rng = np.random.default_rng(seed)
    for i in range(jcfg.num_hidden_layers):
        for rel in jllama.LAYER_REL_KEYS[:7]:
            o, ic = params[f"model.layers.{i}.{rel}.weight"].shape
            for name, shape in (("A", (ic, rank)), ("B", (rank, o))):
                v = (rng.standard_normal(shape) * 0.05).astype(jnp.bfloat16)
                params[f"model.layers.{i}.{rel}.{name}"] = jnp.asarray(
                    v.astype(np.float32))
    qcfgs = jmodels.quantize_model(jcfg, q_config, {"linear": {"rank": rank}})
    backend = jbackend.prepare_serving_params(params, jcfg, qcfgs)
    return jcfg, params, qcfgs, backend


def _port_engine(params, jb, q_config, cache_dtype):
    _, cfg = _cfgs()
    tq = tmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
    backend = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                               jb["meta"])
    return DecodeEngine(params_from_jax({k: np.asarray(v)
                                         for k, v in params.items()}),
                        cfg, tq, num_slots=2, max_len=MAX_LEN,
                        cache_dtype=cache_dtype, pallas_backend=backend,
                        lm_head_width=8, scan_layers=True, device="cpu")


def _requests(cls, rng):
    """A 63-token and a 33-token prompt: both pad to the 64-token bucket,
    the first is past the window at admission, the second crosses it while
    decoding."""
    return [cls(prompt_ids=[int(t) for t in rng.integers(0, 128, n)],
                max_new_tokens=16) for n in (63, 33)]


def _replay(jengine, engine, reqs, steps=15):
    """Logits of one admission of both prompts and ``steps`` decode steps
    fed their greedy tokens, through the JAX engine's step and the port's,
    each from a fresh cache."""
    prompts = [r.prompt_ids for r in reqs]
    padded = np.zeros((2, 64), np.int32)
    lengths = np.array([len(p) for p in prompts], np.int32)
    for r, p in enumerate(prompts):
        padded[r, :len(p)] = p
    jlogits, jcache = jengine._prefill(
        None, jengine.cache, jnp.asarray(padded), jnp.arange(2),
        jnp.asarray(lengths), 64)
    backend = {"arrays": jengine._bs_arrays, "meta": jengine._bs_meta}
    jstep = jax.jit(lambda cache, ids, pos: jdecode.llama_step_scan(
        {}, ids, cache, pos, jengine.cfg, jengine.qcfgs[0],
        stacked=jengine._stacked, rest=jengine._rest,
        backend_stacked=backend))
    pairs = [(jlogits, engine.prefill(padded, np.arange(2), lengths))]
    engine.lengths[:] = lengths
    for i in range(steps):
        tokens = np.array([r.output_ids[i] for r in reqs])
        jl, jcache = jstep(jcache, jnp.asarray(tokens[:, None]),
                           jnp.asarray(engine.lengths))
        pairs.append((jl[:, 0, :], engine.decode_logits(tokens)))
        engine.lengths += 1
    return pairs


@pytest.mark.parametrize("cache_dtype,kv4,staged", [
    ("bfloat16", False, None),
    ("mxint8", False, "mxint8-staged"),
    ("mxint4", True, "mxint4-staged"),
])
def test_engine_matches_jax_engine(cache_dtype, kv4, staged):
    """Each cache name: the JAX engine serves the staged name where there
    is one (under a window it falls back to the direct cache of its
    width); the port's engines serve the direct name and the staged one,
    and both fall back alike."""
    q_config = KV4_Q_CONFIG if kv4 else Q_CONFIG
    jcfg, params, jq, jb = _jax_model(q_config)
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=2, max_len=MAX_LEN,
                            cache_dtype=staged or cache_dtype,
                            pallas_backend=jb, scan_layers=True,
                            lm_head_width=8)
    assert "flushed" not in jengine.cache
    jreqs = _requests(JRequest, np.random.default_rng(1))
    jengine.run(jreqs)

    for name in (cache_dtype, staged) if staged else (cache_dtype,):
        engine = _port_engine(params, jb, q_config, name)
        assert "flushed" not in engine.cache
        kind = tdecode._cache_kind(engine.cache)
        assert kind == cache_dtype
        assert tdecode.decode_route(kind, MAX_LEN, 64, 2) == {
            "bfloat16": ("row_write", "decode_attention_fp"),
            "mxint8": ("decode_attention_write",),
            "mxint4": ("row_write", "decode_attention_quantized")}[kind]
        reqs = _requests(Request, np.random.default_rng(1))
        engine.run(reqs)
        assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    assert len(set(reqs[0].output_ids)) > 3       # not a collapsed stream
    assert len(reqs[1].prompt_ids) + len(reqs[1].output_ids) > WINDOW + 8

    for want, got in _replay(jengine, engine, reqs):
        worst, rms = logits_steps(got, torch.from_numpy(
            np.array(want, np.float32)))
        assert worst <= LOGIT_MAX_STEPS and rms <= LOGIT_RMS_STEPS, (worst,
                                                                     rms)


@pytest.mark.parametrize("cache_dtype,kv4,dtype", [
    ("bfloat16", False, np.float32),
    ("bfloat16", False, jnp.bfloat16),
    ("mxint8", False, np.float32),
    ("mxint4", True, np.float32),
])
def test_windowed_admission_matches_jax(cache_dtype, kv4, dtype):
    """One layer's eager windowed admission over each cache: the rows of
    64-token prompts (the second slot padded after 50) written at
    positions 0, then ``_attend`` over the layer's decoded cache with the
    additive window mask, the port's against the JAX package's. Written
    caches bit-exact, the outputs allclose (rtol = atol = 2e-4; in bf16
    one bf16 ulp of the output's scale)."""
    jcfg, cfg = _cfgs()
    q_config = KV4_Q_CONFIG if kv4 else Q_CONFIG
    jattn = jmodels.quantize_model(jcfg, q_config,
                                   {"linear": {"rank": RANK}})[0]["attn"]
    tattn = tmodels.quantize_model(cfg, q_config,
                                   {"linear": {"rank": RANK}})[0]["attn"]
    rng = np.random.default_rng(3)
    b, h, kvh, s, d = 2, 4, 2, 64, 64
    qh, kh, vh = (jnp.asarray(rng.standard_normal((b, n, s, d)), dtype)
                  for n in (h, kvh, kvh))
    valid = (np.arange(s)[None, :] < np.array([64, 50])[:, None])
    kh = kh * jnp.asarray(valid[:, None, :, None], dtype)
    vh = vh * jnp.asarray(valid[:, None, :, None], dtype)
    pos = jnp.zeros(b, jnp.int32)
    q_abs = jdecode._abs_positions(pos, s)
    jcache = jdecode._cache_write_full(
        jdecode.make_cache(jcfg, b, MAX_LEN, cache_dtype), 1, kh, vh, pos)
    quantized = "k_codes" in jcache
    width = 4 if kv4 else 8
    mask = jdecode._cache_mask(q_abs, MAX_LEN, dtype, window=WINDOW)
    want = jdecode._attend(qh, *jdecode._cache_layer_views(jcache, 1), mask,
                           jattn, d ** -0.5, h // kvh, False,
                           kv_pre_quantized=quantized, cache_width=width)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)

    cache = tdecode.make_cache(cfg, b, MAX_LEN, cache_dtype, device="cpu")
    tdecode._cache_write_full(cache, 1, t(kh), t(vh),
                              torch.zeros(b, dtype=torch.int32))
    for key, arr in cache.items():
        np.testing.assert_array_equal(arr.float().numpy(),
                                      np.asarray(jcache[key], np.float32))
    tmask = tdecode._cache_mask(torch.from_numpy(np.array(q_abs)).long(),
                                MAX_LEN, t(qh).dtype, WINDOW)
    np.testing.assert_array_equal(tmask.float().numpy(),
                                  np.asarray(mask, np.float32))
    got = tdecode._attend(t(qh), *tdecode._cache_layer_views(cache, 1), tmask,
                          tattn, d ** -0.5, h // kvh,
                          kv_pre_quantized=quantized, cache_width=width)
    want = np.asarray(want, np.float32)
    tol = 2e-4 if dtype is np.float32 else 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # the window cut keys: row 63 of slot 0 sees 40 of its 64 tokens
    unwindowed = jdecode._cache_mask(q_abs, MAX_LEN, dtype)
    assert not np.allclose(want, np.asarray(jdecode._attend(
        qh, *jdecode._cache_layer_views(jcache, 1), unwindowed, jattn,
        d ** -0.5, h // kvh, False, kv_pre_quantized=quantized,
        cache_width=width), np.float32), atol=1e-3)


def test_cacheless_window_pieces_match_jax():
    """The case of the JAX package's
    ``test_sliding_window_decode_matches_full_forward`` (window 4 over a
    6-token prompt, 4 heads over 2 kv heads), where the port has its
    pieces: its additive mask over the prompt equals the cache-less
    forward's ``_sliding_window_mask``, and its eager attention equals
    ``models.common.eager_attention`` under that mask, fp and quantized."""
    s, window, h, kvh, d = 6, 4, 4, 2, 16
    mask = tdecode._cache_mask(torch.arange(s)[None], s, torch.float32,
                               window)
    jmask = jllama._sliding_window_mask(s, window, jnp.float32)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, h, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, kvh, s, d)).astype(np.float32)
            for _ in range(2))
    jcfg = JLlamaConfig.tiny(vocab_size=128, hidden=64, layers=2, heads=4,
                             kv_heads=2, inter=96)
    cfg = LlamaConfig.tiny(vocab_size=128, hidden=64, layers=2, heads=4,
                           kv_heads=2, inter=96)
    pairs = [(JFP["attn"], TFP["attn"]),
             (jmodels.quantize_model(jcfg, Q_CONFIG, None)[0]["attn"],
              tmodels.quantize_model(cfg, Q_CONFIG, None)[0]["attn"])]
    for jattn, tattn in pairs:
        want = jcommon.eager_attention(
            jnp.asarray(q), jcommon.repeat_kv(jnp.asarray(k), 2),
            jcommon.repeat_kv(jnp.asarray(v), 2), jmask, jattn.qk_matmul,
            jattn.pv_matmul, d ** -0.5)
        got = tdecode._attend(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), mask, tattn, d ** -0.5,
                              2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-6)


def test_weights_and_rank_128_packing_match_jax():
    """``params_from_jax`` and ``backend_from_jax`` carry a tiny Mistral's
    weights across unchanged (Mistral has Llama's layout), and the port's
    own packing at the templates' rank 128 equals the JAX package's byte
    for byte: q|k|v fused with A (K, 3·128) and a block-diagonal B."""
    jcfg, params, jq, jb = _jax_model(rank=128)
    _, cfg = _cfgs()
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()})
    assert sorted(tparams) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v))
    theirs = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                              jb["meta"])
    tq = tmodels.quantize_model(cfg, Q_CONFIG, {"linear": {"rank": 128}})
    ours = tbackend.prepare_serving_params(tparams, cfg, tq)
    assert sorted(ours["meta"]) == sorted(theirs["meta"])
    for key, entry in ours["arrays"].items():
        assert ours["meta"][key] == theirs["meta"][key], key
        for name, t in entry.items():
            other = theirs["arrays"][key][name]
            assert (t is None) == (other is None), (key, name)
            if t is not None:
                assert torch.equal(t, other), (key, name)
    qkv = ours["arrays"]["model.layers.0.self_attn.qkv_proj"]
    assert tuple(qkv["a"].shape) == (256, 384)
    assert tuple(qkv["b"].shape) == (384, 256 + 2 * 128)
    assert not bool(qkv["b"][:128, 256:].any())       # block-diagonal
    assert not bool(qkv["b"][128:, :256].any())
    mlp = ours["arrays"]["model.layers.0.mlp_fused"]
    assert tuple(mlp["a_gu"].shape) == (256, 256)


def test_registry_matches_jax():
    """Every name of the JAX registry, field for field (``asdict`` bridged
    through plain Python), and the Mistral arch served by the Llama
    module."""
    assert sorted(tmodels.MODEL_CONFIGS) == sorted(jmodels.MODEL_CONFIGS)
    for name in jmodels.MODEL_CONFIGS:
        ours = dataclasses.asdict(tmodels.get_model_config(name))
        theirs = dataclasses.asdict(jmodels.get_model_config(name))
        assert ours == theirs, name
    mistral = tmodels.get_model_config("mistralai/Mistral-7B-v0.1")
    assert (mistral.kv_heads, mistral.head_dim, mistral.sliding_window,
            mistral.arch) == (8, 128, 4096, "mistral")
    assert tmodels.get_arch_module(mistral) is tllama
    with pytest.raises(ValueError, match="Unknown model"):
        tmodels.get_model_config("no/such-model")


def test_prompt_truncation():
    """A prompt of max_len tokens or more keeps its last max_len -
    max_new_tokens - 1: the JAX engine fails in numpy at max_new_tokens =
    max_len - 1, and at 158 keeps a 119-token suffix and serves 9 tokens
    (a fault of the reference, which stays); the port refuses both before
    any work and serves the rule where it holds."""
    jcfg, params, jq, jb = _jax_model()
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, 128, 150)]
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=1, max_len=MAX_LEN, pallas_backend=jb,
                            scan_layers=True, lm_head_width=8)
    with pytest.raises(ValueError, match="broadcast"):
        jengine.run([JRequest(prompt_ids=prompt, max_new_tokens=127)])
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=1, max_len=MAX_LEN, pallas_backend=jb,
                            scan_layers=True, lm_head_width=8)
    jreq = JRequest(prompt_ids=prompt, max_new_tokens=158)
    jengine.run([jreq])
    # the slice ids[-(128 - 158 - 1):] is ids[31:]: a 119-token prompt,
    # then decoding stops at max_len after 9 tokens
    assert len(prompt[-(MAX_LEN - 158 - 1):]) == 119
    assert len(jreq.output_ids) == 9
    engine = _port_engine(params, jb, Q_CONFIG, "bfloat16")
    for n in (127, 158):
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.run([Request(prompt_ids=prompt, max_new_tokens=n)])
        assert engine.lengths.tolist() == [0, 0]   # nothing was admitted
    req = Request(prompt_ids=prompt, max_new_tokens=8)
    engine.run([req])
    assert len(req.output_ids) == 8 and req.done


def test_card_refuses_head_dims_before_any_work():
    """The card's attention kernels take d in {64, 80, 96, 128}: a card
    cache of another head dim (a multiple of 16 outside them, 16 or 48) is
    refused by a pure shape check, while the CPU keeps serving any multiple
    of 16 (the tiny d = 16 models); MXINT4 needs d % 32 == 0 on every
    device, as in JAX."""
    for d in (64, 80, 96, 128):
        tdecode.check_card_shapes(d, "cuda")
    for d in (16, 48):
        tdecode.check_card_shapes(d, "cpu")
        with pytest.raises(NotImplementedError, match="head_dim"):
            tdecode.check_card_shapes(d, "cuda")
    cfg = LlamaConfig.tiny(hidden=64, heads=4)                   # d = 16
    with pytest.raises(ValueError, match="head_dim % 32"):
        tdecode.make_cache(cfg, 1, 128, "mxint4", device="cpu")
    cache = tdecode.make_cache(cfg, 1, 128, "bfloat16", device="cpu")
    attn = tmodels.quantize_model(cfg, Q_CONFIG, None)[0]["attn"]
    tdecode.check_servable(cache, [attn], 16)
    meta = {k: v.to("meta") for k, v in cache.items()}
    tdecode.check_servable(meta, [attn], 16)             # not the card
    with pytest.raises(AssertionError):
        jdecode.make_cache(JLlamaConfig.tiny(hidden=64, heads=4), 1, 128,
                           "mxint4")
