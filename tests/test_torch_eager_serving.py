"""The eager serving path: the port's ``decode.model_step`` (per-prefix
weights, the JAX engine's default) against the JAX package's on the same
weights, carried across by ``convert.py``, on a tiny Llama (hidden 256, 4
heads of d = 64 over 2 kv heads, 2 layers, rank 32), three ways:

- ``emulated``: no backend, every linear through ``qlinear`` on
  ``prepare_ptq``'s weights;
- ``backend``: the packed backend (the JAX kernels in interpret mode, the
  port's plain versions on the CPU), each MLP whole;
- ``fp``: ``layer_qcfgs=None``, the model unquantized;

over every cache (``bfloat16``, ``float32``, ``mxint8``, ``mxint8-staged``,
``mxint4`` with the KV4 configuration) at max_len 64 (the eager ``_attend``
regime) and 256 (the decode kernels where a backend allows): one
right-padded admission of two prompts, then decode steps fed the JAX
greedy tokens; a chunked prefill into a filled cache; the decode steps
with ``LQER_DISABLE_ATTN_KERNEL``. Which layers take a decode kernel,
against the JAX rule.

Limits (``ROADMAP.md``): logits within rtol = atol = 2e-4, or, where an f32
sum re-quantized to 8 bits flips a rounding, within LOGIT_MAX_STEPS and
LOGIT_RMS_STEPS 8-bit code steps (``testing.logits_steps``); greedy tokens
equal; the PTQ weights bit-exact; the cache equal on at least 99.9% of its
entries and within one code step elsewhere (``testing.cache_agreement``).

The helpers here also serve ``test_torch_eager_engines.py``,
``test_torch_eager_serving_opt.py`` and
``test_torch_eager_serving_mistral.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.models import llama as jllama
from lqer_tpu.serving import decode as jdecode
from lqer_tpu.serving import pallas_backend as jbackend
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving.random_model import q_config_for
from lqer_tpu_torch.testing import (
    cache_agreement,
    logits_steps,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()

RANK = 32
TINY = dict(vocab_size=128, hidden=256, layers=2, heads=4, kv_heads=2,
            inter=256, max_pos=256)
CACHES = ("bfloat16", "float32", "mxint8", "mxint8-staged", "mxint4")
MODES = ("emulated", "backend", "fp")
LOGIT_MAX_STEPS = 4.0
LOGIT_RMS_STEPS = 0.4
PROMPTS = (32, 20)          # one right-padded admission of 32 rows
DECODE_STEPS = 2


def jax_cache_dtype(name: str):
    return {"bfloat16": jnp.bfloat16, "float32": jnp.float32}.get(name, name)


def with_factors(params, layer_prefix, rels, num_layers, seed, scale=0.05):
    """Rank-RANK A/B factors (bf16-exact values) on every linear."""
    rng = np.random.default_rng(seed)
    for i in range(num_layers):
        for rel in rels:
            o, ic = params[f"{layer_prefix(i)}.{rel}.weight"].shape
            for name, shape in (("A", (ic, RANK)), ("B", (RANK, o))):
                v = (rng.standard_normal(shape) * scale).astype(jnp.bfloat16)
                params[f"{layer_prefix(i)}.{rel}.{name}"] = jnp.asarray(
                    v.astype(np.float32))
    return params


class Model:
    """One tiny model both ways: the JAX and the port's configs, unprepared
    params, resolved configs (per KV4 or not), packed backends and
    PTQ-prepared params."""

    def __init__(self, jcfg, tcfg, params):
        self.jcfg, self.tcfg, self.params = jcfg, tcfg, params
        self.tparams = params_from_jax({k: np.asarray(v)
                                        for k, v in params.items()})

    @functools.cache
    def qcfgs(self, kv4: bool):
        q = q_config_for(self.tcfg, kv4=kv4)
        lc = {"linear": {"rank": RANK}}
        return (jmodels.quantize_model(self.jcfg, q, lc),
                tmodels.quantize_model(self.tcfg, q, lc))

    @functools.cache
    def backends(self, kv4: bool):
        jq, _ = self.qcfgs(kv4)
        jb = jbackend.prepare_serving_params(self.params, self.jcfg, jq)
        return jb, backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                                    jb["meta"])

    @functools.cache
    def prepared(self, kv4: bool):
        jq, tq = self.qcfgs(kv4)
        return (jmodels.prepare_ptq(self.params, self.jcfg, jq),
                tmodels.prepare_ptq(self.tparams, self.tcfg, tq))

    def side(self, mode: str, kv4: bool):
        """(jax params, qcfgs, backend), (port params, qcfgs, backend)."""
        if mode == "fp":
            return (self.params, None, None), (self.tparams, None, None)
        (jp, tp), (jq, tq) = self.prepared(kv4), self.qcfgs(kv4)
        jb, tb = self.backends(kv4) if mode == "backend" else (None, None)
        return (jp, jq, jb), (tp, tq, tb)


@functools.cache
def llama_model() -> Model:
    jcfg = JLlamaConfig.tiny(**TINY)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"] * 40
    with_factors(params, jllama.layer_prefix, jllama.LAYER_REL_KEYS[:7],
                 jcfg.num_hidden_layers, seed=0)
    return Model(jcfg, LlamaConfig.tiny(**TINY), params)


def check_logits(got, want, what):
    got = torch.as_tensor(np.array(got, np.float32)) \
        if not isinstance(got, torch.Tensor) else got.float()
    want = torch.as_tensor(np.array(want, np.float32))
    if torch.allclose(got, want, rtol=2e-4, atol=2e-4):
        return
    worst, rms = logits_steps(got, want)
    assert worst <= LOGIT_MAX_STEPS and rms <= LOGIT_RMS_STEPS, \
        (what, worst, rms)


def check_cache(tcache, jcache, lengths):
    """The port's cache against the JAX one over the tokens each slot
    holds (a staged cache: its main part below ``flushed``, then the rings
    whole)."""
    jt = {k: torch.as_tensor(np.array(v, np.float32)).to(tcache[k].dtype)
          for k, v in jcache.items()}
    if "flushed" in tcache:
        assert tcache["flushed"].tolist() == jt["flushed"].tolist()
        lengths = tcache["flushed"].tolist()
        for k in tdecode.STAGE_KEYS:
            assert (tcache[k] == jt[k]).float().mean() >= 0.999, k
    frac, steps = cache_agreement(tcache, jt, lengths)
    if tcache.get("k") is not None and tcache["k"].dtype == torch.float32:
        # f32 rows out of f32 sums in other orders: equal within rtol/atol
        frac = float(np.mean([np.isclose(tcache[k].numpy(), jt[k].numpy(),
                                         rtol=2e-4, atol=2e-4).mean()
                              for k in ("k", "v")]))
    assert frac >= 0.999 and steps <= 1, (frac, steps)


def run_steps(model, mode, cache_dtype, max_len, prompts=PROMPTS,
              steps=DECODE_STEPS, chunk=0, seed=1):
    """One admission of ``prompts`` (right-padded to the longest) and
    ``steps`` decode steps through JAX ``model_step`` and the port's, both
    fed the JAX greedy tokens; ``chunk`` > 0 first runs a prefill of that
    many tokens into the filled cache (``fresh_prefill=False``). Checks
    logits, tokens and the cache; returns the port's cache."""
    kv4 = cache_dtype.startswith("mxint4")
    (jp, jq, jb), (tp, tq, tb) = model.side(mode, kv4)
    b = len(prompts)
    jcache = jdecode.make_cache(model.jcfg, b, max_len,
                                jax_cache_dtype(cache_dtype))
    tcache = tdecode.make_cache(model.tcfg, b, max_len, cache_dtype,
                                device="cpu")
    rng = np.random.default_rng(seed)
    vocab = model.jcfg.vocab_size
    lens = np.array(prompts, np.int32)
    ids = rng.integers(0, vocab, (b, int(lens.max())))

    def jstep(ids, pos, **kw):
        nonlocal jcache
        out, jcache = jdecode.model_step(
            jp, jnp.asarray(ids, jnp.int32), jcache,
            jnp.asarray(pos, jnp.int32), model.jcfg, jq, backend=jb, **kw)
        return out

    def tstep(ids, pos, **kw):
        out, _ = tdecode.model_step(
            tp, torch.as_tensor(ids, dtype=torch.int64), tcache,
            torch.as_tensor(pos, dtype=torch.int32), model.tcfg, tq,
            backend=tb, **kw)
        return out

    pos = np.zeros(b, np.int32)
    kw = dict(valid_lengths=lens, fresh_prefill=True, logits_last_only=True)
    jl = jstep(ids, pos, **{**kw, "valid_lengths": jnp.asarray(lens)})
    tl = tstep(ids, pos, **{**kw, "valid_lengths": torch.as_tensor(lens)})
    check_logits(tl, jl, "admission")
    pos = lens.copy()
    if chunk:
        more = rng.integers(0, vocab, (b, chunk))
        jl = jstep(more, pos)[:, -1:]
        check_logits(tstep(more, pos)[:, -1:], jl, "chunked prefill")
        pos = pos + chunk
    tokens = np.array(jnp.argmax(jl[:, -1], -1))
    for i in range(steps):
        jl = jstep(tokens[:, None], pos)
        tl = tstep(tokens[:, None], pos)
        check_logits(tl, jl, f"decode step {i}")
        tokens = np.array(jnp.argmax(jl[:, 0], -1))
        assert tokens.tolist() == tl[:, 0].argmax(-1).tolist(), i
        pos = pos + 1
    check_cache(tcache, jcache, pos)
    return tcache


def test_prepare_ptq_bit_exact():
    """``convert.params_from_jax`` carries the dense, unprepared params;
    the port's ``prepare_ptq`` of them equals the JAX package's bit for
    bit, the unprepared input left as it was."""
    model = llama_model()
    before = {k: v.clone() for k, v in model.tparams.items()}
    jp, tp = model.prepared(False)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
    for k, v in before.items():
        assert torch.equal(model.tparams[k], v)
    assert not torch.equal(tp["model.layers.0.mlp.up_proj.weight"],
                           before["model.layers.0.mlp.up_proj.weight"])
    assert tmodels.prepare_ptq(model.tparams, model.tcfg, None) \
        is model.tparams


@pytest.mark.parametrize("max_len", [64, 256])
@pytest.mark.parametrize("cache_dtype", CACHES)
@pytest.mark.parametrize("mode", MODES)
def test_model_step_matches_jax(mode, cache_dtype, max_len):
    run_steps(llama_model(), mode, cache_dtype, max_len)


def test_routes_follow_the_jax_eligibility(monkeypatch):
    """Which layers take a decode kernel (``_use_attn_kernel``), and the
    route the eager step takes then, against the JAX package's rule; the
    two environment switches."""
    model = llama_model()
    (_, jq, jb), (_, tq, _) = model.side("backend", False)
    jattn, tattn = jq[0]["attn"], tq[0]["attn"]
    for cache_dtype, max_len in (("bfloat16", 64), ("bfloat16", 256),
                                 ("float32", 256), ("mxint8", 144),
                                 ("mxint8", 256), ("bfloat16", 24592)):
        jc = jdecode.make_cache(model.jcfg, 1, max_len,
                                jax_cache_dtype(cache_dtype))
        tc = tdecode.make_cache(model.tcfg, 1, max_len, cache_dtype,
                                device="meta")
        for backend, tb in ((jb, True), (None, None)):
            for s in (1, 16):
                assert tdecode._use_attn_kernel(tb, s, tattn, max_len, 64,
                                                tc) == \
                    jdecode._use_attn_kernel(backend, s, jattn, max_len, 64,
                                             cache=jc), (cache_dtype, max_len)
    assert tdecode.decode_route("mxint8", 256, 64, 2, eager=True) == (
        "decode_attention_quantized",)
    assert tdecode.decode_route("mxint8", 24576, 128, 1, eager=True) == (
        "decode_attention_streaming",)
    assert tdecode.decode_route("bfloat16", 256, 64, 2, eager=True) == (
        "decode_attention_fp",)
    assert tdecode.decode_route("mxint8-staged", 256, 64, 2, eager=True) == (
        "decode_attention",)
    tc = tdecode.make_cache(model.tcfg, 1, 256, "bfloat16", device="meta")
    monkeypatch.setenv("LQER_DISABLE_ATTN_KERNEL", "1")
    assert not tdecode._use_attn_kernel(True, 1, tattn, 256, 64, tc)
    monkeypatch.delenv("LQER_DISABLE_ATTN_KERNEL")
    fp_attn = tdecode._layer_qcfgs(None, model.tcfg)[0]["attn"]
    assert not tdecode._use_attn_kernel(None, 1, fp_attn, 256, 64, tc)
    monkeypatch.setenv("LQER_FP_ATTN_KERNEL", "1")
    assert tdecode._use_attn_kernel(None, 1, fp_attn, 256, 64, tc)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "mxint8", "mxint4"])
def test_cache_updates_and_masks_match_jax(cache_dtype):
    """``kv_cache.update_layer_cache`` / ``update_layer_cache_quantized``
    (a 5-token write at positions (0, 61) into a 64-token cache: the second
    start clamps to 59, as ``dynamic_update_slice`` clamps it), their
    post-update views, and ``decode_mask`` / ``prefill_mask``, against the
    JAX package's, bit for bit."""
    from lqer_tpu.serving import kv_cache as jkv
    from lqer_tpu_torch.serving import kv_cache as tkv

    rng = np.random.default_rng(6)
    kh, vh = (rng.standard_normal((2, 2, 5, 64)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 61], np.int32)
    model = llama_model()
    jc = jdecode.make_cache(model.jcfg, 2, 64, jax_cache_dtype(cache_dtype))
    tc = tdecode.make_cache(model.tcfg, 2, 64, cache_dtype, device="cpu")
    t = (torch.from_numpy(kh), torch.from_numpy(vh), torch.from_numpy(pos))
    if cache_dtype == "bfloat16":
        jc, jk, jv = jkv.update_layer_cache(jc, 1, jnp.asarray(kh),
                                            jnp.asarray(vh), jnp.asarray(pos))
        tc, tk, tv = tkv.update_layer_cache(tc, 1, *t)
    else:
        jc, jk, jv = jkv.update_layer_cache_quantized(
            jc, 1, jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(pos))
        tc, tk, tv = tkv.update_layer_cache_quantized(tc, 1, *t)
    for k in jc:
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      np.asarray(jc[k], np.float32), k)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    lengths = np.array([3, 64], np.int32)
    np.testing.assert_array_equal(
        tkv.decode_mask(torch.from_numpy(lengths), 64).numpy(),
        np.asarray(jkv.decode_mask(jnp.asarray(lengths), 64)))
    np.testing.assert_array_equal(
        tkv.prefill_mask(8, torch.from_numpy(lengths)).numpy(),
        np.asarray(jkv.prefill_mask(8, jnp.asarray(lengths))))


def test_chunked_prefill_into_a_filled_cache():
    """A 16-token prefill at positions (32, 20) into the admitted staged
    cache: the main cache written, then the eager attention over it with
    the cache mask (no kernel takes it in either package), then the stage
    boundary; then decode steps through the kernels."""
    run_steps(llama_model(), "backend", "mxint8-staged", 256, chunk=16,
              steps=2)


def test_disabled_attention_kernel_serves_the_same(monkeypatch):
    """``LQER_DISABLE_ATTN_KERNEL``: every decode step attends eagerly
    (the staged cache through ``_staged_eager_update``), and the JAX
    package does the same."""
    monkeypatch.setenv("LQER_DISABLE_ATTN_KERNEL", "1")
    run_steps(llama_model(), "backend", "mxint8-staged", 256)
