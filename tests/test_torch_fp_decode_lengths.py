"""The bf16 cache at every length the JAX package serves with its fp-cache
kernel (``_fp_cache_kernel_fits``): the port's row 5 keeps nothing in
shared memory that grows with the cache length, so the port takes a bf16
cache through it exactly up to that limit, whatever the GQA group and head
dim; past it both packages attend eagerly.

The boundary is held against the JAX function, and a tiny Llama of head
dim 64 and 8 query heads per kv head is served on the bf16 cache at max_len
6144 (past the 5936 that the port's old score rows in shared memory
allowed) through the port's and the JAX engines: greedy tokens equal,
logits within ``lqer_tpu_torch/testing.py``'s limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.models import llama as jllama
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import decode as jdecode
from lqer_tpu.serving import pallas_backend as jbackend
from lqer_tpu.serving.decode import _fp_cache_kernel_fits as jax_fits
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.serving import DecodeEngine
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving.random_model import Q_CONFIG
from lqer_tpu_torch.testing import logits_steps, one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

RANK = 16


def _jax_limit(head_dim: int) -> int:
    """The longest max_len (a multiple of 16) the JAX fp-cache kernel
    takes at this head dim."""
    n = 16
    while jax_fits(n + 16, head_dim, 2):
        n += 16
    return n


def _tiny(n_rep: int, head_dim: int, max_len: int) -> dict:
    """Two kv heads, so k_proj and v_proj are 128 wide at d = 64 (the JAX
    backend packs widths that are multiples of 128)."""
    return dict(vocab_size=128, hidden=2 * n_rep * head_dim, layers=2,
                heads=2 * n_rep, kv_heads=2, inter=256, max_pos=max_len)


@pytest.mark.parametrize("n_rep,head_dim", [(1, 128), (4, 128), (8, 128),
                                            (8, 64)])
def test_bf16_cache_accepted_exactly_to_the_jax_limit(n_rep, head_dim):
    limit = _jax_limit(head_dim)
    assert limit == (12288 if head_dim == 128 else 24576)
    cfg = LlamaConfig.tiny(**_tiny(n_rep, head_dim, limit + 16))
    attn = tmodels.quantize_model(cfg, Q_CONFIG, None)[0]["attn"]
    cache = tdecode.make_cache(cfg, 1, limit, "bfloat16", device="cpu")
    tdecode.check_servable(cache, [attn] * 2, head_dim)
    assert tdecode._use_attn_kernel(True, 1, attn, limit, head_dim, cache)
    assert tdecode.decode_route("bfloat16", limit, head_dim, n_rep) == (
        "row_write", "decode_attention_fp")
    # past the limit the bf16 cache serves through the eager attention, as
    # in JAX (serving/decode.py::_fp_cache_kernel_fits)
    cache = tdecode.make_cache(cfg, 1, limit + 16, "bfloat16", device="meta")
    assert not tdecode._use_attn_kernel(True, 1, attn, limit + 16, head_dim,
                                        cache)
    assert not tdecode._fp_cache_kernel_fits(limit + 16, head_dim, 2)


def _jax_model(jcfg, seed=0):
    """Random weights with rank-16 A/B factors on every linear and a wide
    embedding, so greedy decoding does not collapse onto one token."""
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(seed))
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"] * 40
    rng = np.random.default_rng(seed)
    for i in range(jcfg.num_hidden_layers):
        for rel in jllama.LAYER_REL_KEYS[:7]:
            o, ic = params[f"model.layers.{i}.{rel}.weight"].shape
            for name, shape in (("A", (ic, RANK)), ("B", (RANK, o))):
                v = (rng.standard_normal(shape) * 0.05).astype(jnp.bfloat16)
                params[f"model.layers.{i}.{rel}.{name}"] = jnp.asarray(
                    v.astype(np.float32))
    qcfgs = jmodels.quantize_model(jcfg, Q_CONFIG, {"linear": {"rank": RANK}})
    backend = jbackend.prepare_serving_params(params, jcfg, qcfgs,
                                              fuse_mlp=True)
    return params, qcfgs, backend


def test_gqa8_head_dim_64_serves_past_the_old_limit():
    """max_len 6144 at n_rep 8, d 64, where the old kernel's score rows
    outgrew its shared memory (from 5936 on): an admission of two prompts
    and decode steps fed the JAX engine's greedy tokens, through the JAX
    engine's step (``llama_step_scan``) and the port's."""
    max_len, steps = 6144, 6
    kw = _tiny(8, 64, max_len)
    jcfg = JLlamaConfig.tiny(**kw)
    params, jq, jb = _jax_model(jcfg)
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=2, max_len=max_len, pallas_backend=jb,
                            scan_layers=True, lm_head_width=8)
    cfg = LlamaConfig.tiny(**kw)
    tq = tmodels.quantize_model(cfg, Q_CONFIG, {"linear": {"rank": RANK}})
    engine = DecodeEngine(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}), cfg,
        tq, num_slots=2, max_len=max_len, pallas_backend=backend_from_jax(
            jax.tree.map(np.asarray, jb["arrays"]), jb["meta"]),
        lm_head_width=8, scan_layers=True, device="cpu")
    padded = np.random.default_rng(1).integers(0, 128, (2, 64)).astype(
        np.int32)
    lengths = np.array([63, 21], np.int32)
    jl, jcache = jengine._prefill(None, jengine.cache, jnp.asarray(padded),
                                  jnp.arange(2), jnp.asarray(lengths), 64)
    backend = {"arrays": jengine._bs_arrays, "meta": jengine._bs_meta}
    jstep = jax.jit(lambda cache, ids, pos: jdecode.llama_step_scan(
        {}, ids, cache, pos, jengine.cfg, jengine.qcfgs[0],
        stacked=jengine._stacked, rest=jengine._rest,
        backend_stacked=backend))
    got = engine.prefill(padded, np.arange(2), lengths)
    engine.lengths[:] = lengths
    for step in range(steps + 1):
        want = torch.from_numpy(np.array(jl, np.float32).reshape(2, -1))
        worst, rms = logits_steps(got.float(), want)
        assert worst <= 4.0 and rms <= 0.4, (step, worst, rms)
        tokens = want.argmax(-1).numpy()
        np.testing.assert_array_equal(got.float().argmax(-1).numpy(), tokens)
        if step == steps:
            break
        jl, jcache = jstep(jcache, jnp.asarray(tokens[:, None]),
                           jnp.asarray(engine.lengths))
        got = engine.decode_logits(tokens)
        engine.lengths += 1
