"""OPT served whole: the port's ``DecodeEngine`` against the JAX
``DecodeEngine(scan_layers=True, lm_head_width=8)`` (``opt_step_scan`` on
the packed backend, its Pallas kernels in interpret mode) on a tiny OPT
(hidden 256, 2 heads of d = 128, so the query scaling is no power of two;
ffn 512, 2 layers, vocab 200, which keeps the head dense as at OPT-6.7B),
with rank-32 A/B factors, non-zero biases on every linear and LayerNorm
affines; the weights carried across by ``convert.py``. One case per cache
(``bfloat16``, ``mxint8``, ``mxint8-staged``, ``mxint4`` with the KV4
configuration), pre-LN, and one post-LN case with ``project_in`` and
``project_out`` (OPT-350m's layout).

Greedy tokens must be equal; the logits of the admission and of each
decode step within LOGIT_MAX_STEPS and LOGIT_RMS_STEPS 8-bit code steps of
the JAX engine's (``testing.logits_steps``). The port packs
OPT as the JAX package does, byte for byte, and refuses a ``max_len`` past
the position table before any work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import OPTConfig as JOPTConfig
from lqer_tpu.models import opt as jopt
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu.serving import decode as jdecode
from lqer_tpu.serving import pallas_backend as jbackend
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import OPTConfig
from lqer_tpu_torch.models import opt as topt
from lqer_tpu_torch.serving import DecodeEngine, Request
from lqer_tpu_torch.serving import kernel_backend as tbackend
from lqer_tpu_torch.serving.random_model import q_config_for
from lqer_tpu_torch.testing import (
    logits_steps,
    one_torch_thread_fixture,
    shared,
)

_one_torch_thread = one_torch_thread_fixture()

MAX_LEN = 128
TINY = dict(vocab_size=200, hidden=256, layers=2, heads=2, ffn=512,
            max_pos=MAX_LEN)
RANK = 32
# |logits − JAX logits| in 8-bit code steps of each row's scale: XLA and
# torch sum the f32 products in other orders, which flips a rare 8-bit
# activation rounding; the same limits as the kernels against the plain
# versions on the card (chip_smoke.py, phase 4)
LOGIT_MAX_STEPS = 4.0
LOGIT_RMS_STEPS = 0.4


@shared
def _jax_model(post_ln=False, kv4=False, seed=0):
    """The tiny OPT's JAX config, params, resolved configs, packed backend
    and q_config."""
    kw = dict(do_layer_norm_before=False, word_embed_proj_dim=128) \
        if post_ln else {}
    jcfg = JOPTConfig(**{**dict(
        vocab_size=TINY["vocab_size"], hidden_size=TINY["hidden"],
        ffn_dim=TINY["ffn"], num_hidden_layers=TINY["layers"],
        num_attention_heads=TINY["heads"],
        max_position_embeddings=TINY["max_pos"]), **kw})
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(seed))
    if post_ln:   # project_in shrinks the embedding below the biases
        params["model.decoder.embed_tokens.weight"] = \
            params["model.decoder.embed_tokens.weight"] * 50
    rng = np.random.default_rng(seed)
    for i in range(jcfg.num_hidden_layers):
        p = jopt.layer_prefix(i)
        for rel in jopt.LAYER_REL_KEYS:
            w = params[f"{p}.{rel}.weight"]
            if rel.endswith("layer_norm"):
                params[f"{p}.{rel}.weight"] = jnp.asarray(
                    1 + rng.standard_normal(w.shape) * 0.1, jnp.float32)
                params[f"{p}.{rel}.bias"] = jnp.asarray(
                    rng.standard_normal(w.shape) * 0.1, jnp.float32)
                continue
            o, ic = w.shape
            # linears five times init_params' scale, so that the layers and
            # not the tied embedding decide the next token (a stream that
            # does not collapse onto repeating its input)
            params[f"{p}.{rel}.weight"] = w * 5
            params[f"{p}.{rel}.bias"] = jnp.asarray(
                rng.standard_normal(o) * 0.05, jnp.float32)
            for name, shape in (("A", (ic, RANK)), ("B", (RANK, o))):
                v = (rng.standard_normal(shape) * 0.05).astype(jnp.bfloat16)
                params[f"{p}.{rel}.{name}"] = jnp.asarray(v.astype(np.float32))
    q_config = q_config_for(OPTConfig(), kv4=kv4)
    qcfgs = jmodels.quantize_model(jcfg, q_config, {"linear": {"rank": RANK}})
    backend = jbackend.prepare_serving_params(params, jcfg, qcfgs)
    return jcfg, params, qcfgs, backend, q_config


def _port_cfg(jcfg):
    return OPTConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers",
        "num_attention_heads", "max_position_embeddings",
        "do_layer_norm_before", "word_embed_proj_dim")})


def _requests(cls, rng, n):
    lengths = [63, 21, 40][:n]
    return [cls(prompt_ids=[int(t) for t in rng.integers(0, 200, k)],
                max_new_tokens=20) for k in lengths]


def _replay(jengine, engine, reqs, steps=12):
    """Logits of one admission of the first two prompts and ``steps``
    decode steps fed their greedy tokens, through the JAX engine's step
    (``opt_step_scan``) and the port's, each from a fresh cache."""
    prompts = [r.prompt_ids for r in reqs[:2]]
    padded = np.zeros((2, 64), np.int32)
    lengths = np.array([len(p) for p in prompts], np.int32)
    for r, p in enumerate(prompts):
        padded[r, :len(p)] = p
    jlogits, jcache = jengine._prefill(
        None, jengine.cache, jnp.asarray(padded), jnp.arange(2),
        jnp.asarray(lengths), 64)
    backend = {"arrays": jengine._bs_arrays, "meta": jengine._bs_meta}
    jstep = jax.jit(lambda cache, ids, pos: jdecode.opt_step_scan(
        {}, ids, cache, pos, jengine.cfg, jengine.qcfgs[0],
        stacked=jengine._stacked, rest=jengine._rest,
        backend_stacked=backend))
    pairs = [(jlogits, engine.prefill(padded, np.arange(2), lengths))]
    engine.lengths[:] = lengths
    for i in range(steps):
        tokens = np.array([r.output_ids[i] for r in reqs[:2]])
        jl, jcache = jstep(jcache, jnp.asarray(tokens[:, None]),
                           jnp.asarray(engine.lengths))
        pairs.append((jl[:, 0, :], engine.decode_logits(tokens)))
        engine.lengths += 1
    return pairs


@pytest.mark.parametrize("cache_dtype,post_ln,kv4", [
    ("bfloat16", False, False),
    ("mxint8", False, False),
    ("mxint8-staged", False, False),
    ("mxint4", False, True),
    ("bfloat16", True, False),        # post-LN, project_in / project_out
])
def test_engine_matches_jax_engine(cache_dtype, post_ln, kv4):
    """Three requests on two slots: the third is admitted into a freed slot
    on a fresh one-slot cache."""
    jcfg, params, jq, jb, q_config = _jax_model(post_ln=post_ln, kv4=kv4)
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=2, max_len=MAX_LEN,
                            cache_dtype=cache_dtype, pallas_backend=jb,
                            scan_layers=True, lm_head_width=8)
    jreqs = _requests(JRequest, np.random.default_rng(1), 3)
    jengine.run(jreqs)

    cfg = _port_cfg(jcfg)
    tq = tmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
    backend = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                               jb["meta"])
    assert "model.decoder.layers.0.mlp_fused" in backend["meta"]
    assert "model.decoder.layers.0.self_attn.qkv_proj" in backend["meta"]
    engine = DecodeEngine(params_from_jax({k: np.asarray(v)
                                           for k, v in params.items()}),
                          cfg, tq, num_slots=2, max_len=MAX_LEN,
                          cache_dtype=cache_dtype, pallas_backend=backend,
                          lm_head_width=8, scan_layers=True, device="cpu")
    assert "lm_head" not in engine._backend["meta"]        # vocab 200: dense
    reqs = _requests(Request, np.random.default_rng(1), 3)
    engine.run(reqs)
    assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    assert len(set(reqs[0].output_ids)) > 3       # not a collapsed stream

    # logits of a replay of the same tokens, admission and decode steps
    for want, got in _replay(jengine, engine, reqs):
        worst, rms = logits_steps(got, torch.from_numpy(
            np.array(want, np.float32)))
        assert worst <= LOGIT_MAX_STEPS and rms <= LOGIT_RMS_STEPS, (worst,
                                                                     rms)


def test_port_packs_opt_as_jax():
    """The port's packing of OPT params (q|k|v fused with its biases,
    out_proj alone, fc1 and fc2 as the relu megakernel entry with bias_g and
    bias_d and no up half, every bias on its b_quantizer grid) equals the
    JAX package's, converted, byte for byte."""
    jcfg, params, _, jb, q_config = _jax_model()
    cfg = _port_cfg(jcfg)
    tq = tmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
    ours = tbackend.prepare_serving_params(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}), cfg,
        tq)
    theirs = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                              jb["meta"])
    assert sorted(ours["meta"]) == sorted(theirs["meta"])
    p0 = "model.decoder.layers.0"
    assert sorted(k for k in ours["meta"] if k.startswith(p0 + ".")) == [
        f"{p0}.mlp_fused", f"{p0}.self_attn.out_proj",
        f"{p0}.self_attn.qkv_proj"]
    for key, entry in ours["arrays"].items():
        assert ours["meta"][key] == theirs["meta"][key], key
        assert sorted(entry) == sorted(theirs["arrays"][key]), key
        for name, t in entry.items():
            other = theirs["arrays"][key][name]
            assert (t is None) == (other is None), (key, name)
            if t is not None:
                assert torch.equal(t, other), (key, name)
    mlp = ours["arrays"][f"{p0}.mlp_fused"]
    assert mlp["codes_u"] is None and mlp["b_u"] is None
    assert mlp["bias_g"] is not None and mlp["bias_d"] is not None
    assert ours["arrays"][f"{p0}.self_attn.qkv_proj"]["bias"] is not None


def test_config_registry_and_stacking_match_jax():
    for name, factory in topt.MODEL_CONFIGS.items():
        theirs = jmodels.MODEL_CONFIGS[name]()
        ours = factory()
        for f in ("vocab_size", "hidden_size", "ffn_dim",
                  "num_hidden_layers", "num_attention_heads",
                  "max_position_embeddings", "do_layer_norm_before",
                  "word_embed_proj_dim", "head_dim", "embed_dim", "arch"):
            assert getattr(ours, f) == getattr(theirs, f), (name, f)
    jcfg, params, _, _, _ = _jax_model(post_ln=True)
    cfg = _port_cfg(jcfg)
    for i in range(2):
        assert tmodels.quantizable_module_prefixes(cfg, i) == \
            jmodels.quantizable_module_prefixes(jcfg, i)
    js, jr = jopt.stack_layer_params(params, jcfg)
    ts, tr = topt.stack_layer_params(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}), cfg)
    assert sorted(js) == sorted(ts) and sorted(jr) == sorted(tr)
    assert "model.decoder.project_in.weight" in tr
    assert "model.decoder.final_layer_norm.weight" not in tr   # post-LN
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_dense_head_at_opt_vocab():
    """At V = 50272 (not a multiple of 128) ``pack_lm_head`` finds OPT's
    tied ``model.decoder.embed_tokens.weight`` and keeps the head dense, as
    the JAX package does: no entry, no zero padding."""
    embed = torch.zeros(50272, 128)
    out = tbackend.pack_lm_head({"arrays": {}, "meta": {}},
                                {"model.decoder.embed_tokens.weight": embed})
    assert out == {"arrays": {}, "meta": {}}
    jout = jbackend.pack_lm_head(
        {"arrays": {}, "meta": {}},
        {"model.decoder.embed_tokens.weight": jnp.zeros((50272, 128))})
    assert "lm_head" not in jout["meta"]
    packed = tbackend.pack_lm_head(
        {"arrays": {}, "meta": {}},
        {"model.decoder.embed_tokens.weight": torch.zeros(50176, 128)})
    assert packed["meta"]["lm_head"]["n_real"] == 50176
    with pytest.raises(KeyError):
        tbackend.pack_lm_head({"arrays": {}, "meta": {}}, {})


def test_engine_refuses_max_len_past_the_position_table():
    """The JAX engine builds at max_len 256 over a 130-row position table
    (its ``jnp.take`` fills the missing rows silently); the port raises
    before any work, before it even looks for the card."""
    jcfg, params, jq, jb, q_config = _jax_model()
    JDecodeEngine(params, jcfg, jq, num_slots=1, max_len=256,
                  pallas_backend=jb, scan_layers=True)
    cfg = _port_cfg(jcfg)
    tq = tmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
    with pytest.raises(ValueError, match="max_position_embeddings"):
        DecodeEngine({}, cfg, tq, num_slots=1, max_len=256,
                     pallas_backend={"arrays": {}, "meta": {}},
                     scan_layers=True, device="cuda")
