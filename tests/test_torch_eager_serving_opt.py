"""The eager serving path for OPT: the port's ``decode.model_step``
against the JAX package's on a tiny pre-LN OPT (hidden 256, 2 heads of
d = 128, ffn 512, vocab 200 so the head stays dense, 2 layers, rank 32;
biases and LayerNorms random), the three ways and every cache of
``test_torch_eager_serving.py`` at max_len 64 and 256. The limits of
``test_torch_eager_serving.py``. ``opt_model(post_ln=True)`` also builds
the OPT-350m-like post-LN model of ``test_torch_eager_serving_opt350m.py``
(``project_in``/``project_out``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lqer_tpu import models as jmodels
from lqer_tpu.models import OPTConfig as JOPTConfig
from lqer_tpu.models import opt as jopt
from lqer_tpu_torch.models import OPTConfig
from lqer_tpu_torch.testing import one_torch_thread_fixture
from test_torch_eager_serving import (
    CACHES,
    MODES,
    Model,
    run_steps,
    with_factors,
)

_one_torch_thread = one_torch_thread_fixture()

SHAPE = dict(vocab_size=200, hidden_size=256, ffn_dim=512,
             num_hidden_layers=2, num_attention_heads=2,
             max_position_embeddings=256)


@functools.cache
def opt_model(post_ln: bool) -> Model:
    kw = dict(do_layer_norm_before=False, word_embed_proj_dim=128) \
        if post_ln else {}
    jcfg = JOPTConfig(**SHAPE, **kw)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(4))
    if post_ln:   # project_in shrinks the embedding below the biases
        params["model.decoder.embed_tokens.weight"] = \
            params["model.decoder.embed_tokens.weight"] * 50
    rng = np.random.default_rng(4)
    rels = jopt.LAYER_REL_KEYS[:6]
    for i in range(jcfg.num_hidden_layers):
        p = jopt.layer_prefix(i)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            shape = params[f"{p}.{ln}.weight"].shape
            params[f"{p}.{ln}.weight"] = jnp.asarray(
                1 + rng.standard_normal(shape) * 0.1, jnp.float32)
            params[f"{p}.{ln}.bias"] = jnp.asarray(
                rng.standard_normal(shape) * 0.1, jnp.float32)
        for rel in rels:
            # linears five times init_params' scale, so that the layers and
            # not the tied embedding decide the next token
            w = params[f"{p}.{rel}.weight"]
            params[f"{p}.{rel}.weight"] = w * 5
            params[f"{p}.{rel}.bias"] = jnp.asarray(
                rng.standard_normal(w.shape[0]) * 0.05, jnp.float32)
    with_factors(params, jopt.layer_prefix, rels, jcfg.num_hidden_layers,
                 seed=4)
    return Model(jcfg, OPTConfig(**SHAPE, **kw), params)


@pytest.mark.parametrize("max_len", [64, 256])
@pytest.mark.parametrize("cache_dtype", CACHES)
@pytest.mark.parametrize("mode", MODES)
def test_model_step_matches_jax(mode, cache_dtype, max_len):
    run_steps(opt_model(False), mode, cache_dtype, max_len)
