"""The eager serving path for Mistral: the port's ``decode.model_step``
against the JAX package's on a tiny Mistral (hidden 256, 4 heads of
d = 64 over 2 kv heads, ``sliding_window`` 16, 2 layers, rank 32), the
three ways and every cache of ``test_torch_eager_serving.py`` at max_len
64 and 256: an admission of prompts longer than the window (an eager
windowed prefill in both packages), then decode steps past it. A staged
name gives the direct-write cache under a window, as in JAX. The limits
of ``test_torch_eager_serving.py``.
"""

import dataclasses
import functools

import jax
import pytest

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.models import llama as jllama
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.testing import one_torch_thread_fixture
from test_torch_eager_serving import (
    CACHES,
    MODES,
    TINY,
    Model,
    run_steps,
    with_factors,
)

_one_torch_thread = one_torch_thread_fixture()

WINDOW = 16


@functools.cache
def mistral_model() -> Model:
    kw = dict(sliding_window=WINDOW, arch="mistral")
    jcfg = dataclasses.replace(JLlamaConfig.tiny(**TINY), **kw)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(2))
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"] * 40
    with_factors(params, jllama.layer_prefix, jllama.LAYER_REL_KEYS[:7],
                 jcfg.num_hidden_layers, seed=2)
    return Model(jcfg, LlamaConfig.tiny(**TINY, **kw), params)


@pytest.mark.parametrize("max_len", [64, 256])
@pytest.mark.parametrize("cache_dtype", CACHES)
@pytest.mark.parametrize("mode", MODES)
def test_model_step_matches_jax(mode, cache_dtype, max_len):
    cache = run_steps(mistral_model(), mode, cache_dtype, max_len)
    assert "flushed" not in cache
