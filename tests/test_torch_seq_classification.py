"""The port's ``models.forward_sequence_classification`` against the JAX
package's on the same weights, carried across through numpy: a
right-padded tiny Llama (the last non-pad token of each row, JAX's rule)
and a quantized tiny OPT (W4A8, ``prepare_ptq``'s weights, OPT's pad id
1). Limits: rtol = atol = 2e-4 (``ROADMAP.md`` "North star"; the f32
summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.models import OPTConfig as JOPTConfig
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import params_from_jax
from lqer_tpu_torch.testing import ATOL, RTOL, one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()


def _q(width, block, skip):
    return {
        "name": "block_fp", "width": width, "exponent_width": 8,
        "exponent_bias": None, "block_size": block, "skip_first_dim": skip,
    }


Q_CONFIG = {
    "linear": {
        "name": "flexible", "is_ptq": True,
        "x_quantizer": _q(8, [1, 16], True),
        "w_quantizer": _q(4, [1, 16], False),
        "b_quantizer": _q(8, [1, 16], False),
    },
    "matmul": {"name": "flexible", "x_quantizer": _q(8, [1, 16], True),
               "w_quantizer": _q(8, [1, 16], True)},
    "bmm": {"name": "flexible", "x_quantizer": _q(8, [1, 16], True),
            "w_quantizer": _q(8, [1, 16], True)},
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("pad_token_id", [0, None])
def test_llama_last_nonpad_token(pad_token_id):
    """Rows padded with 0 after 3 and 1 real tokens; without a pad id (and
    none in the config) the last position."""
    kw = dict(vocab_size=64, hidden=32, layers=1, heads=2, kv_heads=2,
              inter=48)
    jcfg = JLlamaConfig.tiny(**kw)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    params["score.weight"] = jax.random.normal(jax.random.PRNGKey(1), (3, 32))
    ids = np.array([[5, 9, 3, 0, 0], [7, 0, 0, 0, 0]], np.int32)
    want = np.asarray(jmodels.forward_sequence_classification(
        params, jnp.asarray(ids), jcfg, None, pad_token_id=pad_token_id))
    got = tmodels.forward_sequence_classification(
        params_from_jax(_np(params)), torch.from_numpy(ids).long(),
        tmodels.LlamaConfig.tiny(**kw), None, pad_token_id=pad_token_id)
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    h = tmodels.get_arch_module(tmodels.LlamaConfig.tiny(**kw)).forward(
        params_from_jax(_np(params)), torch.from_numpy(ids).long(),
        tmodels.LlamaConfig.tiny(**kw), None, return_hidden=True)
    rows = (2, 0) if pad_token_id is not None else (4, 4)
    score = torch.from_numpy(np.array(params["score.weight"]))
    for r, pos in enumerate(rows):
        np.testing.assert_allclose(got[r].numpy(),
                                   (h[r, pos] @ score.T).numpy(), atol=1e-6)


def test_opt_quantized_with_config_pad():
    """W4A8 OPT on ``prepare_ptq``'s weights; the pad id (1) comes from the
    config."""
    kw = dict(vocab_size=64, hidden=32, layers=1, heads=2, ffn=48)
    jcfg = JOPTConfig.tiny(**kw)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(2))
    params["score.weight"] = jax.random.normal(jax.random.PRNGKey(3), (2, 32))
    jq = jmodels.quantize_model(jcfg, Q_CONFIG, None)
    ids = np.array([[5, 9, 3, 1, 1], [4, 4, 8, 2, 6]], np.int32)
    want = np.asarray(jmodels.forward_sequence_classification(
        jmodels.prepare_ptq(params, jcfg, jq), jnp.asarray(ids), jcfg, jq))
    cfg = tmodels.OPTConfig.tiny(**kw)
    tq = tmodels.quantize_model(cfg, Q_CONFIG, None)
    tparams = tmodels.prepare_ptq(params_from_jax(_np(params)), cfg, tq)
    got = tmodels.forward_sequence_classification(
        tparams, torch.from_numpy(ids).long(), cfg, tq)
    assert got.shape == (2, 2)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
