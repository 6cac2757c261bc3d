"""The eager serving path for a post-LN OPT (OPT-350m's layout: LayerNorm
after each block, ``project_in``/``project_out`` around a 128-wide
embedding): the port's ``decode.model_step`` against the JAX package's on
the tiny OPT of ``test_torch_eager_serving_opt.py``, the three ways and
every cache of ``test_torch_eager_serving.py`` at max_len 64 and 256. The
limits of ``test_torch_eager_serving.py``.
"""

import pytest

from test_torch_eager_serving import CACHES, MODES, run_steps
from test_torch_eager_serving_opt import opt_model
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()


@pytest.mark.parametrize("max_len", [64, 256])
@pytest.mark.parametrize("cache_dtype", CACHES)
@pytest.mark.parametrize("mode", MODES)
def test_model_step_matches_jax(mode, cache_dtype, max_len):
    model = opt_model(True)
    assert "model.decoder.project_in.weight" in model.tparams
    run_steps(model, mode, cache_dtype, max_len)
