"""The port's calibration (``profiler/scale.py``, ``profiler/threshold.py``)
against the JAX package's on the same activations: the per-batch taps, the
running max over several batches, the clamp at ``SCALE_CLAMP_MIN`` (an
all-zero channel and a tiny one) and the normalisation by
``sqrt(min · max)``; then the taps of a whole profiled forward of a tiny
OPT (``make_profiled_forward``) over three batches.

Limits: the per-channel means are f32 sums over tokens in another order,
so rtol = atol = 2e-4 for the forward's scales, where the activations
themselves went through the model (``ROADMAP.md`` "North star"); for the
same activations handed to both taps, rtol 1e-6 (one reduction apart).
The threshold counts are integers and equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu import profiler as jprofiler
from lqer_tpu.profiler import scale as jscale
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch import profiler as tprofiler
from lqer_tpu_torch.convert import params_from_jax
from lqer_tpu_torch.testing import ATOL, RTOL, one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()


def _batches(n=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = (rng.standard_normal((2, 12, 32)) * (1 + i)).astype(np.float32)
        x[..., 0] = 0.0                       # clamped to SCALE_CLAMP_MIN
        x[..., 1] *= 1e-6                     # clamped as well
        x[0, 3, 2] = 7.5 if i % 2 else 2.0    # over the threshold in odd
        out.append({"a": x, "b": x[..., ::-1].copy() * 0.5})
    return out


def test_scale_clamp_constant():
    assert tprofiler.SCALE_CLAMP_MIN == jprofiler.SCALE_CLAMP_MIN


@pytest.mark.parametrize("num_batches", [1, 4])
def test_scale_accumulator_matches_jax(num_batches):
    jacc, tacc = jprofiler.ScaleAccumulator(), tprofiler.ScaleAccumulator()
    for batch in _batches(num_batches):
        jstats, tstats = {}, {}
        jtap = jprofiler.batch_mean_abs_tap(jstats)
        ttap = tprofiler.batch_mean_abs_tap(tstats)
        for name, x in batch.items():
            jtap(name, jnp.asarray(x))
            ttap(name, torch.as_tensor(x))
        assert sorted(tstats) == sorted(jstats) == ["a.scale", "b.scale"]
        jacc.update(jstats)
        tacc.update(tstats)
    jout, tout = jacc.finalize(), tacc.finalize()
    assert sorted(tout) == sorted(jout)
    for k in jout:
        want = np.array(jout[k])
        torch.testing.assert_close(tout[k], torch.as_tensor(want),
                                   rtol=1e-6, atol=0)
        # the clamp and the normalisation: min * max == 1
        s = tout[k]
        assert float(s.min() * s.max()) == pytest.approx(1.0, rel=1e-6)


def test_threshold_accumulator_matches_jax():
    jacc = jprofiler.ThresholdAccumulator(6.0, seq_len=12)
    tacc = tprofiler.ThresholdAccumulator(6.0, seq_len=12)
    for acc in (jacc, tacc):
        acc.register("a", 16, 32)
    for batch in _batches(4):
        jstats, tstats = {}, {}
        jtap = jprofiler.batch_threshold_tap(jstats, 6.0)
        ttap = tprofiler.batch_threshold_tap(tstats, 6.0)
        for name, x in batch.items():
            jtap(name, jnp.asarray(x))
            ttap(name, torch.as_tensor(x))
        assert {k: int(v) for k, v in tstats.items()} == {
            k: int(v) for k, v in jstats.items()}
        jacc.update(jstats)
        tacc.update(tstats)
    assert tacc.finalize() == jacc.finalize()


def test_profiled_forward_matches_jax():
    """Three batches through a tiny OPT's profiled forward: the same tap
    names (every linear's input and the head's), the finalised scales
    within the forward's tolerance."""
    jcfg = jmodels.OPTConfig.tiny(vocab_size=256, hidden=64, layers=2,
                                  heads=4, ffn=128, max_pos=64)
    tcfg = tmodels.OPTConfig.tiny(vocab_size=256, hidden=64, layers=2,
                                  heads=4, ffn=128, max_pos=64)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()})
    jprof = jax.jit(jscale.make_profiled_forward(
        lambda p, ids, tap: jmodels.forward(p, ids, jcfg, None, tap=tap)))
    tprof = tprofiler.make_profiled_forward(
        lambda p, ids, tap: tmodels.forward(p, ids, tcfg, None, tap=tap))
    rng = np.random.default_rng(1)
    jacc, tacc = jprofiler.ScaleAccumulator(), tprofiler.ScaleAccumulator()
    for _ in range(3):
        ids = rng.integers(0, 256, (2, 24)).astype(np.int32)
        _, jstats = jprof(params, jnp.asarray(ids))
        with torch.inference_mode():
            _, tstats = tprof(tparams, torch.as_tensor(ids))
        jacc.update(jstats)
        tacc.update(tstats)
    jout, tout = jacc.finalize(), tacc.finalize()
    assert sorted(tout) == sorted(jout)
    assert len(tout) == 2 * 6 + 1
    for k in jout:
        torch.testing.assert_close(tout[k], torch.as_tensor(
            np.array(jout[k])), rtol=RTOL, atol=ATOL)
