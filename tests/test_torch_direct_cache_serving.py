"""The direct-write caches served whole: the port's ``DecodeEngine`` against
the JAX ``DecodeEngine(scan_layers=True, lm_head_width=8)`` on the tiny
model of ``test_torch_serving.py``, for the bf16 cache (the default of
both), ``mxint8`` at max_len 128 and 144 (at 144 the JAX package writes
with its XLA update and attends with ``decode_attention_quantized``; the
port takes its fused write + attend at every length) and ``mxint4`` with
the KV4 configuration (K/V at width 4).

Greedy tokens must be equal. The caches may differ where K/V come out of
GEMMs and rotary tables whose f32 rounding differs by an ulp between XLA
and PyTorch: MXINT codes equal on >= 99.9% and within one code step,
exponents equal; bf16 values equal on >= 99.9% and within one bf16 ulp.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu.serving.decode import make_cache as jmake_cache
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.serving import DecodeEngine, Request
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving import kv_cache as tkv
from lqer_tpu_torch.parallel.collectives import exp2_int, floor_log2_exact
from lqer_tpu_torch.serving.random_model import KV4_Q_CONFIG, Q_CONFIG
from lqer_tpu_torch.testing import one_torch_thread_fixture
from test_torch_serving import RANK, TINY, _jax_model, _requests

_one_torch_thread = one_torch_thread_fixture()


def _port_engine(jparams, jb, q_config, max_len, cache_dtype, num_slots=2):
    cfg = LlamaConfig.tiny(**TINY)
    tq = tmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
    backend = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                               jb["meta"])
    return DecodeEngine(params_from_jax({k: np.asarray(v)
                                         for k, v in jparams.items()}),
                        cfg, tq, num_slots=num_slots, max_len=max_len,
                        cache_dtype=cache_dtype, pallas_backend=backend,
                        lm_head_width=8, scan_layers=True, device="cpu")


def _assert_caches_agree(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    equal = total = 0
    for key in sorted(ours):
        a = ours[key].float().numpy() if key in ("k", "v") \
            else ours[key].numpy().astype(np.int32)
        b = np.asarray(theirs[key]).astype(np.float32 if key in ("k", "v")
                                            else np.int32)
        equal += int((a == b).sum())
        total += a.size
        if key.endswith("_exps"):
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif key.endswith("_codes"):
            assert np.abs(a - b).max() <= 1, key
        else:           # one bf16 ulp of the larger magnitude
            ulp = exp2_int(floor_log2_exact(torch.from_numpy(
                np.maximum(np.abs(a), np.abs(b))).clamp(min=2 ** -126)) - 7)
            assert (np.abs(a - b) <= ulp.numpy()).all(), key
    assert equal / total >= 0.999, equal / total


@pytest.mark.parametrize("cache_dtype,max_len,kv4,n_requests", [
    ("bfloat16", 128, False, 2),
    ("mxint8", 128, False, 2),
    ("mxint8", 144, False, 2),      # JAX: XLA update + quantized decode
    ("mxint4", 128, True, 3),       # the third: a one-slot admission
])
def test_engine_matches_jax_engine(cache_dtype, max_len, kv4, n_requests):
    """With three requests on two slots the third is admitted into a freed
    slot on a fresh one-slot cache, scattered back into the running one."""
    q_config = KV4_Q_CONFIG if kv4 else Q_CONFIG
    jcfg, params, jq, jb = _jax_model(fuse_mlp=True, q_config=q_config)
    kw = {} if cache_dtype == "bfloat16" else {"cache_dtype": cache_dtype}
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=2, max_len=max_len, pallas_backend=jb,
                            scan_layers=True, lm_head_width=8, **kw)
    jreqs = _requests(JRequest, np.random.default_rng(1), n_requests)
    jengine.run(jreqs)
    engine = _port_engine(params, jb, q_config, max_len, cache_dtype)
    reqs = _requests(Request, np.random.default_rng(1), n_requests)
    engine.run(reqs)
    assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    assert len(set(reqs[0].output_ids)) > 3       # not a collapsed stream
    _assert_caches_agree(engine.cache, jengine.cache)


@pytest.mark.parametrize("cache_dtype,kv4", [("bfloat16", False),
                                             ("mxint4", True)])
def test_one_slot_admission_scatters_into_the_running_cache(cache_dtype,
                                                            kv4):
    """An admission into slot 1 of a two-slot engine runs on a fresh
    one-slot cache and scatters every cache key back: slot 1 then holds the
    bytes a one-slot engine's full admission writes, slot 0 stays as it
    was."""
    q_config = KV4_Q_CONFIG if kv4 else Q_CONFIG
    _, params, _, jb = _jax_model(fuse_mlp=True, q_config=q_config)
    ids = np.random.default_rng(3).integers(0, 128, (1, 64))
    lengths = np.array([57], np.int32)
    two = _port_engine(params, jb, q_config, 128, cache_dtype)
    one = _port_engine(params, jb, q_config, 128, cache_dtype, num_slots=1)
    before = {k: v[:, 0].clone() for k, v in two.cache.items()}
    torch.testing.assert_close(two.prefill(ids, np.array([1]), lengths),
                               one.prefill(ids, np.array([0]), lengths),
                               rtol=0, atol=0)
    for key, arr in two.cache.items():
        assert torch.equal(arr[:, 1], one.cache[key][:, 0]), key
        assert torch.equal(arr[:, 0], before[key]), key
        assert bool(arr[:, 1].ne(0).any()), key


def test_direct_mxint8_serves_as_staged():
    """The JAX package holds the direct-write and the ring-staged MXINT8
    caches to be one function (tests/test_staged_serving.py); so does the
    port."""
    _, params, _, jb = _jax_model(fuse_mlp=True)
    outs = []
    for cache_dtype in ("mxint8", "mxint8-staged"):
        engine = _port_engine(params, jb, Q_CONFIG, 128, cache_dtype)
        reqs = _requests(Request, np.random.default_rng(2), 3)
        engine.run(reqs)
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1]


def test_default_cache_matches_jax_default():
    """``make_cache``'s and the engine's default is the bf16 cache in both
    packages, and an unstaged MXINT cache has the same keys, shapes and
    dtypes in both."""
    cfg = LlamaConfig.tiny(**TINY)
    jcfg = jmodels.LlamaConfig.tiny(**TINY)
    for args in ((), ("mxint8",), ("mxint4",)):
        ours = tdecode.make_cache(cfg, 2, 128, *args, device="cpu")
        theirs = jmake_cache(jcfg, 2, 128, *args)
        assert sorted(ours) == sorted(theirs)
        for key, arr in ours.items():
            assert tuple(arr.shape) == theirs[key].shape, key
            assert str(arr.dtype).removeprefix("torch.") == \
                str(theirs[key].dtype), key
    for engine_cls in (DecodeEngine, JDecodeEngine):
        default = inspect.signature(engine_cls).parameters["cache_dtype"]
        assert default.default in ("bfloat16", jax.numpy.bfloat16)
    assert not tkv.is_staged_cache(tkv.init_quantized_kv_cache(
        1, 2, 2, 64, 128, device="cpu"))
    cache = tdecode.make_cache(cfg, 2, 144, "mxint8-staged", device="cpu")
    assert not tkv.is_staged_cache(cache)          # as JAX, at 144 % 128
