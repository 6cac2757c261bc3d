"""Long-context decode served whole: the port's ``DecodeEngine`` against the
JAX ``DecodeEngine(scan_layers=True, lm_head_width=8)`` on the tiny model of
``test_torch_serving.py`` (d = 64, n_rep = 2).

- At max_len 47104 (23 x 2048, a multiple of 128), past the JAX package's
  one-pass length at d = 64 (``_kvh_chunk_fits``: 46260), both packages
  stream L: ``mxint8`` (the fused encode + write, then the streaming
  kernel), ``mxint8-staged`` (the streaming staged kernel) and ``mxint4``
  with the KV4 configuration (the row write, then the streaming kernel at
  width 4).
- At max_len 28672 both packages take their one-pass kernels: the fused
  write + attend (``mxint8``) and the row write, then the quantized
  decode kernel (``mxint4``). The port's one-pass kernels split L over
  blocks, so no shared memory bounds their length, and the route of the
  direct-write caches is the JAX package's at every length
  (``test_direct_routes_follow_the_jax_package``).

Greedy tokens must be equal. MXINT codes equal on >= 99.9% and within one
code step, exponents equal (K/V come out of GEMMs and rotary tables whose
f32 rounding may differ by an ulp between XLA and PyTorch). Each decode
step launches, per layer, the kernels ``decode.decode_route`` names, in
that order.
"""

import numpy as np
import pytest

from lqer_tpu import models as jmodels
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu.ops.pallas.decode_attention import (
    _kvh_chunk_fits as j_kvh_chunk_fits,
)
from lqer_tpu_torch.ops.kernels import KERNELS
from lqer_tpu_torch.ops.kernels.attention import HEAD_DIMS
from lqer_tpu_torch.serving import Request
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving.random_model import KV4_Q_CONFIG, Q_CONFIG
from lqer_tpu_torch.testing import one_torch_thread_fixture
from test_torch_direct_cache_serving import _assert_caches_agree, _port_engine
from test_torch_serving import _jax_model

_one_torch_thread = one_torch_thread_fixture()


def _requests(cls):
    """Prompts of 70 and 40 tokens: at least 32 each, so a staged slot holds
    main tokens (the JAX streaming staged kernel returns NaN for a slot
    with flushed = 0, ``test_torch_streaming_kernels.py``)."""
    rng = np.random.default_rng(5)
    return [cls(prompt_ids=[int(t) for t in rng.integers(0, 128, n)],
                max_new_tokens=4) for n in (70, 40)]


# the KERNELS names of the decode-attention kernels and the cache writes
DECODE_KERNELS = ("row_write", "decode_attention_fp", "decode_attention_write",
                  "decode_attention_quantized", "encode_write_tokens",
                  "decode_attention_streaming", "decode_attention",
                  "decode_attention_streaming_staged")


def _record_routes(monkeypatch):
    """Patch the step's decode kernel wrappers to note their names."""
    calls = []
    for name in DECODE_KERNELS:
        wrapper = KERNELS[name][0]
        if getattr(tdecode, wrapper.__name__, None) is wrapper:
            monkeypatch.setattr(
                tdecode, wrapper.__name__,
                lambda *a, _w=wrapper, _n=name, **k: calls.append(_n)
                or _w(*a, **k))
    return calls


@pytest.mark.parametrize("cache_dtype,max_len,kv4,route", [
    ("mxint8", 47104, False, ("encode_write_tokens",
                              "decode_attention_streaming")),
    ("mxint8-staged", 47104, False, ("decode_attention_streaming_staged",)),
    ("mxint4", 47104, True, ("row_write", "decode_attention_streaming")),
    # the one-pass rows 10 (mxint8) and 6 (mxint4), as in JAX
    ("mxint8", 28672, False, ("decode_attention_write",)),
    ("mxint4", 28672, True, ("row_write", "decode_attention_quantized")),
])
def test_long_context_engine_matches_jax_engine(monkeypatch, cache_dtype,
                                                max_len, kv4, route):
    assert j_kvh_chunk_fits(max_len, 64) == (max_len == 28672)
    q_config = KV4_Q_CONFIG if kv4 else Q_CONFIG
    jcfg, params, jq, jb = _jax_model(fuse_mlp=True, q_config=q_config)
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=2, max_len=max_len,
                            cache_dtype=cache_dtype, pallas_backend=jb,
                            scan_layers=True, lm_head_width=8)
    jreqs = _requests(JRequest)
    jengine.run(jreqs)

    engine = _port_engine(params, jb, q_config, max_len, cache_dtype)
    assert tdecode.decode_route(cache_dtype, max_len, 64, 2) == route
    calls = _record_routes(monkeypatch)
    reqs = _requests(Request)
    engine.run(reqs)
    steps = len(calls) // (2 * len(route))
    assert steps >= 3 and calls == list(route) * (2 * steps), calls[:6]
    assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    assert len(set(reqs[0].output_ids)) > 2       # not a collapsed stream
    _assert_caches_agree(engine.cache, jengine.cache)


@pytest.mark.parametrize("kind,max_len,route", [
    # Llama-2-7B width (d = 128, n_rep = 1): the JAX one-pass length is
    # 23130 tokens; past it every MXINT cache streams, as in JAX
    ("mxint8", 22528, ("decode_attention_write",)),
    ("mxint8", 24576, ("encode_write_tokens", "decode_attention_streaming")),
    ("mxint4", 22528, ("row_write", "decode_attention_quantized")),
    ("mxint4", 32768, ("row_write", "decode_attention_streaming")),
    ("mxint8-staged", 22528, ("decode_attention",)),
    ("mxint8-staged", 24576, ("decode_attention_streaming_staged",)),
    ("mxint8-staged", 32768, ("decode_attention_streaming_staged",)),
    ("bfloat16", 22528, ("row_write", "decode_attention_fp")),
])
def test_routes_at_7b_width_follow_the_jax_package(kind, max_len, route):
    assert j_kvh_chunk_fits(max_len, 128) == (max_len == 22528)
    assert tdecode.decode_route(kind, max_len, 128, 1) == route


@pytest.mark.parametrize("kind,head_dim", [
    (kind, d) for kind in ("mxint8", "mxint4") for d in HEAD_DIMS
    if kind == "mxint8" or d % 32 == 0])    # MXINT4: head_dim % 32 == 0
def test_direct_routes_follow_the_jax_package(kind, head_dim):
    """The direct-write caches stream exactly where the JAX package does
    (past ``_kvh_chunk_fits``), at every n_rep the kernels take, over
    lengths around its one-pass limit and up to 64K tokens."""
    lengths = {128, 2048, 65536}
    for n in range(128, 65536 + 1, 16):
        if j_kvh_chunk_fits(n, head_dim) != j_kvh_chunk_fits(n + 16,
                                                              head_dim):
            lengths |= {n - 16, n, n + 16, n + 32}
    one_pass = (("decode_attention_write",) if kind == "mxint8"
                else ("row_write", "decode_attention_quantized"))
    for n_rep in range(1, 9):
        for max_len in sorted(lengths):
            route = tdecode.decode_route(kind, max_len, head_dim, n_rep)
            assert (route == one_pass) == j_kvh_chunk_fits(max_len,
                                                           head_dim), (
                n_rep, max_len, route)
