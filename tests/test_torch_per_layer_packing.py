"""Per-layer packing: a model whose layers pack differently (the reference's
``model_layer_{i}`` overrides; here layer 1's q, k and v quantize their
input at width 6) served by the port's stacked ``DecodeEngine``
(``scan_layers=True``) and by the JAX package's default engine
(``DecodeEngine(..., pallas_backend=b)``,
``scan_layers=False``, per-prefix backend entries), on the tiny Llama of
``test_torch_serving.py`` packed with ``fuse_mlp=True``, over
``mxint8-staged``. The port stacks each run of consecutive layers that
pack alike (``decode.stack_backend``, the JAX package's
``_scan_segments``). Greedy tokens must be equal, and the caches within
the limits ``test_torch_serving.py`` holds (codes below ``flushed`` equal
on >= 99.9% and within one code step, exponents equal).
"""

import jax
import numpy as np

from lqer_tpu import models as jmodels
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.serving import DecodeEngine, Request
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving.random_model import Q_CONFIG
from lqer_tpu_torch.testing import one_torch_thread_fixture
from test_torch_direct_cache_serving import _assert_caches_agree
from test_torch_serving import MAX_LEN, RANK, TINY, _jax_model, _requests

_one_torch_thread = one_torch_thread_fixture()


def _per_layer_config():
    """Q_CONFIG with layer 1's q, k and v at x width 6."""
    lin6 = {**Q_CONFIG["linear"], "x_quantizer": {
        **Q_CONFIG["linear"]["x_quantizer"], "width": 6}}
    return {**Q_CONFIG, "model_layer_1": {
        "self_attn": {"q_proj": lin6, "k_proj": lin6, "v_proj": lin6,
                      "o_proj": Q_CONFIG["linear"],
                      "matmul_0": Q_CONFIG["matmul"],
                      "matmul_1": Q_CONFIG["matmul"]},
        "mlp": {p: Q_CONFIG["linear"]
                for p in ("gate_proj", "up_proj", "down_proj")}}}


def test_engine_matches_default_jax_engine():
    q_config = _per_layer_config()
    jcfg, params, jq, jb = _jax_model(fuse_mlp=True, q_config=q_config)
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=2, max_len=MAX_LEN,
                            cache_dtype="mxint8-staged", pallas_backend=jb,
                            lm_head_width=8)
    assert not jengine._scan
    jreqs = _requests(JRequest, np.random.default_rng(1))
    jengine.run(jreqs)

    cfg = LlamaConfig.tiny(**TINY)
    tq = tmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
    backend = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                               jb["meta"])
    qkv = "self_attn.qkv_proj"
    assert (backend["meta"][f"model.layers.0.{qkv}"]
            != backend["meta"][f"model.layers.1.{qkv}"])
    engine = DecodeEngine(params_from_jax({k: np.asarray(v)
                                           for k, v in params.items()}),
                          cfg, tq, num_slots=2, max_len=MAX_LEN,
                          cache_dtype="mxint8-staged", pallas_backend=backend,
                          lm_head_width=8, scan_layers=True, device="cpu")
    segments = engine._backend["segments"]
    assert [(s, e) for s, e, _ in segments] == [(0, 1), (1, 2)]
    assert tdecode.layer_backend(engine._backend, 1) == (segments[1][2], 0)
    reqs = _requests(Request, np.random.default_rng(1))
    engine.run(reqs)
    assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    assert len(set(reqs[0].output_ids)) > 3       # not a collapsed stream
    _assert_caches_agree(engine.cache, jengine.cache)
