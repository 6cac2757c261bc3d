"""The served slice as a whole: the port's ``DecodeEngine`` against the JAX
``DecodeEngine(scan_layers=True, cache_dtype="mxint8-staged",
lm_head_width=8)`` on the same weights (the JAX backend packed with
``fuse_mlp=True``, its default, and with ``fuse_mlp=False``, converted),
plus the model and serving pieces around it.

Greedy tokens must be equal. Main cache codes below ``flushed`` must be
equal on at least 99.9% of entries and within one code step elsewhere:
K/V come out of GEMMs and rotary tables whose f32 rounding may differ by an
ulp between XLA and PyTorch, which can flip a rare 8-bit rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.models import common as jcommon
from lqer_tpu.models import llama as jllama
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu.serving import pallas_backend as jbackend
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.models import common as tcommon
from lqer_tpu_torch.models import llama as tllama
from lqer_tpu_torch.serving import DecodeEngine, Request
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving import kernel_backend as tbackend
from lqer_tpu_torch.serving.engine import _bucket
from lqer_tpu_torch.serving.random_model import Q_CONFIG
from lqer_tpu_torch.testing import one_torch_thread_fixture, shared

_one_torch_thread = one_torch_thread_fixture()

MAX_LEN = 128
TINY = dict(vocab_size=128, hidden=256, layers=2, heads=4, kv_heads=2,
            inter=256, max_pos=MAX_LEN)
RANK = 32


@shared
def _jax_model(seed=0, fuse_mlp=False, q_config=Q_CONFIG):
    """Tiny Llama (tests/test_staged_serving.py:38 shape) with rank-32 A/B
    factors on every linear (bf16-exact values) and a wider embedding so
    greedy decoding does not collapse onto one token."""
    cfg = JLlamaConfig.tiny(**TINY)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(seed))
    params["model.embed_tokens.weight"] = params["model.embed_tokens.weight"] * 40
    rng = np.random.default_rng(seed)
    for i in range(cfg.num_hidden_layers):
        for rel in jllama.LAYER_REL_KEYS[:7]:
            o, ic = params[f"model.layers.{i}.{rel}.weight"].shape
            for name, shape in (("A", (ic, RANK)), ("B", (RANK, o))):
                v = (rng.standard_normal(shape) * 0.05).astype(jnp.bfloat16)
                params[f"model.layers.{i}.{rel}.{name}"] = jnp.asarray(
                    v.astype(np.float32))
    qcfgs = jmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
    backend = jbackend.prepare_serving_params(params, cfg, qcfgs,
                                              fuse_mlp=fuse_mlp)
    return cfg, params, qcfgs, backend


def _requests(cls, rng, n=2):
    """Prompts of 63 and 21 tokens (then 64, 40, 33, ...): every admission
    pads to the 64-token bucket."""
    lengths = [63, 21, 64, 40, 33, 50, 57, 45][:n]
    return [cls(prompt_ids=[int(t) for t in rng.integers(0, 128, k)],
                max_new_tokens=20) for k in lengths]


@pytest.mark.parametrize("fuse_mlp,slots", [
    (False, 2),
    (True, 2),    # a 128-row admission: the megakernel at every step
    (True, 8),    # a 512-row admission: the large-M route, then the megakernel
])
def test_engine_matches_jax_engine(monkeypatch, fuse_mlp, slots):
    jcfg, params, jq, jb = _jax_model(fuse_mlp=fuse_mlp)
    jengine = JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                            num_slots=slots, max_len=MAX_LEN,
                            cache_dtype="mxint8-staged", pallas_backend=jb,
                            scan_layers=True, lm_head_width=8)
    jreqs = _requests(JRequest, np.random.default_rng(1), slots)
    jengine.run(jreqs)

    cfg = LlamaConfig.tiny(**TINY)
    tq = tmodels.quantize_model(cfg, Q_CONFIG, {"linear": {"rank": RANK}})
    backend = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                               jb["meta"])
    assert ("model.layers.0.mlp_fused" in backend["meta"]) == fuse_mlp
    engine = DecodeEngine(params_from_jax({k: np.asarray(v)
                                           for k, v in params.items()}),
                          cfg, tq, num_slots=slots, max_len=MAX_LEN,
                          cache_dtype="mxint8-staged", pallas_backend=backend,
                          lm_head_width=8, scan_layers=True, device="cpu")
    rows = []           # rows of each MLP call, by route
    for name in ("mlp_w4_fused", "mlp_w4_dense_largeM"):
        real = getattr(tbackend, name)
        monkeypatch.setattr(tbackend, name, lambda x, *a, _r=real, _n=name, **k:
                            rows.append((_n, x.shape[0])) or _r(x, *a, **k))
    reqs = _requests(Request, np.random.default_rng(1), slots)
    engine.run(reqs)

    if fuse_mlp:
        large = [m for n, m in rows if n == "mlp_w4_dense_largeM"]
        assert large == ([512] * 2 if slots == 8 else [])
        assert ("mlp_w4_fused", 128) in rows or slots == 8
        assert ("mlp_w4_fused", slots) in rows        # decode steps
    else:
        assert rows == []
    assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    assert len(set(reqs[0].output_ids)) > 3       # not a collapsed stream
    fl = engine.cache["flushed"].numpy()
    np.testing.assert_array_equal(fl, np.asarray(jengine.cache["flushed"]))
    assert fl.max() >= 64                         # a flush happened
    total = equal = 0
    for side in ("k", "v"):
        for b in range(slots):
            f = int(fl[b])
            a = engine.cache[f"{side}_codes"][:, b, ..., :f].numpy()
            j = np.asarray(jengine.cache[f"{side}_codes"])[:, b, ..., :f]
            ea = engine.cache[f"{side}_exps"][:, b, ..., :f].numpy()
            ej = np.asarray(jengine.cache[f"{side}_exps"])[:, b, ..., :f]
            total += a.size + ea.size
            equal += int((a == j).sum()) + int((ea == ej).sum())
            assert np.abs(a.astype(int) - j.astype(int)).max() <= 1
            np.testing.assert_array_equal(ea, ej)
    assert equal / total >= 0.999, equal / total


def test_building_blocks_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), {"weight": torch.from_numpy(w)}
                         ).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), {"weight": jnp.asarray(w)})),
        rtol=1e-6, atol=1e-6)
    cos_t, sin_t = tcommon.rotary_tables(32, 64)
    cos_j, sin_j = jcommon.rotary_tables(32, 64)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=2e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=2e-6)
    q = rng.standard_normal((2, 4, 3, 32)).astype(np.float32)
    pos = np.array([[5, 6, 7], [0, 1, 2]])
    qt, kt = tcommon.apply_rotary(torch.from_numpy(q), torch.from_numpy(q),
                                  cos_t, sin_t, torch.from_numpy(pos))
    qj, _ = jcommon.apply_rotary(jnp.asarray(q), jnp.asarray(q), cos_j, sin_j,
                                 jnp.asarray(pos))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    kv = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tcommon.repeat_kv(torch.from_numpy(kv), 3).numpy(),
        np.asarray(jcommon.repeat_kv(jnp.asarray(kv), 3)))
    np.testing.assert_array_equal(
        tcommon.merge_heads(torch.from_numpy(q)).numpy(),
        np.asarray(jcommon.merge_heads(jnp.asarray(q))))
    g = rng.standard_normal(100).astype(np.float32)
    np.testing.assert_allclose(tdecode.silu(torch.from_numpy(g)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(g))),
                               rtol=1e-6, atol=1e-7)


def test_config_expansion_and_stacking_match_jax():
    q_het = dict(Q_CONFIG)
    lin6 = {**Q_CONFIG["linear"], "x_quantizer": {
        **Q_CONFIG["linear"]["x_quantizer"], "width": 6}}
    q_het["model_layer_1"] = {
        "self_attn": {"q_proj": lin6, "k_proj": lin6, "v_proj": lin6,
                      "o_proj": Q_CONFIG["linear"],
                      "matmul_0": Q_CONFIG["matmul"],
                      "matmul_1": Q_CONFIG["matmul"]},
        "mlp": {p: Q_CONFIG["linear"]
                for p in ("gate_proj", "up_proj", "down_proj")}}
    cfg = LlamaConfig.tiny(**{**TINY, "layers": 3})
    tq = tmodels.quantize_model(cfg, q_het, {"linear": {"rank": 8}})
    assert tq[1]["attn"].q_proj.x_cfg["width"] == 6
    assert tq[0]["attn"].q_proj.x_cfg["width"] == 8
    assert tq[0]["gate_proj"] == tq[2]["gate_proj"]
    assert tq[2]["down_proj"].rank == 8
    jcfg = JLlamaConfig.tiny(**{**TINY, "layers": 3})
    for i in range(3):
        assert tmodels.quantizable_module_prefixes(cfg, i) == \
            jmodels.quantizable_module_prefixes(jcfg, i)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    js, jr = jllama.stack_layer_params(params, jcfg)
    ts, tr = tllama.stack_layer_params(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}), cfg)
    assert sorted(js) == sorted(ts) and sorted(jr) == sorted(tr)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    assert tmodels.get_arch_module(cfg) is tllama
    assert tmodels.get_arch_module(dataclasses.replace(cfg, arch="opt")) \
        is tmodels.opt_mod
    # Mistral is served by the Llama module, as in the JAX package
    assert tmodels.get_arch_module(dataclasses.replace(cfg, arch="mistral")) \
        is tllama


def _port_engine(num_slots, device="cpu", cache_dtype="mxint8-staged", **kw):
    jcfg, params, _, jb = _jax_model(3)
    cfg = LlamaConfig.tiny(**TINY)
    tq = tmodels.quantize_model(cfg, Q_CONFIG, {"linear": {"rank": RANK}})
    backend = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                               jb["meta"])
    return DecodeEngine(params_from_jax({k: np.asarray(v)
                                         for k, v in params.items()}),
                        cfg, tq, num_slots=num_slots, max_len=MAX_LEN,
                        cache_dtype=cache_dtype, pallas_backend=backend,
                        scan_layers=True, device=device, **kw)


def test_partial_admission_and_seeded_sampling():
    """3 slots, 4 requests: the fourth is admitted into a freed slot (the
    per-slot scatter); temperature sampling draws from the engine's seeded
    generator, so two engines with one seed agree."""
    def run(seed):
        engine = _port_engine(3, rng_seed=seed)
        reqs = [Request(prompt_ids=[3, 9, 27], max_new_tokens=4),
                Request(prompt_ids=[5, 6], max_new_tokens=3),
                Request(prompt_ids=[8, 1, 2, 6], max_new_tokens=5,
                        temperature=0.9),
                Request(prompt_ids=[7, 7], max_new_tokens=3)]
        engine.run(reqs)
        assert all(r.done for r in reqs)
        assert [len(r.output_ids) for r in reqs] == [4, 3, 5, 3]
        return [r.output_ids for r in reqs]

    assert run(5) == run(5)
    assert _bucket(63) == 64 and _bucket(3) == 16


def test_stack_backend_and_head():
    engine = _port_engine(2, lm_head_width=8)
    b = engine._backend
    (start, end, layers), = b["segments"]          # every layer packs alike
    assert (start, end) == (0, 2)
    assert layers["arrays"]["self_attn.qkv_proj"]["codes"].shape[0] == 2
    assert layers["meta"]["self_attn.qkv_proj"]["splits"] == (256, 128, 128)
    assert b["meta"]["lm_head"]["n_real"] == 128
    assert "mlp.gateup_proj" in layers["meta"] \
        and "mlp.down_proj" in layers["meta"]
    assert tbackend._LARGEM_THRESHOLD == 512


def test_card_requests_raise_without_a_card(monkeypatch):
    """An entry point asked for the card on a machine without one raises;
    it never carries on on the CPU."""
    from lqer_tpu_torch import resolve_device
    from lqer_tpu_torch.serving.random_model import build_random_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        _port_engine(2, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_random_model(LlamaConfig.tiny(**TINY), rank=0)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("cache_dtype,max_len,q_config,path", [
    ("float32", MAX_LEN, Q_CONFIG, "float32"),
    ("bfloat16", 24592, Q_CONFIG, "_fp_cache_kernel_fits"),
    ("bfloat16", 64, Q_CONFIG, "_attend"),             # short: eager in JAX
    ("mxint4", MAX_LEN, Q_CONFIG, "_attend"),          # K/V width 8 over 4
    ("mxint8", MAX_LEN, None, "_attend"),              # fp attention config
])
def test_unported_options_raise(cache_dtype, max_len, q_config, path):
    """Regimes the port refused before its eager path was ported (the
    ``float32`` cache, the bf16 cache past the fp kernel's one-pass length,
    and the eager ``_attend`` regimes) now serve, as the JAX package
    serves them: the port's engines (eager and stacked) against the JAX
    engine with the packed backend, tokens equal; the decode step takes
    the JAX package's route (``path``: the fp kernel on the f32 cache, or
    no decode kernel)."""
    if q_config is None:
        q_config = {**Q_CONFIG, "matmul": None}
    jcfg, params, jq, jb = _jax_model(3, q_config=q_config)
    jcache_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}.get(
        cache_dtype, cache_dtype)
    kw = dict(num_slots=2, max_len=max_len, lm_head_width=8)
    jreqs = [JRequest(prompt_ids=p, max_new_tokens=4)
             for p in ([3, 9, 27, 4, 100, 17], [5, 6, 7])]
    JDecodeEngine(jmodels.prepare_ptq(params, jcfg, jq), jcfg, jq,
                  pallas_backend=jb, cache_dtype=jcache_dtype,
                  **kw).run(jreqs)
    cfg = LlamaConfig.tiny(**TINY)
    tq = tmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
    attn = tq[0]["attn"]
    tparams = tmodels.prepare_ptq(
        params_from_jax({k: np.asarray(v) for k, v in params.items()}), cfg,
        tq)
    backend = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]),
                               jb["meta"])
    for scan in (False, True):
        engine = DecodeEngine(tparams, cfg, tq, cache_dtype=cache_dtype,
                              pallas_backend=backend, scan_layers=scan,
                              device="cpu", **kw)
        reqs = [Request(prompt_ids=r.prompt_ids, max_new_tokens=4)
                for r in jreqs]
        engine.run(reqs)
        assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    kernel = tdecode._use_attn_kernel(True, 1, attn, max_len, cfg.head_dim,
                                      engine.cache)
    assert kernel == (path == "float32")
    if path == "_fp_cache_kernel_fits":
        assert not tdecode._fp_cache_kernel_fits(max_len, cfg.head_dim, 2)


def test_unfused_projections_serve_like_fused():
    """Group members whose activation quantizers are distinct objects (here
    k_proj and up_proj with an equal-valued config written with a tuple
    block size) are not fusable: they pack one by one and the step launches
    each member. The function is the same, so greedy tokens stay the
    same."""
    jcfg, params, _, _ = _jax_model(4)
    cfg = LlamaConfig.tiny(**TINY)
    lin, mm = Q_CONFIG["linear"], Q_CONFIG["matmul"]
    lin_t = {**lin, "x_quantizer": {**lin["x_quantizer"],
                                    "block_size": (1, 16)}}
    q_split = dict(Q_CONFIG)
    for i in range(cfg.num_hidden_layers):
        q_split[f"model_layer_{i}"] = {
            "self_attn": {"q_proj": lin, "k_proj": lin_t, "v_proj": lin,
                          "o_proj": lin, "matmul_0": mm, "matmul_1": mm},
            "mlp": {"gate_proj": lin, "up_proj": lin_t, "down_proj": lin}}
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()})
    outs = []
    for fused, q_config in ((True, Q_CONFIG), (False, q_split)):
        tq = tmodels.quantize_model(cfg, q_config, {"linear": {"rank": RANK}})
        backend = tbackend.prepare_serving_params(tparams, cfg, tq,
                                                  fuse_mlp=False)
        for rel in ("self_attn.qkv_proj", "mlp.gateup_proj"):
            assert (f"model.layers.0.{rel}" in backend["meta"]) == fused
        assert ("model.layers.0.self_attn.k_proj" in backend["meta"]) != fused
        engine = DecodeEngine(tparams, cfg, tq, num_slots=2, max_len=MAX_LEN,
                              cache_dtype="mxint8-staged",
                              pallas_backend=backend, lm_head_width=8,
                              scan_layers=True, device="cpu")
        reqs = _requests(Request, np.random.default_rng(2))
        engine.run(reqs)
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1]
