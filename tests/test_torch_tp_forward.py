"""The port's tensor-parallel forward, sharded forward and sharded train
step (``lqer_tpu_torch/parallel/tp_forward.py``, ``step.py``) against the
JAX package's on the same weights, carried across through numpy (the
cases of ``tests/test_tp_forward.py`` and ``tests/test_parallel.py``).

- ``make_tp_forward`` for Llama and OPT (rank-16 L²QER, W4A8), exact and
  with quantized collectives, at (dp 2, tp 4) and at tp 2, against JAX's
  ``make_tp_forward`` on a mesh of the same shape, within rtol = atol =
  2e-4 with the argmax equal, and within JAX's own bound of the
  single-device forward (rtol 0.1, atol 0.15). The quantized reference
  runs with exact powers of two in its MXINT8 codec
  (``jax_exact_exp2.exact_exp2``): the codec scales by ``jnp.exp2``, which
  XLA:CPU computes up to 34 ulps off for integer arguments below -12
  (and some above 12), where the port builds each power from its bits.
  Those few-ulp offsets move a wire rounding now and then, and each such
  flip moves everything after it: against the unpatched reference the
  port reads up to 2.14 code steps of each row's scale (0.391 RMS); with
  exact powers of two, 5.3e-5 (7.3e-6 RMS), as the exact wire reads;
- the refusals: dimensions tp does not divide (``ValueError``), OPT-350m's
  ``project_in``/``project_out`` and another architecture
  (``NotImplementedError``);
- ``make_sharded_forward`` against the port's ``models.forward`` (rtol =
  atol = 2e-4) and JAX's (the code-step limits) on a GQA Llama, OPT,
  OPT-350m, a Mistral whose window falls inside the sequence, a width
  where ``shard_params`` replicates dimensions (3 heads, vocab 62; its
  weights quantized at every forward, its row shards splitting the weight
  quantizer's groups) and OPT through LLM.int8()'s linear;
- three ``make_train_step`` steps (weights fake-quantized at every
  forward, STE gradients) against JAX's at (dp 2, tp 4): losses within
  2e-4 relative, every updated parameter within rtol = atol = 2e-4, every
  parameter's update (new - old) within ``UPDATE_RTOL`` of the norm of
  JAX's update, the loss descending. A and B start random, so every
  parameter's update is well above f32's resolution of the parameter.
  The sound port reads at most 1.5e-2; with the tp all-reduce of the
  replicated parameters' gradients left out, those read 0.87 to 1.

The weights are the port's seeded init (A and B at scale 0.01), prepared
by the port's ``prepare_ptq`` and handed to both packages as numpy. The
port's ranks are ``gloo`` processes spawned from the test, one spawn per
world size (8 and 2) running every case; this module imports no JAX at
its top, so the ranks can import it.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.parallel.launch import start_ranks
from lqer_tpu_torch.testing import logits_steps, one_torch_thread_fixture

from jax_exact_exp2 import exact_exp2

_one_torch_thread = one_torch_thread_fixture()

LOGIT_MAX_STEPS = 4.0
LOGIT_RMS_STEPS = 0.4
RTOL = ATOL = 2e-4
STEP_RTOL = 2e-4
UPDATE_RTOL = 0.1
MESHES = {8: 4, 2: 2}        # world size -> tp


def _q(width, block, skip):
    return {"name": "block_fp", "width": width, "exponent_width": 8,
            "exponent_bias": None, "block_size": block,
            "skip_first_dim": skip}


def q_config(is_ptq=True):
    mm = {"name": "flexible", "x_quantizer": _q(8, [1, 16], True),
          "w_quantizer": _q(8, [1, 16], True)}
    return {"linear": {"name": "flexible_lqer", "is_ptq": is_ptq,
                       "x_quantizer": _q(8, [1, 16], True),
                       "w_quantizer": _q(4, [1, 16], False),
                       "b_quantizer": _q(8, [1, 16], False)},
            "matmul": mm, "bmm": mm}


# name -> (arch, tiny kwargs, extra config fields, rank, ids shape)
TP_CASES = {
    "llama": ("llama", dict(vocab_size=64, hidden=64, layers=2, heads=4,
                            kv_heads=4, inter=128, max_pos=64), {}, 16),
    "opt": ("opt", dict(vocab_size=64, hidden=64, layers=2, heads=4,
                        ffn=128, max_pos=64), {}, 16),
}
SHARDED_CASES = {
    "llama_gqa": ("llama", dict(vocab_size=256, hidden=64, layers=2, heads=4,
                                kv_heads=2, inter=128), {}, 8),
    "opt": ("opt", dict(vocab_size=256, hidden=64, layers=2, heads=4,
                        ffn=128), {}, 8),
    "opt350m": ("opt", dict(vocab_size=64, hidden=64, layers=2, heads=4,
                            ffn=128),
                dict(word_embed_proj_dim=32, do_layer_norm_before=False), 8),
    "mistral": ("llama", dict(vocab_size=64, hidden=64, layers=2, heads=4,
                              kv_heads=2, inter=128),
                dict(sliding_window=6, arch="mistral"), 8),
    "replicated": ("llama", dict(vocab_size=62, hidden=48, layers=2, heads=3,
                                 kv_heads=3, inter=96), {}, 8),
    "opt_llm_int8": ("opt", dict(vocab_size=64, hidden=64, layers=1, heads=4,
                                 ffn=128), {}, 8),
}
TRAIN = ("llama", dict(vocab_size=128, hidden=64, layers=2, heads=4,
                       kv_heads=2, inter=128), {}, 8)
TRAIN_STEPS = 3
TRAIN_LR = 1e-2


def sharded_q_config(name):
    """The sharded cases' q_config: the weights of ``replicated`` quantized
    at every forward (its 12-wide row shards split the 16-groups of the
    weight quantizer, so the shard quantizes the gathered weight), OPT
    through LLM.int8()'s linear, the others prepared."""
    if name == "replicated":
        return q_config(is_ptq=False)
    if name == "opt_llm_int8":   # experiments/baselines.py's configs
        fp = {"name": "flexible", "x_quantizer": {"name": "passthrough"},
              "w_quantizer": {"name": "passthrough"}}
        return {"linear": {"name": "llm_int8", "threshold": 6.0},
                "matmul": fp, "bmm": fp}
    return q_config()


def port_cfg(case):
    arch, kw, extra, _ = case
    cls = tmodels.LlamaConfig if arch == "llama" else tmodels.OPTConfig
    return dataclasses.replace(cls.tiny(**kw), **extra)


def _ids(cfg, shape, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               size=shape).astype(np.int64)


def _port_params(params_np):
    return {k: torch.from_numpy(np.array(v)) for k, v in params_np.items()}


def _rank_cases(tp, tp_inputs, sharded_inputs, train_inputs):
    """Every case's port side on one rank of a (world / tp, tp) mesh."""
    import torch.distributed as dist

    from lqer_tpu_torch.parallel.mesh import make_mesh
    from lqer_tpu_torch.parallel.sharding import shard_params
    from lqer_tpu_torch.parallel.step import (
        make_sharded_forward,
        make_train_step,
    )
    from lqer_tpu_torch.parallel.tp_forward import make_tp_forward

    mesh = make_mesh(tp=tp, device_type="cpu")
    out = {"rank": dist.get_rank()}
    for name, (params_np, ids) in tp_inputs.items():
        cfg = port_cfg(TP_CASES[name])
        qcfgs = tmodels.quantize_model(cfg, q_config(),
                                       {"linear": {"rank": TP_CASES[name][3]}})
        local = shard_params(_port_params(params_np), mesh)
        for quantized in (False, True):
            fwd = make_tp_forward(cfg, qcfgs, mesh,
                                  quantized_collectives=quantized)
            out[f"tp/{name}/{quantized}"] = fwd(
                local, torch.from_numpy(ids)).numpy()
    for name, (params_np, ids) in sharded_inputs.items():
        cfg = port_cfg(SHARDED_CASES[name])
        qcfgs = tmodels.quantize_model(
            cfg, sharded_q_config(name),
            {"linear": {"rank": SHARDED_CASES[name][3]}})
        local = shard_params(_port_params(params_np), mesh)
        out[f"sharded/{name}"] = make_sharded_forward(cfg, qcfgs, mesh)(
            local, torch.from_numpy(ids)).numpy()
    refusals = {}
    for name, cfg in (
            ("indivisible", tmodels.LlamaConfig.tiny(
                vocab_size=62, hidden=48, layers=1, heads=3, kv_heads=3,
                inter=96, max_pos=32)),
            ("opt350m", tmodels.OPTConfig(
                vocab_size=64, hidden_size=64, ffn_dim=128,
                num_hidden_layers=1, num_attention_heads=4,
                max_position_embeddings=64, word_embed_proj_dim=32)),
            ("other_arch", dataclasses.replace(tmodels.LlamaConfig.tiny(),
                                               arch="gpt2"))):
        try:
            make_tp_forward(cfg, None, mesh)
            refusals[name] = None
        except (ValueError, NotImplementedError) as e:
            refusals[name] = type(e).__name__
    out["refusals"] = refusals
    if train_inputs is not None:
        params_np, ids = train_inputs
        cfg = port_cfg(TRAIN)
        qcfgs = tmodels.quantize_model(cfg, q_config(is_ptq=False),
                                       {"linear": {"rank": TRAIN[3]}})
        p = shard_params(_port_params(params_np), mesh)
        step = make_train_step(cfg, qcfgs, mesh, lr=TRAIN_LR)
        losses = []
        for _ in range(TRAIN_STEPS):
            p, loss = step(p, torch.from_numpy(ids))
            losses.append(float(loss))
        out["train"] = (losses, {k: v.numpy() for k, v in p.items()})
    return out


# -- the JAX side ---------------------------------------------------------------
def _jax_cfg(case):
    from lqer_tpu.models import LlamaConfig, OPTConfig

    arch, kw, extra, _ = case
    cls = LlamaConfig if arch == "llama" else OPTConfig
    return dataclasses.replace(cls.tiny(**kw), **extra)


def model_inputs(case, seed, is_ptq=True, zero_a=False, q=None):
    """A case's weights as numpy: the port's seeded init, A (zeros with
    ``zero_a``) and B on every quantized linear at scale 0.01, and with
    ``is_ptq`` the weights as ``prepare_ptq`` quantizes them under ``q``
    (default :func:`q_config`; JAX's forward takes prepared weights as they
    are)."""
    cfg = port_cfg(case)
    gen = torch.Generator().manual_seed(seed)
    params = tmodels.init_params(cfg, gen)
    for i in range(cfg.num_hidden_layers):
        for prefix, _ in tmodels.quantizable_module_prefixes(cfg, i):
            out_dim, in_dim = params[prefix + ".weight"].shape
            params[prefix + ".A"] = (
                torch.zeros(in_dim, case[3]) if zero_a else
                torch.randn(in_dim, case[3], generator=gen) * 0.01)
            params[prefix + ".B"] = torch.randn(case[3], out_dim,
                                                generator=gen) * 0.01
    if is_ptq:
        qcfgs = tmodels.quantize_model(cfg, q or q_config(),
                                       {"linear": {"rank": case[3]}})
        params = tmodels.prepare_ptq(params, cfg, qcfgs)
    return {k: v.numpy() for k, v in params.items()}


def _jax_model(case, params_np, is_ptq=True, q=None):
    import jax.numpy as jnp

    from lqer_tpu import models as jmodels

    cfg = _jax_cfg(case)
    qcfgs = jmodels.quantize_model(cfg, q or q_config(is_ptq),
                                   {"linear": {"rank": case[3]}})
    return cfg, qcfgs, {k: jnp.asarray(v) for k, v in params_np.items()}


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _inputs():
    """Every case's weights (numpy) and ids."""
    tp_inputs = {name: (model_inputs(TP_CASES[name], i),
                        _ids(port_cfg(TP_CASES[name]), (2, 12), 3 + i))
                 for i, name in enumerate(sorted(TP_CASES))}
    sharded_inputs = {
        name: (model_inputs(SHARDED_CASES[name], 10 + i,
                            is_ptq=name not in ("replicated", "opt_llm_int8")),
               _ids(port_cfg(SHARDED_CASES[name]), (2, 16), 20 + i))
        for i, name in enumerate(SHARDED_CASES)}
    train_inputs = (model_inputs(TRAIN, 30, is_ptq=False),
                    _ids(port_cfg(TRAIN), (4, 16), 2))
    return tp_inputs, sharded_inputs, train_inputs


def _jax_side(tp_inputs, sharded_inputs, train_inputs) -> dict:
    """The JAX package's results on the same inputs."""
    import jax
    import jax.numpy as jnp

    from lqer_tpu import models as jmodels
    from lqer_tpu.parallel import make_mesh, shard_params
    from lqer_tpu.parallel.step import make_train_step
    from lqer_tpu.parallel.tp_forward import make_tp_forward

    meshes = {n: make_mesh(n, tp=tp) for n, tp in MESHES.items()}
    want = {}

    def forward(params, ids, cfg, qcfgs):
        return np.asarray(jax.jit(lambda p, i: jmodels.forward(
            p, i, cfg, qcfgs))(params, jnp.asarray(ids)))

    for name, (params_np, ids) in tp_inputs.items():
        cfg, qcfgs, params = _jax_model(TP_CASES[name], params_np)
        want[f"ref/{name}"] = forward(params, ids, cfg, qcfgs)
        for n, mesh in meshes.items():
            sharded = shard_params(params, mesh)
            for quantized in (False, True):
                with (exact_exp2("lqer_tpu.parallel.collectives")
                      if quantized else contextlib.nullcontext()):
                    fwd = make_tp_forward(cfg, qcfgs, mesh,
                                          quantized_collectives=quantized)
                    want[f"tp/{name}/{quantized}/{n}"] = np.asarray(
                        fwd(sharded, jnp.asarray(ids)))
    for name, (params_np, ids) in sharded_inputs.items():
        cfg, qcfgs, params = _jax_model(SHARDED_CASES[name], params_np,
                                        q=sharded_q_config(name))
        want[f"sharded/{name}"] = forward(params, ids, cfg, qcfgs)
    params_np, ids = train_inputs
    cfg, qcfgs, params = _jax_model(TRAIN, params_np, is_ptq=False)
    step = make_train_step(cfg, qcfgs, meshes[8], lr=TRAIN_LR)
    p = shard_params(params, meshes[8])
    losses = []
    for _ in range(TRAIN_STEPS):
        p, loss = step(p, jnp.asarray(ids))
        losses.append(float(loss))
    want["train"] = (losses, _np(p))
    return want


@pytest.fixture(scope="module")
def sides():
    """(inputs, JAX results, {world: the ranks' results}): the ranks work
    beside the JAX side."""
    inputs = _inputs()
    groups = {n: start_ranks(_rank_cases, n, backend="gloo", device="cpu",
                             args=(tp, *inputs[:2],
                                   inputs[2] if n == 8 else None),
                             timeout=600)
              for n, tp in MESHES.items()}
    want = _jax_side(*inputs)
    return inputs, want, {n: g.results() for n, g in groups.items()}


@pytest.fixture(scope="module")
def jax_side(sides):
    return (*sides[0], sides[1])


@pytest.fixture(scope="module")
def port_side(sides):
    return sides[2]


def _dp_rows(ranks, key, tp):
    """The whole batch from each dp group's first rank."""
    return np.concatenate([r[key] for r in ranks[::tp]])


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(TP_CASES))
@pytest.mark.parametrize("quantized", [False, True])
def test_tp_forward_equals_jax(name, quantized, world, jax_side, port_side):
    want_all = jax_side[3]
    tp = MESHES[world]
    ranks = port_side[world]
    got = _dp_rows(ranks, f"tp/{name}/{quantized}", tp)
    for r in ranks:   # every rank of a dp group holds the same rows
        d = (r["rank"] // tp) * got.shape[0] // (world // tp)
        np.testing.assert_array_equal(
            r[f"tp/{name}/{quantized}"],
            got[d:d + got.shape[0] // (world // tp)])
    want = want_all[f"tp/{name}/{quantized}/{world}"]
    ref = want_all[f"ref/{name}"]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if not quantized:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=0.1, atol=0.15)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SHARDED_CASES))
def test_sharded_forward_equals_models_forward(name, world, jax_side,
                                               port_side):
    _, sharded_inputs, _, want_all = jax_side
    params_np, ids = sharded_inputs[name]
    cfg = port_cfg(SHARDED_CASES[name])
    qcfgs = tmodels.quantize_model(
        cfg, sharded_q_config(name),
        {"linear": {"rank": SHARDED_CASES[name][3]}})
    ref = tmodels.forward(_port_params(params_np), torch.from_numpy(ids),
                          cfg, qcfgs)
    for r in port_side[world]:
        got = torch.from_numpy(r[f"sharded/{name}"])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                                   atol=ATOL)
        worst, rms = logits_steps(got, torch.from_numpy(
            np.array(want_all[f"sharded/{name}"])))
        assert worst <= LOGIT_MAX_STEPS and rms <= LOGIT_RMS_STEPS, (worst,
                                                                     rms)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_tp_forward_refusals(world, port_side):
    for r in port_side[world]:
        assert r["refusals"] == {"indivisible": "ValueError",
                                 "opt350m": "NotImplementedError",
                                 "other_arch": "NotImplementedError"}


def test_train_step_equals_jax(jax_side, port_side):
    """Three steps at (dp 2, tp 4): the losses, and every rank's updated
    shard and its update against the matching shard of JAX's."""
    from lqer_tpu_torch.parallel.sharding import fixed_spec, local_shard

    init = jax_side[2][0]
    want_losses, want_params = jax_side[3]["train"]

    def shard(a, k, rank):
        full = torch.from_numpy(np.array(a))
        return local_shard(full, fixed_spec(k, full.shape, 4), 4,
                           rank % 4).numpy().astype(np.float64)

    for r in port_side[8]:
        losses, params = r["train"]
        np.testing.assert_allclose(losses, want_losses, rtol=STEP_RTOL)
        assert losses[-1] < losses[0]
        for k, v in params.items():
            want, old = shard(want_params[k], k, r["rank"]), shard(init[k], k,
                                                                   r["rank"])
            np.testing.assert_allclose(v, want, rtol=STEP_RTOL,
                                       atol=STEP_RTOL, err_msg=k)
            d_want = np.linalg.norm(want - old)
            assert d_want > 0, k
            rel = np.linalg.norm(v - want) / d_want
            assert rel <= UPDATE_RTOL, (k, rel)
