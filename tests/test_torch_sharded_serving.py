"""The port's mesh engine (``DecodeEngine(mesh=...)``) against the JAX
package's single-device engine (the cases of
``tests/test_sharded_serving.py``, whose own test shows JAX's sharded
engine giving the single-device tokens), and the port's
``dryrun_multichip``.

- A tiny GQA Llama (4 heads over 2 kv heads, so at tp 4 every rank keeps
  both kv heads and attends its q head to the kv head it maps to) through
  the mesh engine at tp 4 (4 ranks) and at (dp 2, tp 4) (8 ranks: the two
  slots split over dp) on the ``float32``, ``mxint8``, ``mxint8-staged``
  and ``mxint4-staged`` caches (``mxint4-staged`` with the 4-bit K/V
  matmul configuration), two prompts, 5 greedy tokens each: every rank's
  tokens equal to the JAX single-device engine's. The stacked step
  (``scan_layers=True``) serves ``mxint8-staged`` at (dp 2, tp 4) too.
- The dry run's model (``parallel/dryrun.py``: 8 heads over 4 kv heads,
  its weights and biases fake-quantized at every step, ``is_ptq`` False)
  through the mesh engine at both meshes on ``float32`` and
  ``mxint8-staged``: every rank's tokens equal to the JAX single-device
  engine's, so each rank's shard of a linear is quantized as the whole
  weight is.
- The refusals: a ``pallas_backend`` with a mesh (``NotImplementedError``)
  and heads tp does not divide (``ValueError``).
- ``dryrun_multichip(8, tp=4, device="cpu", backend="gloo")`` prints its
  line.

The JAX tokens come from a fresh Python process (ROADMAP fault 18: in a
process that has run other JAX work the JAX engine's decode steps can
move). The weights are the port's seeded init, prepared by the port's
``prepare_ptq``, handed to JAX as numpy. The port's ranks are ``gloo``
processes spawned from the test, one spawn per world size; this module
imports no JAX, so the ranks can import it.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.parallel.launch import run_ranks, start_ranks
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

HERE = Path(__file__).resolve().parent
PROMPTS = [[3, 17, 42], [9, 8, 7, 6]]
NEW_TOKENS = 5
CACHES = ("float32", "mxint8", "mxint8-staged", "mxint4-staged")
DRYRUN_CACHES = ("float32", "mxint8-staged")
WORLDS = {4: 4, 8: 4}       # world size -> tp


def _q(width, block, skip):
    return {"name": "block_fp", "width": width, "exponent_width": 8,
            "exponent_bias": None, "block_size": block,
            "skip_first_dim": skip}


def q_config(cache):
    kv_width = 4 if cache.startswith("mxint4") else 8
    return {"linear": {"name": "flexible_lqer", "is_ptq": True,
                       "x_quantizer": _q(8, [1, 16], True),
                       "w_quantizer": _q(4, [1, 16], False),
                       "b_quantizer": _q(8, [1, 16], False)},
            "matmul": {"name": "flexible",
                       "x_quantizer": _q(8, [1, 16], True),
                       "w_quantizer": _q(kv_width, [1, 16], True)}}


def case(cache):
    """(tiny kwargs, max_len, low-rank B on every linear) of JAX's test:
    the float32 case at hidden 64 with B, the quantized caches at 128."""
    if cache == "float32":
        return dict(vocab_size=128, hidden=64, layers=2, heads=4, kv_heads=2,
                    inter=128), 64, True
    return dict(vocab_size=128, hidden=128, layers=2, heads=4, kv_heads=2,
                inter=128, max_pos=128), 128, False


def model_inputs(cache, seed):
    """The case's prepared weights (the port's init and ``prepare_ptq``),
    with A zero and B random on every linear where JAX's test adds
    them."""
    kw, _, with_b = case(cache)
    cfg = tmodels.LlamaConfig.tiny(**kw)
    gen = torch.Generator().manual_seed(seed)
    params = tmodels.init_params(cfg, gen)
    qcfgs = tmodels.quantize_model(cfg, q_config(cache), {"linear": {"rank": 8}})
    params = tmodels.prepare_ptq(params, cfg, qcfgs)
    if with_b:
        for i in range(cfg.num_hidden_layers):
            for prefix, _ in tmodels.quantizable_module_prefixes(cfg, i):
                out_dim, in_dim = params[prefix + ".weight"].shape
                params[prefix + ".A"] = torch.zeros(in_dim, 8)
                params[prefix + ".B"] = torch.randn(8, out_dim,
                                                    generator=gen) * 0.01
    return {k: v.numpy() for k, v in params.items()}


def dryrun_inputs() -> dict:
    """The dry run's model at hidden 128 as numpy."""
    from lqer_tpu_torch.parallel.dryrun import tiny_llama_setup

    return {k: v.numpy() for k, v in tiny_llama_setup()[1].items()}


def _serve(params_np, cache, mesh=None, scan=False, dryrun=False):
    from lqer_tpu_torch.parallel.dryrun import MODEL, Q_CONFIG
    from lqer_tpu_torch.serving import DecodeEngine, Request

    kw, max_len, _ = case(cache)
    qc = q_config(cache)
    if dryrun:
        kw, qc = dict(MODEL, hidden=128), Q_CONFIG
    cfg = tmodels.LlamaConfig.tiny(**kw)
    qcfgs = tmodels.quantize_model(cfg, qc, {"linear": {"rank": 8}})
    params = {k: torch.from_numpy(np.array(v)) for k, v in params_np.items()}
    engine = DecodeEngine(params, cfg, qcfgs, num_slots=2, max_len=max_len,
                          cache_dtype=cache, device="cpu", mesh=mesh,
                          scan_layers=scan)
    reqs = [Request(prompt_ids=p, max_new_tokens=NEW_TOKENS)
            for p in PROMPTS]
    engine.run(reqs)
    return [r.output_ids for r in reqs]


def _rank_serving(tp, inputs):
    from lqer_tpu_torch.parallel.mesh import axis_size, make_mesh
    from lqer_tpu_torch.serving import DecodeEngine

    mesh = make_mesh(tp=tp, device_type="cpu")
    out = {c: _serve(inputs[c], c, mesh) for c in CACHES}
    for c in DRYRUN_CACHES:
        out[f"dryrun/{c}"] = _serve(inputs["dryrun"], c, mesh, dryrun=True)
    if axis_size(mesh, "dp") > 1:
        out["mxint8-staged/scan"] = _serve(inputs["mxint8-staged"],
                                           "mxint8-staged", mesh, scan=True)
    refusals = {}
    cfg = tmodels.LlamaConfig.tiny(**case("mxint8")[0])
    for name, kw in (("backend", dict(cfg=cfg, pallas_backend={})),
                     ("heads", dict(cfg=dataclasses.replace(
                         cfg, num_attention_heads=2, num_key_value_heads=2),
                         pallas_backend=None))):
        try:
            DecodeEngine({}, kw["cfg"], None, num_slots=2, max_len=128,
                         device="cpu", mesh=mesh,
                         pallas_backend=kw["pallas_backend"])
            refusals[name] = None
        except (ValueError, NotImplementedError) as e:
            refusals[name] = type(e).__name__
    out["refusals"] = refusals
    return out


_CHILD = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[3]); sys.path.insert(0, sys.argv[4])
import conftest  # noqa: F401  (the CPU platform)
import jax.numpy as jnp
from lqer_tpu import models
from lqer_tpu.models import LlamaConfig
from lqer_tpu.serving import DecodeEngine, Request
from lqer_tpu_torch.parallel.dryrun import MODEL, Q_CONFIG
from test_torch_sharded_serving import (CACHES, DRYRUN_CACHES, NEW_TOKENS,
                                        PROMPTS, case, q_config)

inputs = np.load(sys.argv[1])
out = {}
runs = [(c, c, case(c)[0], case(c)[1], q_config(c)) for c in CACHES]
runs += [(f"dryrun/{c}", "dryrun", dict(MODEL, hidden=128), case(c)[1],
          Q_CONFIG) for c in DRYRUN_CACHES]
for key, model, kw, max_len, q in runs:
    cache = key.split("/")[-1]
    cfg = LlamaConfig.tiny(**kw)
    qcfgs = models.quantize_model(cfg, q, {"linear": {"rank": 8}})
    params = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in inputs.items()
              if k.startswith(model + "/")}
    engine = DecodeEngine(params, cfg, qcfgs, num_slots=2, max_len=max_len,
                          cache_dtype=jnp.float32 if cache == "float32"
                          else cache)
    reqs = [Request(prompt_ids=p, max_new_tokens=NEW_TOKENS) for p in PROMPTS]
    engine.run(reqs)
    out[key] = [r.output_ids for r in reqs]
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    """(the JAX single-device engine's tokens per cache, {world: the ranks'
    results}): the ranks serve beside the JAX process."""
    inputs = {c: model_inputs(c, i) for i, c in enumerate(CACHES)}
    inputs["dryrun"] = dryrun_inputs()
    groups = {n: start_ranks(_rank_serving, n, backend="gloo", device="cpu",
                             args=(tp, inputs), timeout=600)
              for n, tp in WORLDS.items()}
    tmp = tmp_path_factory.mktemp("jax_engine")
    npz = tmp / "inputs.npz"
    np.savez(npz, **{f"{c}/{k}": v for c, p in inputs.items()
                     for k, v in p.items()})
    out = tmp / "tokens.json"
    subprocess.run([sys.executable, "-c", _CHILD, str(npz), str(out),
                    str(HERE), str(HERE.parent)],
                   env=dict(os.environ, JAX_PLATFORMS="cpu"), check=True,
                   timeout=900)
    with open(out) as f:
        want = json.load(f)
    return want, {n: g.results() for n, g in groups.items()}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("cache", CACHES)
def test_mesh_engine_matches_jax_engine(cache, world, tokens):
    want, ranks = tokens
    assert all(len(t) == NEW_TOKENS for t in want[cache])
    for r in ranks[world]:
        assert r[cache] == want[cache], (r[cache], want[cache])


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("cache", DRYRUN_CACHES)
def test_mesh_engine_quantizes_whole_weights(cache, world, tokens):
    want, ranks = tokens
    key = f"dryrun/{cache}"
    assert all(len(t) == NEW_TOKENS for t in want[key])
    for r in ranks[world]:
        assert r[key] == want[key], (r[key], want[key])


def test_mesh_engine_stacked_step(tokens):
    want, ranks = tokens
    for r in ranks[8]:
        assert r["mxint8-staged/scan"] == want["mxint8-staged"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_mesh_engine_refusals(world, tokens):
    for r in tokens[1][world]:
        assert r["refusals"] == {"backend": "NotImplementedError",
                                 "heads": "ValueError"}


def test_dryrun_multichip_cpu():
    from lqer_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(8, tp=4, device="cpu", backend="gloo")
    assert line.startswith("dryrun_multichip(8): mesh=(dp=2, tp=4) loss=")
    assert "quantized_collectives=ok" in line
    staged = line.split("sharded_engine_mxint8staged_tokens=")[1].split(
        " fp_tokens=")
    assert [len(t) for t in json.loads(staged[0])] == [2, 2]
    assert [len(t) for t in json.loads(staged[1])] == [2]


def test_run_ranks_fails_when_a_rank_fails():
    """A rank that raises fails the call well within its timeout, whichever
    rank's failure arrives first (rank 1's error, or rank 0's lost peer),
    and the others are stopped."""
    import time

    t = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank [01] failed"):
        run_ranks(_raise_on_rank_1, 2, backend="gloo", device="cpu",
                  timeout=120)
    assert time.monotonic() - t < 60


def _raise_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 stops here")
    dist.barrier()   # rank 0 waits for a rank that never arrives
    return 0
