"""The port's quality studies (``lqer_tpu_torch/experiments/lm_head_quality.py``
and ``kv_cache_quality.py``) against the JAX scripts' functions
(``experiments/lm_head_quality.py``, ``experiments/kv_cache_quality.py``)
on ``tiny-9M`` with JAX's own weights and tokens, carried across through
``convert.params_from_jax`` (the two packages' random inits draw other
values).

JAX's side runs in a fresh process (the ``jax_ref`` fixture): in a process
that has run other JAX work, JAX's ``model_step`` on the CPU can return
other logits for the same inputs (ROADMAP fault 18). It runs with
``jnp.exp2`` built from bits in the JAX package's quantizers and MXINT
codec (``jax_exact_exp2.exact_exp2``): XLA:CPU's exp2 misses whole powers
of two below 2^-12 by up to 34 ulps (ROADMAP §3), which moved 48 of the
W8 head's 65536 values by an ulp.

- ``head_roundtrip`` at widths 8 and 4: bit-equal to JAX's.
- ``lm_head_quality``: the fp, W8 and W4 heads' perplexities within 1e-4
  relative, ``tests/test_torch_pipeline.py``'s limit for one evaluation
  run by both packages (not ``tests/test_torch_perplexity.py``'s 1e-6,
  which holds for one table of logits: here the W4A8 forward's 8-bit
  activation quantizers round 13 of the 508 logit rows one code step
  apart, up to 0.0041, where the f32 sums' order differs, 2.8e-6 of the
  perplexity); the W8 head's largest |Δlogit| within 2e-4.
- ``kv_cache_quality``: one seed, 8 steps. On JAX's teacher tokens the port's
  teacher equals JAX's, its f32-cache trajectory is within
  rtol = atol = 2e-4, its MXINT8 and MXINT4 trajectories within phase 4's
  limits (4 code steps, 0.4 RMS, ``testing.logits_steps``), and each
  cache's mean KL within 1% relative of JAX's row and within 1e-4 of the
  port's formula on JAX's trajectories. The port sums the KL in f64: JAX's
  f32 sum reads MXINT8's KL of about 2.9e-6 0.7% off its f64 value, and
  another f32 order reads 2% off.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import params_from_jax
from lqer_tpu_torch.experiments import kv_cache_quality as tkv
from lqer_tpu_torch.experiments import lm_head_quality as tlm
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.testing import ATOL, RTOL, logits_steps
from lqer_tpu_torch.testing import one_torch_thread_fixture

from jax_exact_exp2 import exact_exp2

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from experiments import lm_head_quality as jlm  # noqa: E402

_one_torch_thread = one_torch_thread_fixture()

SIZE = "tiny-9M"
STEPS = 8
LOGIT_MAX_STEPS = 4.0
LOGIT_RMS_STEPS = 0.4
KL_RTOL = 1e-2
PPL_RTOL = 1e-4


def test_sizes_and_configs_equal_jax():
    assert tlm.Q_CONFIG == jlm.Q_CONFIG
    for name, kw in tlm.SIZES.items():
        assert tmodels.quantize_model(LlamaConfig.tiny(**kw), tlm.Q_CONFIG,
                                      tlm.L_CONFIG) is not None
    from experiments import kv_cache_quality as jkv

    for width in (8, 4):
        assert tkv._qconfig(width) == jkv._qconfig(width)


def jax_side(out: str) -> None:
    """JAX's side of every comparison, with :func:`exact_exp2`: the W8 and
    W4 round trips of a seeded head; ``lm_head_quality``'s row of
    ``tiny-9M`` (weights ``PRNGKey(0)``, tokens ``PRNGKey(1)``, as its
    ``main``); ``kv_cache_quality``'s of ``tiny-9M``, seed 0, STEPS steps,
    as its ``main`` runs one seed. Writes arrays to ``out`` (npz) and
    numbers to ``out + ".json"``."""
    from experiments import kv_cache_quality as jkv
    from lqer_tpu.serving import decode as jdec

    arrays, meta = {}, {}
    with exact_exp2("lqer_tpu.ops.quantizers", "lqer_tpu.ops.storage"):
        w = (np.random.RandomState(0).randn(512, 128) * 0.02).astype(
            np.float32)
        arrays["head"] = w
        for width in (8, 4):
            arrays[f"head_w{width}"] = np.asarray(
                jlm.head_roundtrip(jnp.asarray(w), width))

        cfg = JLlamaConfig.tiny(**tlm.SIZES[SIZE])
        raw = jmodels.init_params(cfg, jax.random.PRNGKey(0))
        jq = jmodels.quantize_model(cfg, jlm.Q_CONFIG,
                                    {"linear": {"rank": 16}})
        params = jmodels.prepare_ptq(raw, cfg, jq)
        ids = jax.random.randint(jax.random.PRNGKey(1), (4, 128), 0,
                                 cfg.vocab_size)
        head = params["lm_head.weight"]
        lm, logits = {}, {}
        for label, h in (("fp", head), ("w8", jlm.head_roundtrip(head, 8)),
                         ("w4", jlm.head_roundtrip(head, 4))):
            lm[label], logits[label] = jlm.ppl_with_head(cfg, params, jq,
                                                         ids, h)
        lm["max_dlogit_w8"] = float(np.abs(logits["w8"] - logits["fp"]).max())
        meta["lm_head"] = lm
        arrays["lm_ids"] = np.asarray(ids)
        arrays.update({"lm:" + k: np.asarray(v) for k, v in raw.items()})

        seed = 0
        raw = jmodels.init_params(cfg, jax.random.PRNGKey(seed))
        qcfgs8 = jmodels.quantize_model(cfg, jkv._qconfig(8),
                                        {"linear": {"rank": 16}})
        qcfgs4 = jmodels.quantize_model(cfg, jkv._qconfig(4),
                                        {"linear": {"rank": 16}})
        params = jmodels.prepare_ptq(raw, cfg, qcfgs8)
        prompt = jax.random.randint(jax.random.PRNGKey(100 + seed), (1, 8),
                                    0, cfg.vocab_size)
        cache = jdec.make_cache(cfg, 1, 256, jnp.float32)
        pos = jnp.zeros((1,), jnp.int32)
        lg, cache = jdec.model_step(params, prompt, cache, pos, cfg, qcfgs8)
        pos = pos + prompt.shape[1]
        toks, ref = [], []
        t = jnp.argmax(lg[0, -1]).astype(jnp.int32)
        for _ in range(STEPS):
            toks.append(t)
            lg, cache = jdec.model_step(params, t.reshape(1, 1), cache, pos,
                                        cfg, qcfgs8)
            ref.append(np.asarray(lg[0, 0], np.float32))
            t = jnp.argmax(lg[0, 0]).astype(jnp.int32)
            pos = pos + 1
        # the teacher run's logits are the f32 cache's trajectory: the
        # script's trajectory(..., jnp.float32, toks, prompt) runs these
        # same steps again
        ref = arrays["kv:float32"] = np.stack(ref)
        rows = {}
        for label, qc in (("mxint8", qcfgs8), ("mxint4", qcfgs4)):
            got = arrays["kv:" + label] = jkv.trajectory(
                cfg, params, qc, label, toks, prompt)
            pr = jax.nn.softmax(jnp.asarray(ref), axis=-1)
            lgs = jax.nn.log_softmax(jnp.asarray(got), axis=-1)
            lr = jax.nn.log_softmax(jnp.asarray(ref), axis=-1)
            rows[label] = [float(jnp.mean(jnp.sum(pr * (lr - lgs), axis=-1))),
                           float(np.abs(got - ref).max()),
                           float((got.argmax(-1) == ref.argmax(-1)).mean())]
        meta["kv_tokens"] = [int(t) for t in toks]
        meta["kv_rows"] = rows
        arrays["kv_prompt"] = np.asarray(prompt)
        arrays.update({"kvp:" + k: np.asarray(v) for k, v in raw.items()})
    np.savez(out, **arrays)
    with open(out + ".json", "w") as f:
        json.dump(meta, f)


_CHILD = """
import sys
sys.path[:0] = sys.argv[2:]
import jax
jax.config.update("jax_platforms", "cpu")
from test_torch_quality_studies import jax_side
jax_side(sys.argv[1])
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """:func:`jax_side` run in a fresh Python process (the JAX package on
    the CPU, the environment's XLA flags): ``(numbers, arrays)``."""
    here = Path(__file__).resolve().parent
    out = str(tmp_path_factory.mktemp("quality") / "jax_side.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _CHILD, out, str(here),
                    str(here.parent)], env=env, check=True, timeout=900)
    with open(out + ".json") as f:
        meta = json.load(f)
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays


def _params(arrays: dict, prefix: str) -> dict:
    return params_from_jax({k.removeprefix(prefix): v
                            for k, v in arrays.items()
                            if k.startswith(prefix)})


@pytest.mark.parametrize("width", [8, 4])
def test_head_roundtrip_bit_equal(width, jax_ref):
    _, arrays = jax_ref
    w = arrays["head"]
    got = tlm.head_roundtrip(torch.from_numpy(w), width)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), arrays[f"head_w{width}"])
    assert not np.array_equal(got.numpy(), w)


def test_lm_head_rows_match_jax(jax_ref):
    meta, arrays = jax_ref
    want = meta["lm_head"]
    cfg = LlamaConfig.tiny(**tlm.SIZES[SIZE])
    qcfgs = tmodels.quantize_model(cfg, tlm.Q_CONFIG, tlm.L_CONFIG)
    params = tmodels.prepare_ptq(_params(arrays, "lm:"), cfg, qcfgs)
    got = tlm.head_rows(cfg, params, qcfgs,
                        torch.from_numpy(arrays["lm_ids"]))
    for label in ("fp", "w8", "w4"):
        assert got[label] == pytest.approx(want[label], rel=PPL_RTOL), label
    assert got["w8"] != got["fp"] and got["w4"] != got["w8"]
    assert got["max_dlogit_w8"] == pytest.approx(
        want["max_dlogit_w8"], rel=RTOL, abs=ATOL)


def test_kv_cache_rows_match_jax(jax_ref):
    meta, arrays = jax_ref
    cfg = LlamaConfig.tiny(**tlm.SIZES[SIZE])
    params = tmodels.prepare_ptq(_params(arrays, "kvp:"), cfg,
                                 tkv.qcfgs_for(cfg, 8))
    prompt = torch.from_numpy(arrays["kv_prompt"])
    tokens = meta["kv_tokens"]
    assert tkv.teacher_tokens(cfg, params, tkv.qcfgs_for(cfg, 8), prompt,
                              STEPS, "cpu") == tokens
    got = tkv.trajectories(cfg, params, prompt, tokens, "cpu")
    np.testing.assert_allclose(got["float32"], arrays["kv:float32"],
                               rtol=RTOL, atol=ATOL)
    for label, _ in tkv.CACHES:
        worst, rms = logits_steps(torch.from_numpy(got[label]),
                                  torch.from_numpy(arrays["kv:" + label]))
        assert worst <= LOGIT_MAX_STEPS and rms <= LOGIT_RMS_STEPS, \
            (label, worst, rms)
        kl, dmax, agree = tkv.row_stats(got["float32"], got[label])
        want_kl, _, want_agree = meta["kv_rows"][label]
        assert kl == pytest.approx(want_kl, rel=KL_RTOL), label
        on_jax = tkv.row_stats(arrays["kv:float32"], arrays["kv:" + label])
        assert kl == pytest.approx(on_jax[0], rel=1e-4), label
        assert kl > 0 and agree == want_agree
    assert not np.array_equal(got["mxint4"], got["mxint8"])


def test_seed_rows_on_the_port():
    """``seed_rows`` (the port's own seeded model, as ``main`` runs it):
    its teacher is the f32 trajectory's greedy sequence, so the f32 cache
    agrees with itself everywhere, and the MXINT4 cache moves the logits
    further than MXINT8."""
    cfg = LlamaConfig.tiny(**tlm.SIZES[SIZE])
    r = tkv.seed_rows(cfg, 0, 6, "cpu")
    traj = r["trajectories"]
    assert list(traj["float32"].argmax(-1)[:-1]) == r["tokens"][1:]
    assert r["mxint4"][1] > r["mxint8"][1] > 0


def test_card_takes_the_studies_head_dim():
    """``tiny-9M`` (d = 32, outside the card's kernel head dims) on a card
    cache: the study's steps, which admit nothing (its prompt is a prefill
    of ``model_step`` without ``fresh_prefill``) and have no backend, reach
    no kernel and pass ``check_servable``; an engine, which admits, is
    refused before any work."""
    from lqer_tpu_torch.serving import decode as tdecode

    class OnCard:
        def __init__(self, t):
            self.t, self.device = t, torch.device("cuda", 0)

        def __getattr__(self, name):
            return getattr(self.t, name)

    cfg = LlamaConfig.tiny(**tlm.SIZES[SIZE])
    assert cfg.head_dim == 32
    for cache_dtype, width in (("float32", 8), ("mxint8", 8), ("mxint4", 4)):
        attn = [q["attn"] for q in tkv.qcfgs_for(cfg, width)]
        cache = tdecode.make_cache(cfg, 1, tkv.MAX_LEN, cache_dtype,
                                   device="meta")
        card = {k: OnCard(v) for k, v in cache.items()}
        tdecode.check_servable(card, attn, cfg.head_dim, backend=False,
                               scan=False, admission=False)
        with pytest.raises(NotImplementedError, match="head_dim 32"):
            tdecode.check_servable(card, attn, cfg.head_dim, backend=False,
                                   scan=False)
