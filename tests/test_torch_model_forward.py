"""The port's full-sequence forwards (``models/llama.py::forward``,
``forward_scan``, ``models/opt.py::forward``, ``models.forward``) against
the JAX package's on the same weights, carried across through numpy, on
tiny models (2 layers, hidden 128, vocab 256, 32 tokens):

- ``llama``: multi-head attention (2 heads of d = 64);
- ``llama_gqa``: 4 heads over 2 kv heads;
- ``mistral``: GQA with a sliding window of 16 inside the 32 tokens;
- ``opt``: pre-LN, biases on every linear;
- ``opt350m``: post-LN with ``project_in``/``project_out``;

each four ways: ``fp`` (no quantization), ``emulated`` (W4A8 L²QER through
``qlinear`` on ``prepare_ptq``'s weights, rank 16), ``fused`` (the
Llama family's attention through the prefill kernel: JAX's Pallas kernel
in interpret mode against the port's plain version) and ``backend`` (every
linear the backend packs through the kernels: JAX's in interpret mode, the
port's plain versions; k and v at 64 output features stay emulated, as in
JAX). The taps (each linear's input, the profiler's hook) arrive under the
same names in the same order.

Limits (``ROADMAP.md`` "North star"): unquantized, the logits and the taps
within rtol = atol = 2e-4 (only the f32 summation order differs); where
f32 sums are quantized again to 8 bits, a rounding may flip one code step,
which then moves everything downstream, so quantized runs are held to
``LOGIT_MAX_STEPS`` and ``LOGIT_RMS_STEPS`` 8-bit code steps of each row's
scale (``testing.logits_steps``), the limits of the serving tests. The
PTQ weights are bit-exact.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import llama as jllama
from lqer_tpu.models import opt as jopt
from lqer_tpu.serving import pallas_backend as jbackend
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import params_from_jax
from lqer_tpu_torch.models import llama as tllama
from lqer_tpu_torch.models.common import fused_quantized_attention
from lqer_tpu_torch.models.config_expand import _default_layer_template
from lqer_tpu_torch.serving.kernel_backend import prepare_serving_params
from lqer_tpu_torch.serving.random_model import q_config_for
from lqer_tpu_torch.testing import (
    ATOL,
    RTOL,
    logits_steps,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()

RANK = 16
SEQ = 32
LOGIT_MAX_STEPS = 4.0
LOGIT_RMS_STEPS = 0.4

LLAMA = dict(vocab_size=256, hidden=128, layers=2, inter=256, max_pos=64)
OPT = dict(vocab_size=256, hidden=128, layers=2, heads=2, ffn=256,
           max_pos=64)
CONFIGS = {
    "llama": ("llama", dict(LLAMA, heads=2)),
    "llama_gqa": ("llama", dict(LLAMA, heads=4, kv_heads=2)),
    "mistral": ("llama", dict(LLAMA, heads=2, kv_heads=1, sliding_window=16,
                              arch="mistral")),
    "opt": ("opt", OPT),
    "opt350m": ("opt", dict(OPT, do_layer_norm_before=False,
                            word_embed_proj_dim=64)),
}
MODES = ("fp", "emulated", "fused", "backend")


CASES = [(n, m) for n in sorted(CONFIGS) for m in MODES
         if not (m == "fused" and CONFIGS[n][0] == "opt")]


def _configs(name):
    kind, kw = CONFIGS[name]
    if kind == "opt":
        kw = dict(kw)
        extra = {k: kw.pop(k) for k in ("do_layer_norm_before",
                                        "word_embed_proj_dim") if k in kw}
        return (dataclasses.replace(jmodels.OPTConfig.tiny(**kw), **extra),
                tmodels.OPTConfig.tiny(**kw, **extra))
    return (jmodels.LlamaConfig.tiny(**kw), tmodels.LlamaConfig.tiny(**kw))


@functools.cache
def model(name):
    """(jcfg, tcfg, jax params, port params, (jax, port) layer configs):
    JAX's random init, random biases on OPT's linears, bf16-exact rank-16
    factors (the approximator's 8-bit A and B are exact in bf16, as the
    kernels require) on every linear; the port's params the same values."""
    jcfg, tcfg = _configs(name)
    params = dict(jmodels.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    for i in range(jcfg.num_hidden_layers):
        for prefix, _ in jmodels.quantizable_module_prefixes(jcfg, i):
            o, ic = params[prefix + ".weight"].shape
            if jcfg.arch == "opt":
                params[prefix + ".bias"] = jnp.asarray(
                    rng.standard_normal(o).astype(np.float32) * 0.02)
            for suffix, shape in (("A", (ic, RANK)), ("B", (RANK, o))):
                v = (rng.standard_normal(shape) * 0.05).astype(jnp.bfloat16)
                params[f"{prefix}.{suffix}"] = jnp.asarray(
                    v.astype(np.float32))
    q = q_config_for(tcfg)
    lc = {"linear": {"rank": RANK}}
    return (jcfg, tcfg, params,
            params_from_jax({k: np.asarray(v) for k, v in params.items()}),
            (jmodels.quantize_model(jcfg, q, lc),
             tmodels.quantize_model(tcfg, q, lc)))


def _ids(cfg, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, SEQ)).astype(np.int32)


@functools.cache
def jax_run(name, mode):
    """The JAX forward (jitted, as the JAX runners run it) of ``mode``:
    (logits, {tap name: input}, tap order) as numpy."""
    jcfg, _, params, _, (jq, _) = model(name)
    arch = jmodels.get_arch_module(jcfg)
    kw, qcfgs, p = {}, None, params
    if mode != "fp":
        qcfgs = jq
        if mode == "backend":
            kw["backend"] = jbackend.prepare_serving_params(params, jcfg, jq)
        p = jmodels.prepare_ptq(params, jcfg, jq)
        if mode == "fused":
            kw["fused_attention"] = True
    order = []

    @jax.jit
    def run(p, ids):
        stats = {}

        def tap(n, x):
            order.append(n)
            stats[n] = x
        return arch.forward(p, ids, jcfg, qcfgs, tap=tap, **kw), stats

    logits, stats = run(p, jnp.asarray(_ids(jcfg)))
    return (np.asarray(logits), {k: np.asarray(v) for k, v in stats.items()},
            order)


def port_run(name, mode):
    _, tcfg, _, tparams, (_, tq) = model(name)
    arch = tmodels.get_arch_module(tcfg)
    kw, qcfgs, p = {}, None, tparams
    if mode != "fp":
        qcfgs = tq
        if mode == "backend":
            kw["backend"] = prepare_serving_params(tparams, tcfg, tq)
            assert kw["backend"]["meta"], "nothing packed"
        p = tmodels.prepare_ptq(tparams, tcfg, tq)
        if mode == "fused":
            kw["fused_attention"] = True
    stats, order = {}, []

    def tap(n, x):
        order.append(n)
        stats[n] = x
    with torch.inference_mode():
        logits = arch.forward(p, torch.as_tensor(_ids(tcfg)), tcfg, qcfgs,
                              tap=tap, **kw)
    return logits, stats, order


def _hold(what, got, want, quantized):
    want = torch.as_tensor(np.array(want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.isfinite(got).all(), what
    if not quantized:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=what)
        return
    worst, rms = logits_steps(got, want)
    assert worst <= LOGIT_MAX_STEPS and rms <= LOGIT_RMS_STEPS, (
        what, worst, rms)


@pytest.mark.parametrize("name,mode", CASES)
def test_forward_matches_jax(name, mode):
    """OPT's forward has no fused attention, in JAX as here."""
    jlogits, jstats, jorder = jax_run(name, mode)
    logits, stats, order = port_run(name, mode)
    assert order == jorder
    _hold(f"{name}/{mode} logits", logits, jlogits, mode != "fp")
    for k in jorder:
        _hold(f"{name}/{mode} tap {k}", stats[k], jstats[k], mode != "fp")


@pytest.mark.parametrize("name", ["llama", "mistral"])
def test_fused_attention_eligibility(name, monkeypatch):
    """The prefill kernel runs only under a causal mask and quantized
    attention configs: past Mistral's window, or unquantized, the forward
    attends eagerly."""
    _, tcfg, _, tparams, (_, tq) = model(name)
    p = tmodels.prepare_ptq(tparams, tcfg, tq)
    ids = torch.as_tensor(_ids(tcfg))
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return fused_quantized_attention(*a, **kw)

    monkeypatch.setattr(tllama, "fused_quantized_attention", counted)
    with torch.inference_mode():
        tllama.forward(tparams, ids, tcfg, None, fused_attention=True)
        assert not calls
        tllama.forward(p, ids, tcfg, tq, fused_attention=True)
    assert len(calls) == (0 if name == "mistral"
                          else tcfg.num_hidden_layers)


def test_ptq_weights_bit_exact():
    jcfg, tcfg, params, tparams, (jq, tq) = model("llama_gqa")
    jp = jmodels.prepare_ptq(params, jcfg, jq)
    tp = tmodels.prepare_ptq(tparams, tcfg, tq)
    for k, v in jp.items():
        assert torch.equal(tp[k], torch.as_tensor(np.array(v))), k


@pytest.mark.parametrize("mode", ["fp", "emulated", "segments"])
@pytest.mark.parametrize("name", ["llama_gqa", "mistral"])
def test_forward_scan_equals_forward(name, mode):
    """``forward_scan`` (one config for every layer, or a per-layer list
    whose layers differ) gives ``forward``'s logits bit for bit, and JAX's
    ``forward_scan`` within the limits."""
    jcfg, tcfg, params, tparams, (jq, tq) = model(name)
    ids = _ids(tcfg)
    if mode == "fp":
        jp, tp, jl, tl, tfull = params, tparams, None, None, None
    else:
        jp = jmodels.prepare_ptq(params, jcfg, jq)
        tp = tmodels.prepare_ptq(tparams, tcfg, tq)
        jl, tl, tfull = jq[0], tq[0], tq
        if mode == "segments":
            q = q_config_for(tcfg)
            layer1 = copy.deepcopy(_default_layer_template(q, tcfg.arch))
            o = layer1["self_attn"]["o_proj"]
            o["x_quantizer"] = {**o["x_quantizer"], "width": 6}
            q1 = {**q, "model_layer_1": layer1}
            lc = {"linear": {"rank": RANK}}
            jl = jmodels.quantize_model(jcfg, q1, lc)
            tl = tfull = tmodels.quantize_model(tcfg, q1, lc)
            assert tl[0]["attn"].o_proj != tl[1]["attn"].o_proj
    with torch.inference_mode():
        scan = tllama.forward_scan(tp, torch.as_tensor(ids), tcfg, tl)
        full = tllama.forward(tp, torch.as_tensor(ids), tcfg, tfull)
    assert torch.equal(scan, full)
    want = jax.jit(lambda p, i: jllama.forward_scan(p, i, jcfg, jl))(
        jp, jnp.asarray(ids))
    _hold(f"{name}/{mode} forward_scan", scan, np.asarray(want),
          mode != "fp")


def test_models_forward_dispatch():
    """``models.forward`` runs each architecture's forward."""
    for name in ("opt", "llama"):
        _, tcfg, _, tparams, _ = model(name)
        ids = torch.as_tensor(_ids(tcfg))
        with torch.inference_mode():
            got = tmodels.forward(tparams, ids, tcfg)
            want = tmodels.get_arch_module(tcfg).forward(tparams, ids, tcfg)
        assert torch.equal(got, want)


def test_opt_decoder_layer_matches_jax():
    """One post-LN OPT layer alone, through the emulated linears."""
    jcfg, tcfg, params, tparams, (jq, tq) = model("opt350m")
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, SEQ, tcfg.hidden_size)).astype(np.float32)
    jp = jmodels.prepare_ptq(params, jcfg, jq)
    tp = tmodels.prepare_ptq(tparams, tcfg, tq)
    from lqer_tpu.models.common import causal_mask as jmask
    from lqer_tpu_torch.models import opt as topt
    from lqer_tpu_torch.models.common import causal_mask

    want = jax.jit(lambda p, x: jopt.decoder_layer(
        x, p, jcfg, 1, jq[1], jmask(SEQ)))(jp, jnp.asarray(h))
    with torch.inference_mode():
        got = topt.decoder_layer(torch.as_tensor(h), tp, tcfg, 1, tq[1],
                                 causal_mask(SEQ))
    _hold("opt350m layer 1", got, np.asarray(want), True)


@pytest.mark.parametrize("offset", [0, 5])
def test_masks_match_jax(offset):
    from lqer_tpu.models.common import causal_mask as jmask
    from lqer_tpu_torch.models.common import causal_mask

    assert np.array_equal(causal_mask(7, offset=offset).numpy(),
                          np.asarray(jmask(7, offset=offset)))
    assert np.array_equal(
        tllama._sliding_window_mask(9, 4, torch.float32).numpy(),
        np.asarray(jllama._sliding_window_mask(9, 4, jnp.float32)))
