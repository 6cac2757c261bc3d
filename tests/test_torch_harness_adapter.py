"""The port's lm-eval adapter (``lqer_tpu_torch.evaluate.harness.
TorchCausalLM``) against the JAX package's ``JaxCausalLM``, as
``tests/test_harness_adapter.py`` drives it: one fake tokenizer and two
forwards built once in numpy (a uniform one, where each position prefers
``last_token + 1``, and a seeded causal one), each wrapped for each
framework.

Both adapters score in numpy on the same f32 logits, so every result must
be equal to JAX's, bit for bit: loglikelihoods, greedy flags, window
clipping, batched against sequential scoring, and the rolling windows,
which cover each token once. ``generate_until`` runs through the port's
``DecodeEngine`` and the JAX one on a tiny OPT carrying the same weights,
and through each package's full-forward loop: the texts are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.evaluate.harness import JaxCausalLM
from lqer_tpu.models import OPTConfig as JOPTConfig
from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import params_from_jax
from lqer_tpu_torch.evaluate import harness as tharness
from lqer_tpu_torch.evaluate.harness import TorchCausalLM
from lqer_tpu_torch.models import OPTConfig
from lqer_tpu_torch.serving import DecodeEngine
from lqer_tpu_torch.testing import one_torch_thread_fixture

from test_harness_adapter import FakeTok

_one_torch_thread = one_torch_thread_fixture()

VOCAB = 50


def _uniform_logits(ids: np.ndarray) -> np.ndarray:
    """Each position prefers ``(last_token + 1) % VOCAB``."""
    b, s = ids.shape
    logits = np.full((b, s, VOCAB), -10.0, dtype=np.float32)
    rows = np.arange(b)
    for i in range(s):
        logits[rows, i, (ids[:, i] + 1) % VOCAB] = 10.0
    return logits


_TABLE = np.random.default_rng(3).standard_normal(
    (2, VOCAB, VOCAB)).astype(np.float32) * 3


def _seeded_logits(ids: np.ndarray) -> np.ndarray:
    """A causal forward from seeded tables: position i reads tokens i and
    i - 1."""
    cur = _TABLE[0][ids]
    prev = np.concatenate([np.zeros_like(cur[:, :1]),
                           _TABLE[1][ids[:, :-1]]], axis=1)
    return cur + 0.5 * prev


LOGITS = {"uniform": _uniform_logits, "seeded": _seeded_logits}


def _pair(kind: str, **kw):
    """(JAX adapter, port adapter) over the same numpy forward."""
    fn = LOGITS[kind]
    jlm = JaxCausalLM(lambda ids: jnp.asarray(fn(np.asarray(ids))), FakeTok(),
                      **kw)

    def tfwd(ids: torch.Tensor) -> torch.Tensor:
        assert ids.device.type == "cpu" and not ids.is_floating_point()
        return torch.from_numpy(fn(ids.numpy()))

    return jlm, TorchCausalLM(tfwd, FakeTok(), device="cpu", **kw)


PAIRS = [([3, 4], [5, 6]), ([10], [11, 12, 13]), ([7, 8, 9, 10, 11], [12]),
         ([1], [9, 9]), ([2, 3, 4], [5]), ([3, 4], [9, 9])]


@pytest.mark.parametrize("kind", sorted(LOGITS))
def test_loglikelihood_tokens_match_jax(kind):
    """Greedy flags and loglikelihoods, one pair at a time; under the
    uniform forward the +1 rule is greedy and near log 1, a wrong
    continuation is not."""
    jlm, tlm = _pair(kind, max_length=64)
    got = [tlm._loglikelihood_tokens(c, n) for c, n in PAIRS]
    assert got == [jlm._loglikelihood_tokens(c, n) for c, n in PAIRS]
    assert all(ll <= 0.0 for ll, _ in got)
    if kind == "uniform":
        (ll, greedy), (ll2, greedy2) = got[0], got[-1]
        assert greedy and ll > -0.1
        assert not greedy2 and ll2 < ll - 10


@pytest.mark.parametrize("kind", sorted(LOGITS))
def test_window_clipping_matches_jax(kind):
    """A context longer than ``max_length`` keeps its last tokens."""
    jlm, tlm = _pair(kind, max_length=8)
    ctx, cont = list(range(1, 20)), [20 % VOCAB]
    assert tlm._loglikelihood_tokens(ctx, cont) == \
        jlm._loglikelihood_tokens(ctx, cont)
    if kind == "uniform":
        assert tlm._loglikelihood_tokens(ctx, cont)[1]


@pytest.mark.parametrize("kind", sorted(LOGITS))
@pytest.mark.parametrize("batch_size", [1, 4])
def test_batched_matches_sequential_and_jax(kind, batch_size):
    """Longest-first padded batches give what one-at-a-time scoring gives
    (right padding is causal-safe), and what JAX's batches give."""
    jlm, tlm = _pair(kind, max_length=64, batch_size=batch_size)
    got = tlm._loglikelihood_tokens_batched(PAIRS)
    assert got == jlm._loglikelihood_tokens_batched(PAIRS)
    _, one = _pair(kind, max_length=64, batch_size=1)
    for (ll, g), (ll1, g1) in zip(got, one._loglikelihood_tokens_batched(
            PAIRS)):
        assert g == g1
        np.testing.assert_allclose(ll, ll1, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_length", [8, 9, 64])
def test_rolling_windows_match_jax(max_length):
    """Disjoint, complete, in order; each window within ``max_length`` and
    with maximal context; the same windows as JAX's."""
    jlm, tlm = _pair("uniform", max_length=max_length)
    ids = list(range(1, 30))
    windows = tlm._rolling_windows(ids)
    assert windows == jlm._rolling_windows(ids)
    assert [t for _, cont in windows for t in cont] == ids
    for ctx, cont in windows:
        assert len(ctx) >= 1 and len(ctx) + len(cont) <= max_length
    assert all(len(ctx) + len(cont) == max_length
               for ctx, cont in windows[1:-1])


class _Req:
    def __init__(self, *args):
        self.args = args


@pytest.mark.parametrize("kind", sorted(LOGITS))
def test_rolling_and_context_requests_match_jax(kind):
    """``loglikelihood_rolling`` over a text longer than ``max_length`` is
    scored whole (a longer text scores lower under the uniform forward);
    ``loglikelihood`` with an empty context scores from the prefix token,
    and splits a joint encoding; each equal to JAX's."""
    jlm, tlm = _pair(kind, max_length=8, batch_size=2)
    texts = [_Req("a" * 40), _Req("a" * 10), _Req("abcdefghij" * 3)]
    got = tlm.loglikelihood_rolling(texts)
    assert got == jlm.loglikelihood_rolling(texts)
    if kind == "uniform":
        assert got[0] < got[1] < 0.0
    reqs = [_Req("", "abc"), _Req("ab", "cd"), _Req("x" * 12, " y")]
    assert tlm.loglikelihood(reqs) == jlm.loglikelihood(reqs)


class _NoEosTok(FakeTok):
    eos_token_id = None


def _tiny_opt():
    jcfg = JOPTConfig.tiny(vocab_size=64, hidden=32, layers=1, heads=2,
                           ffn=48)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = OPTConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers",
        "num_attention_heads", "max_position_embeddings",
        "do_layer_norm_before", "word_embed_proj_dim")})
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()})
    return jcfg, params, cfg, tparams


def test_generate_until_matches_jax():
    """A tiny OPT (the JAX test's), its weights carried across: the port's
    text through a lazily built one-slot engine on the f32 cache, and
    through its full-forward loop, equals the JAX adapter's through the
    JAX engine."""
    jcfg, params, cfg, tparams = _tiny_opt()
    reqs = [_Req("ab", {"until": [], "max_gen_toks": 6}),
            _Req("hello", {"until": ["q"], "max_gen_toks": 5})]
    jengine = JDecodeEngine(params, jcfg, None, num_slots=1, max_len=64,
                            cache_dtype=jnp.float32)
    jfwd = lambda ids: jmodels.forward(params, ids, jcfg, None)  # noqa: E731
    want = JaxCausalLM(jfwd, _NoEosTok(), max_length=64,
                       engine=jengine).generate_until(reqs)

    built = []

    def factory():
        built.append(1)
        return DecodeEngine(tparams, cfg, None, num_slots=1, max_len=64,
                            cache_dtype=torch.float32, device="cpu")

    tfwd = lambda ids: tmodels.forward(tparams, ids, cfg, None)  # noqa: E731
    lm = TorchCausalLM(tfwd, _NoEosTok(), max_length=64, engine=factory,
                       device="cpu")
    assert not built                   # built on the first generation only
    assert lm.generate_until(reqs) == want
    assert built == [1]
    loop = TorchCausalLM(tfwd, _NoEosTok(), max_length=64, device="cpu")
    assert loop.generate_until(reqs) == want
    assert all(isinstance(t, str) for t in want) and len(want[0]) == 6


def test_lm_eval_switch_matches_jax():
    """Without lm_eval both packages fall back to their bundled minieval
    protocol; the port's adapter is minieval's ``LM``; it takes the card
    unless asked for the CPU."""
    from lqer_tpu.evaluate import harness as jharness
    from lqer_tpu_torch.evaluate.minieval import LM

    assert tharness.HAS_LM_EVAL == jharness.HAS_LM_EVAL
    if not tharness.HAS_LM_EVAL:
        assert issubclass(TorchCausalLM, LM)
    if not torch.cuda.is_available():   # the card by default
        with pytest.raises(RuntimeError, match="is_available"):
            TorchCausalLM(lambda ids: ids, FakeTok())
