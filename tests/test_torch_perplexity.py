"""The port's data modules (``data/__init__.py``) and perplexity
(``evaluate/perplexity.py``) against the JAX package's.

- ``synthetic_data_module`` draws from numpy's ``default_rng`` as JAX's
  does: the same arrays, bit for bit; ``batches`` keeps a trailing partial
  batch at its true size; the HF datasets raise without a local cache, as
  in JAX.
- ``causal_lm_loss`` and ``evaluate_perplexity`` read the same logits
  (a fixed table per batch, so no model sits between them) and give the
  same loss and perplexity at rtol 1e-6: one f32 log-softmax and mean on
  each side, then the same float64 accumulation.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import data as jdata
from lqer_tpu.evaluate import perplexity as jppl
from lqer_tpu_torch import data as tdata
from lqer_tpu_torch.evaluate import perplexity as tppl
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()


@pytest.mark.parametrize("kw", [{}, dict(vocab_size=256, max_length=64,
                                         num_train=8, num_test=5, seed=3)])
def test_synthetic_data_equals_jax(kw):
    want = jdata.synthetic_data_module(**kw)
    got = tdata.synthetic_data_module(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(
        tdata.get_data_module("synthetic", max_length=32)["test"],
        jdata.get_data_module("synthetic", max_length=32)["test"])


def test_batches_keep_the_partial_batch():
    split = np.arange(7 * 4).reshape(7, 4)
    got = [b.shape[0] for b in tdata.batches(split, 3)]
    assert got == [b.shape[0] for b in jdata.batches(split, 3)] == [3, 3, 1]


class _WordTok:
    """Whitespace ids: ``"w17"`` → 17."""

    def __call__(self, text, return_tensors=None):
        ids = np.asarray([int(w[1:]) for w in text.split()], np.int64)
        return type("Enc", (), {"input_ids": ids[None]})()


def _texts(split):
    rng = np.random.default_rng(len(split))
    return [" ".join(f"w{i}" for i in rng.integers(0, 50, n))
            for n in rng.integers(3, 40, 30)]


class _FakeDS:
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def select(self, idx):
        return _FakeDS([self.rows[i] for i in idx])

    def __getitem__(self, key):
        return self.rows


def _fake_load_dataset(path, config, split=None):
    return _FakeDS(_texts(split))


def _no_cache(*a, **kw):
    raise FileNotFoundError("no local dataset cache")


@pytest.mark.parametrize("num_raw_samples", [None, 7])
def test_hf_modules_equal_jax(num_raw_samples):
    """wikitext2's chunks through a stand-in ``datasets.load_dataset`` (no
    download here): the same arrays as JAX's, the 1000-row joining
    included."""
    with mock.patch("datasets.load_dataset", side_effect=_fake_load_dataset):
        want = jdata.get_data_module("wikitext2", tokenizer=_WordTok(),
                                     max_length=16,
                                     num_raw_samples=num_raw_samples)
        got = tdata.get_data_module("wikitext2", tokenizer=_WordTok(),
                                    max_length=16,
                                    num_raw_samples=num_raw_samples)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    texts = _texts("train") * 40
    assert np.array_equal(
        tdata._chunk_concatenated(texts, _WordTok(), 16, batch_size=1000),
        jdata._chunk_concatenated(texts, _WordTok(), 16, batch_size=1000))


def test_hf_datasets_raise_without_a_cache():
    with pytest.raises(ValueError):
        tdata.get_data_module("no-such-dataset")
    with pytest.raises(ValueError):
        tdata.get_data_module("wikitext2")            # no tokenizer
    with mock.patch("datasets.load_dataset", side_effect=_no_cache):
        with pytest.raises(RuntimeError):
            tdata.get_data_module("wikitext2", tokenizer=_WordTok(),
                                  max_length=16)


def _logit_table(n, seq, vocab=97, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, seq, vocab)) * 3).astype(np.float32)


def test_causal_lm_loss_matches_jax():
    logits = _logit_table(3, 17)
    labels = np.random.default_rng(1).integers(0, 97, (3, 17)).astype(
        np.int32)
    want = float(jppl.causal_lm_loss(jnp.asarray(logits),
                                     jnp.asarray(labels)))
    got = float(tppl.causal_lm_loss(torch.as_tensor(logits),
                                    torch.as_tensor(labels)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("batch_size,num_samples", [(2, None), (3, None),
                                                    (4, 5), (1, 1)])
def test_evaluate_perplexity_matches_jax(batch_size, num_samples):
    """7 rows: batch size 3 leaves a trailing batch of 1, which counts
    with its true size; ``num_samples`` takes the first rows."""
    split = np.random.default_rng(2).integers(0, 97, (7, 13)).astype(
        np.int32)
    table = _logit_table(7, 13)
    by_row = {tuple(r): table[i] for i, r in enumerate(split)}

    def logits_for(ids):
        return np.stack([by_row[tuple(np.asarray(r))] for r in ids])

    want = jppl.evaluate_perplexity(
        lambda ids: jnp.asarray(logits_for(np.asarray(ids))), split,
        batch_size=batch_size, num_samples=num_samples)
    got = tppl.evaluate_perplexity(
        lambda ids: torch.as_tensor(logits_for(ids.numpy())), split,
        batch_size=batch_size, num_samples=num_samples, device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("num_samples", "seq_len", "batch_size"):
        assert got[k] == want[k]
    for k in ("loss", "perplexity"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    # the trailing batch counts with its true size
    losses = [float(tppl.causal_lm_loss(torch.as_tensor(logits_for(b)),
                                        torch.as_tensor(b)))
              for b in tdata.batches(split[:num_samples], batch_size)]
    sizes = [len(b) for b in tdata.batches(split[:num_samples], batch_size)]
    assert got["loss"] == pytest.approx(
        sum(l_ * n for l_, n in zip(losses, sizes)) / sum(sizes), rel=1e-9)


def test_num_samples_checked():
    split = np.zeros((4, 8), np.int32)
    for n in (1, 5):
        with pytest.raises(ValueError):
            tppl.evaluate_perplexity(lambda ids: None, split, batch_size=2,
                                     num_samples=n, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_needs_a_card():
    """``evaluate_perplexity`` runs on ``"cuda"`` unless told otherwise:
    without a card it raises before calling the forward."""
    calls = []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tppl.evaluate_perplexity(lambda ids: calls.append(ids),
                                 np.zeros((2, 8), np.int32))
    assert not calls
