"""Datasets (port of ``lqer_tpu/data``): GPTQ-style concatenated
language-model chunks for calibration and perplexity, as int32 numpy
arrays ``{split: (n, max_length)}``.

wikitext2 and SlimPajama-6B join the raw split with ``"\\n\\n"``,
tokenize, concatenate and chop into ``max_length`` chunks; they need a
local HF datasets cache and raise without one. ``synthetic`` draws tokens
from numpy's ``default_rng(seed)`` exactly as the JAX package does, so
both packages read the same data.
"""

from __future__ import annotations

import numpy as np

from ..utils.logging import get_logger

logger = get_logger("data")

_HF_DATASET_IDS = {
    "wikitext2": ("wikitext", "wikitext-2-raw-v1"),
    "slim_pajama_6b": ("DKYoon/SlimPajama-6B", None),
}
_TEXT_JOINERS = {"wikitext2": "\n\n", "slim_pajama_6b": "\n\n"}


def _chunk_concatenated(texts, tokenizer, max_length: int,
                        joiner: str = "\n\n", batch_size: int = 1000
                        ) -> np.ndarray:
    """One token stream chopped into (n, max_length). As the reference's
    ``datasets.map(batched=True)`` does, texts are joined with ``joiner``
    within each batch of 1000 rows and consecutive batches concatenate
    with no joiner between them."""
    texts = list(texts)
    ids_parts = [
        np.asarray(tokenizer(joiner.join(texts[i:i + batch_size]),
                             return_tensors="np").input_ids[0])
        for i in range(0, len(texts), batch_size)]
    ids = np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.int64)
    n = len(ids) // max_length
    return ids[:n * max_length].reshape(n, max_length).astype(np.int32)


def _load_hf_split(name: str, split: str, num_raw_samples=None):
    import datasets as hf_datasets

    path, config = _HF_DATASET_IDS[name]
    ds = hf_datasets.load_dataset(path, config, split=split)
    if num_raw_samples is not None:
        ds = ds.select(range(min(num_raw_samples, len(ds))))
    return ds["text"]


def synthetic_data_module(vocab_size: int = 512, max_length: int = 128,
                          num_train: int = 16, num_test: int = 16,
                          seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic offline token chunks: train, validation and test
    drawn in that order from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def make(n):
        return rng.integers(0, vocab_size, size=(n, max_length),
                            dtype=np.int32)

    return {"train": make(num_train), "validation": make(num_test),
            "test": make(num_test)}


def get_data_module(name: str, tokenizer=None, max_length: int = 2048,
                    num_raw_samples: int | None = None,
                    **synthetic_kwargs) -> dict[str, np.ndarray]:
    """Name → ``{split: int32 array (n, max_length)}``;
    ``num_raw_samples`` takes the first raw rows only, before
    tokenizing."""
    if name == "synthetic":
        return synthetic_data_module(max_length=max_length,
                                     **synthetic_kwargs)
    if name not in _HF_DATASET_IDS:
        raise ValueError(f"Unknown dataset {name!r}")
    if tokenizer is None:
        raise ValueError(f"dataset {name} requires a tokenizer")
    out = {}
    for split in ("train", "validation", "test"):
        try:
            texts = _load_hf_split(name, split, num_raw_samples)
        except Exception as e:   # no network and no local cache
            raise RuntimeError(
                f"Could not load HF dataset {name}:{split} "
                f"(offline without a cache?): {e}") from e
        out[split] = _chunk_concatenated(texts, tokenizer, max_length,
                                         _TEXT_JOINERS[name])
    return out


def batches(split: np.ndarray, batch_size: int):
    """(b, L) batches in order; a trailing partial batch keeps its true
    size."""
    for i in range(0, len(split), batch_size):
        yield split[i:i + batch_size]
