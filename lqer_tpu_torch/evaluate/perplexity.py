"""Perplexity over fixed-length chunks (port of
``lqer_tpu/evaluate/perplexity.py``): ``ppl = exp(Σ_i loss_i · bs_i ·
seq_len / (seq_len · Σ_i bs_i))`` with ``loss_i`` the causal-LM loss of
batch i (shifted cross-entropy, the mean over ``bs · (seq_len − 1)``
positions). Each batch counts with its true size: the reference weighted
a trailing partial batch by the nominal batch size."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..data import batches
from ..device import resolve_device
from ..utils import tracing
from ..utils.logging import get_logger

logger = get_logger("evaluate")


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Cross-entropy of ``logits[:, :-1]`` against ``labels[:, 1:]`` in
    f32, the mean over every shifted position."""
    logp = torch.log_softmax(logits[:, :-1, :].to(torch.float32), dim=-1)
    targets = labels[:, 1:].to(torch.int64)
    return -torch.gather(logp, -1, targets[..., None])[..., 0].mean()


def evaluate_perplexity(forward_fn: Callable, split: np.ndarray,
                        batch_size: int = 1, num_samples: int | None = None,
                        progress: bool = False,
                        description: str = "Evaluating perplexity",
                        device="cuda") -> dict:
    """``forward_fn(input_ids) -> logits`` over the rows of ``split``
    (the first ``num_samples``), ``batch_size`` at a time, each batch
    moved to ``device`` (``"cuda"`` by default; without a card it
    raises)."""
    device = resolve_device(device)
    if num_samples is not None:
        if num_samples < batch_size:
            raise ValueError(f"num_samples {num_samples} must be >= "
                             f"batch_size {batch_size}")
        if num_samples > len(split):
            raise ValueError(f"num_samples {num_samples} must be <= dataset "
                             f"size {len(split)}")
        split = split[:num_samples]
    seq_len = split.shape[1]
    total_loss = 0.0
    evaluated = 0
    num_batches = -(-len(split) // batch_size)
    for bi, batch in enumerate(batches(split, batch_size)):
        with tracing.EVAL_BATCH:
            ids = torch.as_tensor(batch).to(device)
            logits = forward_fn(ids)
            with tracing.LOSS:
                loss = float(causal_lm_loss(logits, ids))
            del logits
        bs = batch.shape[0]
        total_loss += loss * bs * seq_len
        evaluated += bs
        if progress:
            logger.info("%s: batch %d/%d loss=%.4f", description, bi + 1,
                        num_batches, loss)
    reduced_loss = total_loss / (seq_len * evaluated)
    try:
        ppl = math.exp(reduced_loss)
    except OverflowError:
        ppl = float("inf")
    return {"loss": reduced_loss, "perplexity": ppl,
            "num_samples": evaluated, "seq_len": seq_len,
            "batch_size": batch_size}
