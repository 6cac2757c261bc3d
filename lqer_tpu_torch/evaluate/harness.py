"""lm-evaluation-harness adapter for downstream 0-shot tasks (port of
``lqer_tpu/evaluate/harness.py``).

:class:`TorchCausalLM` adapts the port's model to the upstream
``lm_eval.api.model.LM`` interface: its loglikelihoods come from the
model's forward, ``forward_fn(ids) -> logits`` on an int tensor on the
model's device. The scoring is numpy, as in the JAX package (the logits
come back to the host as f32), so equal logits give equal results. Without
lm_eval installed, the bundled :mod:`.minieval` runs the same protocol on
its ``tiny_*`` tasks.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import resolve_device

try:
    import lm_eval
    from lm_eval.api.model import LM

    HAS_LM_EVAL = True
except ImportError:  # no lm_eval: the bundled protocol-parity harness
    HAS_LM_EVAL = False
    from .minieval import LM  # the same Instance/LM protocol


class TorchCausalLM(LM):
    """Wrap ``forward_fn(input_ids) -> logits`` and a tokenizer as an
    lm-eval model; ``device`` is where ``forward_fn`` takes its ids (the
    card by default)."""

    def __init__(self, forward_fn: Callable, tokenizer, max_length: int = 2048,
                 batch_size: int = 1, engine=None, device="cuda"):
        """``engine``: optional ``lqer_tpu_torch.serving.DecodeEngine``;
        when given, ``generate_until`` decodes through its KV cache instead
        of re-running the full forward per token. It may be a zero-argument
        factory, built on the first generation request (so
        loglikelihood-only task suites never allocate the cache)."""
        super().__init__()
        self.forward_fn = forward_fn
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._engine = engine

    @property
    def engine(self):
        if self._engine is not None and not hasattr(self._engine, "run"):
            self._engine = self._engine()  # lazy factory
        return self._engine

    def _logits(self, arr: np.ndarray) -> np.ndarray:
        """The forward's f32 logits of the int32 ids ``arr`` (b, s)."""
        with torch.inference_mode():
            ids = torch.from_numpy(arr).to(self.device)
            return self.forward_fn(ids).to(torch.float32).cpu().numpy()

    # -- helpers -----------------------------------------------------------
    def _score_one(self, logits: np.ndarray, n_ctx: int,
                   continuation: list[int]):
        """Score a continuation from (s, vocab) logits where the sequence is
        context+continuation and ``n_ctx`` is the context length."""
        logprobs = logits - _logsumexp(logits)
        ll = 0.0
        greedy = True
        for i, tok in enumerate(continuation):
            pos = n_ctx - 1 + i
            ll += float(logprobs[pos, tok])
            if int(np.argmax(logits[pos])) != tok:
                greedy = False
        return ll, greedy

    def _loglikelihood_tokens(self, context: list[int],
                              continuation: list[int]):
        return self._loglikelihood_tokens_batched([(context, continuation)])[0]

    def _loglikelihood_tokens_batched(self, pairs):
        """Score (context, continuation) token pairs in padded batches of
        ``self.batch_size``. Right padding is safe under the causal mask
        (positions before the pad are unaffected), so requests of different
        lengths share one forward."""
        prepped = []  # (ids, n_ctx, continuation)
        for context, continuation in pairs:
            ids = (list(context) + list(continuation))[-self.max_length:]
            prepped.append((ids, len(ids) - len(continuation), continuation))
        results: list = [None] * len(prepped)
        # longest first, so each batch's padding is small
        order = sorted(range(len(prepped)), key=lambda i: -len(prepped[i][0]))
        pad_id = 0
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            width = max(len(prepped[i][0]) for i in chunk)
            arr = np.full((len(chunk), width), pad_id, dtype=np.int32)
            for row, i in enumerate(chunk):
                ids = prepped[i][0]
                arr[row, :len(ids)] = ids
            logits = self._logits(arr)
            for row, i in enumerate(chunk):
                ids, n_ctx, cont = prepped[i]
                results[i] = self._score_one(logits[row, :len(ids)], n_ctx,
                                             cont)
        return results

    def _prefix_token(self) -> int:
        bos = getattr(self.tokenizer, "bos_token_id", None)
        if bos is None:
            bos = getattr(self.tokenizer, "eos_token_id", None)
        return int(bos or 0)

    def _rolling_windows(self, ids: list[int]):
        """Split a long token list into (context, continuation) windows that
        score every token exactly once, each with maximal preceding context
        within ``max_length`` (stride ``max_length // 2``, like HF's
        strided-perplexity recipe)."""
        prefix = [self._prefix_token()]
        full = prefix + list(ids)
        stride = max(self.max_length // 2, 1)
        windows = []
        start = 1  # first scored token is full[1] (= ids[0])
        while start < len(full):
            cont = full[start:start + stride]
            ctx_lo = max(0, start - (self.max_length - len(cont)))
            windows.append((full[ctx_lo:start], cont))
            start += len(cont)
        return windows

    # -- LM interface ------------------------------------------------------
    def loglikelihood(self, requests):
        pairs = []
        for req in requests:
            context, continuation = req.args
            if context == "":
                ctx_ids = [self._prefix_token()]
            else:
                ctx_ids = self.tokenizer.encode(context)
            cont_ids = self.tokenizer.encode(continuation)
            # tokenizers may split the boundary otherwise: split the joint
            # encoding
            joint = self.tokenizer.encode(context + continuation)
            if joint[: len(ctx_ids)] == ctx_ids:
                cont_ids = joint[len(ctx_ids):]
            pairs.append((ctx_ids, cont_ids))
        return self._loglikelihood_tokens_batched(pairs)

    def loglikelihood_rolling(self, requests):
        """Full-text loglikelihood, strided over ``max_length`` windows so
        long texts are scored completely instead of truncated."""
        out = []
        for req in requests:
            (text,) = req.args
            ids = self.tokenizer.encode(text)
            windows = self._rolling_windows(ids)
            scores = self._loglikelihood_tokens_batched(windows)
            out.append(sum(ll for ll, _ in scores))
        return out

    def generate_until(self, requests):
        out = []
        for req in requests:
            context, gen_kwargs = req.args
            until = gen_kwargs.get("until", [])
            max_gen = gen_kwargs.get("max_gen_toks", 128)
            ids = self.tokenizer.encode(context)
            if self.engine is not None:
                from ..serving import Request as _Req

                r = _Req(prompt_ids=list(ids), max_new_tokens=max_gen,
                         eos_token_id=self.tokenizer.eos_token_id)
                self.engine.run([r])
                text = self.tokenizer.decode(list(r.output_ids))
                for u in until:
                    if u in text:
                        text = text.split(u)[0]
                out.append(text)
                continue
            generated = []
            text = ""
            for _ in range(max_gen):
                window = (ids + generated)[-self.max_length:]
                logits = self._logits(np.array([window], dtype=np.int32))[0]
                generated.append(int(np.argmax(logits[-1])))
                text = self.tokenizer.decode(generated)
                if any(u in text for u in until):
                    for u in until:
                        if u in text:
                            text = text.split(u)[0]
                    break
            out.append(text)
        return out


def _logsumexp(x, axis=-1, keepdims=True):
    m = np.max(x, axis=axis, keepdims=True)
    return m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=keepdims))


def evaluate_harness_downstream(
    forward_fn: Callable,
    tokenizer,
    tasks: list[str],
    num_fewshot: int = 0,
    batch_size: int | None = None,
    max_length: int = 2048,
    engine=None,
    device="cuda",
) -> dict:
    """``lm_eval.simple_evaluate`` over the model; without lm_eval, the
    bundled :mod:`.minieval` (the same Instance protocol, ``tiny_*``
    tasks). ``engine``: an optional ``serving.DecodeEngine`` (or a factory
    of one) for the generation tasks."""
    model = TorchCausalLM(forward_fn, tokenizer, max_length=max_length,
                          batch_size=batch_size or 1, engine=engine,
                          device=device)
    if HAS_LM_EVAL:
        return lm_eval.simple_evaluate(
            model=model, tasks=tasks, num_fewshot=num_fewshot)
    from . import minieval

    return minieval.simple_evaluate(
        model=model, tasks=tasks, num_fewshot=num_fewshot)
