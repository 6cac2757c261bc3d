"""Traffic kind ``eval``: the port's perplexity evaluation,
``lqer_tpu_torch.evaluate.evaluate_perplexity``, over the packed forward
(``models.get_arch_module(cfg).forward`` with the kernel backend and, for
Llama and Mistral, the fused prefill attention), as the pipeline's
evaluation stage builds it (``runners._build_quantized_forward``).

Batch after batch of the mix's seeded token ids, one
``evaluate_perplexity`` call a batch, each inside the benchmark's span; a
warm-up batch is set-up, and the window closes at the first batch boundary
after ``seconds``. Each batch's loss (what ``evaluate_perplexity``
returns), the argmax of its logits and its target tokens' log
probabilities at every position are kept. The check: a batch drawn from
the seed among those the window evaluated, against the reference's
logits (``compare``)."""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import traffic
from ..compare import CONTROL, gaps, stats, target_logprobs
from ..reference.model import Reference
from ..system import build


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix

    def setup(self):
        import torch
        from lqer_tpu_torch import models
        from lqer_tpu_torch.evaluate import evaluate_perplexity

        ctx, spec = self.ctx, self.ctx.spec
        cfg, params, backend, qcfgs = build(spec, ctx.seed, ctx.device)
        arch = models.get_arch_module(cfg)
        kw = {"fused_attention": True} if cfg.arch != "opt" else {}
        self.argmax, self.logprobs = [], []

        def fwd(ids):
            logits = arch.forward(params, ids, cfg, qcfgs, backend=backend,
                                  **kw)
            self.argmax.append(logits.argmax(-1))
            self.logprobs.append(target_logprobs(logits, ids))
            return logits

        self.fwd = fwd
        self.evaluate = evaluate_perplexity
        self.tokens = traffic.eval_tokens(self.mix, ctx.seed, spec.vocab)
        self.torch = torch
        self.losses = []
        self.t_open = self.t_close = None
        for _ in range(self.mix["warmup_batches"]):
            self._batch(0)
        self.argmax, self.logprobs, self.losses = [], [], []

    def _batch(self, b: int) -> float:
        bs = self.mix["batch_size"]
        with self.torch.inference_mode():
            res = self.evaluate(self.fwd, self.tokens[b * bs:(b + 1) * bs],
                                batch_size=bs, device=self.ctx.device)
        return res["loss"]

    def run(self):
        ctx, spans = self.ctx, self.ctx.spans
        n = len(self.tokens) // self.mix["batch_size"]
        self.t_open = time.perf_counter()
        spans.phase = "window"
        b = 0
        while True:
            now = time.perf_counter()
            if self.t_close is None and now - self.t_open >= ctx.seconds:
                self.t_close = now
                if not ctx.traced:
                    break
                ctx.start_trace()
            if self.t_close is not None and ctx.trace_done():
                break
            if b >= n:
                raise RuntimeError("the mix ran out of batches before the "
                                   "window closed: it needs more")
            with spans.span("batch", tokens=self.mix["batch_size"]
                            * self.mix["seq_len"]):
                loss = self._batch(b)
            if self.t_close is None:
                self.losses.append(loss)
            b += 1
            ctx.step_trace()
        return self.t_open, self.t_close

    def record(self) -> dict:
        return {"t_open": self.t_open, "t_close": self.t_close,
                "attempted": len(self.losses)}

    def free(self):
        del self.fwd
        gc.collect()
        if self.torch.cuda.is_available():
            self.torch.cuda.empty_cache()

    def _ref(self, **kw):
        ctx = self.ctx
        return Reference(ctx.spec, ctx.seed, ctx.device, kv_grid="matmul",
                         head="dense", **kw)

    def sample(self) -> list:
        """``check.batches`` batch indices drawn from the seed among those
        the window evaluated."""
        n = len(self.losses)
        k = min(self.mix["check"]["batches"], n)
        rng = np.random.default_rng(self.ctx.seed)
        return sorted(rng.choice(n, size=k, replace=False).tolist())

    def compare(self, sample) -> dict:
        """Over every position of the sampled batches: ``top_gap``, the
        widest gap of the program's first token below the reference's
        best logit; ``logprob_gap_mean``, the mean distance of the target
        tokens' log probabilities from the reference's; ``loss_gap``, the
        widest distance of a batch's loss from the reference's. A missing
        row reads inf. With ``ctx.control`` the control reads the same for
        its own (``control.*``)."""
        import torch

        bs = self.mix["batch_size"]
        sides = {"": ([], [], [])}
        if self.ctx.control:
            sides["control."] = ([], [], [])
        for b in sample:
            ids = torch.as_tensor(self.tokens[b * bs:(b + 1) * bs])
            seqs, rows = list(ids), [list(range(ids.shape[1]))] * bs
            ref = self._ref().logits(seqs, rows)
            dev = ref[0].device
            r_lp = target_logprobs(torch.stack(ref), ids.to(dev))
            for side, (top, lp, loss) in sides.items():
                if side:
                    c = self._ref(**CONTROL).logits(seqs, rows)
                    first = [x.argmax(-1) for x in c]
                    p_lp = target_logprobs(torch.stack(c), ids.to(dev))
                    p_loss = -float(p_lp.double().mean())
                else:
                    first, p_lp = list(self.argmax[b]), self.logprobs[b]
                    p_loss = self.losses[b]
                top.append(gaps(ref, first))
                lp.append((p_lp - r_lp).abs().flatten() if p_lp.shape
                          == r_lp.shape else torch.tensor([float("inf")]))
                loss.append(abs(p_loss + float(r_lp.double().mean())))
        out = {}
        for side, (top, lp, loss) in sides.items():
            out.update(stats(f"{side}top_gap", torch.cat(top)))
            out.update(stats(f"{side}logprob_gap", torch.cat(lp)))
            out[f"{side}loss_gap"] = max(loss)
        return out
