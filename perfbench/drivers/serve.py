"""Traffic kind ``serve``: a closed loop through the port's
``DecodeEngine`` with the kernel backend and the engine's defaults (the
eager step, greedy sampling, no EOS).

One ``run`` serves the mix's seeded queue. The benchmark wraps the
engine instance's ``decode_step`` and ``_admit_batch`` (each ends in a host
copy of its tokens, so its span is synchronised): set-up ends, and the
window opens, after the first admission wave and ``warmup_steps`` decode
steps; the window closes at the first step boundary after ``seconds``,
where the wrapper ends ``run``. With tracing, the loop goes on past the
window for the mix's traced steps under the profiler. Every token's host
time is kept per request.

The check, once the window has closed and the engine is freed: a sample,
drawn from the seed, of the requests the window finished, with the
longest of them; the reference runs each prompt with its served tokens,
and each served token's gap below the reference's best logit is read."""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import traffic
from ..compare import CONTROL, gaps, stats
from ..reference.model import Reference
from ..system import build


class _Stop(Exception):
    """Raised at a step boundary to end ``DecodeEngine.run``."""


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix

    # -- set-up and the measured loop ---------------------------------------
    def setup(self):
        import torch
        from lqer_tpu_torch.serving.engine import DecodeEngine, Request

        ctx, mix, spec = self.ctx, self.mix, self.ctx.spec
        cfg, params, backend, qcfgs = build(spec, ctx.seed, ctx.device)
        self.engine = DecodeEngine(
            params, cfg, qcfgs, num_slots=mix["slots"],
            max_len=mix["max_len"], cache_dtype=spec.kv_cache,
            pallas_backend=backend, lm_head_width=8 if spec.w8_head else None,
            device=ctx.device)
        del params, backend
        self.requests = [Request(prompt_ids=r["prompt_ids"],
                                 max_new_tokens=r["max_new_tokens"])
                         for r in traffic.serve_requests(mix, ctx.seed,
                                                         spec.vocab)]
        self.times = {id(r): [] for r in self.requests}
        self.steps = 0
        self.t_open = self.t_close = None
        self.torch = torch

    def _boundary(self):
        """Called before every step and admission: opens the window,
        closes it, and steps or ends the traced phase."""
        ctx, now = self.ctx, time.perf_counter()
        if self.t_open is None:
            if self.steps >= self.mix["warmup_steps"]:
                self.t_open = now
                ctx.spans.phase = "window"
            return
        if self.t_close is None:
            if now - self.t_open >= ctx.seconds:
                self.t_close = now
                if not ctx.traced:
                    raise _Stop
                ctx.start_trace()
            return
        if ctx.trace_done():
            raise _Stop

    def run(self):
        eng, spans = self.engine, self.ctx.spans
        step, admit = eng.decode_step, eng._admit_batch

        def decode_step(tokens, temps):
            self._boundary()
            active = [r for r in eng.slot_req if r is not None]
            lengths = eng.lengths.tolist()
            with spans.span("decode_step", rows=eng.num_slots,
                            active=len(active), lengths=lengths):
                out = step(tokens, temps)
            t = time.perf_counter()
            for r in active:
                self.times[id(r)].append(t)
            self.steps += 1
            self.ctx.step_trace()
            return out

        def admit_batch(pairs):
            self._boundary()
            with spans.span("admit", seqs=len(pairs),
                            prompts=[len(r.prompt_ids) for r, _ in pairs]):
                toks = admit(pairs)
            t = time.perf_counter()
            for r, _ in pairs:
                self.times[id(r)].append(t)
            return toks

        eng.decode_step, eng._admit_batch = decode_step, admit_batch
        try:
            eng.run(self.requests)
        except _Stop:
            pass
        else:
            raise RuntimeError("the queue ran dry before the window closed: "
                               "the mix needs more requests")
        return self.t_open, self.t_close

    # -- what the window did ----------------------------------------------------
    def record(self) -> dict:
        """Tokens and their host times, for the metric readers."""
        lo, hi = self.t_open, self.t_close
        served = sum(1 for ts in self.times.values()
                     if any(lo < t <= hi for t in ts))
        return {"token_times": self.times, "t_open": lo, "t_close": hi,
                "attempted": served}

    def free(self):
        del self.engine
        gc.collect()
        if self.torch.cuda.is_available():
            self.torch.cuda.empty_cache()

    def _ref(self, **kw):
        ctx = self.ctx
        return Reference(ctx.spec, ctx.seed, ctx.device, kv_grid="cache",
                         head="w8" if ctx.spec.w8_head else "dense", **kw)

    def sample(self) -> list:
        """Requests the window finished, in a seeded sample of
        ``check.requests`` that holds the longest of them."""
        done = [r for r in self.requests if r.done
                and self.t_open < self.times[id(r)][-1] <= self.t_close]
        if not done:
            return []
        done.sort(key=lambda r: -len(r.output_ids))
        rng = np.random.default_rng(self.ctx.seed)
        k = min(self.mix["check"]["requests"], len(done))
        rest = rng.choice(len(done) - 1, size=k - 1, replace=False) + 1 \
            if k > 1 else []
        return [done[0]] + [done[i] for i in sorted(rest)]

    # -- the check ------------------------------------------------------------
    def compare(self, sample) -> dict:
        """The served tokens' gaps below the recipe's reference (the
        widest, ``served_gap``, and their mean); with ``ctx.control``, the
        gaps of the control's own first tokens (``control.served_gap``)."""
        import torch

        seqs, rows, served = [], [], []
        for r in sample:
            p, out = r.prompt_ids, r.output_ids
            seqs.append(torch.as_tensor(p + out[:-1], dtype=torch.int64))
            rows.append(list(range(len(p) - 1, len(p) - 1 + len(out))))
            served.append(torch.as_tensor(out, dtype=torch.int64))
        ref = self._ref().logits(seqs, rows)
        out = stats("served_gap", gaps(ref, served))
        out["served_tokens"] = sum(len(t) for t in served)
        if self.ctx.control:
            ctl = self._ref(**CONTROL).logits(seqs, rows)
            out.update(stats("control.served_gap",
                             gaps(ref, [c.argmax(-1) for c in ctl])))
        return out
