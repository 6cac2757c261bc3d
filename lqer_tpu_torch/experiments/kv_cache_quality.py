#!/usr/bin/env python
"""KV-cache width quality study (port of ``experiments/kv_cache_quality.py``):
what do the MXINT8 (8.5 bits a value) and MXINT4 (4.5) caches do to decode
quality?

Offline proxy (seeded random models and prompts): decode ``--steps``
tokens teacher-forced on the f32-cache greedy trajectory and report, per
cache, the mean softmax KL against the f32 cache, the largest |Δlogit| and
the greedy-token agreement. Each cache's attention config quantizes its
operands at the cache's width (quantize once at write). The steps run
``serving/decode.py::model_step`` with no backend, as in JAX: every linear
emulated, attention eager.

    python -m lqer_tpu_torch.experiments.kv_cache_quality [--steps 48] [--seeds 3] [--device cpu]

Runs on ``--device`` (``cuda`` by default; without a card it raises). The
JAX script draws weights and prompts from ``jax.random``; the port from a
``torch.Generator`` (weights seeded ``seed``, the prompt ``100 + seed``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import models
from ..device import resolve_device
from ..models import LlamaConfig
from ..serving import decode as dec
from .lm_head_quality import L_CONFIG, SIZES, _q

MAX_LEN = 256
PROMPT_LEN = 8
CACHES = (("mxint8", 8), ("mxint4", 4))


def _qconfig(kv_width):
    mm_w = {"name": "flexible", "x_quantizer": _q(8, [1, 16], True),
            "w_quantizer": _q(kv_width, [1, 16], True)} \
        if kv_width else None
    return {
        "linear": {
            "name": "flexible_lqer", "is_ptq": True,
            "x_quantizer": _q(8, [1, 16], True),
            "w_quantizer": _q(4, [1, 16], False),
            "b_quantizer": _q(8, [1, 16], False),
        },
        **({"matmul": mm_w} if mm_w else {}),
    }


def qcfgs_for(cfg, kv_width):
    return models.quantize_model(cfg, _qconfig(kv_width), L_CONFIG)


def _prefill(cfg, params, qcfgs, cache_dtype, prompt, device):
    cache = dec.make_cache(cfg, 1, MAX_LEN, cache_dtype, device=device)
    pos = torch.zeros((1,), dtype=torch.int32, device=device)
    logits, cache = dec.model_step(params, prompt, cache, pos, cfg, qcfgs)
    return logits, cache, pos + prompt.shape[1]


def teacher_tokens(cfg, params, qcfgs, prompt, steps: int, device
                   ) -> list[int]:
    """The greedy continuation of ``prompt (1, s)`` over the f32 cache."""
    with torch.inference_mode():
        logits, cache, pos = _prefill(cfg, params, qcfgs, torch.float32,
                                      prompt, device)
        toks = []
        t = int(logits[0, -1].argmax())
        for _ in range(steps):
            toks.append(t)
            logits, cache = dec.model_step(
                params, torch.tensor([[t]], device=device), cache, pos, cfg,
                qcfgs)
            t = int(logits[0, 0].argmax())
            pos = pos + 1
    return toks


def trajectory(cfg, params, qcfgs, cache_dtype, tokens, prompt, device
               ) -> np.ndarray:
    """f32 logits (steps, vocab) of ``tokens`` teacher-forced after
    ``prompt`` over a ``cache_dtype`` cache."""
    outs = []
    with torch.inference_mode():
        _, cache, pos = _prefill(cfg, params, qcfgs, cache_dtype, prompt,
                                 device)
        for t in tokens:
            logits, cache = dec.model_step(
                params, torch.tensor([[int(t)]], device=device), cache, pos,
                cfg, qcfgs)
            outs.append(logits[0, 0].to(torch.float32).cpu().numpy())
            pos = pos + 1
    return np.stack(outs)


def trajectories(cfg, params, prompt, tokens, device) -> dict:
    """``{"float32", "mxint8", "mxint4"}`` trajectories of ``tokens`` on
    ``params`` (prepared for ``qcfgs_for(cfg, 8)``)."""
    out = {"float32": trajectory(cfg, params, qcfgs_for(cfg, 8),
                                 torch.float32, tokens, prompt, device)}
    for label, width in CACHES:
        out[label] = trajectory(cfg, params, qcfgs_for(cfg, width), label,
                                tokens, prompt, device)
    return out


def row_stats(ref: np.ndarray, got: np.ndarray) -> tuple:
    """(mean KL(ref ‖ got), max |Δlogit|, greedy agreement). The KL sums in
    f64: at MXINT8's KL of a few 1e-6 an f32 sum of 512 terms near 6 in
    magnitude is off by a few percent (the JAX script sums in f32)."""
    ref_t = torch.from_numpy(ref).to(torch.float64)
    got_t = torch.from_numpy(got).to(torch.float64)
    lr = torch.log_softmax(ref_t, dim=-1)
    lg = torch.log_softmax(got_t, dim=-1)
    kl = float((lr.exp() * (lr - lg)).sum(-1).mean())
    dmax = float(np.abs(got - ref).max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    return kl, dmax, agree


def seeded_model(cfg, seed: int, device):
    """``(params prepared for qcfgs_for(cfg, 8), prompt (1, 8))``."""
    params = models.init_params(cfg, torch.Generator().manual_seed(seed),
                                torch.float32, device)
    params = models.prepare_ptq(params, cfg, qcfgs_for(cfg, 8))
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                           generator=torch.Generator().manual_seed(100 + seed))
    return params, prompt.to(device)


def seed_rows(cfg, seed: int, steps: int, device) -> dict:
    """One seed's ``{cache: row_stats}``, with its teacher tokens and
    trajectories under ``"tokens"`` and ``"trajectories"``."""
    params, prompt = seeded_model(cfg, seed, device)
    tokens = teacher_tokens(cfg, params, qcfgs_for(cfg, 8), prompt, steps,
                            device)
    traj = trajectories(cfg, params, prompt, tokens, device)
    rows = {label: row_stats(traj["float32"], traj[label])
            for label, _ in CACHES}
    return {**rows, "tokens": tokens, "trajectories": traj}


def main(argv=None) -> dict:
    """Print the table; returns ``{size: {cache: (mean KL, mean max
    |Δlogit|, mean agreement)}}`` over the seeds."""
    ap = argparse.ArgumentParser(prog="lqer_tpu_torch.experiments."
                                      "kv_cache_quality")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--seeds", type=int, default=3,
                    help="model/prompt seeds averaged per row (the single-"
                    "seed token-agreement numbers swing widely)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"{'model':10s} {'cache':10s} {'meanKL':>10s} {'max|dlogit|':>12s} "
          f"{'tok agree':>10s}   (mean over seeds)")
    table = {}
    for name, kw in SIZES.items():
        cfg = LlamaConfig.tiny(**kw)
        per_seed = [seed_rows(cfg, seed, args.steps, device)
                    for seed in range(args.seeds)]
        table[name] = {}
        for label, _ in CACHES:
            a = np.array([r[label] for r in per_seed])
            table[name][label] = tuple(float(v) for v in a.mean(0))
            print(f"{name:10s} {label:10s} {a[:, 0].mean():10.5f} "
                  f"{a[:, 1].mean():12.4f} {a[:, 2].mean():10.3f}",
                  flush=True)
    return table


if __name__ == "__main__":
    main()
