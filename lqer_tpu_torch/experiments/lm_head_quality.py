#!/usr/bin/env python
"""W8 lm_head quality-neutrality study (port of
``experiments/lm_head_quality.py``).

The serving path's packed lm_head quantizes only the head weight to MXINT8
(groups of 16 along the hidden dimension, width 8); activations stay as
they are for the dense product. This study measures the perplexity that
weight grid costs on the offline proxy (seeded random models, seeded
tokens): for each model size the perplexity with the fp head, the W8 head
and the W4 head, and the worst per-token logit perturbation of W8.

    python -m lqer_tpu_torch.experiments.lm_head_quality [--seed 0] [--device cpu]

Runs on ``--device`` (``cuda`` by default; without a card it raises). The
JAX script draws its weights and tokens from ``jax.random``; the port draws
them from a ``torch.Generator`` seeded with ``--seed`` (weights) and
``--seed + 1`` (tokens), so its numbers are those of other random models.
"""

from __future__ import annotations

import argparse

import torch

from .. import models
from ..device import resolve_device
from ..models import LlamaConfig
from ..ops.storage import MXFormat, dequantize_mx, quantize_mx

# The three proxy sizes of the JAX studies (lm_head_quality.py and
# kv_cache_quality.py), as ``LlamaConfig.tiny`` arguments
SIZES = {
    "tiny-9M": dict(vocab_size=512, hidden=128, layers=2, heads=4,
                    kv_heads=4, inter=256, max_pos=256),
    "small-60M": dict(vocab_size=2048, hidden=512, layers=4, heads=8,
                      kv_heads=8, inter=1024, max_pos=256),
    "base-220M": dict(vocab_size=4096, hidden=1024, layers=8, heads=16,
                      kv_heads=16, inter=2048, max_pos=256),
}
L_CONFIG = {"linear": {"rank": 16}}


def _q(width, block, skip):
    return {
        "name": "block_fp", "width": width, "exponent_width": 8,
        "exponent_bias": None, "block_size": block, "skip_first_dim": skip,
    }


Q_CONFIG = {
    "linear": {
        "name": "flexible_lqer", "is_ptq": True,
        "x_quantizer": _q(8, [1, 16], True),
        "w_quantizer": _q(4, [1, 16], False),
        "b_quantizer": _q(8, [1, 16], False),
    },
    "matmul": {"name": "flexible", "x_quantizer": _q(8, [1, 16], True),
               "w_quantizer": _q(8, [1, 16], True)},
}


def head_roundtrip(w: torch.Tensor, width: int) -> torch.Tensor:
    """``w (vocab, hidden)`` through MXINT``width`` and back: groups of 16
    along the hidden dimension (along K of ``w.T``), in ``w``'s dtype."""
    fmt = MXFormat(width=width)
    codes, exps = quantize_mx(w.to(torch.float32).T, fmt)
    return dequantize_mx(codes, exps, fmt, torch.float32).T.to(w.dtype)


def ppl_with_head(cfg, params, qcfgs, ids, head_w):
    """(perplexity, f32 logits on the CPU) of ``ids (b, s)``, predicting
    ``ids[:, 1:]`` from ``ids[:, :-1]`` with ``head_w`` as the head."""
    p = dict(params)
    p["lm_head.weight"] = head_w
    with torch.inference_mode():
        logits = models.forward(p, ids[:, :-1], cfg, qcfgs).to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, ids[:, 1:, None].long())[..., 0]
        return float(torch.exp(nll.mean())), logits.cpu()


def head_rows(cfg, params, qcfgs, ids) -> dict:
    """The study's row for one prepared model: the fp, W8 and W4 heads'
    perplexities and the W8 head's largest |Δlogit| from the fp head."""
    w = params["lm_head.weight"]
    ppl_fp, lg_fp = ppl_with_head(cfg, params, qcfgs, ids, w)
    ppl_w8, lg_w8 = ppl_with_head(cfg, params, qcfgs, ids,
                                  head_roundtrip(w, 8))
    ppl_w4, _ = ppl_with_head(cfg, params, qcfgs, ids, head_roundtrip(w, 4))
    return {"fp": ppl_fp, "w8": ppl_w8, "w4": ppl_w4,
            "max_dlogit_w8": float((lg_w8 - lg_fp).abs().max())}


def seeded_model(cfg, seed: int, device):
    """``(params prepared for Q_CONFIG, qcfgs, ids (4, 128))``: weights from
    a generator seeded ``seed``, tokens from one seeded ``seed + 1``."""
    params = models.init_params(cfg, torch.Generator().manual_seed(seed),
                                torch.float32, device)
    qcfgs = models.quantize_model(cfg, Q_CONFIG, L_CONFIG)
    params = models.prepare_ptq(params, cfg, qcfgs)
    ids = torch.randint(0, cfg.vocab_size, (4, 128),
                        generator=torch.Generator().manual_seed(seed + 1))
    return params, qcfgs, ids.to(device)


def main(argv=None) -> dict:
    """Print the table; returns ``{size: head_rows(...)}``."""
    ap = argparse.ArgumentParser(prog="lqer_tpu_torch.experiments."
                                      "lm_head_quality")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"{'model':10s} {'fp ppl':>10s} {'W8 ppl':>10s} {'dW8':>9s} "
          f"{'W4 ppl':>10s} {'dW4':>9s} {'max|dlogit| W8':>15s}")
    rows = {}
    for name, kw in SIZES.items():
        cfg = LlamaConfig.tiny(**kw)
        r = rows[name] = head_rows(cfg, *seeded_model(cfg, args.seed, device))
        print(f"{name:10s} {r['fp']:10.4f} {r['w8']:10.4f} "
              f"{r['w8'] - r['fp']:+9.4f} {r['w4']:10.4f} "
              f"{r['w4'] - r['fp']:+9.4f} {r['max_dlogit_w8']:15.5f}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
