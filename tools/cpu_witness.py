#!/usr/bin/env python3
"""Where the card and the CPU part: a second witness for the CPU
comparisons of ``chip_smoke.py``'s phase 4, and its negative controls.

    python3 tools/cpu_witness.py [--seeds N] [--steps N]

Needs one CUDA device; builds the kernels from the checkout. Two parts:

1. Mistral. The 2-layer Mistral-7B-width model of ``chip_smoke.py``'s
   phase 4 (rank 128, the ``bfloat16`` cache at max_len 8192, the same
   seeds) takes the same admission and 8 decode steps through the kernels
   past the window; then, for each of N context fills (the first is the
   one ``chip_smoke.py`` uses, the others a new seed and positions shifted
   by 5 and 11), three engines of 4 slots decode ``--steps`` more steps
   fed the kernels' greedy tokens: the kernels on the card, the plain
   versions on the card and the plain versions on the CPU, the last two
   starting from a copy of the kernels' cache. It prints, per step and
   slot, the logits |diff| (max, RMS) in 8-bit code steps of each pair,
   and, where a pair of the plain versions on the card and on the CPU
   parts by more than 0.1 RMS, the chain of one step's tensors (each
   norm, projection, rotary, attention, MLP and head output of both
   layers) with how many values differ and by how much, so that the first
   discrete difference (a flipped bf16 rounding or quantizer code) shows.
2. OPT-350m. The 2-layer OPT-350m-width model of phase 4 (``bfloat16``
   cache, 8 x 64 admission, 20 steps) through the kernels, against runs
   with corrections left out: layer 1's fc2; fc2 in every layer; fc1 and
   fc2 in every layer; every correction of every layer. Prints each
   control's logits RMS range against the kernels, for the 0.4 limit.

The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

RECORDED = ("rms_norm", "_lin_group", "apply_rotary", "_attention",
            "serving_linear", "_mlp_fused_or_none", "_lm_head_logits")


class Recorder:
    """Wraps the step's building blocks in ``serving.decode`` and keeps
    each output (on the CPU) in call order while ``on``."""

    def __init__(self):
        from lqer_tpu_torch.serving import decode

        self.decode, self.saved, self.log, self.on = decode, {}, [], False
        for name in RECORDED:
            self.saved[name] = getattr(decode, name)
            setattr(decode, name, self._wrap(name, self.saved[name]))

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if self.on:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                for i, t in enumerate(outs):
                    if hasattr(t, "detach"):
                        self.log.append((f"{name}[{i}]",
                                         t.detach().float().cpu()))
            return out
        return wrapped

    def take(self):
        log, self.log = self.log, []
        return log

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.decode, name, fn)


def chain(torch, a, b, slot):
    """One line per recorded tensor of slot ``slot``: values that differ
    and the largest difference relative to the tensor's largest value."""
    lines = []
    for (name, x), (_, y) in zip(a, b):
        x, y = x[slot], y[slot]
        n = int((x != y).sum())
        rel = float((x - y).abs().max() / x.abs().max().clamp_min(1e-30))
        lines.append(f"    {name:24s} {n:6d} of {x.numel():7d} differ, "
                     f"max rel {rel:.3g}")
    return "\n".join(lines)


def mistral(torch, seeds: int, steps: int) -> None:
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import logits_steps

    cfg = dataclasses.replace(LlamaConfig.mistral_7b(), num_hidden_layers=2)
    backend, params, qcfgs = build_random_model(cfg, rank=128,
                                                seed=cs.SEED + 22)
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    cpu_backend = {"arrays": {k: {n: None if t is None else t.cpu()
                                  for n, t in v.items()}
                              for k, v in backend["arrays"].items()},
                   "meta": dict(backend["meta"])}
    cpu_params = {k: v.cpu() for k, v in params.items()}
    kw = dict(num_slots=4, max_len=8192, cache_dtype="bfloat16",
              lm_head_width=8)
    card = DecodeEngine(params, cfg, qcfgs, pallas_backend=backend,
                        scan_layers=True, device="cuda", **kw)
    plain = DecodeEngine(params, cfg, qcfgs, pallas_backend=backend,
                         scan_layers=True, device="cuda", **kw)
    cpu = DecodeEngine(cpu_params, cfg, qcfgs, pallas_backend=cpu_backend,
                       scan_layers=True, device="cpu", **kw)
    rng = np.random.default_rng(cs.SEED + 2)
    padded = rng.integers(0, cfg.vocab_size, (4, 64))
    lengths = np.full(4, 63, dtype=np.int32)
    logits, _ = cs.teacher_force(torch, {"kernels": card}, padded, lengths, 4)
    start = torch.argmax(logits["kernels"][-1], -1).numpy()
    base = np.array([4500, 5003, 6001, 7777], dtype=np.int32)
    rec = Recorder()
    worst = {"kernels vs plain": 0.0, "plain vs cpu": 0.0,
             "kernels vs cpu": 0.0}
    try:
        for i, shift in enumerate((0, 5, 11)[:seeds]):
            positions = base + shift
            cs.fill_context(torch, {"kernels": card}, positions,
                            cs.SEED + 29 + i)
            lg, _ = cs.teacher_decode(torch, {"kernels": card}, start, 8)
            last = lg["kernels"][-1]
            for key, t in card.cache.items():
                plain.cache[key].copy_(t)
                cpu.cache[key].copy_(t)
            plain.lengths[:] = card.lengths
            cpu.lengths[:] = card.lengths
            print(f"fill {i} (seed {cs.SEED + 29 + i}), decode positions "
                  f"{card.lengths.tolist()}.. :", flush=True)
            for step in range(steps):
                tokens = torch.argmax(last, -1).cpu().numpy()
                rec.on = True
                out = {"kernels": card.decode_logits(tokens).float().cpu()}
                logs = {"kernels": rec.take()}
                for name, engine in (("plain", plain), ("cpu", cpu)):
                    with cs.run_context(name):
                        out[name] = engine.decode_logits(tokens).float().cpu()
                    logs[name] = rec.take()
                rec.on = False
                last = out["kernels"]
                for engine in (card, plain, cpu):
                    engine.lengths += 1
                for s in range(4):
                    read = {}
                    for pair in worst:
                        one, other = pair.split(" vs ")
                        m, r = logits_steps(out[one][s:s + 1],
                                            out[other][s:s + 1])
                        read[pair] = (m, r)
                        worst[pair] = max(worst[pair], r)
                    print(f"  step {step} slot {s}: " + "; ".join(
                        f"{p} max {m:.3g} RMS {r:.3g}"
                        for p, (m, r) in read.items()), flush=True)
                    if read["plain vs cpu"][1] > 0.1:
                        print(f"  step {step} slot {s}, plain on the card vs "
                              f"the CPU, tensor by tensor:\n"
                              + chain(torch, logs["plain"], logs["cpu"], s),
                              flush=True)
                        print(f"  step {step} slot {s}, kernels vs plain on "
                              f"the card:\n"
                              + chain(torch, logs["kernels"], logs["plain"],
                                      s), flush=True)
    finally:
        rec.close()
    print(f"Mistral bf16 past the window, largest RMS over {seeds} fills x "
          f"{steps} steps x 4 slots: " + "; ".join(
              f"{p} {r:.3g}" for p, r in worst.items()), flush=True)
    del card, plain, cpu, backend, params
    torch.cuda.empty_cache()


def opt350m(torch) -> None:
    from lqer_tpu_torch.models.opt import MODEL_CONFIGS
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import logits_steps

    cfg = dataclasses.replace(MODEL_CONFIGS["facebook/opt-350m"](),
                              num_hidden_layers=2)
    backend, params, qcfgs = build_random_model(cfg, rank=32,
                                                seed=cs.SEED + 4)

    def without(layers, names):
        arrays = dict(backend["arrays"])
        for key, entry in backend["arrays"].items():
            if any(key.startswith(f"model.decoder.layers.{i}.")
                   for i in layers):
                drop = {n: torch.zeros_like(entry[n]) for n in names
                        if entry.get(n) is not None}
                arrays[key] = dict(entry, **drop)
        return {"arrays": arrays, "meta": backend["meta"]}

    controls = {"fc2, layer 1": without([1], ["b_d"]),
                "fc2, every layer": without([0, 1], ["b_d"]),
                "fc1 and fc2, every layer": without([0, 1], ["b_g", "b_d"]),
                "every correction": without([0, 1], ["b", "b_g", "b_d"])}
    kw = dict(num_slots=8, max_len=256, cache_dtype="bfloat16",
              lm_head_width=8, device="cuda")
    engines = {"kernels": DecodeEngine(params, cfg, qcfgs,
                                       pallas_backend=backend, **kw,
                                       scan_layers=True)}
    for name, b in controls.items():
        engines[name] = DecodeEngine(params, cfg, qcfgs, pallas_backend=b,
                                     **kw, scan_layers=True)
    rng = np.random.default_rng(cs.SEED + 1)
    padded = rng.integers(0, cfg.vocab_size, (8, 64))
    lengths = np.full(8, 63, dtype=np.int32)
    logits, _ = cs.teacher_force(torch, engines, padded, lengths, 20)
    for name in controls:
        seen = [logits_steps(a, b) for a, b in
                zip(logits["kernels"], logits[name])]
        print(f"OPT-350m 2-layer, kernels vs {name} left out: admission + "
              f"20 steps, max {max(m for m, _ in seen):.3g}, RMS "
              f"{min(r for _, r in seen):.3g} to "
              f"{max(r for _, r in seen):.3g} (limit 0.4)", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cpu_witness: needs a CUDA device", file=sys.stderr)
        return 1
    from lqer_tpu_torch.ops.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    build_all()
    opt350m(torch)
    mistral(torch, args.seeds, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
