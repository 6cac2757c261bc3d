#!/usr/bin/env python3
"""Time the long-context decode regimes on the card: one layer at the 7B
decode shape, chained steps, the marginal ms per layer-step. The port of
``experiments/bench_streaming_staged.py``, with its cases, arguments and
defaults:

    python3 tools/bench_streaming_staged.py [--l 32768] [--slots 8]
        [--kvh 32] [--d 128] [--iters 4 12] [--repeats 3]
        [--cases staged twopass]

Cases:
  staged   -- the streaming staged decode kernel (row 9 of PERF.md's
              table): the fresh token's ring write folded into its first
              pass;
  twopass  -- the fresh K/V rows MXINT8-encoded, stored by the all-layer
              row write (row 12, ``write_kv_rows_all_layers``), then the
              streaming decode kernel (row 8).

Each case runs a chain of ITERS decode steps of one layer (one query head
per kv head) at positions L - 2 - max(ITERS) onwards over one staged
MXINT8 cache, timed with CUDA events (the best of ``--repeats`` after one
warm-up); the marginal ms per layer-step is the slope between the shortest
and the longest chain. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MAIN = ("k_codes", "k_exps", "v_codes", "v_exps")
STAGE = ("k_stage_codes", "k_stage_exps", "v_stage_codes", "v_stage_exps")
SCALING = 0.09
CASES = ("staged", "twopass")


def make_state(slots: int, kvh: int, d: int, length: int, longest: int,
               device="cuda") -> dict:
    """A zeroed one-layer staged MXINT8 cache with ``flushed`` at the first
    position's 32-block, seeded queries (as many heads as kv heads) and
    fresh K/V rows, and the first position."""
    import torch

    from lqer_tpu_torch.serving.kv_cache import init_quantized_kv_cache

    cache = init_quantized_kv_cache(1, slots, kvh, d, length, staged=True,
                                    device=device)
    pos0 = length - 2 - longest
    cache["flushed"].fill_((pos0 // 32) * 32)
    q, kh, vh = (torch.randn(shape, generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
        for seed, shape in ((0, (slots, kvh, 1, d)), (1, (slots, kvh, 1, d)),
                            (2, (slots, kvh, 1, d))))
    return {"cache": cache, "q": q, "kh": kh, "vh": vh, "pos0": pos0}


def chain(case: str, iters: int, state: dict):
    """``iters`` decode steps of ``case`` at positions ``pos0``..; returns
    the running sum of the outputs (a tensor on the card)."""
    import torch

    from lqer_tpu_torch.ops.kernels.cache_write import (
        encode_rows,
        write_kv_rows_all_layers,
    )
    from lqer_tpu_torch.ops.kernels.streaming_decode import (
        decode_attention_quantized_streaming,
        decode_attention_quantized_streaming_staged,
    )

    cache, q, kh, vh = (state[k] for k in ("cache", "q", "kh", "vh"))
    main = tuple(cache[k] for k in MAIN)
    acc = torch.zeros((), device=q.device)
    for i in range(iters):
        pos = torch.full((q.shape[0],), state["pos0"] + i, dtype=torch.int32,
                         device=q.device)
        if case == "staged":
            attn = decode_attention_quantized_streaming_staged(
                q, *(a[0] for a in main), *(cache[k][0] for k in STAGE), kh,
                vh, pos, cache["flushed"], scaling=SCALING)
        else:
            cols = tuple(c[None] for c in encode_rows(kh, vh))
            write_kv_rows_all_layers(main, cols, pos)
            attn = decode_attention_quantized_streaming(
                q, *main, pos, 0, scaling=SCALING)
        acc = acc + attn.sum() * 1e-6
    return acc


def measure(case: str, iters_list, repeats: int, state: dict) -> float:
    """The marginal seconds per layer-step of ``case``."""
    import torch

    best = {}
    for iters in iters_list:
        times = []
        for r in range(repeats + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(case, iters, state)
            end.record()
            torch.cuda.synchronize()
            if r:
                times.append(start.elapsed_time(end) / 1e3)
        best[iters] = min(times)
    lo, hi = min(best), max(best)
    return (best[hi] - best[lo]) / (hi - lo)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--l", type=int, default=32768)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--kvh", type=int, default=32)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--iters", nargs="+", type=int, default=[4, 12])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=CASES)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_streaming_staged: no CUDA device", file=sys.stderr)
        return 1
    if len(set(args.iters)) < 2:
        ap.error("--iters needs two different chain lengths")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    B, KVH, d, L = args.slots, args.kvh, args.d, args.l
    state = make_state(B, KVH, d, L, max(args.iters))
    for case in args.cases:
        marg = measure(case, args.iters, args.repeats, state)
        gb = 2 * B * KVH * L * (d + d // 16) * 1e-9
        print(f"{case:8s} L={L}: {marg * 1e3:7.2f} ms/layer-step "
              f"({gb:.2f} GB one-pass stream -> "
              f"{gb * 1.5 / marg:.0f} GB/s two-pass eff)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
