#!/usr/bin/env python3
"""Where the time of rows 4, 5, 6 and 10 goes, on one card.

    python3 tools/bench_attention_parts.py [--rows 4 5 6 10]

Row 5 (fp-cache decode attention, ``ops/kernels/fp_decode.py``) at
``chip_smoke.py``'s phase-3 shapes (Llama-2-7B: 8 slots x 32 kv heads,
L = 2048, positions 64..1984; Mistral-7B: 8 slots x 8 kv heads of 4
queries, L = 8192, positions 6000..6030, window 4096): the served launch,
the same launch with K and V left unquantized (``k_width=v_width=None``),
and each of its kernels' device time (torch.profiler). Rows 6 (widths 8
and 4) and 10 (``ops/kernels/quantized_decode.py``) at those shapes and at
OPT-2.7b's (8 slots x 32 kv heads of d = 80, L = 2048): the launch, each of
its kernels' device time, the bound (the cache bytes the slots hold, the
queries and the output, over the card's memory rate) and
``scaled_dot_product_attention`` on the unquantized bf16 values (with the
window mask where there is a window). Row 4 (prefill attention,
``ops/kernels/attention.py``) at 8 prompts x 64 tokens and one prompt of
2048 tokens, 32 heads, d = 128: the launch and each of its kernels' device
time. Times are medians of CUDA events with L2 flushed before each launch
(``chip_smoke.Timer``); one JSON line per shape, the card's name and power
limit first; a shape the checkout's kernels refuse prints its reason.
Needs one CUDA device. Copied with ``chip_smoke.py`` into another checkout
(``git archive`` unpacked under ``build/``), it times that checkout's
kernels: run both in one call to compare them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (shape, slots, kv heads, n_rep, d, L, positions, window)
DECODE_SHAPES = (
    ("Llama", 8, 32, 1, 128, 2048,
     [64, 303, 560, 815, 1088, 1343, 1600, 1984], None),
    ("Mistral", 8, 8, 4, 128, 8192,
     [6000, 6001, 6003, 6007, 6010, 6013, 6021, 6030], 4096),
    ("OPT-2.7b", 8, 32, 1, 80, 2048,
     [64, 303, 560, 815, 1088, 1343, 1600, 1984], None))


def _row5(timer, launch_split, gen):
    from lqer_tpu_torch.ops.kernels import fp_decode as kfp

    for what, B, KVH, nrep, D, L, pos, win in DECODE_SHAPES[:2]:
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        q = torch.randn(B, KVH * nrep, 1, D, generator=gen, device="cuda")
        k, v = (torch.randn(2, B, KVH, L, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        kw = dict(scaling=D ** -0.5, window=win)
        served = lambda: kfp.decode_attention_fp(q, k, v, p, 1, **kw)
        raw = lambda: kfp.decode_attention_fp(q, k, v, p, 1, k_width=None,
                                              v_width=None, **kw)
        print(json.dumps({
            "row": 5, "shape": what, "ms": timer(served),
            "k_v_unquantized_ms": timer(raw),
            "kernels_ms": launch_split(torch, served)}), flush=True)
        del k, v


def _rows_6_10(timer, launch_split, gen, rows):
    import torch.nn.functional as F

    from chip_smoke import peak_rates
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.ops.kernels.decode_attention import key_mask
    from lqer_tpu_torch.parallel.collectives import mx4_encode, mx8_encode

    rate = peak_rates(torch.cuda.get_device_name(0))[0]
    for what, B, KVH, nrep, D, L, pos, win in DECODE_SHAPES:
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        q = torch.randn(B, KVH * nrep, 1, D, generator=gen, device="cuda")
        lo = (p - win + 1).clamp(min=0) // 16 * 16 if win else 0
        tokens = int(((p + 16) // 16 * 16 - lo).sum())
        mask = key_mask(L, p, win)[:, None, None, :]
        kw = dict(scaling=D ** -0.5, window=win)
        cases = []
        if 6 in rows:   # width 4 needs d % 32 == 0
            cases += [(6, 8)] + [(6, 4)] * (D % 32 == 0)
        if 10 in rows:
            cases.append((10, 8))
        for row, width in cases:
            enc = mx8_encode if width == 8 else mx4_encode
            vals, cache = [], []
            for _ in range(2):
                x = torch.randn(B, KVH, L, D, generator=gen, device="cuda")
                c, e = enc(x, 16, zero_fill=1.0)
                cache += [torch.stack([t.transpose(-1, -2).contiguous()] * 2)
                          for t in (c, e)]
                vals.append(kq._decode_cache_block(cache[-2][1], cache[-1][1])
                            .transpose(-1, -2).to(torch.bfloat16)
                            .contiguous())   # SDPA's fused kernels
            nb = tokens * KVH * (cache[0].shape[-2] + D // 16) * 2 \
                + 2 * q.numel() * 4
            if row == 10:
                kh, vh = (torch.randn(B, KVH, 1, D, generator=gen,
                                      device="cuda") for _ in range(2))
                run = lambda: kq.decode_attention_quantized_write(
                    q, *cache, kh, vh, p, 1, **kw)
                nb += 2 * kh.numel() * 4 + 2 * B * KVH * (D + D // 16)
            else:
                run = lambda: kq.decode_attention_quantized(q, *cache, p, 1,
                                                            **kw)
            qb = q.to(torch.bfloat16)
            sdpa = lambda: F.scaled_dot_product_attention(
                qb, vals[0], vals[1], attn_mask=mask, enable_gqa=True)
            line = {"row": row, "width": width, "shape": what}
            try:
                line.update(ms=timer(run), bound_ms=nb / rate * 1e3,
                            sdpa_ms=timer(sdpa),
                            kernels_ms=launch_split(torch, run))
            except ValueError as e:   # a shape this checkout refuses
                line["refused"] = str(e)
            print(json.dumps(line), flush=True)
            del cache, vals


def _row4(timer, launch_split, gen):
    from lqer_tpu_torch.ops.kernels import attention as k2
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
    from lqer_tpu_torch.parallel.collectives import mx8_decode, mx8_encode

    D = 128
    for BH, S in ((256, 64), (32, 2048)):
        q = block_fp_quantizer(
            torch.randn(BH, S, D, generator=gen, device="cuda"), width=8,
            exponent_width=8, block_size=[1, 16],
            skip_first_dim=True).to(torch.bfloat16)
        k, v = (mx8_decode(*mx8_encode(torch.randn(
            BH, S, D, generator=gen, device="cuda"), 16, 1.0), 16,
            torch.bfloat16) for _ in range(2))
        run = lambda: k2.quantized_attention(q, k, v, scale=D ** -0.5)
        print(json.dumps({
            "row": 4, "shape": f"{BH // 32} x {S} tokens", "ms": timer(run),
            "kernels_ms": launch_split(torch, run)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 5, 6, 10],
                    choices=[4, 5, 6, 10])
    rows = set(ap.parse_args().rows)
    if not torch.cuda.is_available():
        print("bench_attention_parts: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import Timer, card_line, launch_split

    print(f"card: {card_line()}", flush=True)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if 5 in rows:
        _row5(timer, launch_split, gen)
    if rows & {6, 10}:
        _rows_6_10(timer, launch_split, gen, rows)
    if 4 in rows:
        _row4(timer, launch_split, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
