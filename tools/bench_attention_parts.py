#!/usr/bin/env python3
"""Where the time of rows 4 and 5 goes, on one card.

    python3 tools/bench_attention_parts.py

Row 5 (fp-cache decode attention, ``ops/kernels/fp_decode.py``) at
``chip_smoke.py``'s phase-3 shapes (Llama-2-7B: 8 slots x 32 kv heads,
L = 2048, positions 64..1984; Mistral-7B: 8 slots x 8 kv heads of 4
queries, L = 8192, positions 6000..6030, window 4096): the served launch,
the same launch with K and V left unquantized (``k_width=v_width=None``),
and each of its kernels' device time (torch.profiler). Row 4 (prefill
attention, ``ops/kernels/attention.py``) at 8 prompts x 64 tokens and one
prompt of 2048 tokens, 32 heads, d = 128: the launch and each of its two
kernels' device time. Times are medians of CUDA events with L2 flushed
before each launch (``chip_smoke.Timer``); one JSON line per shape, the
card's name and power limit first. Needs one CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def kernel_ms(fn, n: int = 5) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("(")[0]:
            round(e.self_device_time_total / n / 1e3, 4)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_attention_parts: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import Timer, card_line
    from lqer_tpu_torch.ops.kernels import attention as k2
    from lqer_tpu_torch.ops.kernels import fp_decode as kfp
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
    from lqer_tpu_torch.parallel.collectives import mx8_decode, mx8_encode

    print(f"card: {card_line()}", flush=True)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    D = 128
    for what, B, KVH, L, pos, win in (
            ("Llama", 8, 32, 2048,
             [64, 303, 560, 815, 1088, 1343, 1600, 1984], None),
            ("Mistral", 8, 8, 8192,
             [6000, 6001, 6003, 6007, 6010, 6013, 6021, 6030], 4096)):
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        q = torch.randn(B, 32, 1, D, generator=gen, device="cuda")
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
            "kernels_ms": kernel_ms(served)}), flush=True)
        del k, v
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
            "kernels_ms": kernel_ms(run)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
