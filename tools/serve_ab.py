#!/usr/bin/env python3
"""Time the port's serving path in two or more checkouts on one card, in
one call, so that the host's speed (which varies between machines) is the
same for each.

    python3 tools/serve_ab.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``lqer_tpu_torch`` package (for
example ``build/parent`` made with ``git archive``, and ``.``); list them
as parent, change, change, parent. Each runs in its own process, one after
another, and builds the Llama-2-7B-shape model of ``chip_smoke.py``'s
serve phase with its own default packing (32 layers, seeded random
weights, rank 32, W8 head, ``mxint8-staged``, 8 slots, max_len 2048). It
then times, on the host clock around synchronised calls:

- three 8 x 64-token admissions (512 rows),
- 40 decode steps of all 8 slots after the last admission, then the
  device busy time of 5 more (torch.profiler: the summed kernel time a
  step),
- one 2048-token admission into slot 0 (fresh cache, last logits only),
  after one untimed warm-up, twice.

Then, from the same packing, the ``bfloat16`` cache (8 slots, max_len
2048): 40 decode steps from position 64 and the device busy time of 5
more, with the row write's (row 11) device time a step. Then Llama-2-7B
on the ``mxint8``, ``mxint8-staged`` and ``mxint4-staged`` caches (the
last with the KV4 configuration) at 4 slots, max_len 32768 (past the
one-pass length: the fused encode + write and the streaming decode kernel
row 8, or the streaming staged kernel row 9), 10 decode steps from
position 32000 over a context built by the checkout's
``chip_smoke.fill_context`` (a staged cache flushed to 32000), after two
untimed ones, and the device busy time of 5 more (on ``mxint8`` also the
device time a step of the fused encode + write, row 13: the kernels whose
name holds ``encode_``).

Then, the Llama engines freed, it builds Mistral-7B-v0.1 (32 layers, rank
128, W8 head, window 4096) on the ``bfloat16`` cache, 8 slots, max_len
8192, fills every slot's cache with seeded random rows up to position
6000 and times 20 decode steps from there (the fp-cache decode kernel
reads the window's 4096 keys a slot), after two untimed ones; then the
same on the direct ``mxint8`` cache (the context built by
``chip_smoke.fill_context``), with the device busy time of 5 more steps.

Each process prints one JSON line; the card's name and power limit come
first. Needs one CUDA device.
"""

from __future__ import annotations

import json
import inspect
import statistics
import subprocess
import sys
import time
from pathlib import Path


def child(root: str) -> None:
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    import lqer_tpu_torch
    from lqer_tpu_torch import models
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.ops.kernels._build import build_all
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import (
        KV4_Q_CONFIG,
        build_random_model,
    )

    if not Path(lqer_tpu_torch.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise RuntimeError(f"imported {lqer_tpu_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    # the stacked engine (``scan_layers=True``) in every checkout; an
    # engine without ``scan_layers`` serves only that one
    stacked = ({"scan_layers": True} if "scan_layers" in
               inspect.signature(DecodeEngine).parameters else {})
    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_hidden_layers=32)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=3)
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    engine = DecodeEngine(params, cfg, qcfgs, num_slots=8, max_len=2048,
                          cache_dtype="mxint8-staged",
                          pallas_backend=backend, lm_head_width=8,
                          device="cuda", **stacked)
    rng = np.random.default_rng(5)

    def timed(fn, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*a)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    ids = rng.integers(0, cfg.vocab_size, (8, 64))
    full = np.full(8, 64, dtype=np.int32)
    admission = [timed(engine.prefill, ids, np.arange(8), full)
                 for _ in range(3)]
    engine.lengths[:] = full
    tokens = np.zeros(8, dtype=np.int64)
    steps = []
    for _ in range(40):
        steps.append(timed(engine.decode_logits, tokens))
        engine.lengths += 1
    llama_busy, _ = device_busy_ms(torch, engine, tokens)
    long_ids = rng.integers(0, cfg.vocab_size, (1, 2048))
    long_args = (long_ids, np.zeros(1, dtype=np.int64),
                 np.full(1, 2048, dtype=np.int32))
    engine.prefill(*long_args)
    long = [timed(engine.prefill, *long_args) for _ in range(2)]
    del engine
    torch.cuda.empty_cache()
    out = {}
    engine = DecodeEngine(params, cfg, qcfgs, num_slots=8, max_len=2048,
                          cache_dtype="bfloat16", pallas_backend=backend,
                          lm_head_width=8, device="cuda", **stacked)
    engine.lengths[:] = 64
    steps_bf16 = []
    for _ in range(40):
        steps_bf16.append(timed(engine.decode_logits, tokens))
        engine.lengths += 1
    busy, row11 = device_busy_ms(torch, engine, tokens, "row_write_kernel")
    out.update(llama_bf16_step_ms_median=statistics.median(steps_bf16),
               llama_bf16_step_device_busy_ms=busy,
               llama_bf16_row_write_device_ms_per_step=row11)
    del engine
    torch.cuda.empty_cache()
    kv4 = models.quantize_model(cfg, KV4_Q_CONFIG, {"linear": {"rank": 32}})
    for cache_dtype, layer_qcfgs in (("mxint8", qcfgs),
                                     ("mxint8-staged", qcfgs),
                                     ("mxint4-staged", kv4)):
        med, busy, row13 = llama_long_steps(torch, timed, cfg, params,
                                            layer_qcfgs, backend, cache_dtype)
        out[f"llama_{cache_dtype}_32k_step_ms_median"] = med
        out[f"llama_{cache_dtype}_32k_step_device_busy_ms"] = busy
        if cache_dtype == "mxint8":
            out["llama_mxint8_32k_row13_device_ms_per_step"] = row13
    del backend, params
    torch.cuda.empty_cache()
    mistral, _ = mistral_steps(torch, timed)
    mistral8, mistral8_busy = mistral_steps(torch, timed, "mxint8")
    print(json.dumps({"root": root, "admission_8x64_ms": admission,
                      "decode_step_ms_median": statistics.median(steps),
                      "decode_steps_ms": [round(t, 2) for t in steps],
                      "decode_step_device_busy_ms": llama_busy,
                      "admission_2048_ms": long,
                      "mistral_bf16_step_ms_median":
                          statistics.median(mistral),
                      "mistral_bf16_steps_ms":
                          [round(t, 2) for t in mistral],
                      "mistral_mxint8_step_ms_median":
                          statistics.median(mistral8),
                      "mistral_mxint8_step_device_busy_ms": mistral8_busy,
                      **out}),
          flush=True)


def device_busy_ms(torch, engine, tokens, kernel: str = "",
                   steps: int = 5) -> tuple[float, float | None]:
    """The summed device time of the kernels of one decode step, and that
    of the kernels whose name holds ``kernel`` (None without one):
    torch.profiler, mean over ``steps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.decode_logits(tokens)
            engine.lengths += 1
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps
    part = (sum(e.self_device_time_total for e in events if kernel in e.key)
            / 1e3 / steps) if kernel else None
    return busy, part


def mistral_steps(torch, timed, cache_dtype: str = "bfloat16",
                  position: int = 6000) -> tuple[list[float], float | None]:
    """20 decode steps of Mistral-7B on ``cache_dtype``, 8 slots at
    ``position`` onwards over a context of seeded random rows, and (on a
    quantized cache) the device busy ms of 5 more."""
    import numpy as np

    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import build_random_model

    cfg = LlamaConfig.mistral_7b()
    backend, params, qcfgs = build_random_model(cfg, rank=128, seed=4)
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    engine = DecodeEngine(params, cfg, qcfgs, num_slots=8, max_len=8192,
                          cache_dtype=cache_dtype, pallas_backend=backend,
                          consume_backend=True, lm_head_width=8,
                          device="cuda", **stacked)
    del backend
    if cache_dtype == "bfloat16":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(6)
        for key in ("k", "v"):
            engine.cache[key][..., :position, :].normal_(generator=gen)
        engine.lengths[:] = position
    else:
        from chip_smoke import fill_context

        fill_context(torch, {"card": engine}, np.full(8, position), seed=6)
    tokens = np.zeros(8, dtype=np.int64)
    steps = []
    for i in range(22):
        ms = timed(engine.decode_logits, tokens)
        engine.lengths += 1
        if i >= 2:
            steps.append(ms)
    busy = (None if cache_dtype == "bfloat16"
            else device_busy_ms(torch, engine, tokens)[0])
    del engine
    torch.cuda.empty_cache()
    return steps, busy


def llama_long_steps(torch, timed, cfg, params, qcfgs, backend,
                     cache_dtype: str, position: int = 32000
                     ) -> tuple[float, float, float]:
    """The median of 10 decode steps of ``cfg`` on ``cache_dtype``, 4
    slots at max_len 32768, from ``position`` onwards over a context of
    seeded random rows (a staged cache flushed to ``position``), the
    device busy ms of 5 more, and the part of it in kernels named
    ``encode_`` (row 13)."""
    import numpy as np

    from chip_smoke import fill_context
    from lqer_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(params, cfg, qcfgs, num_slots=4, max_len=32768,
                          cache_dtype=cache_dtype, pallas_backend=backend,
                          lm_head_width=8, device="cuda", **stacked)
    fill_context(torch, {"card": engine}, np.full(4, position), seed=17)
    if "flushed" in engine.cache:
        engine.cache["flushed"].fill_(position)
    tokens = np.zeros(4, dtype=np.int64)
    steps = []
    for i in range(12):
        ms = timed(engine.decode_logits, tokens)
        engine.lengths += 1
        if i >= 2:
            steps.append(ms)
    busy, row13 = device_busy_ms(torch, engine, tokens, "encode_")
    del engine
    torch.cuda.empty_cache()
    return statistics.median(steps), busy, row13


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--child", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
