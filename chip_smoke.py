#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its serving path on one
NVIDIA GPU (written for an H100).

Run from the repository root: ``python3 chip_smoke.py``. One line per phase:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the four kernels from ``lqer_tpu_torch/csrc`` (one nvcc each, in
   parallel);
3. each kernel against its plain PyTorch version on the card at the 7B
   serving shapes, held to the limits of ``lqer_tpu_torch/testing.py``
   (rtol = atol = 2e-4 plus one 8-bit code step of each quantizer a
   summation order can flip; ring and flush bytes bit-exact): max
   difference, kernel, plain, bound and library times (CUDA events,
   medians, L2 flushed between launches);
4. a 2-layer Llama at full 7B width, teacher-forced through an admission
   and 20 decode steps that cross a flush, three ways: through the kernels
   on the card, through the plain versions on the card, and through the
   plain versions on the CPU. Logits within LOGIT_MAX_STEPS and
   LOGIT_RMS_STEPS 8-bit code steps at every step for each pair; the main
   cache below ``flushed`` of kernels vs plain on the card equal on >= 99.9%
   and within one code step, and against the CPU within CACHE_CPU_STEPS. A
   fourth run through the kernels with one linear's correction left out
   must fail the RMS limit at every step;
5. ``DecodeEngine`` at Llama-2-7B shape (32 layers, rank 32, W8 head,
   mxint8-staged, 8 slots, max_len 2048) serving 8 greedy requests, then
   a torch.profiler window of 5 decode steps (device busy vs wall time);
6. the ``kernels`` JSON line: launches of each kernel in phase 5 and the
   phase-3 numbers.

The last line is ``{"ok": true, "device": {...}}``. Any failed phase raises
and the script exits non-zero; so does a machine without a CUDA device, or
a directory without the ``lqer_tpu_torch`` package next to this file.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
# Phase 4 limits, in 8-bit code steps of each logit row's scale
# (2^(ceil_log2(max |logit|) - 7)). Two sides that sum in different orders
# (kernels vs torch on the card, the card's libraries vs the CPU's) round a
# rare 8-bit activation, P or cache value one code step apart, and every
# later layer sums each flip into its 4096-wide products. On the H100 the
# flips moved the logits by at most 1.61 steps and 0.18 steps RMS; leaving
# out the rank-32 correction of layer 1's down_proj alone moved them by
# 0.59 to 0.72 steps RMS at every step (PERF.md). The RMS limit sits
# between, and phase 4 checks that it still rejects that run (a negative
# control).
LOGIT_MAX_STEPS = 4.0
LOGIT_RMS_STEPS = 0.4
# Main cache against the CPU: layer 0's K/V differ by single flips; each
# later layer inherits the flips of all before it through the residual
# stream, and the plain versions on the card diverge from the CPU exactly as
# much as the kernels do (7 steps at most in layer 1, PERF.md); the limit is
# twice that.
CACHE_CPU_STEPS = 14
# Fraction of a kernel's outputs allowed past the plain rtol/atol band: a
# flipped P rounding moves a whole output row, a flipped correction code
# one element (``testing.check_close``).
FLIPPED = {"dequant_gemm": 0.01, "attention": 0.05}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def peak_rates(name: str) -> tuple[float, float]:
    """(HBM bytes/s, dense bf16 ops/s) of the card from NVIDIA's data
    sheets: H100 SXM 3.35 TB/s and 989 TFLOP/s, H100 PCIe 2.0 TB/s and 756."""
    if "PCIe" in name:
        return 2.0e12, 756e12
    return 3.35e12, 989e12


class Timer:
    """Median CUDA-event time of one call; a 256 MB memset before each
    launch evicts L2, and a 1 ms spin keeps the card busy while the host
    enqueues the call, so host time stays out of the window."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 15) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_kernels(torch, timer, rates):
    """Phase 3: every kernel against its plain version at the 7B shapes."""
    import dataclasses

    import torch.nn.functional as F

    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.ops.kernels import attention as k2
    from lqer_tpu_torch.ops.kernels import cache_write as k4
    from lqer_tpu_torch.ops.kernels import decode_attention as k3
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
    from lqer_tpu_torch.ops.storage import dequantize_packed
    from lqer_tpu_torch.parallel.collectives import mx8_decode, mx8_encode
    from lqer_tpu_torch.serving.kernel_backend import pack_lm_head
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import (
        attention_limit,
        check_close,
        dequant_gemm_limit,
    )

    bw, ops_rate = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    results = {}

    def bound(nb, ops):
        t_bytes, t_ops = nb / bw * 1e3, ops / ops_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def act(shape):
        x = torch.randn(*shape, generator=gen, device="cuda")
        return block_fp_quantizer(x, width=8, exponent_width=8,
                                  block_size=[1, 16], skip_first_dim=True)

    # ---- kernel 1: the four linears of one layer and the W8 head, M = 8
    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_hidden_layers=1)
    backend, params, _ = build_random_model(cfg, rank=32, seed=SEED + 1)
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    backend = pack_lm_head(backend, params, width=8)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "err": 0.0, "of_limit": 0.0}
    bound_by = set()
    for name, key in (("qkv", "model.layers.0.self_attn.qkv_proj"),
                      ("o", "model.layers.0.self_attn.o_proj"),
                      ("gate|up", "model.layers.0.mlp.gateup_proj"),
                      ("down", "model.layers.0.mlp.down_proj"),
                      ("w8 head", "lm_head")):
        prep, meta = backend["arrays"][key], backend["meta"][key]
        fmt = meta["fmt"]
        K = prep["exps"].shape[0] * 16
        N = prep["exps"].shape[1]
        x = (act((8, K)) if key != "lm_head"
             else torch.randn(8, K, generator=gen, device="cuda")
             ).to(torch.bfloat16)
        kw = dict(quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        y = k1.qlinear_w4_fused(x, prep, fmt, **kw)
        ref = k1.qlinear_w4_plain(x, prep, fmt, **kw)
        c = check_close(f"kernel 1 {name}", y, ref,
                        dequant_gemm_limit(x, prep, ref, **kw),
                        FLIPPED["dequant_gemm"])
        err = c["max_abs_err"]
        w_dense = dequantize_packed(prep["codes"], prep["exps"], fmt).to(
            torch.bfloat16)
        ms = timer(lambda: k1.qlinear_w4_fused(x, prep, fmt, **kw))
        plain_ms = timer(lambda: k1.qlinear_w4_plain(x, prep, fmt, **kw), 5)
        lib_ms = timer(lambda: torch.matmul(x, w_dense))
        R = 0 if prep["a"] is None else prep["a"].shape[1]
        b_ms, b_by = bound(nbytes(x, prep["codes"], prep["exps"], prep["a"],
                                  prep["b"], prep["bias"]) + 8 * N * 4,
                           2 * 8 * N * K + 2 * 8 * R * (K + N))
        bound_by.add(b_by)
        print(f"kernel 1 dequant_gemm {name} M=8 K={K} N={N} R={R}: "
              f"max_abs_err={err:.3g} ({c['of_limit']:.3g} of its limit, "
              f"{c['flipped']:.4%} past 2e-4) kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} "
              "(torch.matmul, dense bf16 weight)", flush=True)
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("bound_ms", b_ms)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
        tot["of_limit"] = max(tot["of_limit"], c["of_limit"])
    results["dequant_gemm"] = dict(
        max_abs_err=tot["err"], of_limit=tot["of_limit"], ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"], bound_by="/".join(sorted(bound_by)),
        library_ms=tot["library_ms"],
        shape="sum over qkv, o, gate|up, down and the W8 head at M=8")
    del backend, params, w_dense

    # ---- kernel 2: 8 prompts x 64 tokens, 32 heads, d = 128
    BH, S, D = 8 * 32, 64, 128
    q = act((BH, S, D)).to(torch.bfloat16)
    k = mx8_decode(*mx8_encode(torch.randn(BH, S, D, generator=gen,
                                           device="cuda"), 16, 1.0),
                   16, torch.bfloat16)
    v = mx8_decode(*mx8_encode(torch.randn(BH, S, D, generator=gen,
                                           device="cuda"), 16, 1.0),
                   16, torch.bfloat16)
    scale = D ** -0.5
    y = k2.quantized_attention(q, k, v, scale=scale)
    ref = k2.quantized_attention_plain(q, k, v, scale=scale)
    c = check_close("kernel 2", y, ref, attention_limit(
        k2.prefill_scores(q, k, scale=scale), v, ref, p_width=8),
        FLIPPED["attention"])
    err = c["max_abs_err"]
    ms = timer(lambda: k2.quantized_attention(q, k, v, scale=scale))
    plain_ms = timer(lambda: k2.quantized_attention_plain(q, k, v,
                                                          scale=scale), 5)
    q4, k4_, v4 = (t.reshape(8, 32, S, D) for t in (q, k, v))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(q4, k4_, v4,
                                                          is_causal=True))
    b_ms, b_by = bound(nbytes(q, k, v) + BH * S * D * 4,
                       2 * 2 * BH * (S * (S + 1) // 2) * D)
    print(f"kernel 2 attention BH={BH} S=L={S} d={D}: max_abs_err={err:.3g} "
          f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past 2e-4) "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
          f"library_ms={lib_ms:.4f} (causal scaled_dot_product_attention)",
          flush=True)
    results["attention"] = dict(max_abs_err=err, of_limit=c["of_limit"],
                                ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib_ms,
                                shape="8 prompts x 64 tokens, 32 heads, d=128")

    # ---- kernel 3: B = 8, 32 kv heads, L = 2048, one layer
    B, KVH, L, SW = 8, 32, 2048, 64

    def cache_block(width):
        vals = torch.randn(B, KVH, width, D, generator=gen, device="cuda")
        c, e = mx8_encode(vals, 16, zero_fill=1.0)
        return (c.transpose(-1, -2).contiguous(),
                e.transpose(-1, -2).contiguous())

    kc, ke = cache_block(L)
    vc, ve = cache_block(L)
    rings = [*cache_block(SW), *cache_block(SW)]
    fl = torch.tensor([1984, 1952, 1920, 1024, 1536, 1984, 64, 1888],
                      dtype=torch.int32, device="cuda")
    pos = fl + torch.tensor([0, 1, 15, 47, 16, 33, 31, 40], dtype=torch.int32,
                            device="cuda")
    qd = torch.randn(B, 32, 1, D, generator=gen, device="cuda")
    kh = torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
    vh = torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
    r_k = [t.clone() for t in rings]
    r_p = [t.clone() for t in rings]
    y = k3.decode_attention_quantized_staged(qd, kc, ke, vc, ve, *r_k, kh, vh,
                                             pos, fl, scaling=scale)
    ref = k3.staged_decode_plain(qd, kc, ke, vc, ve, *r_p, kh, vh, pos, fl,
                                 scaling=scale)
    if not all(torch.equal(a, b) for a, b in zip(r_k, r_p)):
        raise AssertionError("kernel 3: ring bytes differ from the plain "
                             "version")
    sc, vals = k3.staged_scores(qd, kc, ke, vc, ve, *r_p, pos, fl,
                                scaling=scale)
    c = check_close("kernel 3", y, ref, attention_limit(
        sc[:, :, None, :], vals, ref, p_width=8), FLIPPED["attention"])
    del sc, vals
    err = c["max_abs_err"]
    ms = timer(lambda: k3.decode_attention_quantized_staged(
        qd, kc, ke, vc, ve, *r_k, kh, vh, pos, fl, scaling=scale))
    plain_ms = timer(lambda: k3.staged_decode_plain(
        qd, kc, ke, vc, ve, *r_p, kh, vh, pos, fl, scaling=scale), 5)
    flushed_tokens = int(fl.sum())
    per_token = KVH * (D + D // 16) * 2          # K and V codes + exps
    ring_valid = int((pos - fl + 1).sum())
    b_ms, b_by = bound(flushed_tokens * per_token + ring_valid * per_token
                       + nbytes(qd, kh, vh) + B * 32 * D * 4
                       + 2 * B * KVH * (D + D // 16),
                       2 * 2 * 32 * (flushed_tokens + ring_valid) * D)
    print(f"kernel 3 decode_attention B={B} KVH={KVH} L={L} "
          f"flushed={fl.tolist()} pos={pos.tolist()}: max_abs_err={err:.3g} "
          f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
          f"2e-4), rings bit-exact kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} library_ms=null", flush=True)
    results["decode_attention"] = dict(
        max_abs_err=err, of_limit=c["of_limit"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape="one layer, B=8, 32 kv heads, L=2048, flushed 64..1984")
    del kc, ke, vc, ve, rings, r_k, r_p

    # ---- kernel 4: one flush of 32 tokens over 32 layers
    NL = 32
    mains = [torch.randint(-127, 128, (NL, B, KVH, rows, L), generator=gen,
                           device="cuda", dtype=torch.int8)
             for rows in (D, D // 16, D, D // 16)]
    stages = [torch.randint(-127, 128, (NL, B, KVH, rows, SW), generator=gen,
                            device="cuda", dtype=torch.int8)
              for rows in (D, D // 16, D, D // 16)]
    f0 = torch.tensor([0, 32, 64, 96, 1024, 1984, 2000 - 16, 512],
                      dtype=torch.int32, device="cuda")
    f0 = (f0 // 32) * 32
    f1 = f0 + 32
    m_plain = [m.clone() for m in mains]
    k4.flush_stage_to_main(tuple(mains), tuple(stages), f0, f1)
    k4.flush_plain(tuple(m_plain), tuple(stages), f0, f1)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(mains, m_plain)):
        raise AssertionError("kernel 4: flush bytes differ")
    ms = timer(lambda: k4.flush_stage_to_main(tuple(mains), tuple(stages),
                                              f0, f1))
    plain_ms = timer(lambda: k4.flush_plain(tuple(m_plain), tuple(stages),
                                            f0, f1), 3)
    moved = NL * B * KVH * (D + D // 16) * 2 * 32
    b_ms, b_by = bound(2 * moved, 0)
    print(f"kernel 4 cache_write flush NL={NL} B={B} 32 tokens: bit-exact "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
          "library_ms=null", flush=True)
    results["cache_write"] = dict(
        max_abs_err=0.0, of_limit=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape="one flush of 32 tokens, 32 layers, 8 slots, 32 kv heads")
    del mains, stages, m_plain
    torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def plain_versions_on_card():
    """Route the served path's kernel calls to the plain versions, which
    then run on CUDA tensors; every launch counter must stay at 0."""
    from lqer_tpu_torch.ops.kernels import attention as k2
    from lqer_tpu_torch.ops.kernels import cache_write as k4
    from lqer_tpu_torch.ops.kernels import decode_attention as k3
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.serving import decode, kernel_backend

    swaps = [(kernel_backend, "qlinear_w4_fused", k1.qlinear_w4_plain),
             (decode, "qlinear_w4_fused", k1.qlinear_w4_plain),
             (decode, "decode_attention_quantized_staged",
              k3.staged_decode_plain),
             (decode, "flush_stage_to_main", k4.flush_plain),
             (k2, "quantized_attention", k2.quantized_attention_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    reset_launch_counts()
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    if any(launch_counts().values()):
        raise AssertionError(f"a kernel ran in the plain pass: "
                             f"{launch_counts()}")


def phase_teacher_forced(torch):
    """Phase 4: kernels on the card vs plain versions on the card and on
    the CPU, teacher-forced with the kernels' greedy tokens."""
    import dataclasses

    import numpy as np

    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import cache_agreement, logits_steps

    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_hidden_layers=2)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=SEED + 2)
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    cpu_backend = {"arrays": {k: {n: None if t is None else t.cpu()
                                  for n, t in v.items()}
                              for k, v in backend["arrays"].items()},
                   "meta": dict(backend["meta"])}
    kw = dict(num_slots=8, max_len=256, lm_head_width=8)
    # the negative control: the kernels with one linear's correction left
    # out (of the layers' o, qkv and down, the one whose loss moved the
    # logits least)
    broken = {"arrays": dict(backend["arrays"]), "meta": backend["meta"]}
    key = "model.layers.1.mlp.down_proj"
    broken["arrays"][key] = dict(broken["arrays"][key],
                                 b=torch.zeros_like(backend["arrays"][key]["b"]))
    engines = {
        "kernels": DecodeEngine(params, cfg, qcfgs, pallas_backend=backend,
                                device="cuda", **kw),
        "plain": DecodeEngine(params, cfg, qcfgs, pallas_backend=backend,
                              device="cuda", **kw),
        "cpu": DecodeEngine({k: v.cpu() for k, v in params.items()}, cfg,
                            qcfgs, pallas_backend=cpu_backend, device="cpu",
                            **kw),
        "no correction": DecodeEngine(params, cfg, qcfgs,
                                      pallas_backend=broken, device="cuda",
                                      **kw)}
    rng = np.random.default_rng(SEED)
    prompt_len = 63                      # 63 = 32 + 31: residue 31
    padded = rng.integers(0, cfg.vocab_size, (8, 64))
    lengths = np.full(8, prompt_len, dtype=np.int32)
    steps = 20
    t0 = time.perf_counter()
    logits = {}
    tokens = []
    for name, engine in engines.items():
        ctx = (plain_versions_on_card() if name == "plain"
               else contextlib.nullcontext())
        with ctx:
            lg = engine.prefill(padded, np.arange(8), lengths)
            engine.lengths[:] = lengths
            logits[name] = [lg.float().cpu()]
            for i in range(steps):
                if name == "kernels":
                    tokens.append(torch.argmax(lg, -1).cpu().numpy())
                lg = engine.decode_logits(tokens[i])
                engine.lengths += 1
                logits[name].append(lg.float().cpu())
    fl = engines["kernels"].cache["flushed"].tolist()
    if min(fl) < 64:
        raise AssertionError(f"phase 4 did not cross a flush: {fl}")
    failed = []
    for one, other in (("kernels", "plain"), ("kernels", "cpu"),
                       ("plain", "cpu"), ("kernels", "no correction")):
        seen = [logits_steps(a, b) for a, b in zip(logits[one],
                                                   logits[other])]
        worst = max(m for m, _ in seen)
        rms = max(r for _, r in seen)
        least = min(r for _, r in seen)
        frac, cache_steps = cache_agreement(engines[one].cache,
                                            engines[other].cache)
        print(f"teacher-forced 2-layer 7B-width path, {one} vs {other} "
              f"({'CPU' if other == 'cpu' else 'card'}): admission + {steps} "
              f"decode steps, logits |diff| in code steps max {worst:.3g} "
              f"(limit {LOGIT_MAX_STEPS}), RMS {least:.3g} to {rms:.3g} "
              f"(limit {LOGIT_RMS_STEPS}); flushed={fl}, main cache bytes "
              f"equal {frac:.6f}, largest value diff {cache_steps:.3g} code "
              f"step(s), {time.perf_counter() - t0:.1f}s", flush=True)
        if other == "no correction":
            if least <= LOGIT_RMS_STEPS:
                failed.append("the RMS limit passed a missing correction")
            continue
        if worst > LOGIT_MAX_STEPS or rms > LOGIT_RMS_STEPS:
            failed.append(f"{one} vs {other}: logits")
        if other == "plain" and (frac < 0.999 or cache_steps > 1):
            failed.append(f"{one} vs {other}: cache")
        if other == "cpu" and cache_steps > CACHE_CPU_STEPS:
            failed.append(f"{one} vs {other}: cache")
    if failed:
        raise AssertionError(f"phase 4 past its limits: {failed}")
    del engines, backend, broken, params, cpu_backend
    torch.cuda.empty_cache()


def phase_serve(torch, layers: int = 32):
    """Phase 5: the engine at Llama-2-7B shape; returns launch counts."""
    import numpy as np

    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.serving import DecodeEngine, Request
    from lqer_tpu_torch.serving.random_model import build_random_model

    import dataclasses

    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_hidden_layers=layers)
    t0 = time.perf_counter()
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=SEED + 3)
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    engine = DecodeEngine(params, cfg, qcfgs, num_slots=8, max_len=2048,
                          pallas_backend=backend, consume_backend=True,
                          lm_head_width=8, device="cuda")
    del backend
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 5)
    reqs = [Request(prompt_ids=[int(t) for t in rng.integers(
        0, cfg.vocab_size, int(n))], max_new_tokens=80)
        for n in rng.integers(20, 65, 8)]
    step_ms, admit_ms = [], []
    decode_logits, prefill = engine.decode_logits, engine.prefill

    def timed_decode(tokens):
        t = time.perf_counter()
        out = decode_logits(tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_prefill(*a):
        t = time.perf_counter()
        out = prefill(*a)
        torch.cuda.synchronize()
        admit_ms.append((time.perf_counter() - t) * 1e3)
        return out

    engine.decode_logits, engine.prefill = timed_decode, timed_prefill
    reset_launch_counts()
    t1 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    finished = sum(r.done for r in reqs)
    produced = sum(len(r.output_ids) for r in reqs)
    fl = engine.cache["flushed"].tolist()
    if finished != len(reqs) or min(fl) == 0:
        raise AssertionError(f"serve: {finished}/{len(reqs)} finished, "
                             f"flushed={fl}")
    decode_s = sum(step_ms) / 1e3
    print(f"serve Llama-2-7B shape {layers} layers rank 32 W8 head "
          f"mxint8-staged 8 slots max_len 2048: {finished} requests "
          f"finished, {produced} tokens, median decode step "
          f"{statistics.median(step_ms):.2f} ms over {len(step_ms)} steps, "
          f"{8 * len(step_ms) / decode_s:.1f} tok/s (8 slots x steps / "
          f"decode time), admission {sum(admit_ms):.1f} ms, "
          f"{counts['cache_write']} flushes, flushed={fl}, wall "
          f"{wall:.2f}s, packing {pack_s:.1f}s", flush=True)
    profile_steps(torch, decode_logits)
    del engine
    torch.cuda.empty_cache()
    return counts


def profile_steps(torch, decode_logits, steps: int = 5) -> None:
    """Device busy time of decode steps (torch.profiler, kernel self time)
    against their wall time, and the kernels that take the most of it."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    tokens = np.zeros(8, dtype=np.int64)
    decode_logits(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            decode_logits(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    if not events:
        print(f"profile of {steps} decode steps: {wall_ms:.2f} ms wall per "
              "step; device time not recorded by torch.profiler (not "
              "measured)", flush=True)
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / steps:.2f}"
                      for e in top)
    # the port's kernels sit in anonymous namespaces of csrc/*.cu; PyTorch's
    # own anonymous ones are inside at::
    tag = "(anonymous namespace)::"
    ours = "; ".join(
        f"{e.key.split(tag)[1].split('(')[0]} "
        f"{e.self_device_time_total / 1e3 / steps:.3f} ms per step, "
        f"{e.self_device_time_total / e.count:.1f} us per launch"
        for e in events if tag in e.key and "at::" not in e.key)
    print(f"profile of {steps} decode steps (torch.profiler): device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall per step "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler overhead "
          f"included); top device ms per step: {names}; the port's "
          f"kernels: {ours}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lqer_tpu_torch.ops.kernels import KERNELS
    from lqer_tpu_torch.ops.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rates = peak_rates(name)
    print(f"card: {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | peaks {rates[0] / 1e12:.2f} TB/s, "
          f"{rates[1] / 1e12:.0f} TFLOP/s bf16", flush=True)
    secs = build_all()
    print(f"build: 4 kernels (nvcc sm_90a) in {secs:.1f}s", flush=True)
    timer = Timer(torch)
    results = phase_kernels(torch, timer, rates)
    phase_teacher_forced(torch)
    counts = phase_serve(torch)
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    kernels = []
    for k, (_, source, replaces) in KERNELS.items():
        r = results[k]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
