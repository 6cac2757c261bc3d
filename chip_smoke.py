#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its serving path on one
NVIDIA GPU (written for an H100).

Run from the repository root: ``python3 chip_smoke.py``. One line per phase:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the nine sources of ``lqer_tpu_torch/csrc`` (one nvcc each, in
   parallel), which hold the fifteen kernel entries (the megakernel
   counted twice: its gated and its relu variant);
3. each kernel against its plain PyTorch version on the card at the 7B
   serving shapes, held to the limits of ``lqer_tpu_torch/testing.py``
   (rtol = atol = 2e-4 plus one 8-bit code step of each quantizer a
   summation order can flip; ring, flush, row-write, written-column and
   unpacked weight bytes bit-exact): max difference, kernel, plain, bound
   and library times (CUDA events, medians, L2 flushed between launches).
   Kernel 1 runs at 8 rows on the main path's linears and on gate|up and
   down of the ``fuse_mlp=False`` packing, the MLP megakernel at 8 and 256
   rows, the unpack kernel on the five weights of a layer, the large-M
   route (q|k|v and the whole MLP) at 2048 rows, the prefill attention
   kernel at 8 x 64 and at 1 x 2048 tokens; the decode kernels at 8 slots,
   32 kv heads, L = 2048 and positions 64..1984: staged (with the flush),
   fp-cache, quantized at widths 8 and 4, the fused MXINT8 write + attend,
   and the row write in both orientations; the long-context kernels at 8
   slots, 32 kv heads, L = 32768 and positions 64..32767: streaming decode
   at widths 8 and 4, streaming staged decode (rings bit-exact), the staged
   decode kernel (row 7) at n_rep 2, d 64, 16 kv heads against its plain
   version and against the streaming staged kernel on the same inputs
   (rings bit-exact; row 7 held its score rows in shared memory and refused
   this shape until it split L), the fused
   MXINT8 encode + write (columns bit-exact), and at L = 24576 each
   streaming kernel against its one-pass kernel on the same inputs; then
   OPT's modes at OPT-6.7B width: the megakernel's relu variant with
   biases at 8 and 256 rows, kernel 1 with a bias on q|k|v and out_proj,
   and the fp-cache, MXINT4, fused write + attend and staged decode kernels
   with the query scaled before its quantizer (``scale_query``); then
   Mistral-7B-v0.1's shapes at rank 128: kernel 1 on q|k|v (fused rank 384)
   and o and the megakernel at 8 and 256 rows, the unpack kernel, the row
   write and the fused encode + write at 8 kv heads, and the decode kernels
   with the sliding window (4096) at 8 slots of 32 heads over 8 kv heads:
   rows 5, 6 (widths 8 and 4) and 10 at L = 8192, row 8 at L = 32768, each
   also timed without the window, against ``scaled_dot_product_attention``
   with the window mask (row 5 also without the window against SDPA with
   the causal mask, and at L = 12288 near position 12000, the bf16 cache's
   longest length); rows 6 and 10 print each launch's device time
   (torch.profiler) beside their own; then facebook/opt-2.7b's decode
   shape (8 slots, 32 heads of d = 80, L = 2048): rows 6 (width 8), 7,
   8, 9 and 10 on one MXINT8 cache (rings and the written column
   bit-exact); then the staged MXINT4 cache's rows 7 (L = 2048)
   and 9 (L = 32768) at code width 4 (rings bit-exact), kernel 1 (q|k|v,
   o) and the gated megakernel with the in-kernel activation quantizer
   (``quant_x_width = 8``, raw f32 X: the serving path's route below 512
   rows) at M = 8 at Llama's rank 32 and Mistral's 128, each equal to the
   launch fed the separate quantizer's values and timed beside quantizer +
   kernel, and the row write of every
   layer (32 layers x 8 slots x 32 kv heads, L = 2048; MXINT8 and MXINT4
   columns and bf16 rows) bit-exact with its plain version and with 32
   single-layer launches, beside ``index_put_``; rows 9 and 11 to 14 also
   print their earlier kernels' times (EARLIER_MS); then rows 5 and 11 over
   the ``float32`` cache (``phase_f32_kernels``: row 5 at 8 slots x 32 kv
   heads at L = 2048 and at the f32 one-pass length, 6144, beside SDPA on
   the f32 values; row 11's f32 rows bit-exact, beside ``index_put_``);
   last, an empty launch under the same timer, the floor of the
   launch-bound cache writes;
4. a 2-layer Llama at full 7B width, packed as the JAX package packs by
   default (each MLP whole, for the megakernel), teacher-forced through an
   8 x 64-token admission (512 rows: the large-M route) and 20 decode
   steps (the megakernel), per cache: ``mxint8-staged`` (crossing a flush),
   ``mxint4-staged`` (the KV4 configuration, with its control and against
   a direct-write ``mxint4`` engine fed the same tokens), ``bfloat16``,
   ``mxint8`` at max_len 256 and 272, and ``mxint4`` (the KV4
   configuration), each three ways: through the kernels on the card,
   through the plain versions on the card, and through the plain versions
   on the CPU, each packed weight decoded once (the 272 run on the card
   only); then ``mxint8``, ``mxint8-staged`` and ``mxint4`` at max_len
   24576 (the streaming routes), kernels against plain versions on the
   card over prompts of 500..600 tokens, and against the CPU (one slot,
   LONG_CPU_STEPS steps) from a copy of the card's cache at positions
   520.. and over the short prompts, then kernels against plain versions
   on the card from a context built to SPAN_EDGE_POSITIONS (decode
   positions and the staged slots' flushed on both sides of the
   streaming kernels' 2048-token span edge). Logits within
   LOGIT_MAX_STEPS and LOGIT_RMS_STEPS 8-bit code steps at every step for
   each pair; the cache (below ``flushed`` for the staged one) of kernels
   vs plain on the card equal on >= 99.9% and within one code step (a
   direct-write cache: in layer 0, and in later layers, whose
   decode-written K/V carry a flipped p of the layers before, within the
   CPU limit), and against the CPU within CACHE_CPU_STEPS (the MXINT4
   cache within CACHE_CPU_STEPS_MXINT4 4-bit steps); at long context a
   staged cache's decode-written tokens, once flushed, as a direct-write
   cache's. A run through the
   kernels with layer 1's down correction left out must fail the RMS limit
   at every step; the direct-write ``mxint8`` runs must match staged runs
   fed the same tokens as the kernels match the plain versions. Then the
   same model packed with ``fuse_mlp=False`` (gate|up and down through
   kernel 1), kernels vs plain versions on the card, the same limits;
   then a 2-layer OPT at OPT-6.7B width (vocab 50272, dense head) the same
   way: ``mxint8-staged`` (with its negative control, layer 1's fc2
   correction left out) and ``bfloat16`` three ways, ``mxint8`` and
   ``mxint4`` (KV4) kernels vs plain versions on the card; a 2-layer
   OPT-350m (post-LN, ``project_in``/``project_out``, d = 64) on
   ``bfloat16`` three ways with its control, under its own tighter RMS
   limit (LOGIT_RMS_STEPS_OPT350M); then a 2-layer Mistral at
   rank 128, max_len 8192, per cache (``bfloat16``, ``mxint8``, ``mxint4``):
   an eager windowed admission and 4 steps three ways, then the context
   built to positions 4500..7777 and 8 steps past the window, kernels vs
   plain versions on the card (on ``bfloat16`` the runs without the window
   and without layer 1's down correction must fail the limits), then the
   kernels, the plain versions on the card and the plain versions on the
   CPU (4 slots each), the last two from a copy of the kernels' cache,
   held to one another. The eager engine (``scan_layers=False``, the JAX
   package's default) of the 2-layer Llama on ``mxint8-staged`` and
   ``bfloat16`` at max_len 256 against the stacked engine on the card,
   fed the same tokens: logits and caches equal bit for bit, its launches
   per layer those of ``decode_route(eager=True)``; the emulated engine
   (no backend, the same weights kept dense: ``build_random_dense_model``)
   on ``bfloat16`` at max_len 64 and ``float32`` at 256 against itself on
   the CPU and against the backend engine on the card (on ``float32``
   its decode steps through row 5's f32 entry).
   Every CPU side runs in a pool of spawned worker processes
   (``CpuPool``: ``os.cpu_count() // workers`` threads each, at a lower
   priority, tensors through files) beside the card's runs, compared once
   the pool is joined, before phase 5; the CPU runs decode CPU_STEPS
   steps; the models run as Mistral, Llama, OPT-6.7B, OPT-350m, each's
   runs with the longest CPU sides first;
5. ``DecodeEngine`` at Llama-2-7B shape (32 layers, rank 32, W8 head, 8
   slots, max_len 2048) serving 8 greedy requests over each cache
   (``mxint8-staged`` and ``mxint4-staged`` 80 new tokens each, the others
   40; ``mxint4-staged`` must launch rows 7 and 9 at code width 4), a
   torch.profiler window of 5 decode steps per cache (device busy vs wall
   time, each kernel's time per launch), and on the staged cache a
   profile of one 8 x 64-token admission, then one 2048-token admission
   (one slot, fresh cache, last logits only) and its profile; the same
   mix (80 new tokens, ``mxint8-staged``, the f32 embedding) through the
   stacked engine and then the eager engine, each with a profile of 5
   decode steps, greedy tokens equal, the eager run launching rows 1, 2,
   3, 4, 7 and 14; then, per MXINT cache (the staged MXINT4 one too), 4 slots at max_len 32768: the
   same requests with 16 new tokens, and 10 decode steps at positions
   32000.. over a cache filled by tiling one encoded block of 2048 seeded
   rows (median step, tok/s, a profile of 5 steps beside the predicted
   cache-read floor); then the serving CLI (``python -m
   lqer_tpu_torch.serving.cli`` on ``llama-tiny-pallas.toml --pallas
   --max-len 64``) on the card and with ``--device cpu``, each a
   subprocess, token lines equal; then
   ``tools/bench_streaming_staged.py``'s chains
   at its defaults (row 9; row 12 + row 8), once each, and its marginal ms
   per layer-step; then, the Llama engine freed, ``DecodeEngine`` at
   OPT-6.7B shape (32 layers, rank 32, dense head, 8 slots, max_len 2048)
   serving the same mix over ``bfloat16`` (40 new tokens) and
   ``mxint8-staged`` (80), a profile of 5 decode steps each, and one
   2048-token admission with its profile; then Mistral-7B (32 layers,
   rank 128, W8 head; 16 of its 32 layers) at 8 slots, max_len 8192,
   over ``bfloat16``,
   ``mxint8-staged`` (falling back to ``mxint8``) and ``mxint4``: the mix
   with 40 new tokens, 10 steps at positions 6000.. with a profile, on
   ``bfloat16`` one eager 2048-token admission; ``bfloat16`` at max_len
   12288 (8 slots, 10 steps at 12000..); and ``mxint8`` at 4 slots,
   max_len 32768, 10 steps near 32000; then OPT-350m (24 layers) serving
   the mix over ``bfloat16`` with a profile; then OPT-2.7b (32 layers of
   32 heads of d = 80, rank 32, dense head, 8 slots, max_len 2048) over
   ``bfloat16`` and ``mxint8`` (40 new tokens) and ``mxint8-staged`` (80,
   then one 2048-token admission), a profile each;
   then the ``float32`` cache served (``phase_f32_engine``): the 2-layer
   Llama of phase 4 with the kernel backend at 8 slots, max_len 256,
   stacked and eager, kernels against the plain versions on the card
   (phase 4's limits; each decode step launches row 11 then row 5 per
   layer stacked, row 5 eager, both over f32);
6. the offline pipeline (``runners.run_pipeline``: profile → approximate →
   perplexity) on the card at Llama-2-7B width, 2 layers (a checkpoint of
   seeded dense weights through ``model_dir``), W4A8 lqer-act at rank 32
   (``experiments/configs/template/llama-2-7b.toml``'s quantizers),
   synthetic data at max_length 2048: 4 calibration sequences, the 14
   linears' SVDs on the card (``torch.linalg.svd``), the perplexity of 4
   test sequences at batch 1 through the kernel backend and the fused
   prefill attention (2048 rows: row 4 and, on the packed linears, the
   large-M route of row 2), then resumed from
   ``config_after_approximation.toml`` at max_length 256 (row 4 and, on
   the packed linears, row 1; row 3 only where a layer's whole MLP packs).
   A linear whose A or B holds a value the 8-bit quantizer passed through
   at |v| <= 1e-8 (not exact in bf16) runs the emulation, as in JAX: the
   pipeline-made model has packed 5 or 7 of its 14 linears and no whole
   MLP, so row 3 runs only in the 32-layer evaluation below. Each stage's
   wall time, the rows each evaluation launched, its launches held to the
   packed entries (at least one), layers and batches. The same evaluation
   through the plain versions on the card (test batch 0's logits within
   LOGIT_MAX_STEPS and LOGIT_RMS_STEPS, the perplexity within
   PIPELINE_PPL_RTOL), and ``disable_lqer`` (a negative control: its
   logits must fall outside those limits); against the CPU, in 2 spawned
   workers beside the card's runs, the scale dict of the same calibration
   batches (rtol 1e-3) and ``A_q B_q`` of PIPELINE_CPU_WEIGHTS (one of each
   shape, from the card's scales; PIPELINE_PRODUCT_REL_ERR); then the
   perplexity alone at 32 layers (``build_random_model``'s seeded rank-32
   factors, no SVD) on PIPELINE_FULL_BATCHES batches of 2048 tokens and
   one of 256, with a profile of one batch and the launches held. On
   the same 2-layer model, before the 32-layer one: the harness stage
   (``run_pipeline`` resumed with it on and the template's task names:
   skipped without lm_eval, as in JAX; then every ``tiny_*`` task on
   ``ByteTokenizer``, through the kernels and through the plain versions
   on the card, accuracies equal and the rest within HARNESS_RTOL, its
   wall seconds and launches per request type), and
   ``chunked-approximate`` in 2 chunks of 7 weights then ``merge-chunks``
   against the unchunked factors (equal to the bit, or A_q B_q within
   CHUNKED_REL_ERR);
7. the ``kernels`` JSON line: launches of each kernel in phases 5 and 6
   and the phase-3 numbers (at Mistral's shapes as each entry's ``mistral``, with
   Mistral's phase-5 launches; rows 7 and 9 at code width 4 as their
   ``width4``, with its phase-5 launches; kernel 1 and the megakernel with
   the in-kernel activation quantizer as their ``quant_x``; row 4 at one
   2048-token prompt as its ``admission_2048``, row 5 with OPT's
   ``scale_query`` and at Mistral's max_len 12288 as its
   ``opt_scale_query`` and ``mistral_12288``; row 7 at n_rep 2, d 64,
   L = 32768 as its ``nrep2_d64_32768``; rows 6, 7, 8, 9 and 10 at
   d = 80 as their ``opt_2_7b``, with OPT-2.7b's phase-5 launches; row 6
   at code width 8 as its ``width8``; rows 6 and 10 with each launch's
   device time as ``launch_split_ms``; kernel 1 at Mistral's q|k|v and o
   and the megakernel at M = 256 as ``qkv_m256``, ``o_m256`` and ``m256``;
   row 7's yardstick, SDPA on the unquantized bf16 values, as its
   ``library_ms``; rows 5 and 11 over the ``float32`` cache as their
   ``f32``, with their f32 launches, row 5 also at the f32 one-pass
   length as ``f32.L6144``).

The last line is ``{"ok": true, "device": {...}}``. Any failed phase raises
and the script exits non-zero; so does a machine without a CUDA device, or
a directory without the ``lqer_tpu_torch`` package next to this file.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

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
# The MXINT4 cache against the CPU, in 4-bit code steps (one is sixteen
# 8-bit steps): the same divergence lands on a grid sixteen times coarser;
# on the H100 it moved values by at most one step (PERF.md), the limit is
# twice that.
CACHE_CPU_STEPS_MXINT4 = 2
# Phase 4's long-context runs from a built context: the first slot inside
# the streaming kernels' first 2048-token span, the others across its edge
# (a staged slot's flushed, the 32-token block below it, at 1984..2080;
# the flush at step 17 moves it to 2016..2112)
SPAN_EDGE_POSITIONS = np.array([600, 2000, 2030, 2040, 2047, 2060, 2080,
                                2111], dtype=np.int32)
# Decode steps of the CPU side of the short-context runs (the card's runs
# take 20, and the CPU side is held to the card's state after as many):
# with 20, phase 4 took 306.7 s on the H100 host's 8 cores against 249.1 s
# with 10, beside the parent's 497.3 s (tools/phase4_time.py, PERF.md)
CPU_STEPS = 10
# Decode steps of the CPU side of the long-context runs (one slot at
# Llama's max_len 24576, Mistral's 4 at 8192): the plain versions decode
# the whole cache of each layer per call, a few seconds per step.
LONG_CPU_STEPS = 4
# OPT-350m (d = 64, post-LN, 512-wide head input) moves less for a missing
# correction than a 7B-width model: on the H100 its flips moved the logits
# by at most 0.0519 steps RMS and leaving out layer 1's fc2 correction by
# 0.154 to 0.194 at every step, under LOGIT_RMS_STEPS; leaving out every
# correction of both layers moved them 0.366 to 0.471 (PERF.md,
# tools/cpu_witness.py). Its runs are held to an RMS limit between the two.
LOGIT_RMS_STEPS_OPT350M = 0.1
# Runs that must fail the logits limits against the kernels: one linear's
# correction left out, and (Mistral) the sliding window left out
NEGATIVE_CONTROLS = ("no correction", "no window")
# Phase-3 times (ms) of rows 9, 11 to 14 with their earlier kernels (row
# 9: three launches over 512-token chunks; rows 11 and 12: a block per slot
# and array; row 13: a block per slot, a thread per 16-value group; row
# 14: a block per (layer x slot, array), a byte a step), from PERF.md
# (H100 80GB HBM3, 700 W), printed beside this run's
EARLIER_MS = {"row 9": 0.9473, "row 9 width 4": 0.9895, "row 9 d = 80": 0.1278,
              "row 11": 0.0142, "row 11 MXINT4 columns": 0.0121,
              "row 11 Mistral": 0.0083, "row 12 mxint8 columns": 0.1933,
              "row 12 mxint4 columns": 0.1130, "row 12 bf16 rows": 0.0224,
              "row 13": 0.0179, "row 13 Mistral": 0.0090, "row 14": 0.3619}
# Fraction of a kernel's outputs allowed past the plain rtol/atol band: a
# flipped P or H rounding moves a whole output row, a flipped correction
# code one element (``testing.check_close``).
FLIPPED = {"dequant_gemm": 0.01, "attention": 0.05, "mlp_fused": 0.05}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# float32 operations outside the tensor cores, H100 SXM (NVIDIA's data
# sheet): the bound of the f32 cache's row 5
F32_OPS_RATE = 67e12


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


def launch_split(torch, fn, n: int = 5) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches
    (torch.profiler), keyed by the kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {kernel_name(e.key): round(e.self_device_time_total / n / 1e3, 4)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def kernel_name(key: str) -> str:
    """A profiler kernel key without its return type, namespaces and
    argument list: ``void ns::k<8, 1>(ns::Args)`` gives ``k<8, 1>``."""
    depth = 0
    for i in range(len(key) - 1, -1, -1):
        if key[i] == ")":
            depth += 1
        elif key[i] == "(":
            depth -= 1
            if depth == 0:
                key = key[:i]
                break
    start, depth = 0, 0
    for i, ch in enumerate(key):     # past the last "::" or space outside <>
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and (ch == " " or key[i:i + 2] == "::"):
            start = i + (1 if ch == " " else 2)
    return key[start:].strip() or key.strip()


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
    from lqer_tpu_torch.ops.kernels import mlp_fused as k5
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
    from lqer_tpu_torch.ops.storage import dequantize_packed
    from lqer_tpu_torch.parallel.collectives import mx8_decode, mx8_encode
    from lqer_tpu_torch.serving.kernel_backend import pack_lm_head
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import (
        attention_limit,
        check_close,
        dequant_gemm_limit,
        mlp_limit,
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

    # ---- kernel 1, M = 8: the linears it serves on the main path (qkv, o;
    # the MLP runs in kernel 5) and the W8 head, summed into the kernels
    # line; then gate|up and down of the fuse_mlp=False packing, which
    # kernel 1 serves on that path
    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_hidden_layers=1)
    backend, params, _ = build_random_model(cfg, rank=32, seed=SEED + 1)
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    backend = pack_lm_head(backend, params, width=8)
    unfused, _, _ = build_random_model(cfg, rank=32, seed=SEED + 1,
                                       fuse_mlp=False)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "err": 0.0, "of_limit": 0.0}
    bound_by = set()
    for name, packing, key in (
            ("qkv", backend, "model.layers.0.self_attn.qkv_proj"),
            ("o", backend, "model.layers.0.self_attn.o_proj"),
            ("w8 head", backend, "lm_head"),
            ("gate|up (fuse_mlp=False)", unfused,
             "model.layers.0.mlp.gateup_proj"),
            ("down (fuse_mlp=False)", unfused,
             "model.layers.0.mlp.down_proj")):
        prep, meta = packing["arrays"][key], packing["meta"][key]
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
        print(f"kernel 1 dequant_gemm {name} M=8 K={K} N={N} R={R}: "
              f"max_abs_err={err:.3g} ({c['of_limit']:.3g} of its limit, "
              f"{c['flipped']:.4%} past 2e-4) kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} "
              "(torch.matmul, dense bf16 weight)", flush=True)
        if packing is unfused:
            continue
        bound_by.add(b_by)
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("bound_ms", b_ms)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
        tot["of_limit"] = max(tot["of_limit"], c["of_limit"])
    results["dequant_gemm"] = dict(
        max_abs_err=tot["err"], of_limit=tot["of_limit"], ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"], bound_by="/".join(sorted(bound_by)),
        library_ms=tot["library_ms"],
        shape="sum over qkv, o and the W8 head at M=8")
    del w_dense, unfused

    # ---- kernel 5: the whole MLP of one layer, M = 8 (decode) and 256
    key = "model.layers.0.mlp_fused"
    prep, meta = backend["arrays"][key], backend["meta"][key]
    fmt = meta["fmt"]
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    K = prep["exps_g"].shape[0] * 16
    I, N = prep["exps_g"].shape[1], prep["exps_d"].shape[1]
    R = prep["a_d"].shape[1]
    w_gu = torch.cat([dequantize_packed(prep[f"codes_{h}"], prep[f"exps_{h}"],
                                        fmt) for h in ("g", "u")],
                     1).to(torch.bfloat16)
    w_d = dequantize_packed(prep["codes_d"], prep["exps_d"], fmt).to(
        torch.bfloat16)
    weights = nbytes(*(prep[k] for k in prep))
    for M in (8, 256):
        x = act((M, K)).to(torch.bfloat16)
        y = k5.mlp_w4_fused(x, prep, fmt, **kw)
        ref = k5.mlp_w4_plain(x, prep, fmt, **kw)
        c = check_close(f"kernel 5 M={M}", y, ref,
                        mlp_limit(x, prep, ref, **kw), FLIPPED["mlp_fused"])
        ms = timer(lambda: k5.mlp_w4_fused(x, prep, fmt, **kw))
        plain_ms = timer(lambda: k5.mlp_w4_plain(x, prep, fmt, **kw), 5)
        h = torch.zeros(M, I, dtype=torch.bfloat16, device="cuda")
        lib_ms = (timer(lambda: torch.matmul(x, w_gu))
                  + timer(lambda: torch.matmul(h, w_d)))
        b_ms, b_by = bound(weights + nbytes(x) + M * N * 4,
                           2 * M * (2 * K * I + I * N)
                           + 2 * M * R * (2 * K + 2 * I + I + N))
        print(f"kernel 5 mlp_fused M={M} K={K} I={I} N={N} R={R}: "
              f"max_abs_err={c['max_abs_err']:.3g} ({c['of_limit']:.3g} of "
              f"its limit, {c['flipped']:.4%} past 2e-4) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} library_ms="
              f"{lib_ms:.4f} (torch.matmul gate|up + down, dense bf16 "
              "weights)", flush=True)
        entry = dict(max_abs_err=c["max_abs_err"], of_limit=c["of_limit"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms,
                     shape=f"one layer's MLP, M={M}, I={I}")
        if M == 8:
            results["mlp_fused"] = entry
        else:
            results["mlp_fused"]["m256"] = entry
    del w_gu, w_d, h

    # ---- kernel 6: unpack the five packed weights of one layer
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    shapes = []
    for key, halves in (("model.layers.0.self_attn.qkv_proj", ("",)),
                        ("model.layers.0.self_attn.o_proj", ("",)),
                        ("model.layers.0.mlp_fused", ("_g", "_u", "_d"))):
        entry, fmt = backend["arrays"][key], backend["meta"][key]["fmt"]
        for half in halves:
            codes, exps = entry["codes" + half], entry["exps" + half]
            w = k1.unpack_packed_to_bf16(codes, exps, fmt)
            if not torch.equal(w, k1.unpack_plain(codes, exps, fmt)):
                raise AssertionError(f"kernel 6: {key}{half} differs")
            tot["ms"] += timer(lambda: k1.unpack_packed_to_bf16(codes, exps,
                                                                fmt))
            tot["plain_ms"] += timer(lambda: k1.unpack_plain(codes, exps,
                                                             fmt), 5)
            tot["bound_ms"] += bound(nbytes(codes, exps, w), 0)[0]
            shapes.append("x".join(map(str, w.shape)))
    print(f"kernel 6 unpack {', '.join(shapes)}: bit-exact kernel_ms="
          f"{tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} bound_ms="
          f"{tot['bound_ms']:.4f} library_ms=null (sums over the five)",
          flush=True)
    results["unpack"] = dict(max_abs_err=0.0, of_limit=0.0, bound_by="bytes",
                             library_ms=None, shape="sum over qkv, o, gate, "
                             "up and down of one layer (K x N: " +
                             ", ".join(shapes) + ")", **tot)
    del w

    # ---- the large-M route at the 2048-token admission's 2048 rows: q|k|v
    # and the whole MLP (kernel 6, then one dense product each)
    M = 2048
    x = act((M, 4096)).to(torch.bfloat16)
    for name, key, route, plain, limit, flipped in (
            ("qkv", "model.layers.0.self_attn.qkv_proj",
             k1.qlinear_w4_dense_largeM, k1.qlinear_w4_plain,
             dequant_gemm_limit, FLIPPED["dequant_gemm"]),
            ("mlp", "model.layers.0.mlp_fused", k5.mlp_w4_dense_largeM,
             k5.mlp_w4_plain, mlp_limit, FLIPPED["mlp_fused"])):
        prep, meta = backend["arrays"][key], backend["meta"][key]
        kw = dict(quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        if name == "mlp":
            kw["act_width"] = meta["act_width"]
        y = route(x, prep, meta["fmt"], **kw)
        ref = plain(x, prep, meta["fmt"], **kw)
        c = check_close(f"large-M {name}", y, ref,
                        limit(x, prep, ref, **kw), flipped)
        ms = timer(lambda: route(x, prep, meta["fmt"], **kw), 5)
        plain_ms = timer(lambda: plain(x, prep, meta["fmt"], **kw), 3)
        print(f"large-M route {name} M={M}: max_abs_err="
              f"{c['max_abs_err']:.3g} ({c['of_limit']:.3g} of its limit, "
              f"{c['flipped']:.4%} past 2e-4) route_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f}", flush=True)
    del backend, params, x, y, ref

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
    # the 2048-token admission's shape: one prompt, 32 heads
    BH, S = 32, 2048
    q = act((BH, S, D)).to(torch.bfloat16)
    k, v = (mx8_decode(*mx8_encode(torch.randn(BH, S, D, generator=gen,
                                               device="cuda"), 16, 1.0),
                       16, torch.bfloat16) for _ in range(2))
    y = k2.quantized_attention(q, k, v, scale=scale)
    ref = k2.quantized_attention_plain(q, k, v, scale=scale)
    c = check_close("kernel 2 S=2048", y, ref, attention_limit(
        k2.prefill_scores(q, k, scale=scale), v, ref, p_width=8),
        FLIPPED["attention"])
    ms = timer(lambda: k2.quantized_attention(q, k, v, scale=scale), 5)
    plain_ms = timer(lambda: k2.quantized_attention_plain(q, k, v,
                                                          scale=scale), 3)
    q4, k4_, v4 = (t.reshape(1, BH, S, D) for t in (q, k, v))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(q4, k4_, v4,
                                                          is_causal=True))
    b_ms, b_by = bound(nbytes(q, k, v) + BH * S * D * 4,
                       2 * 2 * BH * (S * (S + 1) // 2) * D)
    print(f"kernel 2 attention BH={BH} S=L={S} d={D}: max_abs_err="
          f"{c['max_abs_err']:.3g} ({c['of_limit']:.3g} of its limit, "
          f"{c['flipped']:.4%} past 2e-4) kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) library_ms="
          f"{lib_ms:.4f} (causal scaled_dot_product_attention)", flush=True)
    results["attention"]["admission_2048"] = dict(
        max_abs_err=c["max_abs_err"], of_limit=c["of_limit"], ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape="1 prompt x 2048 tokens, 32 heads, d=128")
    del q, k, v, y, ref, q4, k4_, v4

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
    # the yardstick of the decode rows: SDPA on unquantized bf16 K, V of
    # the same shape over the keys each slot holds
    kb, vb = (torch.randn(B, KVH, L, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    qb = qd.to(torch.bfloat16)
    held = (torch.arange(L, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=held))
    del kb, vb
    print(f"kernel 3 decode_attention B={B} KVH={KVH} L={L} "
          f"flushed={fl.tolist()} pos={pos.tolist()}: max_abs_err={err:.3g} "
          f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
          f"2e-4), rings bit-exact kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} "
          "(scaled_dot_product_attention on unquantized bf16 K, V, keys <= "
          "pos)", flush=True)
    results["decode_attention"] = dict(
        max_abs_err=err, of_limit=c["of_limit"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms,
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
          f"library_ms=null; the earlier kernel {EARLIER_MS['row 14']} ms",
          flush=True)
    results["cache_write"] = dict(
        max_abs_err=0.0, of_limit=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape="one flush of 32 tokens, 32 layers, 8 slots, 32 kv heads")
    del mains, stages, m_plain
    torch.cuda.empty_cache()
    return results


def phase_direct_kernels(torch, timer, rates, results):
    """Phase 3, the direct-write caches' kernels at the 7B decode shape: B = 8
    slots, 32 heads and kv heads, d = 128, L = 2048, layer 1 of a two-layer
    cache, positions spread over 64..1984."""
    import torch.nn.functional as F

    from lqer_tpu_torch.ops.kernels import cache_write as kcw
    from lqer_tpu_torch.ops.kernels import fp_decode as kfp
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.parallel.collectives import (
        mx4_decode,
        mx4_encode,
        mx8_encode,
    )
    from lqer_tpu_torch.testing import attention_limit, check_close

    bw, ops_rate = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    NL, B, H, KVH, D, L, li = 2, 8, 32, 32, 128, 2048, 1
    scale = D ** -0.5
    pos = torch.tensor([64, 303, 560, 815, 1088, 1343, 1600, 1984],
                       dtype=torch.int32, device="cuda")
    ntok = ((pos + 16) // 16 * 16).clamp(max=L)
    tokens = int(ntok.sum())
    q = torch.randn(B, H, 1, D, generator=gen, device="cuda")
    out_bytes = B * H * D * 4
    keep = torch.arange(L, device="cuda")[None, :] <= pos[:, None].long()
    mask = keep[:, None, None, :]                    # SDPA: True = attend

    def bound(nb, ops):
        t_bytes, t_ops = nb / bw * 1e3, ops / ops_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def sdpa_ms(k_bf16, v_bf16):
        # contiguous (B, H, L, d) operands, as the fused kernels take them
        qb, kb, vb = (t.to(torch.bfloat16).contiguous()
                      for t in (q, k_bf16, v_bf16))
        return timer(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask))

    def report(key, what, c, ms, plain_ms, b_ms, b_by, lib_ms, shape,
               extra="", split=None):
        parts = "" if split is None else f" (per launch: {split})"
        print(f"{what}: max_abs_err={c['max_abs_err']:.3g} "
              f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
              f"2e-4){extra} kernel_ms={ms:.4f}{parts} plain_ms="
              f"{plain_ms:.4f} bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} "
              "(scaled_dot_product_attention on the unquantized bf16 "
              "values, the unquantized yardstick)", flush=True)
        entry = dict(
            max_abs_err=c["max_abs_err"], of_limit=c["of_limit"], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, shape=shape,
            **({} if split is None else {"launch_split_ms": split}))
        if key:
            results[key] = entry
        return entry

    # ---- the fp-cache kernel over a bf16 cache with every row filled
    k, v = (torch.randn(NL, B, KVH, L, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    kw = dict(scaling=scale)
    y = kfp.decode_attention_fp(q, k, v, pos, li, **kw)
    ref = kfp.fp_decode_plain(q, k, v, pos, li, **kw)
    sc, vals = kfp.fp_scores(q, k, v, pos, li, **kw)
    c = check_close("fp decode attention", y, ref,
                    attention_limit(sc, vals, ref, p_width=8),
                    FLIPPED["attention"])
    del sc, vals
    ms = timer(lambda: kfp.decode_attention_fp(q, k, v, pos, li, **kw))
    plain_ms = timer(lambda: kfp.fp_decode_plain(q, k, v, pos, li, **kw), 5)
    lib_ms = sdpa_ms(k[li], v[li])
    b_ms, b_by = bound(tokens * KVH * D * 2 * 2 + nbytes(q) + out_bytes,
                       2 * 2 * H * tokens * D)
    report("decode_attention_fp", f"fp decode attention B={B} KVH={KVH} "
           f"L={L} pos={pos.tolist()}", c, ms, plain_ms, b_ms, b_by, lib_ms,
           "one layer of a bf16 cache, B=8, 32 kv heads, L=2048, pos "
           "64..1984")
    del k, v

    # ---- the MXINT8 and MXINT4 caches: read-only kernel, then (width 8)
    # the fused write + attend
    def cache(width):
        enc = mx8_encode if width == 8 else mx4_encode
        out = []
        for _ in range(2):
            c_, e_ = enc(torch.randn(NL, B, KVH, L, D, generator=gen,
                                     device="cuda"), 16, zero_fill=1.0)
            out += [c_.transpose(-1, -2).contiguous(),
                    e_.transpose(-1, -2).contiguous()]
        return out

    for width in (8, 4):
        arrays = cache(width)
        y = kq.decode_attention_quantized(q, *arrays, pos, li, **kw)
        ref = kq.quantized_decode_plain(q, *arrays, pos, li, **kw)
        sc, vals = kq.quantized_scores(q, *arrays, pos, li, **kw)
        c = check_close(f"quantized decode attention width {width}", y, ref,
                        attention_limit(sc, vals, ref, p_width=8),
                        FLIPPED["attention"])
        lib_ms = sdpa_ms(*(t.transpose(-1, -2).to(torch.bfloat16)
                           for t in (kq._decode_cache_block(
                               arrays[0][li], arrays[1][li]),
                               kq._decode_cache_block(arrays[2][li],
                                                      arrays[3][li]))))
        del sc, vals
        run = lambda: kq.decode_attention_quantized(q, *arrays, pos, li, **kw)
        ms = timer(run)
        plain_ms = timer(lambda: kq.quantized_decode_plain(
            q, *arrays, pos, li, **kw), 5)
        per_token = KVH * (arrays[0].shape[-2] + D // 16) * 2
        b_ms, b_by = bound(tokens * per_token + nbytes(q) + out_bytes,
                           2 * 2 * H * tokens * D)
        entry = report(
            "decode_attention_quantized" if width == 4 else None,
            f"quantized decode attention width {width} B={B} KVH={KVH} "
            f"L={L}", c, ms, plain_ms, b_ms, b_by, lib_ms,
            f"one layer of an MXINT{width} cache, B=8, 32 kv heads, L=2048, "
            "pos 64..1984", split=launch_split(torch, run))
        if width == 4:
            results["decode_attention_quantized"]["width8"] = width8
            del arrays
            continue
        width8 = entry
        kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
                  for _ in range(2))
        mine = [a.clone() for a in arrays]
        theirs = [a.clone() for a in arrays]
        y = kq.decode_attention_quantized_write(q, *mine, kh, vh, pos, li,
                                                **kw)
        ref = kq.quantized_write_plain(q, *theirs, kh, vh, pos, li, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
            raise AssertionError("fused write + attend: written cache bytes "
                                 "differ from the plain version")
        sc, vals = kq.quantized_scores(q, *theirs, pos, li, **kw)
        c = check_close("fused write + attend", y, ref,
                        attention_limit(sc, vals, ref, p_width=8),
                        FLIPPED["attention"])
        del sc, vals
        run = lambda: kq.decode_attention_quantized_write(
            q, *mine, kh, vh, pos, li, **kw)
        ms = timer(run)
        plain_ms = timer(lambda: kq.quantized_write_plain(
            q, *theirs, kh, vh, pos, li, **kw), 5)
        b_ms, b_by = bound(tokens * per_token + nbytes(q, kh, vh) + out_bytes
                           + B * KVH * (D + D // 16) * 2,
                           2 * 2 * H * tokens * D)
        report("decode_attention_write", f"fused write + attend B={B} "
               f"KVH={KVH} L={L}", c, ms, plain_ms, b_ms, b_by, lib_ms,
               "one layer of an MXINT8 cache, B=8, 32 kv heads, L=2048, pos "
               "64..1984", ", written column bit-exact",
               split=launch_split(torch, run))
        del arrays, mine, theirs

    # ---- the row write: bf16 rows (token axis on dim 3), then the four
    # MXINT4 columns (token axis on dim 4)
    def index_put(arrays, news, lane):
        b = torch.arange(B, device="cuda")
        kv = torch.arange(KVH, device="cuda")
        p64 = pos.long()
        for arr, new in zip(arrays, news):
            layer = arr[li]
            if lane:
                r = torch.arange(arr.shape[3], device="cuda")
                layer.index_put_((b[:, None, None], kv[None, :, None],
                                  r[None, None, :], p64[:, None, None]),
                                 new[..., 0].to(arr.dtype))
            else:
                layer.index_put_((b[:, None], kv[None, :], p64[:, None]),
                                 new[:, :, 0, :].to(arr.dtype))

    for lane in (False, True):
        if lane:
            arrays = cache(4)
            news = []
            for _ in range(2):
                news += [t.transpose(-1, -2).contiguous() for t in mx4_encode(
                    torch.randn(B, KVH, 1, D, generator=gen, device="cuda"),
                    16, zero_fill=1.0)]
        else:
            arrays = [torch.randn(NL, B, KVH, L, D, generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(2)]
            news = [torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
                    for _ in range(2)]
        mine = [a.clone() for a in arrays]
        theirs = [a.clone() for a in arrays]
        kcw.write_kv_rows_stacked(tuple(mine), tuple(news), li, pos)
        kcw.write_rows_plain(tuple(theirs), tuple(news), li, pos)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
            raise AssertionError(f"row write (token axis on dim "
                                 f"{4 if lane else 3}) differs")
        ms = timer(lambda: kcw.write_kv_rows_stacked(tuple(mine), tuple(news),
                                                    li, pos))
        plain_ms = timer(lambda: kcw.write_rows_plain(tuple(theirs),
                                                      tuple(news), li, pos), 5)
        lib_ms = timer(lambda: index_put(theirs, news, lane))
        moved = sum(n.numel() * (n.element_size() + a.element_size())
                    for a, n in zip(arrays, news))
        b_ms, b_by = bound(moved, 0)
        what = ("the four MXINT4 columns" if lane
                else "the bf16 K and V rows")
        earlier = EARLIER_MS["row 11 MXINT4 columns" if lane else "row 11"]
        print(f"row write, {what} of {B} slots, 32 kv heads: bit-exact "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
              f"{b_ms:.4f} library_ms={lib_ms:.4f} (index_put_); the "
              f"earlier kernel {earlier} ms", flush=True)
        if not lane:
            results["row_write"] = dict(
                max_abs_err=0.0, of_limit=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                shape="the bf16 K and V rows of 8 slots, 32 kv heads, d=128 "
                "(the four MXINT4 columns printed beside it)")
        del arrays, mine, theirs
    torch.cuda.empty_cache()


def phase_f32_kernels(torch, timer, rates, results):
    """Phase 3, the ``float32`` cache's forms of rows 5 and 11 at the 7B
    decode shape (B = 8 slots, 32 heads and kv heads, d = 128, layer 1 of
    a two-layer cache): row 5 at L = 2048 (positions 64..1984) and at the
    f32 one-pass length L = 6144 (positions up to 6143), each against its
    plain version to the bf16 row's limits, beside SDPA on the same f32
    values; row 11's f32 rows bit-exact, beside ``index_put_``. Their
    entries in the kernels line are each row's ``f32``."""
    import torch.nn.functional as F

    from lqer_tpu_torch.ops.kernels import cache_write as kcw
    from lqer_tpu_torch.ops.kernels import fp_decode as kfp
    from lqer_tpu_torch.serving.decode import _fp_cache_kernel_fits
    from lqer_tpu_torch.testing import attention_limit, check_close

    bw, _ = rates
    f32_rate = F32_OPS_RATE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 31)
    NL, B, H, KVH, D, li = 2, 8, 32, 32, 128, 1
    scale = D ** -0.5
    q = torch.randn(B, H, 1, D, generator=gen, device="cuda")

    def bound(nb, ops):
        t_bytes, t_ops = nb / bw * 1e3, ops / f32_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    top = max(n for n in range(2048, 65536, 16)
              if _fp_cache_kernel_fits(n, D, 4))
    entries = {}
    for L, pos in ((2048, [64, 303, 560, 815, 1088, 1343, 1600, 1984]),
                   (top, [100, 1000, 2047, 3000, 4095, 5000, 6000, top - 1])):
        pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
        tokens = int(((pos + 16) // 16 * 16).clamp(max=L).sum())
        k, v = (torch.randn(NL, B, KVH, L, D, generator=gen, device="cuda")
                for _ in range(2))
        k[:, 0, 0, :16] *= 1e-9        # a group the quantizer passes through
        kw = dict(scaling=scale)
        before = kfp.decode_attention_fp.launches_f32
        y = kfp.decode_attention_fp(q, k, v, pos, li, **kw)
        if kfp.decode_attention_fp.launches_f32 != before + 1:
            raise AssertionError("row 5 on an f32 cache: no f32 launch")
        ref = kfp.fp_decode_plain(q, k, v, pos, li, **kw)
        sc, vals = kfp.fp_scores(q, k, v, pos, li, **kw)
        c = check_close(f"fp decode attention f32 L={L}", y, ref,
                        attention_limit(sc, vals, ref, p_width=8),
                        FLIPPED["attention"])
        del sc, vals
        if not torch.equal(y, kfp.decode_attention_fp(q, k, v, pos, li,
                                                       **kw)):
            raise AssertionError("row 5 f32: two launches differ")
        ms = timer(lambda: kfp.decode_attention_fp(q, k, v, pos, li, **kw))
        plain_ms = timer(lambda: kfp.fp_decode_plain(q, k, v, pos, li, **kw),
                         5)
        keep = torch.arange(L, device="cuda")[None, :] <= pos[:, None].long()
        kl, vl = k[li].contiguous(), v[li].contiguous()
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q, kl, vl, attn_mask=keep[:, None, None, :]))
        b_ms, b_by = bound(tokens * KVH * D * 4 * 2 + nbytes(q) * 2,
                           2 * 2 * H * tokens * D)
        print(f"fp decode attention over the f32 cache B={B} KVH={KVH} "
              f"L={L} pos={pos.tolist()}: max_abs_err={c['max_abs_err']:.3g} "
              f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
              f"2e-4), two launches bit-equal, kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; f32 values at "
              f"3.35 TB/s) library_ms={lib_ms:.4f} (scaled_dot_product_"
              f"attention on the unquantized f32 values); the bf16 cache's "
              f"row 5 at L = 2048: "
              f"{results['decode_attention_fp']['ms']:.4f} ms", flush=True)
        entries[L] = dict(
            max_abs_err=c["max_abs_err"], of_limit=c["of_limit"], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms,
            shape=f"one layer of an f32 cache, B=8, 32 kv heads, L={L}")
        del k, v, kl, vl
    results["decode_attention_fp"]["f32"] = {**entries[2048],
                                             f"L{top}": entries[top]}

    # ---- row 11: the f32 K and V rows into the f32 cache, unrounded
    L = 2048
    pos = torch.tensor([64, 303, 560, 815, 1088, 1343, 1600, 1984],
                       dtype=torch.int32, device="cuda")
    arrays = [torch.randn(NL, B, KVH, L, D, generator=gen, device="cuda")
              for _ in range(2)]
    news = [torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
            for _ in range(2)]
    mine = [a.clone() for a in arrays]
    theirs = [a.clone() for a in arrays]
    before = kcw.write_kv_rows_stacked.launches_f32
    kcw.write_kv_rows_stacked(tuple(mine), tuple(news), li, pos)
    if kcw.write_kv_rows_stacked.launches_f32 != before + 1:
        raise AssertionError("row 11 on f32 arrays: no f32 launch")
    kcw.write_rows_plain(tuple(theirs), tuple(news), li, pos)
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(mine, theirs)):
        raise AssertionError("row write of f32 rows differs from its plain "
                             "version")
    ms = timer(lambda: kcw.write_kv_rows_stacked(tuple(mine), tuple(news),
                                                li, pos))
    plain_ms = timer(lambda: kcw.write_rows_plain(tuple(theirs), tuple(news),
                                                  li, pos), 5)
    b_idx, kv_idx = torch.arange(B, device="cuda"), torch.arange(
        KVH, device="cuda")

    def index_put():
        for arr, new in zip(theirs, news):
            arr[li].index_put_((b_idx[:, None], kv_idx[None, :],
                                pos.long()[:, None]), new[:, :, 0, :])

    lib_ms = timer(index_put)
    b_ms, b_by = bound(sum(nbytes(n) * 2 for n in news), 0)
    print(f"row write, the f32 K and V rows of {B} slots, 32 kv heads into "
          f"the f32 cache: bit-exact kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} "
          f"(index_put_); the bf16 rows: {results['row_write']['ms']:.4f} ms",
          flush=True)
    results["row_write"]["f32"] = dict(
        max_abs_err=0.0, of_limit=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape="the f32 K and V rows of 8 slots, 32 kv heads, d=128 into "
              "an f32 cache")
    del arrays, mine, theirs
    torch.cuda.empty_cache()


def phase_stream_kernels(torch, timer, rates, results):
    """Phase 3, the long-context kernels at the 7B decode shape past the
    one-pass length: B = 8 slots, 32 heads and kv heads, d = 128,
    L = 32768, positions spread over 64..32767; then at L = 24576, where
    n_rep = 1 fits the one-pass kernels too, each streaming kernel against
    its one-pass counterpart on the same inputs."""
    import torch.nn.functional as F

    from lqer_tpu_torch.ops.kernels import cache_write as kcw
    from lqer_tpu_torch.ops.kernels import decode_attention as k3
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.ops.kernels import streaming_decode as ks
    from lqer_tpu_torch.parallel.collectives import mx4_encode, mx8_encode
    from lqer_tpu_torch.testing import attention_limit, check_close

    bw, ops_rate = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    B, H, KVH, D, li, SW = 8, 32, 32, 128, 1, 64
    scale = D ** -0.5
    kw = dict(scaling=scale)
    # a chunk's last and first token (511, 512), the cache's last (32767)
    pos = torch.tensor([64, 511, 512, 4095, 12288, 20001, 28671, 32767],
                       dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, 1, D, generator=gen, device="cuda")
    out_bytes = B * H * D * 4

    def bound(nb, ops):
        t_bytes, t_ops = nb / bw * 1e3, ops / ops_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def cache(width, L, NL=2):
        """Layer ``li`` of an NL-layer cache holds seeded values; the other
        layers stay zero (only ``li`` is read)."""
        enc = mx8_encode if width == 8 else mx4_encode
        out = []
        for _ in range(2):
            c_, e_ = enc(torch.randn(B, KVH, L, D, generator=gen,
                                     device="cuda"), 16, zero_fill=1.0)
            for t in (c_, e_):
                full = torch.zeros(NL, *t.transpose(-1, -2).shape,
                                   dtype=torch.int8, device="cuda")
                full[li] = t.transpose(-1, -2)
                out.append(full)
        return out

    def sdpa_ms(arrays, keep):
        """SDPA on the unquantized bf16 values of the cache's layer."""
        k, v = (kq._decode_cache_block(arrays[i][li], arrays[i + 1][li])
                .transpose(-1, -2).to(torch.bfloat16).contiguous()
                for i in (0, 2))
        qb = q.to(torch.bfloat16)
        ms = timer(lambda: F.scaled_dot_product_attention(
            qb, k, v, attn_mask=keep[:, None, None, :]))
        del k, v
        return ms

    def report(key, what, c, ms, plain_ms, b_ms, b_by, lib_ms, lib_what,
               shape, extra=""):
        print(f"{what}: max_abs_err={c['max_abs_err']:.3g} "
              f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
              f"2e-4){extra} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} ({lib_what})",
              flush=True)
        if key:
            results[key] = dict(
                max_abs_err=c["max_abs_err"], of_limit=c["of_limit"], ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=shape)

    # ---- row 8 at widths 8 and 4: whole 16-token groups up to pos
    L = 32768
    ntok = ((pos + 16) // 16 * 16).clamp(max=L)
    tokens = int(ntok.sum())
    keep = torch.arange(L, device="cuda")[None, :] <= pos[:, None].long()
    for width in (8, 4):
        arrays = cache(width, L)
        y = ks.decode_attention_quantized_streaming(q, *arrays, pos, li, **kw)
        ref = kq.quantized_decode_plain(q, *arrays, pos, li, **kw)
        sc, vals = kq.quantized_scores(q, *arrays, pos, li, **kw)
        c = check_close(f"streaming decode attention width {width}", y, ref,
                        attention_limit(sc, vals, ref, p_width=8),
                        FLIPPED["attention"])
        del sc, vals, ref
        ms = timer(lambda: ks.decode_attention_quantized_streaming(
            q, *arrays, pos, li, **kw))
        plain_ms = timer(lambda: kq.quantized_decode_plain(
            q, *arrays, pos, li, **kw), 3)
        lib_ms = sdpa_ms(arrays, keep)
        k_bytes = tokens * KVH * (arrays[0].shape[-2] + D // 16)
        b_ms, b_by = bound(2 * k_bytes + nbytes(q) + out_bytes,
                           2 * 2 * H * tokens * D)
        second_k = k_bytes / bw * 1e3
        report("decode_attention_streaming" if width == 8 else None,
               f"streaming decode attention width {width} B={B} KVH={KVH} "
               f"L={L} pos={pos.tolist()}", c, ms, plain_ms, b_ms, b_by,
               lib_ms, "scaled_dot_product_attention on the unquantized "
               "bf16 values, the unquantized yardstick",
               "one layer of an MXINT8 cache, B=8, 32 kv heads, L=32768, pos "
               "64..32767 (width 4 printed beside it)",
               f", K's second read (the TPU kernel's two passes) would add "
               f"{second_k:.4f} ms to the bound")
        del arrays

    # ---- row 9: the main cache below flushed = floor32(pos), the ring
    def staged(L):
        main = [a[li] for a in cache(8, L)]
        rings = [a[li].contiguous() for a in cache(8, SW)]
        kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
                  for _ in range(2))
        return main, rings, kh, vh

    main, rings, kh, vh = staged(L)
    fl = (pos // 32) * 32
    r_k, r_p = [t.clone() for t in rings], [t.clone() for t in rings]
    y = ks.decode_attention_quantized_streaming_staged(
        q, *main, *r_k, kh, vh, pos, fl, **kw)
    ref = k3.staged_decode_plain(q, *main, *r_p, kh, vh, pos, fl, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(r_k, r_p)):
        raise AssertionError("streaming staged decode: ring bytes differ "
                             "from the plain version")
    sc, vals = k3.staged_scores(q, *main, *r_p, pos, fl, **kw)
    c = check_close("streaming staged decode attention", y, ref,
                    attention_limit(sc[:, :, None, :], vals, ref, p_width=8),
                    FLIPPED["attention"])
    del sc, vals, ref
    ms = timer(lambda: ks.decode_attention_quantized_streaming_staged(
        q, *main, *r_k, kh, vh, pos, fl, **kw))
    plain_ms = timer(lambda: k3.staged_decode_plain(
        q, *main, *r_p, kh, vh, pos, fl, **kw), 3)
    held = int(fl.sum()) + int((pos - fl + 1).sum())   # main + ring tokens
    keep = torch.arange(L, device="cuda")[None, :] <= pos[:, None].long()
    lib_ms = sdpa_ms([t[None].expand(2, *t.shape) for t in main], keep)
    per_token = KVH * (D + D // 16)
    b_ms, b_by = bound(2 * held * per_token + nbytes(q, kh, vh) + out_bytes
                       + 2 * B * KVH * (D + D // 16), 2 * 2 * H * held * D)
    report("decode_attention_streaming_staged", f"streaming staged decode "
           f"attention B={B} KVH={KVH} L={L} flushed={fl.tolist()}", c, ms,
           plain_ms, b_ms, b_by, lib_ms, "scaled_dot_product_attention on "
           "the unquantized bf16 values of the main cache, the unquantized "
           "yardstick", "one layer, B=8, 32 kv heads, L=32768, flushed "
           "64..32736", f", rings bit-exact, K's second read would add "
           f"{held * per_token / bw * 1e3:.4f} ms to the bound, the earlier "
           f"kernel {EARLIER_MS['row 9']} ms,")
    del main, rings, r_k, r_p

    # ---- row 7 at n_rep 2, d 64, L = 32768, which its shared memory
    # refused before it split L: against its plain version and against
    # row 9 on the same inputs (rings bit-exact in both)
    KV2, D2 = 16, 64

    def encoded(n):
        c_, e_ = mx8_encode(torch.randn(B, KV2, n, D2, generator=gen,
                                        device="cuda"), 16, zero_fill=1.0)
        return [c_.transpose(-1, -2).contiguous(),
                e_.transpose(-1, -2).contiguous()]

    main = encoded(L) + encoded(L)
    rings = encoded(SW) + encoded(SW)
    q2 = torch.randn(B, 2 * KV2, 1, D2, generator=gen, device="cuda")
    kh, vh = (torch.randn(B, KV2, 1, D2, generator=gen, device="cuda")
              for _ in range(2))
    kw2 = dict(scaling=D2 ** -0.5)
    r7, r9, r_p = ([t.clone() for t in rings] for _ in range(3))
    y = k3.decode_attention_quantized_staged(q2, *main, *r7, kh, vh, pos, fl,
                                             **kw2)
    y9 = ks.decode_attention_quantized_streaming_staged(
        q2, *main, *r9, kh, vh, pos, fl, **kw2)
    ref = k3.staged_decode_plain(q2, *main, *r_p, kh, vh, pos, fl, **kw2)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) and torch.equal(c_, b)
               for a, b, c_ in zip(r7, r_p, r9)):
        raise AssertionError("row 7 / row 9 at n_rep 2, d 64: ring bytes "
                             "differ from the plain version")
    sc, vals = k3.staged_scores(q2, *main, *r_p, pos, fl, **kw2)
    c = check_close("row 7 at n_rep 2, d 64, L 32768", y, ref,
                    attention_limit(sc[:, :, None, :], vals, ref, p_width=8),
                    FLIPPED["attention"])
    c9 = check_close("row 7 vs row 9 at n_rep 2, d 64, L 32768", y, y9,
                     attention_limit(sc[:, :, None, :], vals, y9, p_width=8),
                     FLIPPED["attention"])
    del sc, vals, ref
    ms = timer(lambda: k3.decode_attention_quantized_staged(
        q2, *main, *r7, kh, vh, pos, fl, **kw2))
    ms9 = timer(lambda: ks.decode_attention_quantized_streaming_staged(
        q2, *main, *r9, kh, vh, pos, fl, **kw2))
    plain_ms = timer(lambda: k3.staged_decode_plain(
        q2, *main, *r_p, kh, vh, pos, fl, **kw2), 3)
    held = int(fl.sum()) + int((pos - fl + 1).sum())
    per_token = KV2 * (D2 + D2 // 16)
    b_ms, b_by = bound(2 * held * per_token + nbytes(q2, kh, vh)
                       + q2.numel() * 4 + 2 * B * KV2 * (D2 + D2 // 16),
                       2 * 2 * 2 * KV2 * held * D2)
    k, v = (kq._decode_cache_block(main[i], main[i + 1]).transpose(-1, -2)
            .to(torch.bfloat16).contiguous() for i in (0, 2))
    qb = q2.to(torch.bfloat16)
    keep = torch.arange(L, device="cuda")[None, :] <= pos[:, None].long()
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qb, k, v, attn_mask=keep[:, None, None, :], enable_gqa=True))
    del k, v
    print(f"row 7 staged decode attention n_rep 2 B={B} KVH={KV2} d={D2} "
          f"L={L} flushed={fl.tolist()}: max_abs_err={c['max_abs_err']:.3g} "
          f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
          f"2e-4), rings bit-exact kernel_ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} "
          f"(SDPA on the unquantized bf16 values); row 9 on the same "
          f"inputs: {ms9:.4f} ms, bound {b_ms:.4f}, SDPA {lib_ms:.4f}, "
          f"row 7 vs row 9 max_abs_err={c9['max_abs_err']:.3g} "
          f"({c9['of_limit']:.3g} of its limit)", flush=True)
    results["decode_attention"]["nrep2_d64_32768"] = dict(
        max_abs_err=c["max_abs_err"], of_limit=c["of_limit"], ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        row9_ms=ms9, row7_vs_row9_max_abs_err=c9["max_abs_err"],
        shape="one layer, B=8, 32 heads over 16 kv heads, d=64, L=32768, "
              "flushed 64..32736")
    del main, rings, r7, r9, r_p

    # ---- row 13: the fresh rows encoded into column pos of four arrays
    arrays = cache(8, L)
    kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
              for _ in range(2))
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    kcw.write_kv_tokens_fused(tuple(mine), kh, vh, li, pos)
    kcw.encode_write_plain(tuple(theirs), kh, vh, li, pos)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
        raise AssertionError("fused encode + write: cache bytes differ from "
                             "the plain version")
    del theirs
    cols = kcw.encode_rows(kh, vh)
    bi = torch.arange(B, device="cuda")[:, None, None]
    kvi = torch.arange(KVH, device="cuda")[None, :, None]
    p64 = pos.long()[:, None, None]

    def index_put():
        for arr, col in zip(arrays, cols):
            r = torch.arange(arr.shape[3], device="cuda")[None, None, :]
            arr[li].index_put_((bi, kvi, r, p64), col[..., 0])

    ms = timer(lambda: kcw.write_kv_tokens_fused(tuple(mine), kh, vh, li,
                                                 pos))
    plain_ms = timer(lambda: kcw.encode_write_plain(tuple(arrays), kh, vh,
                                                    li, pos), 5)
    lib_ms = timer(index_put)
    b_ms, b_by = bound(nbytes(kh, vh) + 2 * B * KVH * (D + D // 16), 0)
    print(f"fused encode + write B={B} KVH={KVH} L={L}: bit-exact "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
          f"library_ms={lib_ms:.4f} (index_put_ of the pre-encoded columns); "
          f"the earlier kernel {EARLIER_MS['row 13']} ms", flush=True)
    results["encode_write_tokens"] = dict(
        max_abs_err=0.0, of_limit=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape="the K and V rows of 8 slots, 32 kv heads, d=128, L=32768")
    # the long-context step's 4 slots (phase 5), one of them past the cache
    p4 = torch.tensor([32000, 32767, 32768, 100], dtype=torch.int32,
                      device="cuda")
    mine4 = [a[:, :4].contiguous() for a in mine]
    theirs4 = [a.clone() for a in mine4]
    kh4, vh4 = kh[:4], vh[:4]
    kcw.write_kv_tokens_fused(tuple(mine4), kh4, vh4, li, p4)
    kcw.encode_write_plain(tuple(theirs4), kh4, vh4, li, p4)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(mine4, theirs4)):
        raise AssertionError("fused encode + write at 4 slots: cache bytes "
                             "differ from the plain version")
    ms4 = timer(lambda: kcw.write_kv_tokens_fused(tuple(mine4), kh4, vh4, li,
                                                  p4))
    plain4 = timer(lambda: kcw.encode_write_plain(tuple(theirs4), kh4, vh4,
                                                  li, p4), 5)
    b4, _ = bound(nbytes(kh4, vh4) + 2 * 4 * KVH * (D + D // 16), 0)
    print(f"fused encode + write B=4 KVH={KVH} L={L} (one slot past L): "
          f"bit-exact kernel_ms={ms4:.4f} plain_ms={plain4:.4f} "
          f"bound_ms={b4:.4f}", flush=True)
    results["encode_write_tokens"]["slots4"] = dict(
        max_abs_err=0.0, ms=ms4, plain_ms=plain4, bound_ms=b4,
        shape="the K and V rows of 4 slots, 32 kv heads, d=128, L=32768")
    del arrays, mine, cols, mine4, theirs4

    # ---- at L = 24576: each streaming kernel against its one-pass kernel
    L = 24576
    pos = pos.clamp(max=L - 1)
    fl = (pos // 32) * 32
    arrays = cache(8, L)
    y = ks.decode_attention_quantized_streaming(q, *arrays, pos, li, **kw)
    one = kq.decode_attention_quantized(q, *arrays, pos, li, **kw)
    sc, vals = kq.quantized_scores(q, *arrays, pos, li, **kw)
    c = check_close("streaming vs one-pass", y, one,
                    attention_limit(sc, vals, one, p_width=8),
                    FLIPPED["attention"])
    del sc, vals
    ms = timer(lambda: ks.decode_attention_quantized_streaming(
        q, *arrays, pos, li, **kw))
    one_ms = timer(lambda: kq.decode_attention_quantized(q, *arrays, pos, li,
                                                         **kw))
    del arrays
    main, rings, kh, vh = staged(L)
    r_one = [t.clone() for t in rings]
    ys = ks.decode_attention_quantized_streaming_staged(
        q, *main, *rings, kh, vh, pos, fl, **kw)
    ones = k3.decode_attention_quantized_staged(q, *main, *r_one, kh, vh,
                                                pos, fl, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(rings, r_one)):
        raise AssertionError("streaming vs one-pass staged: rings differ")
    sc, vals = k3.staged_scores(q, *main, *r_one, pos, fl, **kw)
    cs = check_close("streaming staged vs one-pass staged", ys, ones,
                     attention_limit(sc[:, :, None, :], vals, ones,
                                     p_width=8), FLIPPED["attention"])
    ms_s = timer(lambda: ks.decode_attention_quantized_streaming_staged(
        q, *main, *rings, kh, vh, pos, fl, **kw))
    one_ms_s = timer(lambda: k3.decode_attention_quantized_staged(
        q, *main, *r_one, kh, vh, pos, fl, **kw))
    print(f"at L={L} pos={pos.tolist()}, kernels against kernels: "
          f"streaming vs one-pass max_abs_err={c['max_abs_err']:.3g} "
          f"({c['of_limit']:.3g} of its limit), {ms:.4f} vs {one_ms:.4f} "
          f"ms; streaming staged vs one-pass staged max_abs_err="
          f"{cs['max_abs_err']:.3g} ({cs['of_limit']:.3g} of its limit), "
          f"rings bit-exact, {ms_s:.4f} vs {one_ms_s:.4f} ms", flush=True)
    del main, rings, r_one, sc, vals
    torch.cuda.empty_cache()


def phase_opt_kernels(torch, timer, rates, results):
    """Phase 3, OPT's modes at OPT-6.7B width: the megakernel's relu variant
    with biases (fc1 and fc2 of one layer, K = 4096, I = 16384, N = 4096,
    rank 32) at 8 and 256 rows; kernel 1 with a bias on q|k|v (N = 12288)
    and out_proj at 8 rows; the decode kernels of OPT's caches with the
    query scaled before its quantizer (``scale_query``) at 8 slots, 32 kv
    heads, d = 128, L = 2048: fp cache, MXINT4 cache, staged MXINT8 cache
    and the fused MXINT8 write + attend."""
    import dataclasses

    import torch.nn.functional as F

    from lqer_tpu_torch.models.opt import MODEL_CONFIGS
    from lqer_tpu_torch.ops.kernels import decode_attention as k3
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.kernels import fp_decode as kfp
    from lqer_tpu_torch.ops.kernels import mlp_fused as k5
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
    from lqer_tpu_torch.ops.storage import dequantize_packed
    from lqer_tpu_torch.parallel.collectives import mx4_encode, mx8_encode
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import (
        attention_limit,
        check_close,
        dequant_gemm_limit,
        mlp_limit,
    )

    bw, ops_rate = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)

    def bound(nb, ops):
        t_bytes, t_ops = nb / bw * 1e3, ops / ops_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def act(shape):
        x = torch.randn(*shape, generator=gen, device="cuda")
        return block_fp_quantizer(x, width=8, exponent_width=8,
                                  block_size=[1, 16], skip_first_dim=True)

    cfg = dataclasses.replace(MODEL_CONFIGS["facebook/opt-6.7b"](),
                              num_hidden_layers=1)
    backend, _, _ = build_random_model(cfg, rank=32, seed=SEED + 4)
    p0 = "model.decoder.layers.0"

    # ---- the relu/bias megakernel (row 3's un-gated variant)
    prep, meta = backend["arrays"][f"{p0}.mlp_fused"], \
        backend["meta"][f"{p0}.mlp_fused"]
    fmt = meta["fmt"]
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    K = prep["exps_g"].shape[0] * 16
    I, N = prep["exps_g"].shape[1], prep["exps_d"].shape[1]
    R = prep["a_d"].shape[1]
    w1 = dequantize_packed(prep["codes_g"], prep["exps_g"], fmt).to(
        torch.bfloat16)
    w2 = dequantize_packed(prep["codes_d"], prep["exps_d"], fmt).to(
        torch.bfloat16)
    b1, b2 = (prep[k].to(torch.bfloat16) for k in ("bias_g", "bias_d"))
    weights = nbytes(*(prep[k] for k in prep))
    for M in (8, 256):
        x = act((M, K)).to(torch.bfloat16)
        y = k5.mlp_w4_fused_relu(x, prep, fmt, **kw)
        ref = k5.mlp_w4_plain(x, prep, fmt, **kw)
        c = check_close(f"relu megakernel M={M}", y, ref,
                        mlp_limit(x, prep, ref, **kw), FLIPPED["mlp_fused"])
        ms = timer(lambda: k5.mlp_w4_fused_relu(x, prep, fmt, **kw))
        plain_ms = timer(lambda: k5.mlp_w4_plain(x, prep, fmt, **kw), 5)
        lib_ms = timer(lambda: torch.matmul(
            torch.relu(torch.matmul(x, w1) + b1), w2) + b2)
        b_ms, b_by = bound(weights + nbytes(x) + M * N * 4,
                           2 * M * (K * I + I * N)
                           + 2 * M * R * (K + I + I + N))
        print(f"kernel 5 mlp_fused relu/bias M={M} K={K} I={I} N={N} R={R}: "
              f"max_abs_err={c['max_abs_err']:.3g} ({c['of_limit']:.3g} of "
              f"its limit, {c['flipped']:.4%} past 2e-4) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} library_ms="
              f"{lib_ms:.4f} (torch.matmul fc1 + bias, relu, fc2 + bias, "
              "dense bf16 weights)", flush=True)
        entry = dict(max_abs_err=c["max_abs_err"], of_limit=c["of_limit"],
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms,
                     shape=f"one OPT-6.7B layer's fc1 and fc2, M={M}, I={I}")
        if M == 8:
            results["mlp_fused_relu"] = entry
        else:
            results["mlp_fused_relu"]["m256"] = entry
    del w1, w2

    # ---- kernel 1 with a bias: q|k|v and out_proj, M = 8
    for name, key in (("qkv", f"{p0}.self_attn.qkv_proj"),
                      ("out_proj", f"{p0}.self_attn.out_proj")):
        prep, meta = backend["arrays"][key], backend["meta"][key]
        fmt = meta["fmt"]
        K, N = prep["exps"].shape[0] * 16, prep["exps"].shape[1]
        R = prep["a"].shape[1]
        x = act((8, K)).to(torch.bfloat16)
        kw = dict(quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        y = k1.qlinear_w4_fused(x, prep, fmt, **kw)
        ref = k1.qlinear_w4_plain(x, prep, fmt, **kw)
        c = check_close(f"kernel 1 {name} with bias", y, ref,
                        dequant_gemm_limit(x, prep, ref, **kw),
                        FLIPPED["dequant_gemm"])
        w = dequantize_packed(prep["codes"], prep["exps"], fmt).to(
            torch.bfloat16)
        bias = prep["bias"].to(torch.bfloat16)
        ms = timer(lambda: k1.qlinear_w4_fused(x, prep, fmt, **kw))
        plain_ms = timer(lambda: k1.qlinear_w4_plain(x, prep, fmt, **kw), 5)
        lib_ms = timer(lambda: torch.addmm(bias, x, w))
        b_ms, _ = bound(nbytes(x, prep["codes"], prep["exps"], prep["a"],
                               prep["b"], prep["bias"]) + 8 * N * 4,
                        2 * 8 * N * K + 2 * 8 * R * (K + N))
        print(f"kernel 1 dequant_gemm OPT {name} with bias M=8 K={K} N={N} "
              f"R={R}: max_abs_err={c['max_abs_err']:.3g} "
              f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
              f"2e-4) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} (torch.addmm, "
              "dense bf16 weight and bias)", flush=True)
        del w
    del backend

    # ---- decode kernels with scale_query: B = 8, 32 kv heads, L = 2048
    NL, B, H, D, L, li, SW = 2, 8, 32, 128, 2048, 1, 64
    pos = torch.tensor([64, 303, 560, 815, 1088, 1343, 1600, 1984],
                       dtype=torch.int32, device="cuda")
    tokens = int(((pos + 16) // 16 * 16).clamp(max=L).sum())
    q = torch.randn(B, H, 1, D, generator=gen, device="cuda") * 3
    kw = dict(scaling=D ** -0.5, scale_query=True)
    out_bytes = B * H * D * 4

    def report(what, c, ms, plain_ms, nb, lib_ms=None):
        b_ms, b_by = bound(nb + nbytes(q) + out_bytes,
                           2 * 2 * H * tokens * D)
        lib = ("" if lib_ms is None else f" library_ms={lib_ms:.4f} "
               "(scaled_dot_product_attention on the unquantized bf16 values)")
        print(f"{what} B={B} KVH={H} L={L}, scale_query: max_abs_err="
              f"{c['max_abs_err']:.3g} ({c['of_limit']:.3g} of its limit, "
              f"{c['flipped']:.4%} past 2e-4) kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={b_ms:.4f}{lib}", flush=True)
        return dict(max_abs_err=c["max_abs_err"], of_limit=c["of_limit"],
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)

    def encoded(width, n):
        enc = mx8_encode if width == 8 else mx4_encode
        out = []
        for _ in range(2):
            c_, e_ = enc(torch.randn(NL, B, H, n, D, generator=gen,
                                     device="cuda"), 16, zero_fill=1.0)
            out += [c_.transpose(-1, -2).contiguous(),
                    e_.transpose(-1, -2).contiguous()]
        return out

    k, v = (torch.randn(NL, B, H, L, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    y = kfp.decode_attention_fp(q, k, v, pos, li, **kw)
    ref = kfp.fp_decode_plain(q, k, v, pos, li, **kw)
    sc, vals = kfp.fp_scores(q, k, v, pos, li, **kw)
    c = check_close("fp decode, scale_query", y, ref,
                    attention_limit(sc, vals, ref, p_width=8),
                    FLIPPED["attention"])
    keep = torch.arange(L, device="cuda")[None, :] <= pos[:, None].long()
    qb, kb, vb = (t.to(torch.bfloat16).contiguous() for t in (q, k[li], v[li]))
    results["decode_attention_fp"]["opt_scale_query"] = dict(
        report("fp decode attention", c,
               timer(lambda: kfp.decode_attention_fp(q, k, v, pos, li, **kw)),
               timer(lambda: kfp.fp_decode_plain(q, k, v, pos, li, **kw), 5),
               tokens * H * D * 2 * 2,
               timer(lambda: F.scaled_dot_product_attention(
                   qb, kb, vb, attn_mask=keep[:, None, None, :]))),
        shape="one layer, B=8, 32 kv heads, L=2048, pos 64..1984, "
        "scale_query (OPT)")
    del k, v, sc, vals, qb, kb, vb
    arrays = encoded(4, L)
    y = kq.decode_attention_quantized(q, *arrays, pos, li, **kw)
    ref = kq.quantized_decode_plain(q, *arrays, pos, li, **kw)
    sc, vals = kq.quantized_scores(q, *arrays, pos, li, **kw)
    c = check_close("quantized decode width 4, scale_query", y, ref,
                    attention_limit(sc, vals, ref, p_width=8),
                    FLIPPED["attention"])
    report("quantized decode attention width 4", c,
           timer(lambda: kq.decode_attention_quantized(q, *arrays, pos, li,
                                                       **kw)),
           timer(lambda: kq.quantized_decode_plain(q, *arrays, pos, li, **kw),
                 5), tokens * H * (D // 2 + D // 16) * 2)
    del arrays, sc, vals
    arrays = encoded(8, L)
    kh, vh = (torch.randn(B, H, 1, D, generator=gen, device="cuda")
              for _ in range(2))
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    y = kq.decode_attention_quantized_write(q, *mine, kh, vh, pos, li, **kw)
    ref = kq.quantized_write_plain(q, *theirs, kh, vh, pos, li, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
        raise AssertionError("fused write + attend, scale_query: written "
                             "cache bytes differ from the plain version")
    sc, vals = kq.quantized_scores(q, *theirs, pos, li, **kw)
    c = check_close("fused write + attend, scale_query", y, ref,
                    attention_limit(sc, vals, ref, p_width=8),
                    FLIPPED["attention"])
    report("fused write + attend", c,
           timer(lambda: kq.decode_attention_quantized_write(
               q, *mine, kh, vh, pos, li, **kw)),
           timer(lambda: kq.quantized_write_plain(q, *theirs, kh, vh, pos,
                                                  li, **kw), 5),
           tokens * H * (D + D // 16) * 2)
    del mine, theirs, sc, vals
    main = [a[li] for a in arrays]
    rings = [a[li].contiguous() for a in encoded(8, SW)]
    fl = (pos // 32) * 32
    r_k, r_p = [t.clone() for t in rings], [t.clone() for t in rings]
    y = k3.decode_attention_quantized_staged(q, *main, *r_k, kh, vh, pos, fl,
                                             **kw)
    ref = k3.staged_decode_plain(q, *main, *r_p, kh, vh, pos, fl, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(r_k, r_p)):
        raise AssertionError("staged decode, scale_query: ring bytes differ "
                             "from the plain version")
    sc, vals = k3.staged_scores(q, *main, *r_p, pos, fl, **kw)
    c = check_close("staged decode, scale_query", y, ref, attention_limit(
        sc[:, :, None, :], vals, ref, p_width=8), FLIPPED["attention"])
    report("staged decode attention", c,
           timer(lambda: k3.decode_attention_quantized_staged(
               q, *main, *r_k, kh, vh, pos, fl, **kw)),
           timer(lambda: k3.staged_decode_plain(q, *main, *r_p, kh, vh, pos,
                                                fl, **kw), 5),
           tokens * H * (D + D // 16) * 2)
    del arrays, main, rings, r_k, r_p, sc, vals
    torch.cuda.empty_cache()


def phase_mistral_kernels(torch, timer, rates, results):
    """Phase 3, Mistral-7B-v0.1's shapes at the templates' rank 128: kernel
    1 on q|k|v (N = 6144, fused rank 384) and o (rank 128) and the gated
    megakernel (I = 14336, rank 128) at 8 and 256 rows; the unpack kernel
    over one layer's weights; the row write and the fused MXINT8 encode +
    write at 8 slots of 8 kv heads; then the decode kernels with the
    sliding window (4096) at 8 slots, 32 heads over 8 kv heads, d = 128:
    rows 5, 6 (widths 8 and 4) and 10 at L = 8192 and positions 6000..6030
    (the window's first key not 16-aligned), row 8 (width 8) at L = 32768
    and positions 32000..32030, each against its plain version, and timed
    beside the same launch without the window. The bound of a windowed
    row is the window's bytes; the library yardstick is
    ``scaled_dot_product_attention`` with the explicit window mask on the
    unquantized bf16 values. Adds a ``mistral`` entry to each kernel's
    results."""
    import dataclasses

    import torch.nn.functional as F

    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.ops.kernels import cache_write as kcw
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.kernels import fp_decode as kfp
    from lqer_tpu_torch.ops.kernels import mlp_fused as k5
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.ops.kernels import streaming_decode as ks
    from lqer_tpu_torch.ops.kernels.decode_attention import key_mask
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
    from lqer_tpu_torch.ops.storage import dequantize_packed
    from lqer_tpu_torch.parallel.collectives import mx4_encode, mx8_encode
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import (
        attention_limit,
        check_close,
        dequant_gemm_limit,
        mlp_limit,
    )

    bw, ops_rate = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 23)

    def bound(nb, ops):
        t_bytes, t_ops = nb / bw * 1e3, ops / ops_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def act(shape):
        x = torch.randn(*shape, generator=gen, device="cuda")
        return block_fp_quantizer(x, width=8, exponent_width=8,
                                  block_size=[1, 16], skip_first_dim=True)

    def keep(key, c, ms, plain_ms, b_ms, b_by, lib_ms, shape, **extra):
        results[key]["mistral"] = dict(
            max_abs_err=c["max_abs_err"], of_limit=c["of_limit"], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, shape=shape, **extra)

    cfg = dataclasses.replace(LlamaConfig.mistral_7b(), num_hidden_layers=1)
    backend, _, _ = build_random_model(cfg, rank=128, seed=SEED + 21)
    p0 = "model.layers.0"

    # ---- kernel 1 at rank 128: q|k|v (fused rank 384) and o
    for name, key in (("qkv", f"{p0}.self_attn.qkv_proj"),
                      ("o", f"{p0}.self_attn.o_proj")):
        prep, meta = backend["arrays"][key], backend["meta"][key]
        fmt = meta["fmt"]
        K, N = prep["exps"].shape[0] * 16, prep["exps"].shape[1]
        R = prep["a"].shape[1]
        kw = dict(quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        w = dequantize_packed(prep["codes"], prep["exps"], fmt).to(
            torch.bfloat16)
        for M in (8, 256):
            x = act((M, K)).to(torch.bfloat16)
            y = k1.qlinear_w4_fused(x, prep, fmt, **kw)
            ref = k1.qlinear_w4_plain(x, prep, fmt, **kw)
            c = check_close(f"Mistral kernel 1 {name} M={M}", y, ref,
                            dequant_gemm_limit(x, prep, ref, **kw),
                            FLIPPED["dequant_gemm"])
            ms = timer(lambda: k1.qlinear_w4_fused(x, prep, fmt, **kw))
            plain_ms = timer(lambda: k1.qlinear_w4_plain(x, prep, fmt, **kw),
                             5)
            lib_ms = timer(lambda: torch.matmul(x, w))
            b_ms, b_by = bound(nbytes(x, prep["codes"], prep["exps"],
                                      prep["a"], prep["b"]) + M * N * 4,
                               2 * M * N * K + 2 * M * R * (K + N))
            print(f"Mistral kernel 1 dequant_gemm {name} M={M} K={K} N={N} "
                  f"R={R}: max_abs_err={c['max_abs_err']:.3g} "
                  f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} "
                  f"past 2e-4) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} "
                  "(torch.matmul, dense bf16 weight)", flush=True)
            if name == "qkv" and M == 8:
                keep("dequant_gemm", c, ms, plain_ms, b_ms, b_by, lib_ms,
                     f"Mistral q|k|v, M=8, K={K}, N={N}, fused R={R}")
            elif M == 256:
                results["dequant_gemm"]["mistral"][f"{name}_m256"] = dict(
                    max_abs_err=c["max_abs_err"], of_limit=c["of_limit"],
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms,
                    shape=f"Mistral {name}, M=256, K={K}, N={N}, R={R}")
        del w

    # ---- the gated megakernel at rank 128, M = 8 and 256
    key = f"{p0}.mlp_fused"
    prep, meta = backend["arrays"][key], backend["meta"][key]
    fmt = meta["fmt"]
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    K = prep["exps_g"].shape[0] * 16
    I, N = prep["exps_g"].shape[1], prep["exps_d"].shape[1]
    R = prep["a_d"].shape[1]
    w_gu = torch.cat([dequantize_packed(prep[f"codes_{h}"], prep[f"exps_{h}"],
                                        fmt) for h in ("g", "u")],
                     1).to(torch.bfloat16)
    w_d = dequantize_packed(prep["codes_d"], prep["exps_d"], fmt).to(
        torch.bfloat16)
    weights = nbytes(*(prep[k] for k in prep))
    for M in (8, 256):
        x = act((M, K)).to(torch.bfloat16)
        y = k5.mlp_w4_fused(x, prep, fmt, **kw)
        ref = k5.mlp_w4_plain(x, prep, fmt, **kw)
        c = check_close(f"Mistral kernel 5 M={M}", y, ref,
                        mlp_limit(x, prep, ref, **kw), FLIPPED["mlp_fused"])
        ms = timer(lambda: k5.mlp_w4_fused(x, prep, fmt, **kw))
        plain_ms = timer(lambda: k5.mlp_w4_plain(x, prep, fmt, **kw), 5)
        h = torch.zeros(M, I, dtype=torch.bfloat16, device="cuda")
        lib_ms = (timer(lambda: torch.matmul(x, w_gu))
                  + timer(lambda: torch.matmul(h, w_d)))
        b_ms, b_by = bound(weights + nbytes(x) + M * N * 4,
                           2 * M * (2 * K * I + I * N)
                           + 2 * M * R * (2 * K + 2 * I + I + N))
        print(f"Mistral kernel 5 mlp_fused M={M} K={K} I={I} N={N} R={R}: "
              f"max_abs_err={c['max_abs_err']:.3g} ({c['of_limit']:.3g} of "
              f"its limit, {c['flipped']:.4%} past 2e-4) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} library_ms="
              f"{lib_ms:.4f} (torch.matmul gate|up + down, dense bf16 "
              "weights)", flush=True)
        if M == 8:
            keep("mlp_fused", c, ms, plain_ms, b_ms, b_by, lib_ms,
                 f"one Mistral layer's MLP, M=8, I={I}, R={R}")
        else:
            results["mlp_fused"]["mistral"]["m256"] = dict(
                max_abs_err=c["max_abs_err"], of_limit=c["of_limit"], ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms,
                shape=f"one Mistral layer's MLP, M=256, I={I}, R={R}")
    del w_gu, w_d, h

    # ---- the unpack kernel over one layer's five weights
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for key, halves in ((f"{p0}.self_attn.qkv_proj", ("",)),
                        (f"{p0}.self_attn.o_proj", ("",)),
                        (f"{p0}.mlp_fused", ("_g", "_u", "_d"))):
        entry, fmt = backend["arrays"][key], backend["meta"][key]["fmt"]
        for half in halves:
            codes, exps = entry["codes" + half], entry["exps" + half]
            w = k1.unpack_packed_to_bf16(codes, exps, fmt)
            if not torch.equal(w, k1.unpack_plain(codes, exps, fmt)):
                raise AssertionError(f"Mistral unpack: {key}{half} differs")
            tot["ms"] += timer(lambda: k1.unpack_packed_to_bf16(codes, exps,
                                                                fmt))
            tot["plain_ms"] += timer(lambda: k1.unpack_plain(codes, exps,
                                                             fmt), 5)
            tot["bound_ms"] += bound(nbytes(codes, exps, w), 0)[0]
    del w, backend
    print(f"Mistral kernel 6 unpack, one layer's five weights: bit-exact "
          f"kernel_ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
          f"bound_ms={tot['bound_ms']:.4f} library_ms=null", flush=True)
    results["unpack"]["mistral"] = dict(
        max_abs_err=0.0, of_limit=0.0, bound_by="bytes", library_ms=None,
        shape="sum over one Mistral layer's q|k|v, o, gate, up and down",
        **tot)

    # ---- decode with the window: B = 8, 32 heads, 8 kv heads
    B, H, KVH, D, li, WIN = 8, 32, 8, 128, 1, cfg.sliding_window
    scale = D ** -0.5
    q = torch.randn(B, H, 1, D, generator=gen, device="cuda")
    out_bytes = B * H * D * 4

    def window_tokens(pos, win):
        """Keys a slot reads: whole 16-token groups from the one holding
        the window's first key (0 without a window) to the one holding
        pos."""
        lo = (pos - win + 1).clamp(min=0) // 16 * 16 if win else 0
        return int(((pos + 16) // 16 * 16 - lo).sum())

    def sdpa_ms(k_bf16, v_bf16, pos, L, win=WIN):
        qb, kb, vb = (t.to(torch.bfloat16).contiguous()
                      for t in (q, k_bf16, v_bf16))
        m = key_mask(L, pos, win)[:, None, None, :]
        return timer(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=m, enable_gqa=True))

    def report(key, what, run, plain, scores, L, pos, per_token, lib_ms,
               extra_bytes=0, lib_all_ms=None):
        y, ref = run(WIN), plain()
        s, vals = scores()
        c = check_close(what, y, ref, attention_limit(s, vals, ref,
                                                      p_width=8),
                        FLIPPED["attention"])
        del s, vals
        ms, ms_all = timer(lambda: run(WIN)), timer(lambda: run(None))
        split = launch_split(torch, lambda: run(WIN))
        plain_ms = timer(plain, 3)
        tokens = window_tokens(pos, WIN)
        b_ms, b_by = bound(tokens * KVH * per_token + nbytes(q) + out_bytes
                           + extra_bytes, 2 * 2 * H * tokens * D)
        all_ms = bound(window_tokens(pos, 0) * KVH * per_token + nbytes(q)
                       + out_bytes + extra_bytes, 0)[0]
        lib_all = ("" if lib_all_ms is None
                   else f", SDPA {lib_all_ms:.4f} with the causal mask")
        print(f"{what} B={B} H={H} KVH={KVH} L={L} window={WIN} "
              f"pos={pos.tolist()}: max_abs_err={c['max_abs_err']:.3g} "
              f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
              f"2e-4) kernel_ms={ms:.4f} (per launch: {split}; without the "
              f"window {ms_all:.4f}, bound {all_ms:.4f}{lib_all}) "
              f"plain_ms={plain_ms:.4f} bound_ms="
              f"{b_ms:.4f} (the window's bytes) library_ms={lib_ms:.4f} "
              "(scaled_dot_product_attention, window mask, unquantized "
              "bf16)", flush=True)
        shape = (f"one layer, B=8, 32 heads over 8 kv heads, L={L}, window "
                 f"{WIN}, pos {pos.min().item()}..{pos.max().item()}")
        extra = dict(unwindowed_ms=ms_all, unwindowed_bound_ms=all_ms,
                     unwindowed_library_ms=lib_all_ms, launch_split_ms=split)
        if key:
            keep(key, c, ms, plain_ms, b_ms, b_by, lib_ms, shape, **extra)
        return dict(max_abs_err=c["max_abs_err"], of_limit=c["of_limit"],
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, shape=shape, **extra)

    L = 8192
    pos = torch.tensor([6000, 6001, 6003, 6007, 6010, 6013, 6021, 6030],
                       dtype=torch.int32, device="cuda")
    k, v = (torch.randn(2, B, KVH, L, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    report("decode_attention_fp", "Mistral fp decode attention",
           lambda w: kfp.decode_attention_fp(q, k, v, pos, li, scaling=scale,
                                             window=w),
           lambda: kfp.fp_decode_plain(q, k, v, pos, li, scaling=scale,
                                       window=WIN),
           lambda: kfp.fp_scores(q, k, v, pos, li, scaling=scale, window=WIN),
           L, pos, D * 2 * 2, sdpa_ms(k[li], v[li], pos, L),
           lib_all_ms=sdpa_ms(k[li], v[li], pos, L, None))
    del k, v
    # row 5 at the bf16 cache's longest length, 12288, near position 12000
    pos12 = pos + 6000
    k, v = (torch.randn(2, B, KVH, 12288, D, generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    results["decode_attention_fp"]["mistral_12288"] = report(
        None, "Mistral fp decode attention at max_len 12288",
        lambda w: kfp.decode_attention_fp(q, k, v, pos12, li, scaling=scale,
                                          window=w),
        lambda: kfp.fp_decode_plain(q, k, v, pos12, li, scaling=scale,
                                    window=WIN),
        lambda: kfp.fp_scores(q, k, v, pos12, li, scaling=scale, window=WIN),
        12288, pos12, D * 2 * 2, sdpa_ms(k[li], v[li], pos12, 12288),
        lib_all_ms=sdpa_ms(k[li], v[li], pos12, 12288, None))
    del k, v

    def encoded(width, n):
        enc = mx8_encode if width == 8 else mx4_encode
        out = []
        for _ in range(2):
            c_, e_ = enc(torch.randn(B, KVH, n, D, generator=gen,
                                     device="cuda"), 16, zero_fill=1.0)
            for t in (c_, e_):
                full = torch.zeros(2, *t.transpose(-1, -2).shape,
                                   dtype=torch.int8, device="cuda")
                full[li] = t.transpose(-1, -2)
                out.append(full)
        return out

    def sdpa_of(arrays, pos, L):
        kb, vb = (kq._decode_cache_block(arrays[i][li], arrays[i + 1][li])
                  .transpose(-1, -2) for i in (0, 2))
        ms = sdpa_ms(kb, vb, pos, L)
        del kb, vb
        return ms

    kw = dict(scaling=scale, window=WIN)
    for width in (8, 4):
        arrays = encoded(width, L)
        entry = report(
               "decode_attention_quantized" if width == 4 else None,
               f"Mistral quantized decode attention width {width}",
               lambda w: kq.decode_attention_quantized(
                   q, *arrays, pos, li, scaling=scale, window=w),
               lambda: kq.quantized_decode_plain(q, *arrays, pos, li, **kw),
               lambda: kq.quantized_scores(q, *arrays, pos, li, **kw),
               L, pos, (arrays[0].shape[-2] + D // 16) * 2,
               sdpa_of(arrays, pos, L))
        if width == 4:
            results["decode_attention_quantized"]["mistral"]["width8"] = \
                width8
            del arrays
            continue
        width8 = entry
        kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
                  for _ in range(2))
        mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
        kq.decode_attention_quantized_write(q, *mine, kh, vh, pos, li, **kw)
        kq.quantized_write_plain(q, *theirs, kh, vh, pos, li, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
            raise AssertionError("Mistral fused write + attend: written "
                                 "cache bytes differ from the plain version")
        report("decode_attention_write", "Mistral fused write + attend",
               lambda w: kq.decode_attention_quantized_write(
                   q, *mine, kh, vh, pos, li, scaling=scale, window=w),
               lambda: kq.quantized_write_plain(q, *theirs, kh, vh, pos, li,
                                                **kw),
               lambda: kq.quantized_scores(q, *theirs, pos, li, **kw),
               L, pos, (D + D // 16) * 2, sdpa_of(arrays, pos, L),
               nbytes(kh, vh) + 2 * B * KVH * (D + D // 16))
        del arrays, mine, theirs

    # ---- row 8 at L = 32768, near position 32000
    L = 32768
    pos = pos + 26000
    arrays = encoded(8, L)
    report("decode_attention_streaming",
           "Mistral streaming decode attention width 8",
           lambda w: ks.decode_attention_quantized_streaming(
               q, *arrays, pos, li, scaling=scale, window=w),
           lambda: kq.quantized_decode_plain(q, *arrays, pos, li, **kw),
           lambda: kq.quantized_scores(q, *arrays, pos, li, **kw),
           L, pos, (D + D // 16) * 2, sdpa_of(arrays, pos, L))
    del arrays

    # ---- row 13 (L = 32768) and row 11 (bf16 rows, L = 8192) at 8 kv heads
    arrays = encoded(8, L)
    kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
              for _ in range(2))
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    kcw.write_kv_tokens_fused(tuple(mine), kh, vh, li, pos)
    kcw.encode_write_plain(tuple(theirs), kh, vh, li, pos)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
        raise AssertionError("Mistral fused encode + write differs")
    ms = timer(lambda: kcw.write_kv_tokens_fused(tuple(mine), kh, vh, li,
                                                 pos))
    plain_ms = timer(lambda: kcw.encode_write_plain(tuple(theirs), kh, vh,
                                                    li, pos), 5)
    b_ms, b_by = bound(nbytes(kh, vh) + 2 * B * KVH * (D + D // 16), 0)
    print(f"Mistral fused encode + write B={B} KVH={KVH} L={L}: bit-exact "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f}; "
          f"the earlier kernel {EARLIER_MS['row 13 Mistral']} ms", flush=True)
    results["encode_write_tokens"]["mistral"] = dict(
        max_abs_err=0.0, of_limit=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="the K and V rows of 8 slots, 8 kv heads, d=128, L=32768")
    del arrays, mine, theirs
    L = 8192
    arrays = [torch.randn(2, B, KVH, L, D, generator=gen,
                          device="cuda").to(torch.bfloat16) for _ in range(2)]
    news = [torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
            for _ in range(2)]
    pos = pos - 26000
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    kcw.write_kv_rows_stacked(tuple(mine), tuple(news), li, pos)
    kcw.write_rows_plain(tuple(theirs), tuple(news), li, pos)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
        raise AssertionError("Mistral row write differs")
    ms = timer(lambda: kcw.write_kv_rows_stacked(tuple(mine), tuple(news),
                                                li, pos))
    plain_ms = timer(lambda: kcw.write_rows_plain(tuple(theirs), tuple(news),
                                                  li, pos), 5)
    b_ms, b_by = bound(sum(n.numel() * 6 for n in news), 0)
    print(f"Mistral row write, the bf16 K and V rows of {B} slots, {KVH} kv "
          f"heads: bit-exact kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f}; the earlier kernel "
          f"{EARLIER_MS['row 11 Mistral']} ms", flush=True)
    results["row_write"]["mistral"] = dict(
        max_abs_err=0.0, of_limit=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="the bf16 K and V rows of 8 slots, 8 kv heads, d=128")
    del arrays, mine, theirs
    torch.cuda.empty_cache()


def phase_head_dim_kernels(torch, timer, rates, results):
    """Phase 3 at facebook/opt-2.7b's decode shape (32 heads of d = 80, one
    query per kv head): rows 6 (width 8; MXINT4 needs d % 32 == 0) and 10
    at 8 slots, L = 2048, positions 64..1984, each with its per-launch
    split, and rows 7 (flushed = positions rounded down to 32), 8 and 9 on
    the same MXINT8 cache, against their plain versions; the library
    yardstick is ``scaled_dot_product_attention`` on the unquantized bf16
    values. Adds an ``opt_2_7b`` entry to each kernel's results."""
    import torch.nn.functional as F

    from lqer_tpu_torch.ops.kernels import decode_attention as k3
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.ops.kernels import streaming_decode as ks
    from lqer_tpu_torch.parallel.collectives import mx8_encode
    from lqer_tpu_torch.testing import attention_limit, check_close

    bw, ops_rate = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 29)
    NL, B, H, KVH, D, L, SW, li = 2, 8, 32, 32, 80, 2048, 64, 1
    scale = D ** -0.5
    pos = torch.tensor([64, 303, 560, 815, 1088, 1343, 1600, 1984],
                       dtype=torch.int32, device="cuda")
    fl = (pos // 32) * 32
    q = torch.randn(B, H, 1, D, generator=gen, device="cuda")
    kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
              for _ in range(2))
    per_token = KVH * (D + D // 16) * 2      # K and V codes + exponents
    column = 2 * B * KVH * (D + D // 16)     # the fresh K/V column written

    def encoded(n):
        out = []
        for _ in range(2):
            c_, e_ = mx8_encode(torch.randn(NL, B, KVH, n, D, generator=gen,
                                            device="cuda"), 16, zero_fill=1.0)
            out += [c_.transpose(-1, -2).contiguous(),
                    e_.transpose(-1, -2).contiguous()]
        return out

    arrays = encoded(L)
    rings = [a[li].contiguous() for a in encoded(SW)]
    main = [a[li] for a in arrays]
    kb, vb = (kq._decode_cache_block(arrays[i][li], arrays[i + 1][li])
              .transpose(-1, -2).to(torch.bfloat16).contiguous()
              for i in (0, 2))
    qb = q.to(torch.bfloat16)
    mask = (torch.arange(L, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                          attn_mask=mask))
    del kb, vb
    tokens = int(((pos + 16) // 16 * 16).sum())
    staged_tokens = int((pos + 1).sum())     # main [0, flushed) + the ring
    kw = dict(scaling=scale)

    def bound(nb, ops):
        t_bytes, t_ops = nb / bw * 1e3, ops / ops_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def held(key, what, run, plain, scores, nb, n_tok, extra=""):
        y, ref = run(), plain()
        s_, vals = scores()
        c = check_close(f"d = 80 {what}", y, ref,
                        attention_limit(s_, vals, ref, p_width=8),
                        FLIPPED["attention"])
        del s_, vals
        ms = timer(run)
        split = launch_split(torch, run)
        plain_ms = timer(plain, 5)
        b_ms, b_by = bound(nb + nbytes(q) + B * H * D * 4,
                           2 * 2 * H * n_tok * D)
        print(f"d = 80 {what} B={B} H={H} KVH={KVH} L={L} "
              f"pos={pos.tolist()}: max_abs_err={c['max_abs_err']:.3g} "
              f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
              f"2e-4){extra} kernel_ms={ms:.4f} (per launch: {split}) "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} library_ms="
              f"{lib_ms:.4f} (scaled_dot_product_attention, unquantized "
              "bf16)", flush=True)
        results[key]["opt_2_7b"] = dict(
            max_abs_err=c["max_abs_err"], of_limit=c["of_limit"], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, launch_split_ms=split,
            shape="one layer of an MXINT8 cache, B=8, 32 kv heads of d=80, "
                  "L=2048, pos 64..1984")

    held("decode_attention_quantized", "quantized decode attention width 8",
         lambda: kq.decode_attention_quantized(q, *arrays, pos, li, **kw),
         lambda: kq.quantized_decode_plain(q, *arrays, pos, li, **kw),
         lambda: kq.quantized_scores(q, *arrays, pos, li, **kw),
         tokens * per_token, tokens)
    held("decode_attention_streaming", "streaming decode attention width 8",
         lambda: ks.decode_attention_quantized_streaming(q, *arrays, pos, li,
                                                         **kw),
         lambda: kq.quantized_decode_plain(q, *arrays, pos, li, **kw),
         lambda: kq.quantized_scores(q, *arrays, pos, li, **kw),
         tokens * per_token, tokens)
    for key, fn, what in (
            ("decode_attention", k3.decode_attention_quantized_staged,
             "staged decode attention"),
            ("decode_attention_streaming_staged",
             ks.decode_attention_quantized_streaming_staged,
             "streaming staged decode attention")):
        mine, theirs = [r.clone() for r in rings], [r.clone() for r in rings]
        fn(q, *main, *mine, kh, vh, pos, fl, **kw)
        k3.staged_decode_plain(q, *main, *theirs, kh, vh, pos, fl, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
            raise AssertionError(f"d = 80 {what}: ring bytes differ")
        held(key, what,
             lambda: fn(q, *main, *mine, kh, vh, pos, fl, **kw),
             lambda: k3.staged_decode_plain(q, *main, *theirs, kh, vh, pos,
                                            fl, **kw),
             lambda: (lambda s_, v_: (s_[:, :, None, :], v_))(
                 *k3.staged_scores(q, *main, *theirs, pos, fl, **kw)),
             staged_tokens * per_token + nbytes(kh, vh) + column,
             staged_tokens, ", rings bit-exact" + (
                 f", the earlier kernel {EARLIER_MS['row 9 d = 80']} ms,"
                 if key == "decode_attention_streaming_staged" else ""))
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    kq.decode_attention_quantized_write(q, *mine, kh, vh, pos, li, **kw)
    kq.quantized_write_plain(q, *theirs, kh, vh, pos, li, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
        raise AssertionError("d = 80 fused write + attend: written cache "
                             "bytes differ from the plain version")
    held("decode_attention_write", "fused write + attend",
         lambda: kq.decode_attention_quantized_write(q, *mine, kh, vh, pos,
                                                     li, **kw),
         lambda: kq.quantized_write_plain(q, *theirs, kh, vh, pos, li, **kw),
         lambda: kq.quantized_scores(q, *theirs, pos, li, **kw),
         tokens * per_token + nbytes(kh, vh) + column, tokens,
         ", written column bit-exact")
    del arrays, rings, main, mine, theirs
    torch.cuda.empty_cache()


def phase_slice7_kernels(torch, timer, rates, results):
    """Phase 3, the kernels of the staged MXINT4 cache, the in-kernel
    activation quantizer and the all-layer row write: row 7 at code width 4
    (8 slots, 32 kv heads, d = 128, L = 2048) and row 9 at width 4
    (L = 32768), rings bit-exact; kernel 1 (q|k|v and o) and the gated
    megakernel with ``quant_x_width = 8`` on raw f32 X at M = 8, at Llama's
    rank 32 and at Mistral's rank 128 (q|k|v's fused rank 384), each equal
    to the launch fed the separate quantizer's values and timed beside
    quantizer + kernel; row 12 over 32 layers x 8 slots x 32 kv heads at
    L = 2048 for the MXINT8 and MXINT4 columns and the bf16 rows,
    bit-exact with its plain version and with 32 launches of row 11, timed
    beside ``index_put_``. Width-4 and rank-128 numbers ride on their
    entries as ``width4`` and ``rank128``."""
    import dataclasses

    import torch.nn.functional as F

    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.ops.kernels import cache_write as kcw
    from lqer_tpu_torch.ops.kernels import decode_attention as k3
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.kernels import mlp_fused as k5
    from lqer_tpu_torch.ops.kernels import streaming_decode as ks
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
    from lqer_tpu_torch.ops.storage import dequantize_packed
    from lqer_tpu_torch.parallel.collectives import mx4_encode
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import (
        attention_limit,
        check_close,
        dequant_gemm_limit,
        mlp_limit,
    )

    bw, ops_rate = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 31)

    def bound(nb, ops):
        t_bytes, t_ops = nb / bw * 1e3, ops / ops_rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def entry(c, ms, plain_ms, b_ms, b_by, lib_ms, shape, **extra):
        return dict(max_abs_err=c["max_abs_err"], of_limit=c["of_limit"],
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, shape=shape, **extra)

    def line(what, c, ms, plain_ms, b_ms, lib_ms, lib_what, extra=""):
        print(f"{what}: max_abs_err={c['max_abs_err']:.3g} "
              f"({c['of_limit']:.3g} of its limit, {c['flipped']:.4%} past "
              f"2e-4){extra} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} library_ms="
              f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} ({lib_what})",
              flush=True)

    # ---- rows 7 and 9 at code width 4: the staged MXINT4 cache
    B, H, KVH, D, SW = 8, 32, 32, 128, 64
    scale = D ** -0.5

    def w4_block(n):
        c_, e_ = mx4_encode(torch.randn(B, KVH, n, D, generator=gen,
                                        device="cuda"), 16, zero_fill=1.0)
        return [c_.transpose(-1, -2).contiguous(),
                e_.transpose(-1, -2).contiguous()]

    q = torch.randn(B, H, 1, D, generator=gen, device="cuda")
    kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
              for _ in range(2))
    per_token = KVH * (D // 2 + D // 16) * 2         # K and V codes + exps
    for key, L, fn, what in (
            ("decode_attention", 2048, k3.decode_attention_quantized_staged,
             "kernel 3 decode_attention width 4"),
            ("decode_attention_streaming_staged", 32768,
             ks.decode_attention_quantized_streaming_staged,
             "streaming staged decode attention width 4")):
        main = w4_block(L) + w4_block(L)
        ring = w4_block(SW) + w4_block(SW)
        if L == 2048:
            fl = torch.tensor([1984, 1952, 1920, 1024, 1536, 1984, 64, 1888],
                              dtype=torch.int32, device="cuda")
            pos = fl + torch.tensor([0, 1, 15, 47, 16, 33, 31, 40],
                                    dtype=torch.int32, device="cuda")
        else:   # flushed > 0 everywhere (the JAX kernel's NaN at 0)
            pos = torch.tensor([64, 511, 512, 4095, 12288, 20001, 28671,
                                32767], dtype=torch.int32, device="cuda")
            fl = (pos // 32) * 32
        r_k, r_p = [t.clone() for t in ring], [t.clone() for t in ring]
        y = fn(q, *main, *r_k, kh, vh, pos, fl, scaling=scale)
        ref = k3.staged_decode_plain(q, *main, *r_p, kh, vh, pos, fl,
                                     scaling=scale)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(r_k, r_p)):
            raise AssertionError(f"{what}: ring bytes differ from the plain "
                                 "version")
        sc, vals = k3.staged_scores(q, *main, *r_p, pos, fl, scaling=scale)
        c = check_close(what, y, ref, attention_limit(
            sc[:, :, None, :], vals, ref, p_width=8), FLIPPED["attention"])
        del sc, vals, ref
        ms = timer(lambda: fn(q, *main, *r_k, kh, vh, pos, fl, scaling=scale))
        plain_ms = timer(lambda: k3.staged_decode_plain(
            q, *main, *r_p, kh, vh, pos, fl, scaling=scale), 3)
        held = int(fl.sum()) + int((pos - fl + 1).sum())
        b_ms, b_by = bound(held * per_token + nbytes(q, kh, vh)
                           + B * H * D * 4 + B * KVH * (D // 2 + D // 16) * 2,
                           2 * 2 * H * held * D)
        earlier = (f", the earlier kernel {EARLIER_MS['row 9 width 4']} ms,"
                   if L == 32768 else "")
        line(f"{what} B={B} KVH={KVH} L={L} flushed={fl.tolist()}", c, ms,
             plain_ms, b_ms, None, "no library call computes it",
             f", rings bit-exact{earlier}")
        results[key]["width4"] = entry(
            c, ms, plain_ms, b_ms, b_by, None,
            f"one layer of an MXINT4 staged cache, B=8, 32 kv heads, L={L}")
        del main, ring, r_k, r_p
    torch.cuda.empty_cache()

    # ---- kernel 1 and the megakernel with the in-kernel X quantizer, M = 8
    def raw(shape):   # unquantized f32, the scale of phase 3's inputs
        return torch.randn(*shape, generator=gen, device="cuda")

    def quantizer(x):
        return block_fp_quantizer(x, width=8, exponent_width=8,
                                  block_size=[1, 16],
                                  skip_first_dim=True).to(torch.bfloat16)

    for model, rank in (("Llama", 32), ("Mistral", 128)):
        cfg = (LlamaConfig.llama_7b() if model == "Llama"
               else LlamaConfig.mistral_7b())
        cfg = dataclasses.replace(cfg, num_hidden_layers=1)
        backend, _, _ = build_random_model(cfg, rank=rank, seed=SEED + 33)
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   ext_ms=0.0, err=0.0, of_limit=0.0)
        for name in ("qkv", "o"):
            key = ("model.layers.0.self_attn.qkv_proj" if name == "qkv"
                   else "model.layers.0.self_attn.o_proj")
            prep, meta = backend["arrays"][key], backend["meta"][key]
            fmt = meta["fmt"]
            K, N = prep["exps"].shape[0] * 16, prep["exps"].shape[1]
            R = prep["a"].shape[1]
            kw = dict(quant_xa_width=meta["xa_width"],
                      quant_out_width=meta["out_width"])
            x = raw((8, K))
            y = k1.qlinear_w4_fused(x, prep, fmt, quant_x_width=8, **kw)
            xq = k1.quantize_x_plain(x, 8)
            ext = k1.qlinear_w4_fused(quantizer(x), prep, fmt, **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, ext):
                raise AssertionError(f"{model} kernel 1 {name} with "
                                     "quant_x_width differs from the launch "
                                     "fed the separate quantizer")
            ref = k1.qlinear_w4_plain(x, prep, fmt, quant_x_width=8, **kw)
            c = check_close(f"{model} kernel 1 {name} quant_x_width=8", y,
                            ref, dequant_gemm_limit(xq, prep, ref, **kw),
                            FLIPPED["dequant_gemm"])
            w = dequantize_packed(prep["codes"], prep["exps"], fmt).to(
                torch.bfloat16)
            ms = timer(lambda: k1.qlinear_w4_fused(x, prep, fmt,
                                                   quant_x_width=8, **kw))
            ext_ms = timer(lambda: k1.qlinear_w4_fused(quantizer(x), prep,
                                                       fmt, **kw))
            plain_ms = timer(lambda: k1.qlinear_w4_plain(
                x, prep, fmt, quant_x_width=8, **kw), 5)
            xb = xq.to(torch.bfloat16)
            lib_ms = timer(lambda: torch.matmul(xb, w))
            b_ms, b_by = bound(nbytes(x, prep["codes"], prep["exps"],
                                      prep["a"], prep["b"]) + 8 * N * 4,
                               2 * 8 * N * K + 2 * 8 * R * (K + N))
            line(f"{model} kernel 1 dequant_gemm quant_x {name} M=8 K={K} N={N} "
                 f"R={R}", c, ms, plain_ms, b_ms, lib_ms, "torch.matmul, "
                 "dense bf16 weight", f", equal to the launch after the "
                 f"separate quantizer (quantizer + kernel {ext_ms:.4f} ms)")
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", b_ms), ("library_ms", lib_ms),
                         ("ext_ms", ext_ms)):
                tot[k] += v
            tot["err"] = max(tot["err"], c["max_abs_err"])
            tot["of_limit"] = max(tot["of_limit"], c["of_limit"])
            del w
        k1_entry = dict(
            max_abs_err=tot["err"], of_limit=tot["of_limit"], ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes", library_ms=tot["library_ms"],
            external_quantizer_ms=tot["ext_ms"],
            shape=f"sum over {model} q|k|v and o at M=8, rank {rank}")

        key = "model.layers.0.mlp_fused"
        prep, meta = backend["arrays"][key], backend["meta"][key]
        fmt = meta["fmt"]
        kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        K = prep["exps_g"].shape[0] * 16
        I, N = prep["exps_g"].shape[1], prep["exps_d"].shape[1]
        x = raw((8, K))
        y = k5.mlp_w4_fused(x, prep, fmt, quant_x_width=8, **kw)
        xq = k1.quantize_x_plain(x, 8)
        ext = k5.mlp_w4_fused(quantizer(x), prep, fmt, **kw)
        torch.cuda.synchronize()
        if not torch.equal(y, ext):
            raise AssertionError(f"{model} megakernel with quant_x_width "
                                 "differs from the launch fed the separate "
                                 "quantizer")
        ref = k5.mlp_w4_plain(x, prep, fmt, quant_x_width=8, **kw)
        c = check_close(f"{model} megakernel quant_x_width=8", y, ref,
                        mlp_limit(xq, prep, ref, **kw), FLIPPED["mlp_fused"])
        ms = timer(lambda: k5.mlp_w4_fused(x, prep, fmt, quant_x_width=8,
                                           **kw))
        ext_ms = timer(lambda: k5.mlp_w4_fused(quantizer(x), prep, fmt, **kw))
        plain_ms = timer(lambda: k5.mlp_w4_plain(x, prep, fmt,
                                                 quant_x_width=8, **kw), 5)
        w_gu = torch.cat([dequantize_packed(prep[f"codes_{h}"],
                                            prep[f"exps_{h}"], fmt)
                          for h in ("g", "u")], 1).to(torch.bfloat16)
        w_d = dequantize_packed(prep["codes_d"], prep["exps_d"], fmt).to(
            torch.bfloat16)
        xb = xq.to(torch.bfloat16)
        h = torch.zeros(8, I, dtype=torch.bfloat16, device="cuda")
        lib_ms = (timer(lambda: torch.matmul(xb, w_gu))
                  + timer(lambda: torch.matmul(h, w_d)))
        b_ms, b_by = bound(nbytes(*(prep[k] for k in prep)) + nbytes(x)
                           + 8 * N * 4, 2 * 8 * (2 * K * I + I * N)
                           + 2 * 8 * rank * (2 * K + 2 * I + I + N))
        line(f"{model} kernel 5 mlp_fused quant_x M=8 K={K} I={I} N={N} "
             f"R={rank}", c, ms, plain_ms, b_ms, lib_ms, "torch.matmul "
             "gate|up + down, dense bf16 weights", f", equal to the launch "
             f"after the separate quantizer (quantizer + kernel "
             f"{ext_ms:.4f} ms)")
        k5_entry = entry(c, ms, plain_ms, b_ms, b_by, lib_ms,
                         f"one {model} layer's MLP, M=8, I={I}, rank {rank}",
                         external_quantizer_ms=ext_ms)
        if model == "Llama":
            results["dequant_gemm"]["quant_x"] = k1_entry
            results["mlp_fused"]["quant_x"] = k5_entry
        else:
            results["dequant_gemm"]["quant_x"]["rank128"] = k1_entry
            results["mlp_fused"]["quant_x"]["rank128"] = k5_entry
        del backend, prep, w_gu, w_d, h
        torch.cuda.empty_cache()

    # ---- row 12: every layer's token in one launch
    NL, L = 32, 2048
    pos = torch.tensor([0, 17, 255, 1024, 1500, 2000, 2046, 2047],
                       dtype=torch.int32, device="cuda")
    bi = torch.arange(B, device="cuda")[None, :, None, None]
    li_ = torch.arange(NL, device="cuda")[:, None, None, None]
    kvi = torch.arange(KVH, device="cuda")[None, None, :, None]
    p64 = pos.long()[None, :, None, None]
    for kind in ("mxint8 columns", "mxint4 columns", "bf16 rows"):
        if kind == "bf16 rows":
            arrays = [torch.zeros(NL, B, KVH, L, D, dtype=torch.bfloat16,
                                  device="cuda") for _ in range(2)]
            news = [torch.randn(NL, B, KVH, 1, D, generator=gen,
                                device="cuda") for _ in range(2)]
        else:
            rows = [D if kind == "mxint8 columns" else D // 2, D // 16] * 2
            arrays = [torch.zeros(NL, B, KVH, r, L, dtype=torch.int8,
                                  device="cuda") for r in rows]
            news = [torch.randint(-127, 128, (NL, B, KVH, r, 1),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8) for r in rows]
        mine = [a.clone() for a in arrays]
        kcw.write_kv_rows_all_layers(tuple(mine), tuple(news), pos)
        theirs = [a.clone() for a in arrays]
        kcw.write_rows_all_layers_plain(tuple(theirs), tuple(news), pos)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
            raise AssertionError(f"row write of every layer, {kind}: bytes "
                                 "differ from the plain version")
        del theirs
        per = [a.clone() for a in arrays]
        for li in range(NL):
            kcw.write_kv_rows_stacked(tuple(per), tuple(n[li] for n in news),
                                      li, pos)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(mine, per)):
            raise AssertionError(f"row write of every layer, {kind}: bytes "
                                 "differ from 32 single-layer launches")
        del per

        def row11():
            for li in range(NL):
                kcw.write_kv_rows_stacked(tuple(mine),
                                          tuple(n[li] for n in news), li, pos)

        def index_put():
            for arr, new in zip(mine, news):
                if new.shape[4] == 1 and arr.shape[4] > 1:   # columns
                    r = torch.arange(arr.shape[3], device="cuda")[
                        None, None, None, :]
                    arr.index_put_((li_, bi, kvi, r, p64),
                                   new[..., 0].to(arr.dtype))
                else:
                    c_ = torch.arange(arr.shape[4], device="cuda")[
                        None, None, None, :]
                    arr.index_put_((li_, bi, kvi, p64, c_),
                                   new[:, :, :, 0, :].to(arr.dtype))

        ms = timer(lambda: kcw.write_kv_rows_all_layers(tuple(mine),
                                                        tuple(news), pos))
        row11_ms = timer(row11)
        plain_ms = timer(lambda: kcw.write_rows_all_layers_plain(
            tuple(mine), tuple(news), pos), 3)
        lib_ms = timer(index_put)
        written = sum(n.numel() * a.element_size()
                      for a, n in zip(mine, news))
        b_ms, b_by = bound(nbytes(*news) + written, 0)
        print(f"row write of every layer ({kind}) NL={NL} B={B} KVH={KVH} "
              f"L={L}: bit-exact with its plain version and with {NL} "
              f"row-write launches kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={b_ms:.4f} library_ms={lib_ms:.4f} "
              f"(index_put_ of every layer's rows); {NL} row-write launches "
              f"{row11_ms:.4f} ms; the earlier kernel "
              f"{EARLIER_MS['row 12 ' + kind]} ms", flush=True)
        if kind == "mxint8 columns":
            results["row_write_all"] = dict(
                max_abs_err=0.0, of_limit=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                row_write_x32_ms=row11_ms,
                shape="the MXINT8 K/V columns of 32 layers, 8 slots, 32 kv "
                      "heads, d=128, L=2048")
        else:
            results["row_write_all"][kind.split()[0]] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, library_ms=lib_ms,
                row_write_x32_ms=row11_ms)
        del arrays, mine, news
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_versions_on_card():
    """Route the served path's kernel calls to the plain versions, which
    then run on CUDA tensors; every launch counter must stay at 0."""
    from lqer_tpu_torch.ops.kernels import attention as k2
    from lqer_tpu_torch.ops.kernels import cache_write as k4
    from lqer_tpu_torch.ops.kernels import decode_attention as k3
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.kernels import fp_decode as kfp
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.ops.kernels import mlp_fused as k5
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.serving import decode, kernel_backend

    swaps = [(kernel_backend, "qlinear_w4_fused", k1.qlinear_w4_plain),
             (decode, "qlinear_w4_fused", k1.qlinear_w4_plain),
             (kernel_backend, "mlp_w4_fused", k5.mlp_w4_plain),
             (k1, "unpack_packed_to_bf16", k1.unpack_plain),
             (decode, "decode_attention_quantized_staged",
              k3.staged_decode_plain),
             (decode, "flush_stage_to_main", k4.flush_plain),
             (k2, "quantized_attention", k2.quantized_attention_plain),
             (decode, "decode_attention_fp", kfp.fp_decode_plain),
             (decode, "decode_attention_quantized", kq.quantized_decode_plain),
             (decode, "decode_attention_quantized_write",
              kq.quantized_write_plain),
             (decode, "write_kv_rows_stacked", k4.write_rows_plain),
             (decode, "write_kv_tokens_fused", k4.encode_write_plain),
             (decode, "decode_attention_quantized_streaming",
              kq.quantized_decode_plain),
             (decode, "decode_attention_quantized_streaming_staged",
              k3.staged_decode_plain)]
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


@contextlib.contextmanager
def weights_decoded_once():
    """Decode each packed weight once while the plain versions run on the
    CPU. They decode every weight per call, nine tenths of a CPU decode
    step at 7B width; a decoded weight is a function of its packed words
    alone, so every value stays the same. The memo holds each packed
    tensor, so no other weight can take its address while it lives."""
    from lqer_tpu_torch.ops import storage
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.kernels import mlp_fused as k5

    memo = {}

    def decoded(words, exps, fmt):
        key = (words.data_ptr(), tuple(words.shape), words.stride(),
               exps.data_ptr(), tuple(exps.shape), exps.stride(), fmt)
        if key not in memo:
            memo[key] = (words, exps,
                         storage.dequantize_packed(words, exps, fmt))
        return memo[key][2]

    saved = [(m, m.dequantize_packed) for m in (k1, k5)]
    for m, _ in saved:
        m.dequantize_packed = decoded
    try:
        yield
    finally:
        for m, f in saved:
            m.dequantize_packed = f


def run_context(name: str):
    """How the engine called ``name`` runs: "plain" through the plain
    versions on the card, "cpu" through them on the CPU with each weight
    decoded once, any other through the kernels."""
    if name == "plain":
        return plain_versions_on_card()
    if name == "cpu":
        return weights_decoded_once()
    return contextlib.nullcontext()


def snapshot(engine, n: int | None = None) -> types.SimpleNamespace:
    """The first ``n`` slots of an engine's cache (on the CPU) and lengths,
    for a comparison made later (the engine runs on meanwhile)."""
    n = engine.num_slots if n is None else n
    return types.SimpleNamespace(
        num_slots=n, lengths=engine.lengths[:n].copy(),
        cache={k: (v[:, :n] if v.ndim == 5 else v[:n]).cpu().clone()
               for k, v in engine.cache.items()})


def _cpu_worker_init(root: str, threads: int) -> None:
    """A CPU worker: the repository importable, ``threads`` threads, and a
    lower scheduling priority than the process that drives the card."""
    import torch

    sys.path.insert(0, root)
    torch.set_num_threads(threads)
    os.nice(10)


_CPU_MODELS: dict = {}


def cpu_job(job: dict) -> str:
    """One CPU engine of phase 4, in a worker process: the model of
    ``job["model"]`` (CPU params and backend, loaded once per worker) in a
    ``DecodeEngine`` on the CPU, its packed weights each decoded once; an
    admission of ``padded``/``lengths`` (or, with ``cache``, a copy of a
    card engine's cache and lengths instead), then one decode step per
    array of ``tokens``. Saves the logits, the cache and the lengths to a
    file and returns its path: tensors travel through files, not shared
    memory."""
    import torch

    from lqer_tpu_torch import models
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import q_config_for

    t0 = time.perf_counter()
    path = job["model"]
    if path not in _CPU_MODELS:
        _CPU_MODELS.clear()
        _CPU_MODELS[path] = torch.load(path, mmap=True, weights_only=False)
    params, backend = _CPU_MODELS[path]
    cfg = job["cfg"]
    qcfgs = models.quantize_model(cfg, q_config_for(cfg, kv4=job["kv4"]),
                                  {"linear": {"rank": job["rank"]}})
    engine = DecodeEngine(params, cfg, qcfgs, pallas_backend=backend,
                          device="cpu", **job["engine"])
    n = engine.num_slots
    logits = []
    with weights_decoded_once():
        if job.get("cache") is not None:
            for k, t in torch.load(job["cache"]).items():
                engine.cache[k].copy_(t)
            engine.lengths[:] = job["lengths"][:n]
        else:
            logits.append(engine.prefill(job["padded"][:n], np.arange(n),
                                         job["lengths"][:n]).float())
            engine.lengths[:] = job["lengths"][:n]
        for tokens in job["tokens"]:
            logits.append(engine.decode_logits(tokens[:n]).float())
            engine.lengths += 1
    out = job["out"]
    torch.save({"logits": logits, "cache": engine.cache,
                "lengths": engine.lengths.copy(),
                "seconds": time.perf_counter() - t0}, out)
    return out


class CpuPool:
    """Phase 4's CPU engines in a pool of spawned worker processes (a
    forked child of a process that has initialised CUDA is unsafe), each
    with ``os.cpu_count() // workers`` threads at a lower priority, so that
    they run beside the card's runs instead of after them. Each model's CPU params and backend
    go to a file once (:meth:`model`); each job (:func:`cpu_job`) gets CPU
    data only and never touches the card. :meth:`defer` queues a
    comparison of a job's result with card runs captured at the time
    (:func:`snapshot`); :meth:`finish` joins the pool, then makes the
    comparisons in order. A worker that dies or raises fails phase 4."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing
        import tempfile

        self.cpus = os.cpu_count() or 1
        self.workers = max(1, min(4, self.cpus // 2))
        self.threads = max(1, self.cpus // self.workers)
        self.dir = Path(tempfile.mkdtemp(prefix="chip_smoke_cpu_"))
        self.pool = concurrent.futures.ProcessPoolExecutor(
            self.workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init,
            initargs=(str(Path(__file__).resolve().parent), self.threads))
        self.deferred = []
        self.saving = {}
        self.count = 0

    def _path(self, what: str) -> str:
        self.count += 1
        return str(self.dir / f"{self.count}-{what}.pt")

    def model(self, torch, cfg, params, backend, kv4=False, rank=32) -> dict:
        """Save the model's CPU params and backend once, in a thread beside
        the card's runs (:meth:`submit` waits for it); returns the job
        fields that name it."""
        import threading

        cpu_backend = None if backend is None else {
            "arrays": {k: {n: None if t is None else t.cpu()
                           for n, t in v.items()}
                       for k, v in backend["arrays"].items()},
            "meta": dict(backend["meta"])}
        path = self._path("model")
        saving = threading.Thread(target=torch.save, args=(
            ({k: v.cpu() for k, v in params.items()}, cpu_backend), path))
        saving.start()
        self.saving[path] = saving
        return {"model": path, "cfg": cfg, "kv4": kv4, "rank": rank}

    def submit(self, torch, model: dict, engine: dict, tokens, padded=None,
               lengths=None, cache=None):
        """An admission of ``padded``/``lengths`` and a decode step per
        array of ``tokens``; or, from ``cache`` (a :func:`snapshot` of a
        card engine), its decode steps. Returns the job's future."""
        saving = self.saving.pop(model["model"], None)
        if saving is not None:
            saving.join()
        job = {**model, "engine": engine, "tokens": list(tokens),
               "padded": padded, "lengths": lengths, "out": self._path("out")}
        if cache is not None:
            job["cache"] = self._path("cache")
            torch.save(cache.cache, job["cache"])
            job["lengths"] = cache.lengths
        return self.pool.submit(cpu_job, job)

    def defer(self, future, compare) -> None:
        """``compare(cpu)`` once the job is done; ``cpu`` carries the CPU
        engine's ``logits``, ``cache``, ``lengths`` and ``num_slots``;
        ``compare`` returns what failed."""
        self.deferred.append((future, compare))

    def finish(self, torch) -> list:
        """Join the pool (a job that raised, or a worker that died, raises
        here), then make the deferred comparisons; returns what failed."""
        import shutil

        for saving in self.saving.values():
            saving.join()
        try:
            results = [f.result() for f, _ in self.deferred]
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)
        failed, seconds = [], []
        for path, (_, compare) in zip(results, self.deferred):
            out = torch.load(path, weights_only=False)
            cpu = types.SimpleNamespace(
                logits=out["logits"], cache=out["cache"],
                lengths=out["lengths"],
                num_slots=int(out["lengths"].shape[0]))
            failed += compare(cpu)
            seconds.append(out["seconds"])
            os.remove(path)
        shutil.rmtree(self.dir, ignore_errors=True)
        print(f"phase 4's CPU sides: {len(seconds)} engines in "
              f"{self.workers} workers, {sum(seconds):.1f} worker-seconds "
              f"(longest {max(seconds, default=0):.1f}s)", flush=True)
        return failed


def teacher_force(torch, engines, padded, lengths, steps, snap=None):
    """One admission and ``steps`` decode steps through each engine, all fed
    the greedy tokens of the first (the "kernels" one, or the emulated
    one); an engine of fewer slots takes the first ones. Returns each
    engine's logits per step, the kernel launches of the first and the
    tokens fed (an array per step); with ``snap`` = (slots, step), also
    each engine's :func:`snapshot` of that many slots after that many
    steps (for a CPU run of fewer steps)."""
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    logits, tokens, snaps = {}, [], {}
    first = next(iter(engines))
    for name, engine in engines.items():
        n = engine.num_slots
        reset_launch_counts()
        with run_context(name):
            lg = engine.prefill(padded[:n], np.arange(n), lengths[:n])
            engine.lengths[:] = lengths[:n]
            logits[name] = [lg.float().cpu()]
            for i in range(steps):
                if name == first:
                    tokens.append(torch.argmax(lg, -1).cpu().numpy())
                lg = engine.decode_logits(tokens[i][:n])
                engine.lengths += 1
                logits[name].append(lg.float().cpu())
                if snap is not None and i + 1 == snap[1]:
                    snaps[name] = snapshot(engine, snap[0])
        if name == first:
            routes = launch_counts()
    if snap is not None:
        return logits, routes, tokens, snaps
    return logits, routes, tokens


def continue_on_card(torch, card, others, last, steps, start_slots=0):
    """``steps`` more decode steps of the card engine and of each engine of
    ``others`` on the card (name: engine, run as :func:`run_context`
    says), all fed the card's greedy tokens from its ``last`` logits, each
    other engine starting from a copy of the card's cache and lengths:
    decode positions deep in a long context, without the drift the card's
    and the CPU's libraries build up over a long admission. Returns each
    engine's logits per step, the tokens fed, and the card's
    :func:`snapshot` of ``start_slots`` slots before the steps (for a CPU
    engine that continues from it too; None for 0)."""
    start = snapshot(card, start_slots) if start_slots else None
    for engine in others.values():
        n = engine.num_slots
        for key, t in card.cache.items():
            engine.cache[key].copy_(t[:, :n] if t.ndim == 5 else t[:n])
        engine.lengths[:] = card.lengths[:n]
    logits, seq = {"kernels": []}, []
    for _ in range(steps):
        seq.append(torch.argmax(last, -1).cpu().numpy())
        last = card.decode_logits(seq[-1])
        card.lengths += 1
        logits["kernels"].append(last.float().cpu())
    for name, engine in others.items():
        logits[name] = []
        with run_context(name):
            for tokens in seq:
                logits[name].append(engine.decode_logits(
                    tokens[:engine.num_slots]).float().cpu())
                engine.lengths += 1
    return logits, seq, start


def compare_runs(engines, logits, pairs, what: str, t0: float,
                 cpu_steps: float = None, flushed_steps: float = 1,
                 admitted: bool = True, flush: bool = True,
                 rms_limit: float = LOGIT_RMS_STEPS,
                 logits_only=()) -> list:
    """Logits and cache of each pair of runs against the phase-4 limits
    (the logits RMS against ``rms_limit``; the cache over the tokens every
    slot holds: below ``flushed`` of a staged cache, which with ``flush``
    must have crossed one); prints one line per pair, with each slot's
    largest RMS, and returns what failed. ``flushed_steps`` holds a staged
    cache against another card run; ``admitted``: the logits start with an
    admission's; the pairs of ``logits_only`` (caches of another kind) are
    held on their logits alone. An engine may be a :func:`snapshot`."""
    from lqer_tpu_torch.testing import cache_agreement, logits_steps

    cpu_steps = CACHE_CPU_STEPS if cpu_steps is None else cpu_steps

    def held(engine):
        """Tokens each slot holds: below ``flushed`` for a staged cache."""
        if "flushed" in engine.cache:
            return engine.cache["flushed"].tolist()
        return engine.lengths.tolist()

    staged = "flushed" in engines[pairs[0][0]].cache
    flushed = held(engines[pairs[0][0]])
    failed = ([] if not staged or not flush or min(flushed) >= 64
              else [f"{what}: no flush crossed: {flushed}"])
    for one, other in pairs:
        n = min(engines[one].num_slots, engines[other].num_slots)
        seen = [logits_steps(a[:n], b[:n])
                for a, b in zip(logits[one], logits[other])]
        worst = max(m for m, _ in seen)
        rms = max(r for _, r in seen)
        least = min(r for _, r in seen)
        per_slot = [max(logits_steps(a[s:s + 1], b[s:s + 1])[1]
                        for a, b in zip(logits[one], logits[other]))
                    for s in range(n)] if n > 1 else []
        cache_note, frac, cache_steps, steps0 = "", 1.0, 0.0, 0.0
        if (one, other) not in logits_only:
            mine, theirs = held(engines[one])[:n], held(engines[other])[:n]
            if staged and "flushed" in engines[other].cache \
                    and theirs != mine:
                failed.append(f"{what}, {one} vs {other}: flushed {mine} vs "
                              f"{theirs}")
            ranges = [min(a, b) for a, b in zip(mine, theirs)]
            frac, cache_steps = cache_agreement(engines[one].cache,
                                                engines[other].cache, ranges)
            # layer 0's K/V come straight from the bit-exact GEMMs; a later
            # layer's decode-written K/V carry a flipped p of the layers
            # before, as the CPU comparison's do. A staged cache holds them
            # in its ring, out of this comparison, until a flush moves them
            # below ``flushed``: held there to ``flushed_steps``
            first0 = {k: v[:1] for k, v in engines[one].cache.items()
                      if v.ndim == 5}
            other0 = {k: v[:1] for k, v in engines[other].cache.items()
                      if v.ndim == 5}
            steps0 = cache_agreement(first0, other0, ranges)[1]
            cache_note = (
                f"; cache over tokens {ranges} "
                f"({'below flushed' if staged else 'held'}): bytes equal "
                f"{frac:.6f}, largest value diff {cache_steps:.3g} code "
                f"step(s) ({steps0:.3g} in layer 0)")
        print(f"teacher-forced {what}, {one} vs {other} "
              f"({'CPU' if other.startswith('cpu') else 'card'}): "
              f"{'admission + ' if admitted else ''}"
              f"{len(seen) - admitted} decode steps, logits |diff| in code "
              f"steps max {worst:.3g} (limit {LOGIT_MAX_STEPS}), RMS "
              f"{least:.3g} to {rms:.3g} (limit {rms_limit}"
              f"{'; each slot to ' if per_slot else ''}"
              f"{', '.join(f'{r:.3g}' for r in per_slot)}){cache_note}, "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        if other in NEGATIVE_CONTROLS:
            if least <= rms_limit:
                failed.append(f"the RMS limit passed a run {other}")
            continue
        if worst > LOGIT_MAX_STEPS or rms > rms_limit:
            failed.append(f"{what}, {one} vs {other}: logits")
        if (one, other) in logits_only:
            continue
        later = flushed_steps if staged else cpu_steps
        if not other.startswith("cpu") and (frac < 0.999 or steps0 > 1
                                            or cache_steps > later):
            failed.append(f"{what}, {one} vs {other}: cache")
        if other.startswith("cpu") and cache_steps > cpu_steps:
            failed.append(f"{what}, {one} vs {other}: cache")
    return failed


def defer_cpu(torch, pool, model, engine_kw, what, card, logits, tokens, *,
              pairs=(("kernels", "cpu"), ("plain", "cpu")), padded=None,
              lengths=None, start=None, **limits):
    """Queue a CPU engine fed the card's ``tokens`` (an admission of
    ``padded``/``lengths``, or from ``start``, a snapshot of the card's
    cache) and its comparison with the card runs ``card`` (name: a
    :func:`snapshot` taken after as many steps) over ``pairs``, on the
    card runs' ``logits``, held to ``limits`` (:func:`compare_runs`)."""
    future = pool.submit(torch, model, engine_kw, tokens, padded, lengths,
                         start)
    t0 = time.perf_counter()
    steps = len(tokens) + (start is None)

    def compare(cpu):
        runs = {**card, "cpu": cpu}
        lg = {name: logits[name][:steps] for name in card}
        lg["cpu"] = cpu.logits
        return compare_runs(runs, lg, pairs, what, t0, flush=False, **limits)

    pool.defer(future, compare)


def phase_teacher_forced(torch, pool):
    """Phase 4: kernels on the card vs plain versions on the card and on
    the CPU (through ``pool``), teacher-forced with the kernels' greedy
    tokens, for each cache; the direct-write MXINT8 cache against the
    staged one; the ``fuse_mlp=False`` packing, kernels vs plain versions
    on the card; the eager engine against the stacked one on the card; the
    emulated engine on the card against itself on the CPU and against the
    kernel backend."""
    import dataclasses

    from lqer_tpu_torch import models
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.decode import decode_route
    from lqer_tpu_torch.serving.random_model import (
        KV4_Q_CONFIG,
        build_random_model,
    )

    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_hidden_layers=2)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=SEED + 2)
    kv4 = models.quantize_model(cfg, KV4_Q_CONFIG, {"linear": {"rank": 32}})
    embed32 = params["model.embed_tokens.weight"]
    params["model.embed_tokens.weight"] = embed32.to(torch.bfloat16)
    model = pool.model(torch, cfg, params, backend)
    kw = dict(num_slots=8, lm_head_width=8, scan_layers=True)
    staged = dict(kw, max_len=256, cache_dtype="mxint8-staged")
    # the negative control: the kernels with one linear's correction left
    # out (of the layers' o, qkv and down, the one whose loss moved the
    # logits least): layer 1's down projection, inside its megakernel entry
    broken = {"arrays": dict(backend["arrays"]), "meta": backend["meta"]}
    key = "model.layers.1.mlp_fused"
    broken["arrays"][key] = dict(
        broken["arrays"][key],
        b_d=torch.zeros_like(backend["arrays"][key]["b_d"]))
    # the runs whose CPU sides take longest come first, so that the pool
    # works on them beside the rest of the card's runs
    rng = np.random.default_rng(SEED)
    prompt_len = 63                      # 63 = 32 + 31: residue 31
    padded = rng.integers(0, cfg.vocab_size, (8, 64))
    lengths = np.full(8, prompt_len, dtype=np.int32)
    steps = 20
    long_len = 24576
    long_lengths = np.array([500, 505, 510, 511, 512, 530, 560, 600],
                            dtype=np.int32)
    long_padded = rng.integers(0, cfg.vocab_size, (8, 1024))
    decode_kernels = ("row_write", "decode_attention_fp",
                      "decode_attention_quantized", "decode_attention_write",
                      "decode_attention", "encode_write_tokens",
                      "decode_attention_streaming",
                      "decode_attention_streaming_staged")
    failed = emulated_engines(torch, pool, cfg, backend, padded, steps)

    # the long-context caches at max_len 24576 (the smallest multiple of
    # 2048 past the one-pass length at d = 128), then the direct-write ones:
    # each decode step launches, per layer, the kernels decode_route names
    # (and no other decode kernel). At long context the kernels meet the
    # plain versions on the card over long prompts (500..600 tokens, one
    # 1024-token bucket: prefill attention is bit-exact with its plain
    # version up to 1024 keys, where torch takes its warp softmax). They
    # meet the CPU (one slot) twice: from a copy of the card's cache after
    # those steps (positions 520..), and over the short prompts from the
    # admission on. A CPU admission of a long prompt drifts from the card's
    # by the libraries' flipped roundings, which cascade through every
    # token of it (PERF.md). Last, the streaming kernels' blocks span 2048
    # tokens there (split_plan.chunks_per_block), so the card's context is
    # built to SPAN_EDGE_POSITIONS (staged: flushed to the 32-token block)
    # and the plain versions continue from a copy of it: every slot but the
    # first holds columns on both sides of a span's edge, and the staged
    # slots' flushed lies below, at and past it, before and after the
    # flush at step 17.
    for cache_dtype, max_len, layer_qcfgs in (
            ("mxint8", long_len, qcfgs), ("mxint8-staged", long_len, qcfgs),
            ("mxint4", long_len, kv4), ("bfloat16", 256, qcfgs),
            ("mxint8", 256, qcfgs), ("mxint8", 272, qcfgs),
            ("mxint4", 256, kv4)):
        long = max_len == long_len
        direct = dict(kw, max_len=max_len, cache_dtype=cache_dtype)
        cpu_kw = dict(direct, num_slots=1 if long else 8)
        cpu_model = {**model, "kv4": layer_qcfgs is kv4}
        engines = {name: DecodeEngine(params, cfg, layer_qcfgs,
                                      pallas_backend=backend, device="cuda",
                                      **direct)
                   for name in ("kernels", "plain")}
        pairs = [("kernels", "plain")]
        if cache_dtype == "mxint8" and max_len != 272:
            # the JAX package holds the direct-write and the staged MXINT8
            # caches to be one function: so are they here, on the card
            engines["staged"] = DecodeEngine(
                params, cfg, qcfgs, pallas_backend=backend, device="cuda",
                **dict(staged, max_len=max_len))
            pairs.append(("kernels", "staged"))
        t0 = time.perf_counter()
        cpu_here = max_len not in (272, long_len)   # 272: the route only
        logits, routes, tokens, *snaps = teacher_force(
            torch, engines, long_padded if long else padded,
            long_lengths if long else lengths, steps,
            snap=(8, CPU_STEPS) if cpu_here else None)
        route = decode_route(cache_dtype, max_len, cfg.head_dim, 1)
        got = {k: routes[k] for k in decode_kernels}
        if got != {k: steps * 2 * (k in route) for k in decode_kernels} \
                or routes["mlp_fused"] != steps * 2:
            raise AssertionError(f"phase 4 {cache_dtype} routes: {routes}")
        what = (f"2-layer 7B-width path, {cache_dtype} cache, max_len "
                f"{max_len}")
        print(f"teacher-forced {what}: kernel launches {routes}", flush=True)
        cpu_limit = (CACHE_CPU_STEPS_MXINT4 if cache_dtype == "mxint4"
                     else CACHE_CPU_STEPS)
        # at long context the staged cache's flushes move decode-written
        # tokens of layer 1 below flushed (6 code steps from the plain
        # versions on the H100, as a direct-write cache's, PERF.md)
        failed += compare_runs(engines, logits, pairs, what, t0,
                               cpu_steps=cpu_limit,
                               flushed_steps=cpu_limit if long else 1)
        if cpu_here:
            defer_cpu(torch, pool, cpu_model, cpu_kw, what,
                      {k: snaps[0][k] for k in ("kernels", "plain")}, logits,
                      tokens[:CPU_STEPS], padded=padded, lengths=lengths,
                      cpu_steps=cpu_limit)
        if long:
            card, plain = engines["kernels"], engines["plain"]
            logits, seq, start = continue_on_card(
                torch, card, {}, logits["kernels"][-1], LONG_CPU_STEPS,
                start_slots=1)
            at = int(start.lengths[0])
            defer_cpu(torch, pool, cpu_model, cpu_kw,
                      f"{what}, from the card's cache at positions "
                      f"{at}..{at + LONG_CPU_STEPS - 1}",
                      {"kernels": snapshot(card, 1)}, logits, seq,
                      pairs=(("kernels", "cpu"),), start=start,
                      cpu_steps=cpu_limit, admitted=False)
            logits, _, tokens, snaps = teacher_force(
                torch, {"kernels": card}, padded, lengths, LONG_CPU_STEPS,
                snap=(1, LONG_CPU_STEPS))
            defer_cpu(torch, pool, cpu_model, cpu_kw,
                      f"{what}, short prompts", snaps, logits, tokens,
                      pairs=(("kernels", "cpu"),), padded=padded,
                      lengths=lengths, cpu_steps=cpu_limit)
            fill_context(torch, {"kernels": card}, SPAN_EDGE_POSITIONS,
                         SEED + 19)
            if "flushed" in card.cache:
                card.cache["flushed"].copy_(torch.as_tensor(
                    SPAN_EDGE_POSITIONS // 32 * 32, device="cuda"))
            engines = {"kernels": card, "plain": plain}
            logits, _, _ = continue_on_card(torch, card, {"plain": plain},
                                            logits["kernels"][-1], steps)
            failed += compare_runs(
                engines, logits, [("kernels", "plain")],
                f"{what}, from a built context at positions "
                f"{SPAN_EDGE_POSITIONS.tolist()}.. (span edge 2048)", t0,
                cpu_steps=cpu_limit, flushed_steps=cpu_limit, admitted=False)
            del plain, card
        del engines

    engines = {
        "kernels": DecodeEngine(params, cfg, qcfgs, pallas_backend=backend,
                                device="cuda", **staged),
        "plain": DecodeEngine(params, cfg, qcfgs, pallas_backend=backend,
                              device="cuda", **staged),
        "no correction": DecodeEngine(params, cfg, qcfgs,
                                      pallas_backend=broken, device="cuda",
                                      **staged)}
    t0 = time.perf_counter()
    logits, routes, tokens, snaps = teacher_force(
        torch, engines, padded, lengths, steps, snap=(8, CPU_STEPS))
    # the 512-row admission took the large-M route (5 unpacks per layer),
    # every decode step the megakernel (one launch per layer)
    if routes["unpack"] != 5 * 2 or routes["mlp_fused"] != steps * 2:
        raise AssertionError(f"phase 4 routes: {routes}")
    what = "2-layer 7B-width path"
    print(f"teacher-forced {what}: kernel launches {routes}", flush=True)
    failed += compare_runs(engines, logits, (
        ("kernels", "plain"), ("kernels", "no correction")), what, t0)
    defer_cpu(torch, pool, model, staged, what, snaps, logits,
              tokens[:CPU_STEPS], padded=padded, lengths=lengths)
    del engines

    # the staged MXINT4 cache (KV4 configuration), three ways, with the
    # control without layer 1's down correction; once flushed, its
    # decode-written tokens as a direct-write MXINT4 cache's
    staged4 = dict(staged, cache_dtype="mxint4-staged")
    engines = {
        name: DecodeEngine(params, cfg, kv4, pallas_backend=backend,
                           device="cuda", **staged4)
        for name in ("kernels", "plain")}
    engines["no correction"] = DecodeEngine(params, cfg, kv4,
                                            pallas_backend=broken,
                                            device="cuda", **staged4)
    engines["mxint4"] = DecodeEngine(params, cfg, kv4, pallas_backend=backend,
                                     device="cuda",
                                     **dict(staged, cache_dtype="mxint4"))
    t0 = time.perf_counter()
    logits, routes, tokens, snaps = teacher_force(
        torch, engines, padded, lengths, steps, snap=(8, CPU_STEPS))
    if (routes["decode_attention"] != steps * 2
            or routes["mlp_fused"] != steps * 2 or routes["unpack"] != 10
            or routes["decode_attention_quantized"] != 0):
        raise AssertionError(f"phase 4 mxint4-staged routes: {routes}")
    what = "2-layer 7B-width path, mxint4-staged cache"
    print(f"teacher-forced {what}: kernel launches {routes}", flush=True)
    failed += compare_runs(engines, logits, (
        ("kernels", "plain"), ("kernels", "no correction"),
        ("kernels", "mxint4")), what, t0, cpu_steps=CACHE_CPU_STEPS_MXINT4)
    defer_cpu(torch, pool, {**model, "kv4": True}, staged4, what,
              {k: snaps[k] for k in ("kernels", "plain")}, logits,
              tokens[:CPU_STEPS], padded=padded, lengths=lengths,
              cpu_steps=CACHE_CPU_STEPS_MXINT4)
    del engines, broken

    # the fuse_mlp=False packing: gate|up and down through kernel 1 at
    # decode, through the large-M route at the 512-row admission
    unfused, _, _ = build_random_model(cfg, rank=32, seed=SEED + 2,
                                       fuse_mlp=False)
    engines = {name: DecodeEngine(params, cfg, qcfgs, pallas_backend=unfused,
                                  device="cuda", **staged)
               for name in ("kernels", "plain")}
    t0 = time.perf_counter()
    logits, routes, _ = teacher_force(torch, engines, padded, lengths, steps)
    # 4 unpacks per layer at admission; per decode step kernel 1 for q|k|v,
    # o, gate|up and down of both layers and the head, plus the admission's
    # head (8 rows)
    if (routes["unpack"] != 4 * 2 or routes["mlp_fused"] != 0
            or routes["dequant_gemm"] != steps * (4 * 2 + 1) + 1):
        raise AssertionError(f"phase 4 fuse_mlp=False routes: {routes}")
    what = "2-layer 7B-width path, fuse_mlp=False"
    print(f"teacher-forced {what}: kernel launches {routes}", flush=True)
    failed += compare_runs(engines, logits, (("kernels", "plain"),), what, t0)
    del engines, unfused
    params["model.embed_tokens.weight"] = embed32
    failed += eager_against_stacked(torch, cfg, params, backend, qcfgs,
                                    padded, lengths, steps)
    del backend, params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 4 past its limits: {failed}")


def eager_against_stacked(torch, cfg, params, backend, qcfgs, padded,
                          lengths, steps) -> list:
    """The eager engine (``scan_layers=False``, per-prefix backend entries)
    and the stacked one on the same weights (the f32 embedding: the eager
    step keeps the f32 stream its kernels return, as the JAX package's
    does), teacher-forced with the eager engine's tokens on the
    ``mxint8-staged`` and ``bfloat16`` caches at max_len 256: logits and
    caches equal bit for bit at every step, and the eager engine's
    launches per layer those of its route (``decode_route(eager=True)``:
    no row write, the rows written in plain PyTorch)."""
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.decode import decode_route

    decode_kernels = ("row_write", "decode_attention_fp",
                      "decode_attention_quantized", "decode_attention_write",
                      "decode_attention", "encode_write_tokens")
    failed = []
    for cache_dtype in ("mxint8-staged", "bfloat16"):
        kw = dict(num_slots=8, max_len=256, cache_dtype=cache_dtype,
                  lm_head_width=8, pallas_backend=backend, device="cuda")
        engines = {"eager": DecodeEngine(params, cfg, qcfgs, **kw),
                   "stacked": DecodeEngine(params, cfg, qcfgs,
                                           scan_layers=True, **kw)}
        logits, routes, _ = teacher_force(torch, engines, padded, lengths,
                                          steps)
        route = decode_route(cache_dtype, 256, cfg.head_dim, 1, eager=True)
        want = {k: steps * 2 * (k in route) for k in decode_kernels}
        got = {k: routes[k] for k in decode_kernels}
        if (got != want or routes["mlp_fused"] != steps * 2
                or routes["unpack"] != 5 * 2 or routes["attention"] != 2
                or routes["dequant_gemm"] != steps * (2 * 2 + 1) + 1
                or routes["cache_write"] != (cache_dtype != "bfloat16")):
            raise AssertionError(f"phase 4 eager {cache_dtype} routes: "
                                 f"{routes}")
        steps_equal = sum(torch.equal(a, b) for a, b in
                          zip(logits["eager"], logits["stacked"]))
        cache_equal = all(torch.equal(engines["eager"].cache[k],
                                      engines["stacked"].cache[k])
                          for k in engines["eager"].cache)
        print(f"eager engine against the stacked engine, 2-layer 7B-width "
              f"path, {cache_dtype} cache, max_len 256 (card): logits equal "
              f"at {steps_equal} of {len(logits['eager'])} steps "
              f"(admission + {steps} decode steps), caches equal "
              f"{cache_equal}; eager kernel launches {routes}", flush=True)
        if steps_equal != len(logits["eager"]) or not cache_equal:
            failed.append(f"eager vs stacked, {cache_dtype}")
        del engines
    return failed


def emulated_engines(torch, pool, cfg, backend, padded, steps) -> list:
    """The emulated engine (no backend: every linear through ``qlinear`` on
    ``prepare_ptq``'s weights) of the same 2-layer model, its dense weights
    drawn from the same seeds (``build_random_dense_model``; ``backend``
    packs them: ``build_random_model``'s), on the
    ``bfloat16`` cache at max_len 64 (prompts of 40 tokens) and the
    ``float32`` cache at 256: against itself on the CPU (the pool) and
    against the backend engine (kernels) on the card, within phase 4's
    limits. Its admissions attend through the prefill kernel, as JAX's do;
    on the ``float32`` cache the backend engine's decode steps attend
    through row 5's f32 entry, as JAX's fp decode kernel reads an f32
    cache."""
    from lqer_tpu_torch import models
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import build_random_dense_model

    dense, qcfgs = build_random_dense_model(cfg, rank=32, seed=SEED + 2)
    prepared = models.prepare_ptq(dense, cfg, qcfgs)
    del dense
    model = pool.model(torch, cfg, prepared, None)
    lengths = np.full(8, 40, dtype=np.int32)
    failed = []
    for cache_dtype, max_len in (("bfloat16", 64), ("float32", 256)):
        kw = dict(num_slots=8, max_len=max_len, cache_dtype=cache_dtype)
        engines = {
            "emulated": DecodeEngine(prepared, cfg, qcfgs, device="cuda",
                                     **kw),
            "kernels": DecodeEngine(prepared, cfg, qcfgs,
                                    pallas_backend=backend, device="cuda",
                                    **kw)}
        t0 = time.perf_counter()
        logits, routes, tokens, snaps = teacher_force(
            torch, engines, padded, lengths, steps, snap=(8, CPU_STEPS))
        if (routes["attention"] != 2 or routes["dequant_gemm"]
                or routes["mlp_fused"] or routes["unpack"]):
            raise AssertionError(f"phase 4 emulated {cache_dtype} routes: "
                                 f"{routes}")
        what = (f"2-layer 7B-width path, emulated linears, {cache_dtype} "
                f"cache, max_len {max_len}")
        print(f"teacher-forced {what}: kernel launches {routes}", flush=True)
        failed += compare_runs(engines, logits, (("emulated", "kernels"),),
                               what, t0)
        defer_cpu(torch, pool, model, kw, what,
                  {"emulated": snaps["emulated"]}, logits,
                  tokens[:CPU_STEPS], pairs=(("emulated", "cpu"),),
                  padded=padded, lengths=lengths)
        del engines
    del prepared
    torch.cuda.empty_cache()
    return failed


def fill_context(torch, engines, positions, seed) -> None:
    """Each engine's cache ``[0, positions[b])`` in every layer and slot
    from one block of 2048 seeded random rows tiled along the token axis
    (bf16 rows, or their MXINT encode as the cache's write grid), the same
    in every engine; ``lengths`` set to ``positions``. The context is built,
    not prefilled."""
    from lqer_tpu_torch.parallel.collectives import mx4_encode, mx8_encode
    from lqer_tpu_torch.serving.kv_cache import MAIN_KEYS, cache_code_width

    first = next(iter(engines.values())).cache
    quantized = "k_codes" in first
    _, B, KVH, *_ = first["k_codes" if quantized else "k"].shape
    D = first["k_exps"].shape[3] * 16 if quantized else first["k"].shape[4]
    dev = first["k_codes" if quantized else "k"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = [torch.randn(B, KVH, 2048, D, generator=gen, device=dev)
            for _ in range(2)]
    if quantized:
        enc = mx4_encode if cache_code_width(first) == 4 else mx8_encode
        block = {}
        for side, r in zip("kv", rows):
            c, e = enc(r, 16, zero_fill=1.0)
            block[f"{side}_codes"] = c.transpose(-1, -2)
            block[f"{side}_exps"] = e.transpose(-1, -2)
        keys, axis = MAIN_KEYS, 4
    else:
        block = {"k": rows[0].to(torch.bfloat16),
                 "v": rows[1].to(torch.bfloat16)}
        keys, axis = ("k", "v"), 3
    for engine in engines.values():
        n_slots = engine.num_slots
        for key in keys:
            arr, blk = engine.cache[key], block[key]
            for b in range(n_slots):
                for t0 in range(0, int(positions[b]), 2048):
                    n = min(2048, int(positions[b]) - t0)
                    dst = arr[:, b].narrow(axis - 1, t0, n)
                    dst.copy_(blk[b].narrow(axis - 2, 0, n)[None].expand_as(
                        dst))
        engine.lengths[:] = positions[:n_slots]


def teacher_decode(torch, engines, tokens, steps):
    """``steps`` decode steps of each engine at its ``lengths``, all fed the
    greedy tokens of the first ("kernels"), starting from ``tokens``;
    returns each engine's logits per step and the kernels' launches."""
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    logits = {name: [] for name in engines}
    seq = [tokens]
    for name, engine in engines.items():
        reset_launch_counts()
        with run_context(name):
            for i in range(steps):
                lg = engine.decode_logits(seq[i][:engine.num_slots])
                engine.lengths += 1
                logits[name].append(lg.float().cpu())
                if name == "kernels":
                    seq.append(torch.argmax(lg, -1).cpu().numpy())
        if name == "kernels":
            routes = launch_counts()
    return logits, routes


def phase_teacher_forced_mistral(torch, pool):
    """Phase 4 for Mistral: a 2-layer model at Mistral-7B-v0.1 width (32
    heads over 8 kv heads, I = 14336, window 4096) at the templates' rank
    128, packed as the JAX package packs by default, per cache at max_len
    8192 (``bfloat16``, ``mxint8``, ``mxint4`` with the KV4 configuration):
    an eager windowed admission of 4 prompts of 63 tokens and 4 decode
    steps, then the context of every slot built to positions 4500..7777
    from one seeded block (not prefilled) and 8 decode steps there, past
    the window, all teacher-forced with the kernels' greedy tokens:
    kernels against the plain versions on the card; then LONG_CPU_STEPS
    steps of the kernels, of the plain versions on the card and of the
    plain versions on the CPU (the pool), the last two from a copy of the
    kernels' cache, all three held to one another (the plain versions on
    the card are the second witness of a departure from the CPU: one
    flipped f32 rounding in layer 0's attention moves one slot's logits up
    to 0.42 RMS there, theirs as the kernels', PERF.md). The CPU engine
    takes the card's 4 slots, as every other comparison of phase 4 does.
    On the bf16 cache two negative controls must fail the logits limit at
    every step past the window: the same model without its window, and
    without layer 1's down correction."""
    import dataclasses

    from lqer_tpu_torch import models
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.decode import decode_route
    from lqer_tpu_torch.serving.random_model import (
        build_random_model,
        q_config_for,
    )

    cfg = dataclasses.replace(LlamaConfig.mistral_7b(), num_hidden_layers=2)
    backend, params, qcfgs = build_random_model(cfg, rank=128, seed=SEED + 22)
    kv4 = models.quantize_model(cfg, q_config_for(cfg, kv4=True),
                                {"linear": {"rank": 128}})
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    model = pool.model(torch, cfg, params, backend, rank=128)
    broken = {"arrays": dict(backend["arrays"]), "meta": backend["meta"]}
    key = "model.layers.1.mlp_fused"
    broken["arrays"][key] = dict(
        broken["arrays"][key],
        b_d=torch.zeros_like(backend["arrays"][key]["b_d"]))
    rng = np.random.default_rng(SEED + 2)
    padded = rng.integers(0, cfg.vocab_size, (4, 64))
    lengths = np.full(4, 63, dtype=np.int32)
    positions = np.array([4500, 5003, 6001, 7777], dtype=np.int32)
    max_len, steps, long_steps = 8192, 4, 8
    decode_kernels = ("row_write", "decode_attention_fp",
                      "decode_attention_quantized", "decode_attention_write",
                      "decode_attention_streaming", "encode_write_tokens")
    failed = []
    for cache_dtype, layer_qcfgs in (("bfloat16", qcfgs), ("mxint8", qcfgs),
                                     ("mxint4", kv4)):
        kw = dict(num_slots=4, max_len=max_len, cache_dtype=cache_dtype,
                  lm_head_width=8, scan_layers=True)
        cpu_model = {**model, "kv4": layer_qcfgs is kv4}
        engines = {name: DecodeEngine(params, cfg, layer_qcfgs,
                                      pallas_backend=backend, device="cuda",
                                      **kw)
                   for name in ("kernels", "plain")}
        pairs = [("kernels", "plain")]
        if cache_dtype == "bfloat16":
            engines["no window"] = DecodeEngine(
                params, dataclasses.replace(cfg, sliding_window=None),
                layer_qcfgs, pallas_backend=backend, device="cuda", **kw)
            engines["no correction"] = DecodeEngine(
                params, cfg, layer_qcfgs, pallas_backend=broken,
                device="cuda", **kw)
        what = f"2-layer Mistral-7B-width path (rank 128), {cache_dtype} cache"
        t0 = time.perf_counter()
        short = {k: e for k, e in engines.items() if k in ("kernels", "plain")}
        logits, routes, tokens = teacher_force(torch, short, padded, lengths,
                                               steps)
        # the 256-row admission and each step: one megakernel per layer
        route = decode_route(cache_dtype, max_len, cfg.head_dim, 4)
        got = {k: routes[k] for k in decode_kernels}
        if (routes["mlp_fused"] != (steps + 1) * 2 or routes["attention"]
                or got != {k: steps * 2 * (k in route)
                           for k in decode_kernels}):
            raise AssertionError(f"phase 4 Mistral {cache_dtype} routes: "
                                 f"{routes}")
        print(f"teacher-forced {what}, eager windowed admission: kernel "
              f"launches {routes}", flush=True)
        cpu_limit = (CACHE_CPU_STEPS_MXINT4 if cache_dtype == "mxint4"
                     else CACHE_CPU_STEPS)
        failed += compare_runs(short, logits, (("kernels", "plain"),),
                               f"{what}, admission", t0, cpu_steps=cpu_limit)
        defer_cpu(torch, pool, cpu_model, kw, f"{what}, admission",
                  {k: snapshot(e) for k, e in short.items()}, logits, tokens,
                  padded=padded, lengths=lengths, cpu_steps=cpu_limit)
        # past the window: the context built, then decode steps
        fill_context(torch, engines, positions, SEED + 29)
        start = torch.argmax(logits["kernels"][-1], -1).numpy()
        logits, routes = teacher_decode(torch, engines, start, long_steps)
        got = {k: routes[k] for k in decode_kernels}
        if got != {k: long_steps * 2 * (k in route) for k in decode_kernels}:
            raise AssertionError(f"phase 4 Mistral {cache_dtype} routes past "
                                 f"the window: {routes}")
        pairs += [(name, other) for name, other in
                  (("kernels", "no window"), ("kernels", "no correction"))
                  if other in engines]
        failed += compare_runs(
            engines, logits, pairs,
            f"{what}, positions {positions.tolist()}..+{long_steps - 1}",
            t0, cpu_steps=cpu_limit, admitted=False)
        card, plain = engines["kernels"], engines["plain"]
        logits, seq, start = continue_on_card(
            torch, card, {"plain": plain}, logits["kernels"][-1],
            LONG_CPU_STEPS, start_slots=4)
        what = (f"{what}, from the kernels' cache at positions "
                f"{start.lengths.tolist()}..+{LONG_CPU_STEPS - 1}")
        failed += compare_runs({"kernels": card, "plain": plain}, logits,
                               (("kernels", "plain"),), what, t0,
                               cpu_steps=cpu_limit, admitted=False)
        defer_cpu(torch, pool, cpu_model, kw, what,
                  {"kernels": snapshot(card), "plain": snapshot(plain)},
                  logits, seq, start=start, cpu_steps=cpu_limit,
                  admitted=False)
        del engines, short, card, plain
    if failed:
        raise AssertionError(f"phase 4 Mistral past its limits: {failed}")
    del backend, params, broken
    torch.cuda.empty_cache()


def phase_teacher_forced_opt(torch, pool, name="facebook/opt-6.7b",
                             caches=("mxint8-staged", "bfloat16", "mxint8",
                                     "mxint4"),
                             rms_limit=LOGIT_RMS_STEPS):
    """Phase 4 for OPT: a 2-layer OPT at the width of ``name`` (vocab 50272,
    the dense head; OPT-6.7B, or OPT-350m with post-LN, ``project_in`` and
    ``project_out`` and d = 64), packed as the JAX package packs (q|k|v
    fused with its biases, out_proj alone, fc1 and fc2 in the relu
    megakernel entry), teacher-forced through an 8 x 64 admission (512
    rows: the large-M route) and 20 decode steps (the relu megakernel) per
    cache of ``caches``: the first with the negative control (layer 1's fc2
    correction left out), ``mxint8-staged`` and ``bfloat16`` three ways
    (kernels on the card, plain versions on the card and on the CPU, the
    last through ``pool``), ``mxint8`` and ``mxint4`` (the KV4
    configuration) kernels against plain versions on the card; the limits
    of the Llama runs, the logits RMS held to ``rms_limit``."""
    import dataclasses

    from lqer_tpu_torch import models
    from lqer_tpu_torch.models.opt import MODEL_CONFIGS
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.decode import decode_route
    from lqer_tpu_torch.serving.random_model import (
        build_random_model,
        q_config_for,
    )

    cfg = dataclasses.replace(MODEL_CONFIGS[name](), num_hidden_layers=2)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=SEED + 4)
    kv4 = models.quantize_model(cfg, q_config_for(cfg, kv4=True),
                                {"linear": {"rank": 32}})
    model = pool.model(torch, cfg, params, backend)
    key = "model.decoder.layers.1.mlp_fused"
    broken = {"arrays": dict(backend["arrays"]), "meta": backend["meta"]}
    broken["arrays"][key] = dict(
        broken["arrays"][key],
        b_d=torch.zeros_like(backend["arrays"][key]["b_d"]))
    rng = np.random.default_rng(SEED + 1)
    padded = rng.integers(0, cfg.vocab_size, (8, 64))
    lengths = np.full(8, 63, dtype=np.int32)
    steps = 20
    decode_kernels = ("row_write", "decode_attention_fp",
                      "decode_attention_quantized", "decode_attention_write",
                      "decode_attention")
    failed = []
    for cache_dtype in caches:
        layer_qcfgs = kv4 if cache_dtype == "mxint4" else qcfgs
        kw = dict(num_slots=8, max_len=256, cache_dtype=cache_dtype,
                  lm_head_width=8, scan_layers=True)
        engines = {name: DecodeEngine(params, cfg, layer_qcfgs,
                                      pallas_backend=backend, device="cuda",
                                      **kw)
                   for name in ("kernels", "plain")}
        pairs = [("kernels", "plain")]
        if cache_dtype == caches[0]:
            engines["no correction"] = DecodeEngine(
                params, cfg, layer_qcfgs, pallas_backend=broken,
                device="cuda", **kw)
            pairs.append(("kernels", "no correction"))
        t0 = time.perf_counter()
        logits, routes, tokens, snaps = teacher_force(
            torch, engines, padded, lengths, steps, snap=(8, CPU_STEPS))
        # the admission: 4 unpacks per layer (q|k|v, out_proj, fc1, fc2);
        # each decode step: kernel 1 for q|k|v and out_proj and one relu
        # megakernel per layer, the decode route's kernels; the head dense
        route = decode_route(cache_dtype, 256, cfg.head_dim, 1)
        got = {k: routes[k] for k in decode_kernels}
        if (routes["unpack"] != 4 * 2 or routes["mlp_fused"] != 0
                or routes["mlp_fused_relu"] != steps * 2
                or routes["dequant_gemm"] != steps * 2 * 2
                or got != {k: steps * 2 * (k in route)
                           for k in decode_kernels}):
            raise AssertionError(f"phase 4 OPT {cache_dtype} routes: "
                                 f"{routes}")
        what = f"2-layer {name.split('/')[1]}-width path, {cache_dtype} cache"
        print(f"teacher-forced {what}: kernel launches {routes}", flush=True)
        limits = dict(cpu_steps=(CACHE_CPU_STEPS_MXINT4
                                 if cache_dtype == "mxint4"
                                 else CACHE_CPU_STEPS), rms_limit=rms_limit)
        failed += compare_runs(engines, logits, pairs, what, t0, **limits)
        if cache_dtype in ("mxint8-staged", "bfloat16"):
            defer_cpu(torch, pool, model, kw, what,
                      {k: snaps[k] for k in ("kernels", "plain")}, logits,
                      tokens[:CPU_STEPS], padded=padded, lengths=lengths,
                      **limits)
        del engines
    if failed:
        raise AssertionError(f"phase 4 OPT past its limits: {failed}")
    del backend, params, broken
    torch.cuda.empty_cache()


F32_STEPS = 6   # decode steps of the float32 engines


def phase_f32_engine(torch, rates) -> dict:
    """The ``float32`` cache served with the kernel backend: phase 4's
    2-layer Llama-2-7B-width model, 8 slots at max_len 256, stacked and
    eager, one admission of 63-token prompts and F32_STEPS decode steps
    through the kernels and through the plain versions on the card,
    teacher-forced with the kernels' greedy tokens. Each decode step
    launches decode_route's kernels per layer on the f32 cache (stacked:
    row 11 then row 5; eager: row 5); the logits are held to phase 4's
    limits and the cache's layer 0 to one code step. Returns the kernels'
    launches."""
    import dataclasses

    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.decode import decode_route
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import cache_agreement, logits_steps

    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_hidden_layers=2)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=SEED + 2)
    params["model.embed_tokens.weight"] = params[
        "model.embed_tokens.weight"].to(torch.bfloat16)
    rng = np.random.default_rng(SEED)
    padded = rng.integers(0, cfg.vocab_size, (8, 64))
    lengths = np.full(8, 63, dtype=np.int32)
    total, failed, tokens_by = {}, [], {}
    for scan in (True, False):
        what = "stacked" if scan else "eager"
        kw = dict(num_slots=8, max_len=256, cache_dtype="float32",
                  lm_head_width=8, scan_layers=scan)
        engines = {name: DecodeEngine(params, cfg, qcfgs,
                                      pallas_backend=backend, device="cuda",
                                      **kw)
                   for name in ("kernels", "plain")}
        t0 = time.perf_counter()
        logits, routes, tokens = teacher_force(torch, engines, padded,
                                               lengths, F32_STEPS)
        tokens_by[what] = np.stack(tokens)
        n = cfg.num_hidden_layers * F32_STEPS
        route = decode_route("float32", 256, cfg.head_dim, 1, eager=not scan)
        want = {k: n for k in route}
        got = {k: routes[k] for k in ("row_write", "decode_attention_fp")
               if routes[k]}
        f32 = {k: routes[f"{k}.f32"] for k in got}
        if got != want or f32 != want:
            failed.append(f"float32 {what}: decode launches {got} (f32 "
                          f"{f32}), expected {want}")
        seen = [logits_steps(a, b) for a, b in zip(logits["kernels"],
                                                   logits["plain"])]
        worst, rms = max(m for m, _ in seen), max(r for _, r in seen)
        held = engines["kernels"].lengths.tolist()
        frac, steps_all = cache_agreement(engines["kernels"].cache,
                                          engines["plain"].cache, held)
        steps0 = cache_agreement(
            {k: v[:1] for k, v in engines["kernels"].cache.items()},
            {k: v[:1] for k, v in engines["plain"].cache.items()}, held)[1]
        print(f"float32 cache, {what} engine with the kernel backend, "
              f"kernels vs plain versions on the card: admission + "
              f"{F32_STEPS} decode steps, logits |diff| in code steps max "
              f"{worst:.3g} (limit {LOGIT_MAX_STEPS}), RMS {rms:.3g} (limit "
              f"{LOGIT_RMS_STEPS}); cache over tokens {held}: f32 values "
              f"equal {frac:.6f}, largest diff {steps_all:.3g} 8-bit code "
              f"step(s) of its 16-groups ({steps0:.3g} in layer 0); decode "
              f"launches {got}, of them over f32 {f32}; "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        if worst > LOGIT_MAX_STEPS or rms > LOGIT_RMS_STEPS:
            failed.append(f"float32 {what}: logits")
        if steps0 > 1 or steps_all > CACHE_CPU_STEPS:
            failed.append(f"float32 {what}: cache")
        for k, v in routes.items():
            total[k] = total.get(k, 0) + v
        del engines
        gc.collect()
        torch.cuda.empty_cache()
    same = np.array_equal(tokens_by["stacked"], tokens_by["eager"])
    print(f"float32 cache: the eager engine's greedy tokens equal the "
          f"stacked one's: {same}", flush=True)
    if failed:
        raise AssertionError(f"the float32 cache: {failed}")
    return total


def phase_serve_opt(torch, rates, name="facebook/opt-6.7b",
                    caches=(("bfloat16", 40), ("mxint8-staged", 80))):
    """Phase 5 for OPT: the engine at the shape of ``name`` (all its layers,
    rank 32, dense head, 8 slots, max_len 2048) serving the request mix
    over each cache of ``caches`` with its new tokens (OPT-6.7B: the
    ``bfloat16`` cache 40, the ``mxint8-staged`` one 80), a profile of 5
    decode steps each; then, on the staged cache, one 2048-token admission
    and its profile. Returns the kernel launches."""
    import dataclasses

    from lqer_tpu_torch.models.opt import MODEL_CONFIGS
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import build_random_model

    cfg = MODEL_CONFIGS[name]()
    t0 = time.perf_counter()
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=SEED + 5)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    counts = None
    for cache_dtype, new_tokens in caches:
        engine = DecodeEngine(params, cfg, qcfgs, num_slots=8, max_len=2048,
                              cache_dtype=cache_dtype,
                              pallas_backend=backend, lm_head_width=8,
                              scan_layers=True, device="cuda")
        run = serve_requests(torch, engine, cfg, cache_dtype, new_tokens,
                             pack_s, f"{name} shape, dense head", 32)
        counts = run if counts is None else {k: n + run[k]
                                             for k, n in counts.items()}
        tokens = np.zeros(engine.num_slots, dtype=np.int64)
        profile_window(torch, lambda: engine.decode_logits(tokens), 5,
                       f"{name} decode steps, {cache_dtype} cache")
        if cache_dtype == "mxint8-staged":
            reset_launch_counts()
            long_prompt(torch, engine.prefill, cfg,
                        np.random.default_rng(SEED + 7))
            counts = {k: n + launch_counts()[k] for k, n in counts.items()}
        del engine
        torch.cuda.empty_cache()
    del backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_serve(torch, rates, layers: int = 32):
    """Phase 5: the engine at Llama-2-7B shape over each cache, then over
    each MXINT cache at long context; returns the launch counts of the
    served requests, the long prompt and the long-context steps."""
    import dataclasses

    from lqer_tpu_torch import models
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import (
        KV4_Q_CONFIG,
        build_random_model,
    )

    cfg = dataclasses.replace(LlamaConfig.llama_7b(), num_hidden_layers=layers)
    t0 = time.perf_counter()
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=SEED + 3)
    kv4 = models.quantize_model(cfg, KV4_Q_CONFIG, {"linear": {"rank": 32}})
    embed32 = params["model.embed_tokens.weight"]
    params["model.embed_tokens.weight"] = embed32.to(torch.bfloat16)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    counts = None
    # the staged caches serve 80 new tokens per request (every slot
    # flushes); mxint8-staged then profiles an admission and runs the long
    # prompt; the direct-write caches serve 40
    for cache_dtype, layer_qcfgs, new_tokens in (
            ("mxint8-staged", qcfgs, 80), ("bfloat16", qcfgs, 40),
            ("mxint8", qcfgs, 40), ("mxint4", kv4, 40),
            ("mxint4-staged", kv4, 80)):
        engine = DecodeEngine(params, cfg, layer_qcfgs, num_slots=8,
                              max_len=2048, cache_dtype=cache_dtype,
                              pallas_backend=backend, lm_head_width=8,
                              scan_layers=True, device="cuda")
        run = serve_requests(torch, engine, cfg, cache_dtype, new_tokens,
                             pack_s, "Llama-2-7B shape, W8 head")
        tokens = np.zeros(engine.num_slots, dtype=np.int64)
        profile_window(torch, lambda: engine.decode_logits(tokens), 5,
                       f"decode steps, {cache_dtype} cache")
        if (cache_dtype == "mxint4-staged"
                and run["decode_attention.width4"] <= 0):
            raise AssertionError(f"serve {cache_dtype}: row 7 not launched "
                                 f"at code width 4: {run}")
        counts = run if counts is None else {k: n + run[k]
                                             for k, n in counts.items()}
        rng = np.random.default_rng(SEED + 7)
        if cache_dtype == "mxint8-staged":
            ids = rng.integers(0, cfg.vocab_size, (8, 64))
            profile_window(torch, lambda: engine.prefill(
                ids, np.arange(8), np.full(8, 64, dtype=np.int32)), 1,
                "8 x 64-token admission")
            # last: the long admission leaves slot 0 holding 2048 tokens
            reset_launch_counts()
            long_prompt(torch, engine.prefill, cfg, rng)
            counts = {k: n + launch_counts()[k] for k, n in counts.items()}
        del engine
        torch.cuda.empty_cache()
    eager = serve_eager(torch, cfg, params, backend, qcfgs, embed32, pack_s)
    counts = {k: n + eager[k] for k, n in counts.items()}
    # long context: 4 slots at max_len 32768, past the one-pass length, per
    # MXINT cache (36.5 GB at width 8, 19.3 GB at width 4, freed after
    # each): the request mix with 16 new tokens, then decode steps at
    # positions near 32000
    for cache_dtype, layer_qcfgs in (("mxint8-staged", qcfgs),
                                     ("mxint8", qcfgs), ("mxint4", kv4),
                                     ("mxint4-staged", kv4)):
        engine = DecodeEngine(params, cfg, layer_qcfgs, num_slots=4,
                              max_len=32768, cache_dtype=cache_dtype,
                              pallas_backend=backend, lm_head_width=8,
                              scan_layers=True, device="cuda")
        run = serve_requests(torch, engine, cfg, cache_dtype, 16, pack_s)
        reset_launch_counts()
        long_context_steps(torch, engine, cfg, cache_dtype, rates)
        steps = launch_counts()
        if (cache_dtype == "mxint4-staged"
                and steps["decode_attention_streaming_staged.width4"] <= 0):
            raise AssertionError(f"{cache_dtype} at long context: row 9 not "
                                 f"launched at code width 4: {steps}")
        counts = {k: n + run[k] + steps[k] for k, n in counts.items()}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def serve_eager(torch, cfg, params, backend, qcfgs, embed32, pack_s):
    """Phase 5, the eager step: the request mix (80 new tokens) on the
    ``mxint8-staged`` cache through the stacked engine, then through the
    eager engine (``scan_layers=False``: per-prefix backend entries, the
    JAX package's default), both with the f32 embedding (the eager stream
    stays in the f32 its kernels return, as the JAX package's does, so the
    two compute the same function); each with a profile of 5 decode steps.
    Greedy tokens must be equal; the eager run must launch rows 1
    (``dequant_gemm``), 2 (``unpack``: the 8 x 64-row admission takes the
    large-M route), 3 (``mlp_fused``), 4 (``attention``), 7
    (``decode_attention``) and 14 (``cache_write``). Returns the eager
    run's launches."""
    from lqer_tpu_torch.serving import DecodeEngine

    params32 = dict(params)
    params32["model.embed_tokens.weight"] = embed32
    outputs, busy = {}, {}
    for scan in (True, False):
        name = "stacked" if scan else "eager"
        outputs[name] = []
        engine = DecodeEngine(params32, cfg, qcfgs, num_slots=8,
                              max_len=2048, cache_dtype="mxint8-staged",
                              pallas_backend=backend, lm_head_width=8,
                              scan_layers=scan, device="cuda")
        run = serve_requests(torch, engine, cfg, "mxint8-staged", 80, pack_s,
                             f"Llama-2-7B shape, W8 head, f32 embedding, "
                             f"{name} engine", outputs=outputs[name])
        tokens = np.zeros(engine.num_slots, dtype=np.int64)
        busy[name] = profile_window(
            torch, lambda: engine.decode_logits(tokens), 5,
            f"decode steps, mxint8-staged cache, {name} engine")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    idle = [k for k in ("dequant_gemm", "unpack", "mlp_fused", "attention",
                        "decode_attention", "cache_write") if run[k] <= 0]
    same = outputs["eager"] == outputs["stacked"]
    print(f"eager engine against the stacked engine, 32 layers, "
          f"mxint8-staged, the request mix: greedy tokens equal {same}; "
          f"device busy per step (profile) eager {busy['eager']} ms, "
          f"stacked {busy['stacked']} ms", flush=True)
    if idle or not same:
        raise AssertionError(f"phase 5 eager engine: tokens equal {same}, "
                             f"rows not launched {idle}: {run}")
    return run


def phase_serve_cli(torch, rates):
    """Phase 5, the serving CLI: ``python -m lqer_tpu_torch.serving.cli``
    on ``experiments/configs/debug/llama-tiny-pallas.toml`` with
    ``--pallas --max-len 64`` (kernel 1 and the megakernel, the prefill
    kernel, the eager attention at decode), once on the card and once with
    ``--device cpu``, each a subprocess (the two at once): one token line
    per prompt, equal.
    Returns no launches (they are the subprocesses')."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "lqer_tpu_torch.serving.cli",
           "experiments/configs/debug/llama-tiny-pallas.toml", "--pallas",
           "--max-len", "64", "--slots", "2", "--max-new-tokens", "8",
           "--prompt", "1 2 3", "--prompt", "7 8 9 10 11"]
    t = time.perf_counter()
    procs = {device: subprocess.Popen(
        cmd + ["--device", device], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for device in ("cuda", "cpu")}
    lines = {}
    try:
        for device, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"serving CLI on {device}: exit "
                                     f"{proc.returncode}\n{err[-4000:]}")
            lines[device] = [ln for ln in out.splitlines()
                             if ln.startswith("[") and "tokens:" in ln]
            print(f"serving CLI (llama-tiny-pallas.toml --pallas --max-len "
                  f"64) --device {device}: {lines[device]}, "
                  f"{time.perf_counter() - t:.1f}s after both started",
                  flush=True)
    finally:
        for proc in procs.values():
            proc.kill()
    if lines["cuda"] != lines["cpu"] or len(lines["cuda"]) != 2:
        raise AssertionError(f"serving CLI: card {lines['cuda']} against "
                             f"CPU {lines['cpu']}")
    return {}


def phase_bench_streaming(torch, rates):
    """Phase 5, the all-layer row write's path: ``tools/bench_streaming_
    staged.py`` at its defaults (8 slots, 32 kv heads, d = 128, L = 32768),
    its chain of 4 decode steps once per case (``staged``: row 9;
    ``twopass``: row 12, then row 8), outputs checked finite, then its
    marginal ms per layer-step (chains of 4 and 12, best of 1). Returns
    the launches of the two chains."""
    import importlib.util

    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    path = Path(__file__).resolve().parent / "tools" / "bench_streaming_staged.py"
    spec = importlib.util.spec_from_file_location("bench_streaming_staged",
                                                  path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    B, KVH, D, L = 8, 32, 128, 32768
    state = bench.make_state(B, KVH, D, L, 12)
    reset_launch_counts()
    sums = {case: bench.chain(case, 4, state) for case in bench.CASES}
    torch.cuda.synchronize()
    counts = launch_counts()
    if not all(bool(torch.isfinite(v)) for v in sums.values()):
        raise AssertionError(f"bench_streaming_staged chains: {sums}")
    gb = 2 * B * KVH * L * (D + D // 16) * 1e-9
    for case in bench.CASES:
        marg = bench.measure(case, [4, 12], 1, state)
        print(f"tools/bench_streaming_staged.py {case} L={L}: "
              f"{marg * 1e3:.4f} ms/layer-step (CUDA events; the one-pass "
              f"stream {gb:.2f} GB, {gb * 1e9 / rates[0] * 1e3:.4f} ms at "
              f"{rates[0] / 1e12:.2f} TB/s)", flush=True)
    print(f"tools/bench_streaming_staged.py chains of 4 steps per case: "
          f"kernel launches {counts}", flush=True)
    del state
    torch.cuda.empty_cache()
    return counts


def phase_serve_mistral(torch, rates, layers: int = 16):
    """Phase 5 for Mistral: the engine at Mistral-7B-v0.1 width (``layers``
    of its 32: the depth cut to keep the run inside its time, every kernel
    and route as at 32), rank 128, W8 head, window 4096, 8 slots at max_len
    8192 over the
    ``bfloat16`` cache, ``mxint8-staged``, which falls back to the
    direct-write ``mxint8`` under the window, and ``mxint4`` (the KV4
    configuration): the request mix (40 new tokens), then 10 decode steps
    at positions 6000.. past the window with a 5-step profile; on the bf16
    cache one 2048-token eager windowed admission. Then the bf16 cache at
    its longest length, max_len 12288 (the JAX fp-cache kernel's limit;
    12.9 GB of cache): 10 steps at positions 12000.. Then ``mxint8`` at
    max_len 32768, 4 slots: 10 steps near position 32000 (row 13 + row 8
    with the window) beside the window's cache-read floor. Returns the
    kernel launches."""
    import dataclasses

    from lqer_tpu_torch import models
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.serving import DecodeEngine
    from lqer_tpu_torch.serving.random_model import (
        build_random_model,
        q_config_for,
    )

    cfg = dataclasses.replace(LlamaConfig.mistral_7b(),
                              num_hidden_layers=layers)
    t0 = time.perf_counter()
    backend, params, qcfgs = build_random_model(cfg, rank=128, seed=SEED + 25)
    kv4 = models.quantize_model(cfg, q_config_for(cfg, kv4=True),
                                {"linear": {"rank": 128}})
    params["model.embed_tokens.weight"] = \
        params["model.embed_tokens.weight"].to(torch.bfloat16)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    model = "Mistral-7B-v0.1 shape, W8 head, window 4096"
    counts = None
    for cache_dtype, slots, max_len, position in (
            ("bfloat16", 8, 8192, 6000), ("bfloat16", 8, 12288, 12000),
            ("mxint8-staged", 8, 8192, 6000), ("mxint4", 8, 8192, 6000),
            ("mxint8", 4, 32768, 32000)):
        layer_qcfgs = kv4 if cache_dtype == "mxint4" else qcfgs
        engine = DecodeEngine(params, cfg, layer_qcfgs, num_slots=slots,
                              max_len=max_len, cache_dtype=cache_dtype,
                              pallas_backend=backend, lm_head_width=8,
                              scan_layers=True, device="cuda")
        if "flushed" in engine.cache:
            raise AssertionError("mxint8-staged under a window must fall "
                                 "back to the direct-write cache")
        run = {}
        if max_len == 8192:
            run = serve_requests(torch, engine, cfg, cache_dtype, 40, pack_s,
                                 model, 128)
        reset_launch_counts()
        long_context_steps(torch, engine, cfg, cache_dtype, rates,
                           position=position)
        if cache_dtype == "bfloat16" and max_len == 8192:
            long_prompt(torch, engine.prefill, cfg,
                        np.random.default_rng(SEED + 7))
        counts = {k: n + run.get(k, 0) + (counts or {}).get(k, 0)
                  for k, n in launch_counts().items()}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def serve_requests(torch, engine, cfg, cache_dtype, new_tokens, pack_s,
                   model="Llama-2-7B shape, W8 head", rank=32, outputs=None):
    """8 greedy requests of 20..64 prompt tokens through ``engine``; prints
    the step and admission times and returns the kernel launches (and
    appends each request's tokens to ``outputs``). With 64 new tokens or
    more every staged slot must have flushed."""
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.serving import Request

    rng = np.random.default_rng(SEED + 5)
    reqs = [Request(prompt_ids=[int(t) for t in rng.integers(
        0, cfg.vocab_size, int(n))], max_new_tokens=new_tokens)
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
    del engine.decode_logits, engine.prefill   # no cycle keeps the cache
    finished = sum(r.done for r in reqs)
    produced = sum(len(r.output_ids) for r in reqs)
    if outputs is not None:
        outputs += [r.output_ids for r in reqs]
    staged = "flushed" in engine.cache
    fl = engine.cache["flushed"].tolist() if staged else None
    if finished != len(reqs) or (staged and new_tokens >= 64
                                 and min(fl) == 0):
        raise AssertionError(f"serve {cache_dtype}: {finished}/{len(reqs)} "
                             f"finished, flushed={fl}")
    decode_s = sum(step_ms) / 1e3
    flushes = (f"{launch_counts()['cache_write']} flushes, flushed={fl}, "
               if staged else "")
    slots = engine.num_slots
    print(f"serve {model}, {cfg.num_hidden_layers} layers rank {rank} "
          f"{cache_dtype} {slots} slots max_len {engine.max_len}: "
          f"{finished} requests finished, {produced} tokens, median decode "
          f"step {statistics.median(step_ms):.2f} ms over {len(step_ms)} "
          f"steps, {slots * len(step_ms) / decode_s:.1f} tok/s ({slots} "
          f"slots x steps / decode time), admission {sum(admit_ms):.1f} ms, "
          f"{flushes}kernel launches {launch_counts()}, wall {wall:.2f}s, "
          f"packing {pack_s:.1f}s", flush=True)
    return launch_counts()


def long_context_steps(torch, engine, cfg, cache_dtype, rates,
                       position: int = 32000, steps: int = 10) -> None:
    """Decode steps of every slot at ``position`` onwards over a context
    built by :func:`fill_context` (a staged cache with ``flushed =
    position``). Prints the median step (host clock around a synchronised
    step), tok/s, the predicted cache-read floor (under a sliding window,
    the window's keys) beside the profiled device time, and checks the
    logits."""
    from lqer_tpu_torch.serving.kv_cache import cache_code_width

    cache = engine.cache
    quantized = "k_codes" in cache
    NL, B, KVH = cache["k_codes" if quantized else "k"].shape[:3]
    D = cfg.head_dim
    fill_context(torch, {"engine": engine}, np.full(B, position), SEED + 17)
    if "flushed" in cache:
        cache["flushed"].fill_(position)
    tokens = np.zeros(B, dtype=np.int64)
    step_ms = []
    for _ in range(steps):
        t = time.perf_counter()
        logits = engine.decode_logits(tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        engine.lengths += 1
        tokens = torch.argmax(logits, -1).cpu().numpy()
    if logits.shape != (B, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"long-context steps {cache_dtype}: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    per_token = KVH * 2 * (D * 2 if not quantized else
                           D * cache_code_width(cache) // 8 + D // 16)
    window = getattr(cfg, "sliding_window", None)
    held = min(position, window) if window else position
    floor_ms = NL * B * per_token * (held + steps) / rates[0] * 1e3
    med = statistics.median(step_ms)
    print(f"long-context decode, {cache_dtype} cache, {NL} layers, {B} slots "
          f"at positions {position}..{position + steps - 1} (max_len "
          f"{engine.max_len}{f', window {window}' if window else ''}): "
          f"median step {med:.2f} ms over {steps} steps, "
          f"{B / med * 1e3:.1f} tok/s; predicted cache-read floor "
          f"{floor_ms:.2f} ms per step ({NL * B * per_token * held / 1e9:.2f}"
          f" GB / {rates[0] / 1e12:.2f} TB/s)", flush=True)
    busy = profile_window(torch, lambda: engine.decode_logits(tokens), 5,
                          f"long-context decode steps, {cache_dtype} cache")
    print(f"long-context {cache_dtype}: device busy "
          f"{'not measured' if busy is None else f'{busy:.2f} ms'} per step "
          f"against the cache-read floor {floor_ms:.2f} ms", flush=True)


def long_prompt(torch, prefill, cfg, rng, length: int = 2048) -> None:
    """One ``length``-token admission into slot 0 on a fresh cache, last
    logits only (the prefill chunk of ``bench.py``): every layer takes the
    large-M route. Prints its time (host clock around a synchronised
    call, after one warm-up), checks the logits, then profiles one more."""
    ids = rng.integers(0, cfg.vocab_size, (1, length))
    args = (ids, np.zeros(1, dtype=np.int64),
            np.full(1, length, dtype=np.int32))
    prefill(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = prefill(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    if logits.shape != (1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{length}-token admission: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    print(f"one {length}-token admission ({cfg.num_hidden_layers} layers, "
          f"fresh cache, last logits only): {ms:.1f} ms, "
          f"{length / ms * 1e3:.0f} tokens/s", flush=True)
    profile_window(torch, lambda: prefill(*args), 1,
                   f"{length}-token admission")


def profile_window(torch, fn, steps: int, what: str) -> float | None:
    """Device busy time of ``steps`` calls of ``fn`` (torch.profiler,
    device-side kernel time) against their wall time, the kernels that take
    the most of it and each of the port's kernels per call and launch;
    returns the busy ms per call (None where the profiler recorded no
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    # device-side events only: a CPU op's self device time is the time of
    # the kernels it launched, which the kernels' own events count already
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    if not events:
        print(f"profile of {steps} {what}: {wall_ms:.2f} ms wall per call; "
              "device time not recorded by torch.profiler (not measured)",
              flush=True)
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / steps:.2f}"
                      for e in top)
    # the port's kernels sit in anonymous namespaces of csrc/*.cu; PyTorch's
    # own anonymous ones are inside at:: or native::
    tag = "(anonymous namespace)::"
    ours = "; ".join(
        f"{e.key.split(tag)[1].split('(')[0]} "
        f"{e.self_device_time_total / 1e3 / steps:.3f} ms per call, "
        f"{e.self_device_time_total / e.count:.1f} us per launch"
        for e in events if tag in e.key and "at::" not in e.key
        and not e.key.split(tag)[1].startswith("native"))
    kernels = sum(e.count for e in events) / steps
    aten = sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::")) / steps
    print(f"profile of {steps} {what} (torch.profiler): device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall per call "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler overhead "
          f"included); {kernels:.0f} device kernels and {aten:.0f} aten ops "
          f"(nested ones included) per call; top device ms per call: "
          f"{names}; the port's kernels: {ours}", flush=True)
    return busy_ms


# -- phase 6: the offline pipeline ------------------------------------------------
# Phase 6's model: Llama-2-7B's width at PIPELINE_LAYERS layers, W4A8
# lqer-act at rank 32 (the template's quantizers), synthetic data at
# max_length 2048; the 32-layer evaluation reads PIPELINE_FULL_BATCHES
# batches of 2048 tokens
PIPELINE_LAYERS = 2
PIPELINE_RANK = 32
PIPELINE_FULL_BATCHES = 2
# The perplexity through the kernels against through the plain versions on
# the card: a flipped 8-bit rounding moves a logit row by a few code steps
# (the logits limits above), the perplexity of 4 x 2047 predictions by far
# less
PIPELINE_PPL_RTOL = 2e-3
# One weight of each of the three shapes, held card against CPU
PIPELINE_CPU_WEIGHTS = ("model.layers.0.self_attn.q_proj.weight",
                        "model.layers.0.mlp.gate_proj.weight",
                        "model.layers.0.mlp.down_proj.weight")
# ``A_q B_q`` card against CPU: the limit of the CPU tests
# (tests/test_torch_approximator.py::PRODUCT_REL_ERR)
PIPELINE_PRODUCT_REL_ERR = 1e-2


def pipeline_config(root: Path, work: Path, ckpt: Path) -> dict:
    """The pipeline config of phase 6: ``experiments/configs/template/
    llama-2-7b.toml`` (W4A8, lqer-act) at rank 32 on the 2-layer model
    of ``ckpt``, synthetic data (4 calibration sequences of 2048 tokens at
    batch 2; 4 test sequences at batch 1), the evaluation through the
    kernel backend and the fused prefill attention, no harness."""
    import dataclasses

    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.utils import load_config

    c = load_config(root / "experiments/configs/template/llama-2-7b.toml")
    cfg = dataclasses.replace(LlamaConfig.llama_7b(),
                              num_hidden_layers=PIPELINE_LAYERS)
    c.update(project="chip_smoke", enable_wandb=False,
             enable_harness_downstream_evaluation=False,
             checkpoint_path=str(work / "run"), model_dir=str(ckpt),
             overwrite_checkpoint=True, tags=["chip_smoke"])
    c["model"] = {k: v for k, v in dataclasses.asdict(cfg).items()
                  if v is not None}
    c["l_config"]["linear"]["rank"] = PIPELINE_RANK
    c["approximate"]["approximator"]["default"]["rank"] = PIPELINE_RANK
    synthetic = {"vocab_size": cfg.vocab_size, "num_train": 4,
                 "num_test": 4, "seed": SEED}
    c["profile"] = {"dataset": "synthetic", "dtype": "float32",
                    "max_length": 2048, "batch_size": 2, "num_samples": 4,
                    "synthetic": synthetic}
    c["evaluate"] = {"disable_lqer": False, "dtype": "float32",
                     "pallas_backend": True, "fused_attention": True,
                     "perplexity": {"dataset": "synthetic", "batch_size": 1,
                                    "max_length": 2048,
                                    "progress_bar": False,
                                    "synthetic": synthetic}}
    return c


def write_checkpoint(torch, cfg, path: Path) -> dict:
    """``model.safetensors`` of seeded random dense weights
    (``random_model.build_random_dense_model`` at rank 0: the linears'
    weights f32 at scale 0.01, the embedding at 0.02, the head tied),
    stored as bf16 (the pipeline reads them back as f32). Returns the
    params, on the card."""
    from safetensors.torch import save_file

    from lqer_tpu_torch.serving.random_model import build_random_dense_model

    params, _ = build_random_dense_model(cfg, rank=0, seed=SEED + 11)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.cpu().contiguous() for k, v in params.items()},
              str(path / "model.safetensors"))
    return params


def cpu_pipeline_job(job: dict) -> str:
    """Phase 6's CPU side, in a worker process: ``"profile"`` runs the
    profiling stage of ``job["config"]`` on the CPU; ``"approximate"``
    runs ``approximate_weight`` of the weights ``job["names"]`` with the
    card's scale dict ``job["scale_dict"]``. Saves the result to a file and
    returns its path."""
    import torch
    from safetensors import safe_open

    from lqer_tpu_torch import runners
    from lqer_tpu_torch.approximate import approximate_weight
    from lqer_tpu_torch.models.checkpoint import load_tensor_dict
    from lqer_tpu_torch.ops.quantizers import make_quantizer

    t0 = time.perf_counter()
    out = job["out"]
    if job["kind"] == "profile":
        work = Path(out).parent / "cpu-profile"
        work.mkdir(parents=True, exist_ok=True)
        config = runners.run_profiler(json.loads(job["config"]), work,
                                      device="cpu")
        result = load_tensor_dict(config["profile"]["scale_dict"])
    else:
        d = json.loads(job["config"])["approximate"]["approximator"][
            "default"]
        qs = [make_quantizer(d[k]) for k in ("W_quantizer", "A_quantizer",
                                             "B_quantizer")]
        scales = load_tensor_dict(job["scale_dict"])
        result = {}
        with safe_open(job["checkpoint"], framework="pt") as f:
            for name in job["names"]:
                w = f.get_tensor(name).to(torch.float32)
                s = torch.as_tensor(scales[name[:-len("weight")] + "scale"])
                a, b, _ = approximate_weight(w, d["rank"], *qs, scale=s)
                result[name + ".A"], result[name + ".B"] = a, b
    torch.save({"result": result, "seconds": time.perf_counter() - t0}, out)
    return out


def packed_prefixes(meta: dict) -> set:
    """The Llama linears a backend's entries cover: a fused q|k|v or
    gate|up entry its members, an MLP entry gate, up and down."""
    members = {"self_attn.qkv_proj": ("self_attn.q_proj", "self_attn.k_proj",
                                      "self_attn.v_proj"),
               "mlp.gateup_proj": ("mlp.gate_proj", "mlp.up_proj"),
               "mlp_fused": ("mlp.gate_proj", "mlp.up_proj",
                             "mlp.down_proj")}
    out = set()
    for key in meta:
        for fused, rels in members.items():
            if key.endswith("." + fused):
                lp = key[:-len(fused) - 1]
                out.update(f"{lp}.{r}" for r in rels)
                break
        else:
            out.add(key)
    return out


def pipeline_launches(counts: dict, meta: dict, layers: int, batches: int,
                      rows: int) -> dict:
    """The launches each row should make in an evaluation of ``batches``
    batches of ``rows`` rows through ``layers`` Llama layers whose packed
    entries are ``meta`` (the backend's): per layer one prefill attention
    (row 4); per packed linear (q|k|v fused, or one projection) kernel 1
    below 512 rows, else one unpack (row 2) before a dense product; per
    packed MLP one megakernel (row 3) below 512 rows, else three unpacks.
    A linear the backend did not pack runs the emulation, as in JAX; the
    head stays a dense product. Raises unless ``counts`` holds exactly
    these."""
    want = {"attention": layers * batches}
    for entry in meta.values():
        mlp = entry.get("kind") == "mlp"
        key, n = (("mlp_fused", 1) if mlp else ("dequant_gemm", 1)) \
            if rows < 512 else ("unpack", 3 if mlp else 1)
        want[key] = want.get(key, 0) + n * batches
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want} "
                             f"({layers} layers x {batches} batches of "
                             f"{rows} rows, {len(meta)} packed entries)")
    return got


PIPELINE_ROWS = {"dequant_gemm": 1, "unpack": 2, "mlp_fused": 3,
                 "attention": 4}


def pipeline_rows(launches: dict) -> list:
    """The kernel table's rows of an evaluation's launches."""
    return sorted(PIPELINE_ROWS[k] for k in launches)


# The harness stage on phase 6's model, kernels against the plain versions
# on the card: accuracies equal; every other metric (a task's mean
# perplexity, word perplexity, and the stderrs) within this relative
# tolerance, phase 6's perplexity limit: each is an exp of a sum of
# log-softmaxes of logits held to phase 4's limits.
HARNESS_RTOL = 2e-3
HARNESS_ACCURACIES = ("acc", "acc_norm", "exact_match")
# The chunked approximation against the unchunked one on the same card:
# equal to the bit, or (where cuSOLVER's batched gesvda gives another
# rounding for another batch) each weight's A_q B_q within this relative
# Frobenius error
CHUNKED_REL_ERR = 1e-4


class ByteTokenizer:
    """A byte-level tokenizer for the harness on the card (the card machine
    has no ``transformers``): UTF-8 bytes as ids 3..258, 1 the BOS and 2
    the EOS id, as Llama's."""

    bos_token_id = 1
    eos_token_id = 2

    def encode(self, text: str) -> list[int]:
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        return bytes(i - 3 for i in ids if 3 <= i < 259).decode(
            "utf-8", errors="replace")


def harness_on_pipeline_model(torch, root: Path, run_dir: Path,
                              work: Path) -> dict:
    """Phase 6's harness stage on its model (``run_dir``: the pipeline's
    output). First ``run_pipeline`` from ``config_after_approximation.toml``
    with the stage on and the template's own task names: without lm_eval
    it skips them, then the stage, and ends "Done.". Then every ``tiny_*``
    task on :class:`ByteTokenizer` (patched into ``runners._get_tokenizer``
    for the call), through the kernels and through the plain versions on
    the card: accuracies equal, the rest within HARNESS_RTOL. The fused
    prefill attention is off for it: row 4 takes only lengths that are
    multiples of 16 (the JAX kernel asserts it), and a batch of requests
    is as long as its longest. Returns the kernels' launches."""
    from lqer_tpu_torch import runners
    from lqer_tpu_torch.evaluate import harness
    from lqer_tpu_torch.evaluate.minieval import TASK_REGISTRY
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.utils import load_config, save_config

    template = load_config(root / "experiments/configs/template/"
                           "llama-2-7b.toml")["evaluate"]["harness_downstream"]
    config = load_config(run_dir / "pipeline/config_after_approximation.toml")
    config.update(enable_harness_downstream_evaluation=True,
                  enable_perplexity_evaluation=False)
    config["evaluate"]["harness_downstream"] = dict(template)
    path = work / "harness.toml"
    save_config(config, path)
    warned = []
    saved_warning = runners.logger.warning
    runners.logger.warning = lambda msg, *a: (warned.append(msg % a),
                                              saved_warning(msg, *a))
    try:
        out = runners.run_pipeline([str(path),
                                    f"--checkpoint_path={work / 'real'}"])
    finally:
        runners.logger.warning = saved_warning
    stage = work / "real/evaluate_harness_downstream"
    skipped = (out["enable_harness_downstream_evaluation"] is False
               and stage.is_dir() and not any(stage.iterdir())
               and (work / "real/pipeline/config_after_harness_downstream_"
                    "evaluation.toml").exists()
               and any("lambada_openai" in w for w in warned)
               and any("skipping stage" in w for w in warned))
    print(f"phase 6 harness with the template's tasks {template['datasets']}"
          f": skipped as in JAX {skipped} ({warned})", flush=True)
    if not skipped:
        raise AssertionError("phase 6 harness: the template's tasks were "
                             "not skipped")

    config["evaluate"]["harness_downstream"] = dict(
        template, datasets=sorted(TASK_REGISTRY))
    config["evaluate"]["fused_attention"] = False
    per_type, secs, launches, results = {}, {}, {}, {}
    methods = ("loglikelihood", "loglikelihood_rolling", "generate_until")
    saved = [(runners, "_get_tokenizer", runners._get_tokenizer)] + [
        (harness.TorchCausalLM, m, getattr(harness.TorchCausalLM, m))
        for m in methods]

    def counted(m, fn):
        def run(self, requests):
            torch.cuda.synchronize()
            before, t = launch_counts(), time.perf_counter()
            out = fn(self, requests)
            torch.cuda.synchronize()
            per_type[m] = {
                "requests": len(requests),
                "seconds": round(time.perf_counter() - t, 3),
                "launches": {k: v - before[k]
                             for k, v in launch_counts().items()
                             if v != before[k]}}
            return out
        return run

    runners._get_tokenizer = lambda c: ByteTokenizer()
    try:
        for name in ("kernels", "plain"):
            for m in methods:
                setattr(harness.TorchCausalLM, m,
                        counted(m, dict((n, f) for _, n, f in saved)[m]))
            d = work / f"harness_{name}"
            d.mkdir()
            with run_context(name):
                torch.cuda.synchronize()
                reset_launch_counts()
                t = time.perf_counter()
                runners.run_evaluate_harness_downstream(config, d, "cuda")
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t
                launches[name] = {k: v for k, v in launch_counts().items()
                                  if v}
            with open(d / "harness_results.json") as f:
                results[name] = json.load(f)
            if name == "kernels":
                kernel_types = dict(per_type)
    finally:
        for obj, n, f in saved:
            setattr(obj, n, f)
    worst, unequal = 0.0, []
    for task, metrics in results["plain"]["results"].items():
        for k, v in metrics.items():
            got = results["kernels"]["results"][task][k]
            if k == "alias":
                continue
            if k.split(",")[0].removesuffix("_stderr") in HARNESS_ACCURACIES:
                if got != v:
                    unequal.append(f"{task} {k}: {got} vs {v}")
            else:
                worst = max(worst, abs(got - v) / max(abs(v), 1e-30))
    acc = {t: m.get("acc", m.get("exact_match"))
           for t, m in results["kernels"]["results"].items()}
    print(f"phase 6 harness, every tiny task on a byte-level tokenizer "
          f"(batch {template['batch_size']}, fused prefill attention off): "
          f"through the kernels {secs['kernels']:.2f}s wall, through the "
          f"plain versions on the card {secs['plain']:.2f}s; accuracies "
          f"{acc}, equal to the plain versions' {not unequal}; the other "
          f"metrics' largest relative difference {worst:.3g} (limit "
          f"{HARNESS_RTOL}); the kernels' launches per request type "
          f"{kernel_types}; in all {launches['kernels']}", flush=True)
    if unequal or worst > HARNESS_RTOL or not launches["kernels"]:
        raise AssertionError(f"phase 6 harness: accuracies differ "
                             f"{unequal}, worst other {worst}")
    return launches["kernels"]


def chunked_on_pipeline_model(torch, run_dir: Path, work: Path) -> None:
    """``chunked-approximate`` of phase 6's 14 weights in 2 chunks of 7 on
    the card, then ``merge-chunks`` (the CLI), against the pipeline's
    unchunked ``low_rank_dict`` from the same scale dict."""
    import copy

    from lqer_tpu_torch import cli
    from lqer_tpu_torch.models.checkpoint import load_tensor_dict
    from lqer_tpu_torch.utils import load_config, save_config

    config = load_config(run_dir / "pipeline/config_after_profiling.toml")
    path = work / "chunked.toml"
    save_config(copy.deepcopy(config), path)
    out = work / "chunked"
    torch.cuda.synchronize()
    t = time.perf_counter()
    for idx in range(2):
        if cli.main(["chunked-approximate", str(path), "chip_smoke",
                     f"--checkpoint_path={out}",
                     "--approximate:chunk_size=:ast:7",
                     f"--approximate:chunk_idx=:ast:{idx}"]) != 0:
            raise AssertionError(f"chunked-approximate chunk {idx} failed")
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t
    prj = out / "approximate_chunked"
    if cli.main(["merge-chunks", str(prj)]) != 0:
        raise AssertionError("merge-chunks failed")
    paths = load_config(prj / "config_merged.toml")["evaluate"][
        "low_rank_dict"]
    merged = load_tensor_dict(paths)
    whole = load_tensor_dict(run_dir / "approximate/low_rank_dict.safetensors")
    if sorted(merged) != sorted(whole) or len(paths) != 2:
        raise AssertionError(f"merged chunks hold {len(merged)} factors in "
                             f"{len(paths)} files, the pipeline {len(whole)}")
    equal = sum(np.array_equal(merged[k], whole[k]) for k in whole)
    worst = 0.0
    for k in whole:
        if k.endswith(".A"):
            m = k[:-2]
            want = (torch.as_tensor(whole[m + ".A"]).double()
                    @ torch.as_tensor(whole[m + ".B"]).double())
            got = (torch.as_tensor(merged[m + ".A"]).double()
                   @ torch.as_tensor(merged[m + ".B"]).double())
            worst = max(worst, float(torch.linalg.norm(got - want)
                                     / torch.linalg.norm(want)))
    print(f"phase 6 chunked approximation (2 chunks of 7 weights, "
          f"chunked-approximate then merge-chunks, torch.linalg.svd on the "
          f"card): {chunk_s:.2f}s for the chunks; {equal} of {len(whole)} "
          f"factors equal to the bit to the unchunked run's, A_q B_q "
          f"largest relative error {worst:.3g} (limit {CHUNKED_REL_ERR} "
          f"where not bit-equal)", flush=True)
    if equal != len(whole) and worst > CHUNKED_REL_ERR:
        raise AssertionError("phase 6 chunked approximation differs from "
                             "the unchunked one")


def phase_pipeline(torch, rates, pool_workers: int = 2) -> dict:
    """Phase 6: the offline pipeline on the card (``runners.run_pipeline``,
    profile → approximate → perplexity) at Llama-2-7B width, held against
    the plain versions on the card and against the CPU; then the
    perplexity of the 32-layer model. Returns the launches of its
    evaluations."""
    import concurrent.futures
    import dataclasses
    import multiprocessing
    import shutil
    import tempfile

    from lqer_tpu_torch import models, runners
    from lqer_tpu_torch.evaluate import evaluate_perplexity
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.models import llama as llama_mod
    from lqer_tpu_torch.models.checkpoint import load_tensor_dict
    from lqer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from lqer_tpu_torch.serving.random_model import build_random_model
    from lqer_tpu_torch.testing import logits_steps
    from lqer_tpu_torch.utils import load_config, save_config

    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_"))
    cpus = os.cpu_count() or 1
    pool = concurrent.futures.ProcessPoolExecutor(
        pool_workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init,
        initargs=(str(root), max(1, cpus // pool_workers)))
    total = {}
    try:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(LlamaConfig.llama_7b(),
                                  num_hidden_layers=PIPELINE_LAYERS)
        ckpt = work / "checkpoint"
        write_checkpoint(torch, cfg, ckpt)
        config = pipeline_config(root, work, ckpt)
        config_json = json.dumps(config)
        print(f"phase 6: checkpoint of the {PIPELINE_LAYERS}-layer "
              f"Llama-2-7B-width model written in "
              f"{time.perf_counter() - t0:.1f}s; the CPU sides in "
              f"{pool_workers} spawned workers of "
              f"{max(1, cpus // pool_workers)} threads", flush=True)
        cpu_profile = pool.submit(cpu_pipeline_job, {
            "kind": "profile", "config": config_json,
            "out": str(work / "cpu-profile.pt")})
        cpu_svd, ran = [], []
        stage_s, eval_counts = {}, {}
        run_dir = work / "run"

        @contextlib.contextmanager
        def timed(folder):
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            yield
            torch.cuda.synchronize()
            stage_s[folder] = time.perf_counter() - t
            eval_counts[folder] = launch_counts()
            ran.append(folder)
            if folder == "profile":
                cpu_svd.append(pool.submit(cpu_pipeline_job, {
                    "kind": "approximate", "config": config_json,
                    "names": PIPELINE_CPU_WEIGHTS,
                    "checkpoint": str(ckpt / "model.safetensors"),
                    "scale_dict": str(
                        run_dir / "profile/scale_dict.safetensors"),
                    "out": str(work / "cpu-svd.pt")}))

        path = work / "pipeline.toml"
        save_config(config, path)
        t = time.perf_counter()
        runners.run_pipeline([str(path)], stage_hook=timed)
        pipeline_s = time.perf_counter() - t
        stage_s["evaluate_2048"] = stage_s.pop("evaluate_perplexity")
        counts_2048 = eval_counts.pop("evaluate_perplexity")
        # resume from after the approximation at 256 rows a batch
        runners.run_pipeline([
            str(run_dir / "pipeline/config_after_approximation.toml"),
            "--evaluate:perplexity:max_length=256",
            f"--checkpoint_path={work / 'run256'}"], stage_hook=timed)
        stage_s["evaluate_256"] = stage_s.pop("evaluate_perplexity")
        counts_256 = eval_counts.pop("evaluate_perplexity")
        if ran != ["profile", "approximate", "evaluate_perplexity",
                   "evaluate_perplexity"]:
            raise AssertionError(f"the two runs ran the stages {ran}")
        for name in ("profile", "approximate"):
            if any(eval_counts[name].values()):
                raise AssertionError(f"the {name} stage launched kernels: "
                                     f"{eval_counts[name]}")
        # the evaluated model as run_pipeline builds it (the same weights
        # and factors pack the same way): its packed entries
        config = load_config(
            run_dir / "pipeline/config_after_approximation.toml")
        _, _, _, backend, fwd = runners._build_quantized_forward(
            config, False, torch.float32, "cuda")
        meta = dict(backend["meta"])
        if not meta:
            raise AssertionError("run_pipeline's evaluation packed no entry")
        got_2048 = pipeline_launches(counts_2048, meta, PIPELINE_LAYERS, 4,
                                     2048)
        got_256 = pipeline_launches(counts_256, meta, PIPELINE_LAYERS, 4,
                                    256)
        covered = packed_prefixes(meta)
        linears = [p for i in range(PIPELINE_LAYERS)
                   for p, _ in models.quantizable_module_prefixes(cfg, i)]
        emulated = [p.removeprefix("model.layers.") for p in linears
                    if p not in covered]
        for got in (got_2048, got_256):
            for k, n in got.items():
                total[k] = total.get(k, 0) + n

        def ppl(out):
            with open(out / "evaluate_perplexity/synthetic.json") as f:
                return json.load(f)["perplexity"]

        ppl_2048, ppl_256 = ppl(run_dir), ppl(work / "run256")
        print(f"phase 6 pipeline (run_pipeline on the card, "
              f"{PIPELINE_LAYERS} layers at Llama-2-7B width, W4A8 lqer-act "
              f"rank {PIPELINE_RANK}): {pipeline_s:.1f}s; stages: profile "
              f"(4 x 2048 tokens, batch 2) {stage_s['profile']:.2f}s, "
              f"approximate (14 linears, torch.linalg.svd on the card) "
              f"{stage_s['approximate']:.2f}s, perplexity at 2048 rows (4 "
              f"batches of 1 x 2048) {stage_s['evaluate_2048']:.2f}s, "
              f"ppl {ppl_2048:.4f}, launches {got_2048}; resumed from "
              f"config_after_approximation.toml at 256 rows (4 batches of "
              f"1 x 256) {stage_s['evaluate_256']:.2f}s, ppl {ppl_256:.4f}, "
              f"launches {got_256}; rows launched at 2048 rows "
              f"{pipeline_rows(got_2048)}, at 256 rows "
              f"{pipeline_rows(got_256)}; {len(meta)} packed entries cover "
              f"{len(linears) - len(emulated)} of the {len(linears)} "
              f"linears, emulated (an A or B value the 8-bit quantizer "
              f"passed through at |v| <= 1e-8, not exact in bf16, as the "
              f"JAX package leaves it): {emulated or 'none'}", flush=True)

        # (b) the same evaluation through the plain versions on the card
        test = runners._get_split(config["evaluate"]["perplexity"], config,
                                  "test")
        ids = torch.as_tensor(test[:1]).cuda()
        with torch.inference_mode():
            kern = fwd(ids)
            with plain_versions_on_card():
                plain = fwd(ids)
                plain_dir = work / "plain"
                plain_dir.mkdir()
                runners.run_evaluate_perplexity(config, plain_dir, "cuda")
            *_, fwd_nc = runners._build_quantized_forward(
                config, True, torch.float32, "cuda")
            control = fwd_nc(ids)
        with open(plain_dir / "synthetic.json") as f:
            ppl_plain = json.load(f)["perplexity"]
        steps = logits_steps(kern, plain)
        ctrl = logits_steps(control, kern)
        ok = steps[0] <= LOGIT_MAX_STEPS and steps[1] <= LOGIT_RMS_STEPS
        ctrl_out = ctrl[0] > LOGIT_MAX_STEPS or ctrl[1] > LOGIT_RMS_STEPS
        ppl_ok = abs(ppl_2048 - ppl_plain) <= PIPELINE_PPL_RTOL * ppl_plain
        print(f"phase 6 kernels against the plain versions on the card, "
              f"test batch 0 (1 x 2048): logits {steps[0]:.4f} code steps "
              f"at most, {steps[1]:.4f} RMS (limits {LOGIT_MAX_STEPS}, "
              f"{LOGIT_RMS_STEPS}); perplexity {ppl_2048:.6f} against "
              f"{ppl_plain:.6f} (rtol {PIPELINE_PPL_RTOL}); negative "
              f"control, disable_lqer = true: {ctrl[0]:.4f} steps at most, "
              f"{ctrl[1]:.4f} RMS from the LQER logits (must fall outside)",
              flush=True)
        del backend, fwd, fwd_nc, kern, plain, control
        gc.collect()
        torch.cuda.empty_cache()
        if not (ok and ctrl_out and ppl_ok):
            raise AssertionError(
                f"phase 6 against the plain versions: logits within limits "
                f"{ok}, control outside {ctrl_out}, perplexity {ppl_ok}")

        # (e) the harness stage and the chunked approximation, same model
        for k, n in harness_on_pipeline_model(torch, root, run_dir,
                                              work).items():
            total[k] = total.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
        chunked_on_pipeline_model(torch, run_dir, work)

        # (d) the perplexity alone at all 32 layers
        cfg32 = LlamaConfig.llama_7b()
        t = time.perf_counter()
        backend, params, qcfgs = build_random_model(cfg32, rank=PIPELINE_RANK,
                                                    seed=SEED + 12)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t
        data = runners._get_split(
            {"dataset": "synthetic", "max_length": 2048,
             "synthetic": {"vocab_size": cfg32.vocab_size,
                           "num_train": 0, "num_test": PIPELINE_FULL_BATCHES,
                           "seed": SEED + 13}}, {"model_name": "n/a"},
            "test")

        def fwd32(ids):
            return llama_mod.forward(params, ids, cfg32, qcfgs,
                                     fused_attention=True, backend=backend)

        with torch.inference_mode():
            fwd32(torch.as_tensor(data[:1]).cuda())     # warm
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            res = evaluate_perplexity(fwd32, data, batch_size=1,
                                      device="cuda")
            torch.cuda.synchronize()
            full_s = time.perf_counter() - t
            got_32 = pipeline_launches(launch_counts(), backend["meta"], 32,
                                       PIPELINE_FULL_BATCHES, 2048)
            # one batch of 256 rows: rows 1 and 3 on every layer
            reset_launch_counts()
            t = time.perf_counter()
            res_256 = evaluate_perplexity(fwd32, data[:1, :256], batch_size=1,
                                          device="cuda")
            torch.cuda.synchronize()
            s256 = time.perf_counter() - t
            got_32_256 = pipeline_launches(launch_counts(), backend["meta"],
                                           32, 1, 256)
            busy = profile_window(
                torch, lambda: fwd32(torch.as_tensor(data[:1]).cuda()), 1,
                "32-layer perplexity batches (1 x 2048 tokens)")
        for got in (got_32, got_32_256):
            for k, n in got.items():
                total[k] = total.get(k, 0) + n
        print(f"phase 6 perplexity at 32 layers (Llama-2-7B, rank "
              f"{PIPELINE_RANK} seeded A and B, packed in {pack_s:.1f}s): "
              f"{PIPELINE_FULL_BATCHES} batches of 1 x 2048 tokens in "
              f"{full_s:.2f}s wall ({full_s / PIPELINE_FULL_BATCHES:.3f}s "
              f"a batch; device busy {busy} ms a batch), ppl "
              f"{res['perplexity']:.4f}, launches {got_32}; one batch of "
              f"1 x 256 tokens {s256:.3f}s, ppl {res_256['perplexity']:.4f}, "
              f"launches {got_32_256}", flush=True)
        del backend, params
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the CPU sides
        t = time.perf_counter()
        cpu = torch.load(cpu_profile.result(), weights_only=False)
        svd = torch.load(cpu_svd[0].result(), weights_only=False)
        wait_s = time.perf_counter() - t
        card_sd = load_tensor_dict(run_dir / "profile/scale_dict.safetensors")
        worst_scale = 0.0
        for k, v in card_sd.items():
            c = torch.as_tensor(cpu["result"][k], dtype=torch.float64)
            d = ((torch.as_tensor(v, dtype=torch.float64) - c).abs()
                 / c.abs()).max()
            worst_scale = max(worst_scale, float(d))
        card_lr = load_tensor_dict(
            run_dir / "approximate/low_rank_dict.safetensors")
        products = {}
        for name in PIPELINE_CPU_WEIGHTS:
            m = name[:-len(".weight")]
            want = (torch.as_tensor(card_lr[m + ".A"]).double().cuda()
                    @ torch.as_tensor(card_lr[m + ".B"]).double().cuda())
            got = (svd["result"][name + ".A"].double().cuda()
                   @ svd["result"][name + ".B"].double().cuda())
            products[m.split("layers.0.")[1]] = float(
                torch.linalg.norm(got - want) / torch.linalg.norm(want))
        print(f"phase 6 against the CPU (waited {wait_s:.1f}s for the "
              f"workers: profile {cpu['seconds']:.1f}s, SVDs "
              f"{svd['seconds']:.1f}s): scale dict largest relative "
              f"difference {worst_scale:.3g} over {len(card_sd)} entries "
              f"(rtol 1e-3); A_q B_q relative Frobenius error card against "
              f"CPU {products} (limit {PIPELINE_PRODUCT_REL_ERR})",
              flush=True)
        if (sorted(card_sd) != sorted(cpu["result"]) or worst_scale > 1e-3
                or max(products.values()) > PIPELINE_PRODUCT_REL_ERR):
            raise AssertionError("phase 6 against the CPU: past the limits")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lqer_tpu_torch.ops.kernels import (
        KERNELS,
        launch_counts,
        reset_launch_counts,
    )
    from lqer_tpu_torch.ops.kernels._build import ENTRIES, SOURCES, build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rates = peak_rates(name)
    print(f"card: {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | peaks {rates[0] / 1e12:.2f} TB/s, "
          f"{rates[1] / 1e12:.0f} TFLOP/s bf16", flush=True)
    secs = build_all()
    print(f"build: {len(SOURCES)} sources, {len(ENTRIES)} entry points, "
          f"{len(KERNELS)} kernels (nvcc sm_90a, in parallel) in {secs:.1f}s",
          flush=True)
    timer = Timer(torch)
    t0 = time.perf_counter()
    results = phase_kernels(torch, timer, rates)
    phase_direct_kernels(torch, timer, rates, results)
    phase_stream_kernels(torch, timer, rates, results)
    phase_opt_kernels(torch, timer, rates, results)
    phase_mistral_kernels(torch, timer, rates, results)
    phase_head_dim_kernels(torch, timer, rates, results)
    phase_slice7_kernels(torch, timer, rates, results)
    phase_f32_kernels(torch, timer, rates, results)
    floor = timer(lambda: torch.cuda._sleep(0))
    print(f"empty launch (torch.cuda._sleep(0): one thread that returns at "
          f"once) under phase 3's timer: {floor:.4f} ms, the floor of the "
          f"launch-bound cache writes (rows 11 to 14)", flush=True)
    for k in ("row_write", "row_write_all", "encode_write_tokens",
              "cache_write"):
        results[k]["launch_floor_ms"] = floor
    print(f"phase 3 done at {time.perf_counter() - t0:.0f}s", flush=True)
    t4 = time.perf_counter()
    pool = CpuPool()
    print(f"phase 4: os.cpu_count() {pool.cpus}; the CPU sides in "
          f"{pool.workers} spawned workers of {pool.threads} threads each, "
          f"{CPU_STEPS} decode steps a short-context CPU run", flush=True)
    try:
        # the models whose CPU sides take longest first: the pool works
        # on them beside the later card runs
        for what, run in (
                ("Mistral", phase_teacher_forced_mistral),
                ("Llama", phase_teacher_forced),
                ("OPT-6.7B", phase_teacher_forced_opt),
                ("OPT-350m", lambda *a: phase_teacher_forced_opt(
                    *a, "facebook/opt-350m", ("bfloat16",),
                    rms_limit=LOGIT_RMS_STEPS_OPT350M))):
            run(torch, pool)
            print(f"phase 4 {what} card runs done at "
                  f"{time.perf_counter() - t0:.0f}s", flush=True)
        card_s = time.perf_counter() - t4
    finally:
        failed = pool.finish(torch)
    if failed:
        raise AssertionError(f"phase 4 past its limits against the CPU: "
                             f"{failed}")
    print(f"phase 4 done at {time.perf_counter() - t0:.0f}s: "
          f"{time.perf_counter() - t4:.1f}s wall ({card_s:.1f}s until the "
          f"card's runs were done, then the CPU workers joined)", flush=True)
    counts = dict.fromkeys(launch_counts(), 0)
    for what, serve in (
            ("Llama", phase_serve), ("CLI", phase_serve_cli),
            ("bench", phase_bench_streaming),
            ("OPT-6.7B", phase_serve_opt), ("Mistral", phase_serve_mistral),
            ("OPT-350m", lambda *a: phase_serve_opt(
                *a, name="facebook/opt-350m", caches=(("bfloat16", 40),))),
            ("OPT-2.7b", lambda *a: phase_serve_opt(
                *a, name="facebook/opt-2.7b", caches=(
                    ("bfloat16", 40), ("mxint8", 40),
                    ("mxint8-staged", 80)))),
            ("float32", phase_f32_engine)):
        run = serve(torch, rates)
        extra = {"Mistral": "mistral", "OPT-2.7b": "opt_2_7b"}.get(what)
        for k, n in run.items():
            counts[k] += n
            if extra in results.get(k, {}):
                results[k][extra]["launches"] = n
        if what == "OPT-2.7b":   # d = 80 through each cache's decode route
            idle = [k for k in ("row_write", "decode_attention_fp",
                                "decode_attention_write", "decode_attention",
                                "cache_write", "mlp_fused_relu",
                                "dequant_gemm") if run[k] <= 0]
            if idle:
                raise AssertionError(f"OPT-2.7b served without {idle}")
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 5 {what} done at {time.perf_counter() - t0:.0f}s",
              flush=True)
    print(f"phase 5 done at {time.perf_counter() - t0:.0f}s", flush=True)
    reset_launch_counts()
    for k, n in phase_pipeline(torch, rates).items():
        counts[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 6 done at {time.perf_counter() - t0:.0f}s", flush=True)
    missing = [k for k, n in counts.items() if n <= 0]
    missing += [f"{k} (Mistral)" for k, r in results.items()
                if r.get("mistral", {}).get("launches", 1) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for k in ("decode_attention", "decode_attention_streaming_staged"):
        results[k]["width4"]["launches"] = counts[f"{k}.width4"]
    for k in ("decode_attention_fp", "row_write"):
        results[k]["f32"]["launches"] = counts[f"{k}.f32"]
    kernels = []
    for k, (_, source, replaces) in KERNELS.items():
        r = results[k]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{x: r[x] for x in ("mistral", "width4", "width8", "opt_2_7b",
                                 "launch_split_ms", "quant_x",
                                 "admission_2048", "opt_scale_query",
                                 "mistral_12288", "nrep2_d64_32768",
                                 "launch_floor_ms", "slots4", "f32")
               if x in r}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
