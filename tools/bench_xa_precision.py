#!/usr/bin/env python3
"""What kernel 1's and the megakernel's f64 X·A sum costs and what it buys,
in one call on the card:

    python3 tools/bench_xa_precision.py [--rows 4096] [--reps 15]

The two kernels sum X·A per K range of a block and then across the
ranges (``csrc/w4_gemm.cuh::xa_tile``, ``xa_value``), and the q_xa
quantizer rounds the f32 value. Three builds of ``csrc/dequant_gemm.cu`` and
``csrc/mlp_fused.cu`` (``-D LQER_XA_CHUNK_T`` / ``LQER_XA_SUM_T``):

  f64      -- each range's partial and the cross-range sum in f64, rounded
              to f32 once (the kernels as built for serving);
  f32+f64  -- each range's partial in f32, the sum across ranges in f64;
  f32      -- both in f32 (the kernels before the f64 sum).

1. Times, at M = 8 on raw f32 X (the serving path's in-kernel quantizer)
   at Llama-2-7B width (rank 32) and Mistral-7B's (rank 128): kernel 1 on
   q|k|v and o, and the gated megakernel; medians of ``--reps`` CUDA-event
   timings (``chip_smoke.Timer``, L2 flushed), every build in turn.
2. Counts, over ``--rows`` raw rows of q|k|v at each width (launches of 256
   rows), the rows whose output differs bit for bit from the f64 build's:
   the builds share every other instruction, so each such row holds a q_xa
   value that the f32 sum rounded the other way. Beside it, per build, the
   largest share of one row's outputs past rtol = atol = 2e-4 of the plain
   version (``dequant_gemm.qlinear_w4_plain``, X·A in f64), the measure
   that ``check_close`` caps at 1%.

Prints the card's name and power limit first and a JSON summary last.
Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BUILDS = {"f64": ("double", "double"), "f32+f64": ("float", "double"),
          "f32": ("float", "float")}
SOURCES = {"dequant_gemm": "dequant_gemm", "mlp_fused": "mlp_fused"}


def build_variants() -> dict:
    """{build: {entry: ctypes function}}, every (build, source) compiled by
    one nvcc, all at once, into the build directory."""
    from lqer_tpu_torch.ops.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (chunk_t, sum_t) in BUILDS.items():
        for entry, source in SOURCES.items():
            out = _build.BUILD_DIR / (
                f"{_build._lib_path(source).stem}-xa-{chunk_t}-{sum_t}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
                   f"-DLQER_XA_CHUNK_T={chunk_t}", f"-DLQER_XA_SUM_T={sum_t}",
                   "-I", str(_build.CSRC), "-o", str(out),
                   str(_build.CSRC / f"{source}.cu")]
            procs[name, entry] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    funcs: dict = {name: {} for name in BUILDS}
    for (name, entry), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {entry}:\n{log}")
        _, fn_name, argtypes = _build.ENTRIES[entry]
        fn = getattr(ctypes.CDLL(str(out)), fn_name)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        funcs[name][entry] = fn
    return funcs


def use(funcs: dict, name: str) -> None:
    """Route the kernel wrappers' launches to build ``name``."""
    from lqer_tpu_torch.ops.kernels import _build

    _build._FUNCS.update(funcs[name])


def layer(torch, model: str):
    """One layer's packed backend at ``model``'s width and rank."""
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.serving.random_model import build_random_model

    cfg, rank = ((LlamaConfig.llama_7b(), 32) if model == "Llama"
                 else (LlamaConfig.mistral_7b(), 128))
    cfg = dataclasses.replace(cfg, num_hidden_layers=1)
    backend, _, _ = build_random_model(cfg, rank=rank, seed=33)
    return backend, rank


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_xa_precision: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import Timer, card_line
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.kernels import mlp_fused as k5

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    funcs = build_variants()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    summary: dict = {"ms": {}, "rows_moved": {}, "worst_row_share": {}}
    for model in ("Llama", "Mistral"):
        backend, rank = layer(torch, model)
        calls = {}
        for name in ("qkv", "o"):
            key = ("model.layers.0.self_attn.qkv_proj" if name == "qkv"
                   else "model.layers.0.self_attn.o_proj")
            prep, meta = backend["arrays"][key], backend["meta"][key]
            kw = dict(quant_xa_width=meta["xa_width"],
                      quant_out_width=meta["out_width"], quant_x_width=8)
            x = torch.randn(8, prep["exps"].shape[0] * 16, generator=gen,
                            device="cuda")
            calls[f"kernel 1 {name}"] = (
                lambda x=x, p=prep, f=meta["fmt"], kw=kw:
                k1.qlinear_w4_fused(x, p, f, **kw))
        key = "model.layers.0.mlp_fused"
        prep, meta = backend["arrays"][key], backend["meta"][key]
        kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"], quant_x_width=8)
        x = torch.randn(8, prep["exps_g"].shape[0] * 16, generator=gen,
                        device="cuda")
        calls["megakernel"] = (lambda x=x, p=prep, f=meta["fmt"], kw=kw:
                               k5.mlp_w4_fused(x, p, f, **kw))
        for what, fn in calls.items():
            row = {}
            for name in BUILDS:
                use(funcs, name)
                row[name] = timer(fn, args.reps)
            summary["ms"][f"{model} {what}"] = row
            print(f"{model} (rank {rank}) {what}, M=8: " + ", ".join(
                f"{n} {ms:.4f} ms" for n, ms in row.items()), flush=True)

        key = "model.layers.0.self_attn.qkv_proj"
        prep, meta = backend["arrays"][key], backend["meta"][key]
        kw = dict(quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        K = prep["exps"].shape[0] * 16
        moved = dict.fromkeys(BUILDS, 0)
        worst = dict.fromkeys(BUILDS, 0.0)
        for _ in range(-(-args.rows // 256)):
            x = torch.randn(256, K, generator=gen, device="cuda")
            plain = k1.qlinear_w4_plain(x, prep, meta["fmt"],
                                        quant_x_width=8, **kw)
            band = 2e-4 + 2e-4 * plain.abs()
            ys = {}
            for name in BUILDS:
                use(funcs, name)
                ys[name] = k1.qlinear_w4_fused(x, prep, meta["fmt"],
                                               quant_x_width=8, **kw)
                past = ((ys[name] - plain).abs() > band).float().mean(1)
                worst[name] = max(worst[name], float(past.max()))
                moved[name] += int((ys[name] != ys["f64"]).any(1).sum())
        n = -(-args.rows // 256) * 256
        summary["rows_moved"][model] = moved
        summary["worst_row_share"][model] = worst
        print(f"{model} q|k|v (K={K}, fused rank {prep['a'].shape[1]}), "
              f"{n} rows: rows differing from the f64 build " + ", ".join(
                  f"{b} {m}" for b, m in moved.items())
              + "; largest share of one row past 2e-4 of the plain version "
              + ", ".join(f"{b} {w:.4f}" for b, w in worst.items()),
              flush=True)
        del backend
        torch.cuda.empty_cache()
    use(funcs, "f64")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
