#!/usr/bin/env python3
"""Where the time of rows 1 and 3 goes, on one card.

    python3 tools/bench_w4_parts.py [--m 8 256] [--models Llama OPT Mistral]

Kernel 1 (``ops/kernels/dequant_gemm.py``: q|k|v and o) and the MLP
megakernel (``ops/kernels/mlp_fused.py``, gated or OPT's relu with
biases) at one layer of Llama-2-7B (rank 32), OPT-6.7B (rank 32) and
Mistral-7B-v0.1 (rank 128) at M rows, on the serving route below 512
rows: raw f32 X quantized in the kernel (``quant_x_width = 8``). Per
launch: the median time (``chip_smoke.Timer``: CUDA events, L2 flushed),
each of its CUDA kernels' device time (torch.profiler), the bound (the
packed weights, corrections, X and the output over the card's memory
rate, or the products over its bf16 rate) and one dense bf16
``torch.matmul`` per weight (gate|up as one) on the same X as the
library yardstick. Where ``csrc/mlp_fused.cu`` has the ``LQER_PHASE_CLOCK``
hook, a ``-D LQER_PHASE_CLOCK`` build of it gives the megakernel's phase
times from ``%globaltimer`` at its grid barriers (``phases_us``; one
launch after a warm-up). A kernel that runs an X·A phase beside the GEMM
phase after it, as the tensor-core megakernel does, has no barrier
between them: its ``gate/up`` and ``down`` include X·A_gu and H·A_d.

With ``--sass`` it first counts, per kernel function of the built
``dequant_gemm`` and ``mlp_fused`` libraries, the ``HMMA`` (tensor-core)
and ``FFMA`` instructions ``cuobjdump -sass`` shows.

One JSON line per (model, M, launch), the card's name and power limit
first. Needs one CUDA device and nvcc. Copied with ``chip_smoke.py`` into
another checkout (``git archive`` unpacked under ``build/``), it times that
checkout's kernels: run parent, change, change, parent in one call to
compare them.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("quantize X", "X·A partials", "X·A finish", "gate/up",
          "H·A partials", "H·A finish", "down")


def _backend(model: str):
    from lqer_tpu_torch.models import LlamaConfig
    from lqer_tpu_torch.models.opt import MODEL_CONFIGS
    from lqer_tpu_torch.serving.random_model import build_random_model

    if model == "OPT":
        cfg, rank, p0 = (MODEL_CONFIGS["facebook/opt-6.7b"](), 32,
                         "model.decoder.layers.0")
    else:
        cfg, rank = ((LlamaConfig.llama_7b(), 32) if model == "Llama"
                     else (LlamaConfig.mistral_7b(), 128))
        p0 = "model.layers.0"
    cfg = dataclasses.replace(cfg, num_hidden_layers=1)
    backend, _, _ = build_random_model(cfg, rank=rank, seed=41)
    o = "out_proj" if model == "OPT" else "o_proj"
    return backend, p0, o


def _phase_clock_lib():
    """The ``-D LQER_PHASE_CLOCK`` build of the megakernel's source, or
    None where the source has no such hook."""
    from lqer_tpu_torch.ops.kernels import _build

    src = _build.CSRC / "mlp_fused.cu"
    if "LQER_PHASE_CLOCK" not in src.read_text():
        return None
    out = _build.BUILD_DIR / f"{_build._lib_path('mlp_fused').stem}-clock.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DLQER_PHASE_CLOCK", "-I",
           str(_build.CSRC), "-o", str(out), str(src)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(out))


def _phases(lib, launch) -> dict:
    """Phase times (us) of one megakernel launch through ``lib``."""
    from lqer_tpu_torch.ops.kernels import _build

    _, fn_name, argtypes = _build.ENTRIES["mlp_fused"]
    fn = getattr(lib, fn_name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    read = lib.lqer_mlp_phase_clock
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    clocks = (ctypes.c_ulonglong * 8)()
    saved = _build._FUNCS.get("mlp_fused")
    _build._FUNCS["mlp_fused"] = fn
    try:
        launch()
        read(clocks)   # the warm-up's, then zeroed
        launch()
        if read(clocks):
            raise RuntimeError("lqer_mlp_phase_clock failed")
    finally:
        if saved is None:
            _build._FUNCS.pop("mlp_fused")
        else:
            _build._FUNCS["mlp_fused"] = saved
    t = list(clocks)
    out, last = {}, t[0]
    for name, v in zip(PHASES, t[1:7] + [t[7]]):
        if v:
            out[name] = round((v - last) / 1e3, 3)
            last = v
    out["total"] = round((t[7] - t[0]) / 1e3, 3)
    return out


def _sass_counts() -> dict:
    """{library: {kernel function: {"HMMA": n, "FFMA": n}}} of the built
    kernel 1 and megakernel libraries (cuobjdump from the CUDA toolkit)."""
    import re
    import shutil

    from lqer_tpu_torch.ops.kernels import _build

    _build.build_all(("dequant_gemm", "mlp_fused"))
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).with_name("cuobjdump"))
    out = {}
    for name in ("dequant_gemm", "mlp_fused"):
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs = {}
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            fn = part.split("\n", 1)[0].strip()
            kernel = re.search(r"(gemm_kernel|xa_kernel|mlp_kernel)[^P]*", fn)
            key = kernel.group(0) if kernel else fn[:60]
            funcs[key] = {op: len(re.findall(rf"\b{op}\b", part))
                          for op in ("HMMA", "FFMA")}
        out[name] = funcs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[8, 256])
    ap.add_argument("--models", nargs="+", default=["Llama", "OPT", "Mistral"],
                    choices=["Llama", "OPT", "Mistral"])
    ap.add_argument("--sass", action="store_true",
                    help="count HMMA and FFMA per kernel function first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_w4_parts: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import Timer, card_line, launch_split, nbytes, peak_rates
    from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
    from lqer_tpu_torch.ops.kernels import mlp_fused as k5
    from lqer_tpu_torch.ops.storage import dequantize_packed

    print(f"card: {card_line()}", flush=True)
    if args.sass:
        print(json.dumps({"sass": _sass_counts()}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    bw, ops_rate = peak_rates(torch.cuda.get_device_name(0))
    timer = Timer(torch)
    clock_lib = _phase_clock_lib()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def bound(nb, ops):
        return max(nb / bw, ops / ops_rate) * 1e3

    def dense(codes, exps, fmt):
        return dequantize_packed(codes, exps, fmt).to(torch.bfloat16)

    for model in args.models:
        backend, p0, o = _backend(model)
        for M in args.m:
            x = torch.randn(M, 4096, generator=gen, device="cuda")
            xb = x.to(torch.bfloat16)
            for name in ("qkv_proj", o):
                key = f"{p0}.self_attn.{name}"
                prep, meta = backend["arrays"][key], backend["meta"][key]
                fmt = meta["fmt"]
                kw = dict(quant_xa_width=meta["xa_width"],
                          quant_out_width=meta["out_width"], quant_x_width=8)
                N, R = prep["codes"].shape[1], prep["a"].shape[1]
                w = dense(prep["codes"], prep["exps"], fmt)
                run = lambda: k1.qlinear_w4_fused(x, prep, fmt, **kw)
                line = {"model": model, "row": 1, "launch": name, "M": M,
                        "N": N, "R": R}
                try:
                    line.update(
                        ms=timer(run),
                        library_ms=timer(lambda: torch.matmul(xb, w)),
                        bound_ms=bound(
                            nbytes(x, prep["codes"], prep["exps"], prep["a"],
                                   prep["b"], prep["bias"]) + M * N * 4,
                            2 * M * N * 4096 + 2 * M * R * (4096 + N)),
                        kernels_ms=launch_split(torch, run))
                except ValueError as e:   # a shape this checkout refuses
                    line["refused"] = str(e)
                print(json.dumps(line), flush=True)
                del w
            key = f"{p0}.mlp_fused"
            prep, meta = backend["arrays"][key], backend["meta"][key]
            fmt = meta["fmt"]
            kw = dict(act_width=meta["act_width"],
                      quant_xa_width=meta["xa_width"],
                      quant_out_width=meta["out_width"], quant_x_width=8)
            gated = prep.get("codes_u") is not None
            I, N = prep["codes_g"].shape[1], prep["codes_d"].shape[1]
            R = prep["a_d"].shape[1]
            halves = ("g", "u") if gated else ("g",)
            w_gu = torch.cat([dense(prep[f"codes_{h}"], prep[f"exps_{h}"],
                                    fmt) for h in halves], 1)
            w_d = dense(prep["codes_d"], prep["exps_d"], fmt)
            h = torch.zeros(M, I, dtype=torch.bfloat16, device="cuda")
            run = lambda: k5.mlp_w4_fused(x, prep, fmt, **kw)
            n_w = len(halves) + 1
            line = {"model": model, "row": 3, "launch": "mlp", "M": M,
                    "I": I, "R": R, "ms": timer(run),
                    "library_ms": timer(lambda: torch.matmul(xb, w_gu))
                    + timer(lambda: torch.matmul(h, w_d)),
                    "bound_ms": bound(
                        nbytes(*(prep[k] for k in prep)) + nbytes(x)
                        + M * N * 4,
                        2 * M * (n_w * 4096 * I)
                        + 2 * M * R * (len(halves) * (4096 + I) + I + N)),
                    "kernels_ms": launch_split(torch, run)}
            if clock_lib is not None:
                line["phases_us"] = _phases(clock_lib, run)
            print(json.dumps(line), flush=True)
            del w_gu, w_d, h
        del backend
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
