"""Serving CLI (port of ``lqer_tpu/serving/cli.py``): load a (quantized,
LQER-corrected) model from a pipeline config and decode with the
continuous-batching engine.

    python -m lqer_tpu_torch.serving.cli <config.toml> --prompt "1 2 3" \
        [--max-new-tokens 16] [--slots 4] [--max-len 512] [--pallas] \
        [--scan-layers] [--cache-dtype mxint8] [--device cpu]

Prompts are token ids (``--prompt``, repeatable); with a local HF
checkpoint and tokenizer, ``--text`` instead. Each request prints one line,
``[i] tokens: [...]`` (or its decoded text), and the log reports tok/s.
``--device`` (default ``cuda``) places the engine; without ``--pallas``
every linear runs the software emulation, with it the kernel backend packs
each eligible linear (``kernel_backend.prepare_serving_params``).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from .. import models
from ..models.checkpoint import load_tensor_dict
from ..utils import get_logger, load_config
from . import DecodeEngine, Request

logger = get_logger("serve")


def main(argv=None):
    from ..runners import _get_dtype, build_model_config, build_params

    ap = argparse.ArgumentParser(prog="lqer_tpu_torch.serving.cli")
    ap.add_argument("config", type=str)
    ap.add_argument("--prompt", action="append", default=None,
                    help="space-separated token ids; repeatable for batching")
    ap.add_argument("--text", action="append", default=None,
                    help="text prompts (needs a local tokenizer)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--fp", action="store_true", help="skip quantization")
    ap.add_argument("--scan-layers", action="store_true",
                    help="the stacked step over layer-stacked weights")
    ap.add_argument("--cache-dtype", type=str, default="bfloat16",
                    choices=["bfloat16", "float32", "mxint8",
                             "mxint8-staged", "mxint4", "mxint4-staged"],
                    help="KV cache storage (mxint8 = 8.5 bits/value; "
                    "*-staged = ring-staged writes; mxint4 = 4.5 bits)")
    ap.add_argument("--lm-head-width", type=int, default=None,
                    help="pack the lm_head at this MXINT width (8); needs "
                    "--pallas")
    ap.add_argument("--pallas", action="store_true",
                    help="route linears through the W4A8 kernels")
    ap.add_argument("--trace-dir", type=str, default=None,
                    help="write a torch.profiler trace of the run there")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    config = load_config(args.config)
    dtype = _get_dtype(config.get("evaluate", {}).get("dtype"), "float32")
    cfg = build_model_config(config)
    params = build_params(config, cfg, dtype)

    qcfgs = None
    backend = None
    if not args.fp and config.get("q_config"):
        qcfgs = models.quantize_model(cfg, config["q_config"],
                                      config.get("l_config"))
        lrd_path = config.get("evaluate", {}).get("low_rank_dict")
        if lrd_path and Path(str(lrd_path)).exists():
            params = models.load_low_rank_dict(
                params, load_tensor_dict(lrd_path), dtype=dtype)
            logger.info("loaded low-rank correctors from %s", lrd_path)
        if args.pallas:
            from .kernel_backend import prepare_serving_params

            # packed from the original weights, before the PTQ step
            backend = prepare_serving_params(params, cfg, qcfgs)
        params = models.prepare_ptq(params, cfg, qcfgs)

    tokenizer = None
    if args.text:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(config["model_name"],
                                                  local_files_only=True)
        prompts = [tokenizer.encode(t) for t in args.text]
    elif args.prompt:
        prompts = [[int(t) for t in p.split()] for p in args.prompt]
    else:
        prompts = [[1, 2, 3]]

    engine = DecodeEngine(params, cfg, qcfgs, num_slots=args.slots,
                          max_len=args.max_len, cache_dtype=args.cache_dtype,
                          lm_head_width=args.lm_head_width,
                          pallas_backend=backend,
                          scan_layers=args.scan_layers, device=args.device)
    reqs = [Request(prompt_ids=p, max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature,
                    eos_token_id=getattr(tokenizer, "eos_token_id", None))
            for p in prompts]
    profiler = None
    if args.trace_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
    t0 = time.perf_counter()
    engine.run(reqs)
    if engine.device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if profiler is not None:
        profiler.__exit__(None, None, None)
        out = Path(args.trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(out / "trace.json"))
        logger.info("profiler trace written to %s", out / "trace.json")
    total = sum(len(r.output_ids) for r in reqs)
    for i, r in enumerate(reqs):
        if tokenizer:
            print(f"[{i}] {tokenizer.decode(r.output_ids)}")
        else:
            print(f"[{i}] tokens: {r.output_ids}")
    logger.info("%d tokens in %.2fs (%.1f tok/s)", total, dt, total / dt)


if __name__ == "__main__":
    main()
