#!/usr/bin/env python
"""Baseline evaluation: FP32/BF16/FP16, AWQ/GPTQ checkpoints and the
emulated LLM.int8()/int4 linears, through the same perplexity code as the
quantized pipeline (port of ``experiments/baselines.py``).

AWQ/GPTQ checkpoints are dequantized to fp on the device
(``models/quant_checkpoints.py``: weights-only quantization, so the
dequantized model computes the numbers the checkpoint's own kernels
represent) and evaluated through ``models.forward``. LLM.int8()/int4 are
bitsandbytes runtime formats with no checkpoint artifact: their rows come
from the emulation of the bitsandbytes math (vector-wise absmax int8/int4
plus fp outlier columns at ``--int8-threshold``, ``ops/llm_int8.py``) over
the fp checkpoint.

    python -m lqer_tpu_torch.experiments.baselines <config.toml> --method fp32
    python -m lqer_tpu_torch.experiments.baselines <config.toml> --method gptq \\
        --model-dir /path/to/gptq-checkpoint [--device cpu]

Runs on ``--device`` (``cuda`` by default; without a card it raises).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from .. import models
from ..device import resolve_device
from ..evaluate import evaluate_perplexity
from ..runners import _get_dtype, _get_split, build_model_config, build_params
from ..utils import get_logger, load_config

logger = get_logger("baselines")

METHOD_DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}
QUANT_METHODS = ("awq", "gptq")
# runtime bitsandbytes formats, emulated (ops/llm_int8.py): the fp
# checkpoint with dynamic outlier-decomposition int8/int4 linears
INT_METHODS = ("llm_int8", "llm_int4")
METHODS = sorted(METHOD_DTYPES) + list(QUANT_METHODS) + list(INT_METHODS)


def build_llm_int_qcfgs(cfg, method: str, threshold: float):
    """Per-layer configs routing every decoder linear through the emulated
    bitsandbytes linear; attention matmuls stay fp (bitsandbytes quantizes
    nn.Linear only)."""
    pq = {"name": "flexible",
          "x_quantizer": {"name": "passthrough"},
          "w_quantizer": {"name": "passthrough"}}
    q_config = {
        "linear": {"name": method, "threshold": threshold},
        "matmul": pq,
        "bmm": pq,
    }
    return models.quantize_model(cfg, q_config, None)


def build_dequantized_params(config, method: str, model_dir, dtype,
                             gptq_no_zero_offset: bool = False,
                             device="cuda") -> dict:
    """Load an AWQ/GPTQ checkpoint and decode its packed weights to
    ``dtype`` on ``device``."""
    from ..models.checkpoint import load_hf_pretrained, resolve_model_source
    from ..models.quant_checkpoints import dequantize_checkpoint

    src = resolve_model_source(config["model_name"],
                               model_dir or config.get("model_dir"))
    if src is None:
        raise FileNotFoundError(
            f"--method {method} needs a local quantized checkpoint; pass "
            "--model-dir or set model_dir in the config")
    logger.info("dequantizing %s checkpoint from %s", method, src)
    raw = {k: torch.as_tensor(v).to(device)
           for k, v in load_hf_pretrained(src).items()}
    fp = dequantize_checkpoint(raw, fmt=method,
                               zero_offset=not gptq_no_zero_offset)
    return {k: v.to(dtype) for k, v in fp.items()}


def main(argv=None) -> dict:
    """Evaluate one baseline; returns (and with ``--save-dir`` writes to
    ``<dataset>.json``) the perplexity results with ``"method"``."""
    ap = argparse.ArgumentParser(prog="lqer_tpu_torch.experiments.baselines")
    ap.add_argument("config", type=str)
    ap.add_argument("--method", default=None, choices=METHODS,
                    help="quantization method; defaults to the config's "
                         "evaluate.hf_quant_method, else fp32")
    ap.add_argument("--int8-threshold", type=float, default=6.0,
                    help="LLM.int8() outlier threshold (bitsandbytes "
                         "default 6.0)")
    ap.add_argument("--model-dir", type=str, default=None,
                    help="local checkpoint dir (required for awq/gptq; "
                         "the fp methods read the config's model_dir)")
    ap.add_argument("--gptq-no-zero-offset", action="store_true",
                    help="checkpoint stores zeros without the historical "
                         "AutoGPTQ -1 offset (sym/gptqmodel-v2 exports)")
    ap.add_argument("--save-dir", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(args.config)
    method = args.method
    if method is None:
        method = (config.get("evaluate", {}).get("hf_quant_method")
                  or "fp32")
        if method not in METHODS:
            raise ValueError(f"evaluate.hf_quant_method {method!r} is none "
                             f"of {METHODS}")
    dtype = _get_dtype(METHOD_DTYPES.get(method, "float32"))
    cfg = build_model_config(config)
    qcfgs = None
    if method in QUANT_METHODS:
        params = build_dequantized_params(
            config, method, args.model_dir, dtype,
            gptq_no_zero_offset=args.gptq_no_zero_offset, device=device)
    else:
        params = build_params(config, cfg, dtype, device)
        if method in INT_METHODS:
            qcfgs = build_llm_int_qcfgs(cfg, method, args.int8_threshold)

    eval_ppl_config = config["evaluate"]["perplexity"]
    test = _get_split(eval_ppl_config, config, "test")
    with torch.inference_mode():
        results = evaluate_perplexity(
            lambda ids: models.forward(params, ids, cfg, qcfgs),
            test,
            batch_size=eval_ppl_config.get("batch_size", 4),
            num_samples=eval_ppl_config.get("num_samples"),
            progress=True,
            description=f"Baseline {method} ppl",
            device=device,
        )
    results["method"] = method
    logger.info("results:\n%s", json.dumps(results, indent=4))
    if args.save_dir:
        save = Path(args.save_dir)
        save.mkdir(parents=True, exist_ok=True)
        name = eval_ppl_config["dataset"].replace("/", "_")
        with open(save / f"{name}.json", "w") as f:
            json.dump(results, f, indent=4)
    return results


if __name__ == "__main__":
    main()
