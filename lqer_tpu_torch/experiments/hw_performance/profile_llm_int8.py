#!/usr/bin/env python
"""LLM.int8()-style outlier census feeding the hardware-area study (port
of ``experiments/hw_performance/profile_llm_int8.py``).

Calibration batches run through the unquantized model with a threshold
tap on every linear (``profiler/threshold.py``); per linear, the count of
activation columns with any ``|x| >= --threshold`` (6.0 by default), and
the high- and low-precision sub-matrix shapes derived from it, which the
cost model (``cost_model.py``) takes.

    python -m lqer_tpu_torch.experiments.hw_performance.profile_llm_int8 \\
        <config.toml> [--threshold 6.0] [--save-dir DIR] [--device cpu]

Runs on ``--device`` (``cuda`` by default; without a card it raises).
Writes ``thresholds.json`` and ``thresholds.csv`` under ``--save-dir``.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import torch

from ... import models
from ...device import resolve_device
from ...profiler import ThresholdAccumulator, batch_threshold_tap
from ...runners import _get_split, build_model_config, build_params
from ...utils import get_logger, load_config

logger = get_logger("hw_performance")


def main(argv=None) -> dict:
    """The census of the config's model over its profile split; returns
    ``ThresholdAccumulator.finalize()``."""
    ap = argparse.ArgumentParser(
        prog="lqer_tpu_torch.experiments.hw_performance.profile_llm_int8")
    ap.add_argument("config", type=str, help="pipeline toml (model + profile)")
    ap.add_argument("--threshold", type=float, default=6.0)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--num-samples", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--save-dir", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(args.config)
    cfg = build_model_config(config)
    params = build_params(config, cfg, torch.float32, device)

    acc = ThresholdAccumulator(args.threshold, args.seq_len)
    for i in range(cfg.num_hidden_layers):
        for prefix, _ in models.quantizable_module_prefixes(cfg, i):
            w = params[prefix + ".weight"]
            acc.register(prefix, w.shape[0], w.shape[1])

    profile_cfg = dict(config["profile"])
    profile_cfg["max_length"] = min(
        args.seq_len, profile_cfg.get("max_length", args.seq_len))
    train = _get_split(profile_cfg, config, "train")

    n_batches = max(1, args.num_samples // args.batch_size)
    for bi in range(n_batches):
        batch = train[bi * args.batch_size:(bi + 1) * args.batch_size]
        if len(batch) == 0:
            break
        stats = {}
        with torch.inference_mode():
            models.forward(params, torch.as_tensor(batch).to(device), cfg,
                           None, tap=batch_threshold_tap(stats,
                                                         args.threshold))
        # in key order, as JAX's jitted forward returns its stats dict
        acc.update(dict(sorted(stats.items())))
        logger.info("threshold batch %d/%d", bi + 1, n_batches)

    results = acc.finalize()
    rows = [{"name": k, **{kk: str(vv) for kk, vv in v.items()}}
            for k, v in results.items()]
    for r in rows[:5]:
        logger.info("%s", r)

    if args.save_dir:
        save = Path(args.save_dir)
        save.mkdir(parents=True, exist_ok=True)
        with open(save / "thresholds.json", "w") as f:
            json.dump(results, f, indent=2, default=str)
        keys = sorted({k for r in rows for k in r})
        with open(save / "thresholds.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        logger.info("saved to %s", save)
    return results


if __name__ == "__main__":
    main()
