#!/usr/bin/env python
"""Print the sharding plan for a model over an N-device mesh (port of
``experiments/infer_sharding_plan.py``).

Sharding is derived from rules (``parallel/sharding.py``), so this tool
reports, for capacity planning: each param's shape and spec (per
dimension ``'tp'`` or None, the port's notation for JAX's
``PartitionSpec``), its bytes per device, and the total per device.

    python -m lqer_tpu_torch.experiments.infer_sharding_plan meta-llama/Llama-2-7b-hf --devices 8

The shapes come from a one-layer model on the ``meta`` device: nothing is
allocated or drawn, so the plan needs no ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from .. import models
from ..parallel.mesh import mesh_shape_for
from ..parallel.sharding import spec_for_param

QUANT_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "out_proj",
                 "gate_proj", "up_proj", "down_proj", "fc1", "fc2")


def plan_rows(cfg, tp: int, bits: float) -> tuple[list, float]:
    """``([(name, shape, spec, bytes per device)], total bytes per
    device)``: layer 0 and the rest of a one-layer model, each layer's
    params counted ``num_hidden_layers`` times in the total."""
    params = models.init_params(
        dataclasses.replace(cfg, num_hidden_layers=1), torch.Generator(),
        torch.bfloat16, device="meta")
    rows, total = [], 0.0
    for name, t in sorted(params.items()):
        spec = spec_for_param(name)
        shard_factor = tp if "tp" in spec else 1
        is_quant_linear = name.endswith(tuple(p + ".weight"
                                              for p in QUANT_LINEARS))
        bytes_per_el = bits / 8 if is_quant_linear else 2.0  # bf16 rest
        per_dev = t.numel() * bytes_per_el / shard_factor
        total += per_dev * (cfg.num_hidden_layers if "layers." in name
                            else 1)
        rows.append((name, tuple(t.shape), spec, per_dev))
    return rows, total


def main(argv=None) -> tuple[list, float]:
    """Print the plan; returns :func:`plan_rows`' rows and total."""
    ap = argparse.ArgumentParser(prog="lqer_tpu_torch.experiments."
                                      "infer_sharding_plan")
    ap.add_argument("model_name", type=str)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--bits", type=float, default=4.5,
                    help="effective bits/weight for quantized linears "
                         "(4-bit codes + 8-bit exponent per 16-group = 4.5)")
    ap.add_argument("--rank", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = models.get_model_config(args.model_name)
    dp, tp = mesh_shape_for(args.devices, args.tp)
    print(f"model={args.model_name} mesh=(dp={dp}, tp={tp})")
    rows, total = plan_rows(cfg, tp, args.bits)
    for name, shape, spec, per_dev in rows:
        mb = f"{per_dev / 1e6:.2f}MB"
        print(f"  {name:<60} {str(shape):<20} {str(spec):<24} {mb}/dev")
    print(f"\nestimated param bytes per device: {total / 1e9:.2f} GB "
          f"(x{cfg.num_hidden_layers} layers, W{args.bits}-bit linears, "
          f"rank-{args.rank} correctors not included)")
    return rows, total


if __name__ == "__main__":
    main()
