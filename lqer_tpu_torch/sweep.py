"""Sweep runner (port of ``lqer_tpu/sweep.py``): the pipeline over the
cartesian product of rank × W-bits × A-bits × block sizes, each point a
``run_pipeline`` with its config overrides, on ``--device``.

Each point's overrides keep the configs' invariants: the evaluation's
quantizers equal the approximator's, and ``l_config.rank`` equals the
approximator's rank. ``--dry-run`` prints each point's command line
instead of running it.
"""

import argparse
import itertools
import sys
from pathlib import Path

from .runners import run_pipeline
from .utils import get_logger

logger = get_logger("sweep")


def build_overrides(method, rank, w_bits, x_bits, w_block, x_block,
                    save_dir, num_profile_samples):
    """The override set of one sweep point, as the JAX package builds it."""
    approx_name = "lqer-act" if method.startswith("lqer-act") else method
    ov = [
        "--project=lqer-sweep",
        f"--checkpoint_path={save_dir}",
        f"--profile:num_samples={num_profile_samples}",
        f"--approximate:name={approx_name}",
        # invariant: approximator quantizers ≡ eval quantizers
        f"--approximate:approximator:default:rank={rank}",
        f"--approximate:approximator:default:W_quantizer:width={w_bits}",
        f"--approximate:approximator:default:W_quantizer:block_size=:ast:{w_block}",
        f"--approximate:approximator:default:A_quantizer:width={x_bits}",
        f"--approximate:approximator:default:A_quantizer:block_size=:ast:{x_block}",
        f"--approximate:approximator:default:B_quantizer:width={x_bits}",
        f"--approximate:approximator:default:B_quantizer:block_size=:ast:{x_block}",
        f"--l_config:linear:rank={rank}",
        f"--q_config:linear:w_quantizer:width={w_bits}",
        f"--q_config:linear:w_quantizer:block_size=:ast:{w_block}",
        f"--q_config:linear:x_quantizer:width={x_bits}",
        f"--q_config:linear:x_quantizer:block_size=:ast:{x_block}",
        f"--q_config:linear:b_quantizer:width={x_bits}",
        f"--q_config:linear:b_quantizer:block_size=:ast:{x_block}",
        f"--q_config:bmm:w_quantizer:width={x_bits}",
        f"--q_config:bmm:w_quantizer:block_size=:ast:{x_block}",
        f"--q_config:bmm:x_quantizer:width={x_bits}",
        f"--q_config:bmm:x_quantizer:block_size=:ast:{x_block}",
        f"--q_config:matmul:w_quantizer:width={x_bits}",
        f"--q_config:matmul:w_quantizer:block_size=:ast:{x_block}",
        f"--q_config:matmul:x_quantizer:width={x_bits}",
        f"--q_config:matmul:x_quantizer:block_size=:ast:{x_block}",
    ]
    if method == "no-lqer":
        # the WxAy baseline without A and B: disable_lqer
        ov = [o for o in ov if "approximate:name" not in o]
        ov += [
            "--approximate:name=lqer-svd",
            "--evaluate:disable_lqer=:ast:True",
        ]
    elif method in ("lqer-act-int", "lqer-act-w-only"):
        # the INT and W-only (W4A16) variants: activations, A_out, B_out,
        # bmm and matmul all passthrough, only the weight quantizer (and
        # for -int its whole-row [1,-1] blocking) is active
        drop = ("A_quantizer", "B_quantizer", "x_quantizer", "b_quantizer",
                "bmm", "matmul")
        ov = [o for o in ov if not any(d in o for d in drop)]
        ov += [
            "--approximate:approximator:default:A_quantizer:name=passthrough",
            "--approximate:approximator:default:B_quantizer:name=passthrough",
            "--q_config:linear:x_quantizer:name=passthrough",
            "--q_config:linear:b_quantizer:name=passthrough",
            "--q_config:bmm:w_quantizer:name=passthrough",
            "--q_config:bmm:x_quantizer:name=passthrough",
            "--q_config:matmul:w_quantizer:name=passthrough",
            "--q_config:matmul:x_quantizer:name=passthrough",
        ]
    return ov


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lqer_tpu_torch.cli sweep")
    ap.add_argument("template", type=str)
    ap.add_argument("--method", default="lqer-act",
                    choices=["lqer-act", "lqer-svd", "no-lqer",
                             "lqer-act-int", "lqer-act-w-only"])
    ap.add_argument("--ranks", type=int, nargs="+", default=[32])
    ap.add_argument("--w-bits", type=int, nargs="+", default=[4])
    ap.add_argument("--x-bits", type=int, nargs="+", default=[8])
    ap.add_argument("--w-blocks", type=str, nargs="+", default=["[1,16]"])
    ap.add_argument("--x-blocks", type=str, nargs="+", default=["[1,16]"])
    ap.add_argument("--num-profile-samples", type=int, default=32)
    ap.add_argument("--save-root", type=str, default="checkpoints/sweeps")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    grid = list(itertools.product(
        args.ranks, args.w_bits, args.x_bits, args.w_blocks, args.x_blocks))
    logger.info("sweep: %d points", len(grid))
    failures = []
    for rank, wb, xb, wblk, xblk in grid:
        tag = (f"{args.method}_W{wb}A{xb}_rank{rank}"
               f"_WB{wblk.replace(',', '-')}_XB{xblk.replace(',', '-')}")
        save_dir = Path(args.save_root) / tag
        ov = build_overrides(args.method, rank, wb, xb, wblk, xblk,
                             save_dir, args.num_profile_samples)
        argv = [args.template, tag, "--overwrite_checkpoint=:ast:True"] + ov
        logger.info("=== %s ===", tag)
        if args.dry_run:
            print(" \\\n  ".join(["python -m lqer_tpu_torch.cli pipeline"]
                                  + argv + [f"--device={args.device}"]))
            continue
        try:
            run_pipeline(argv, device=args.device)
        except Exception as e:  # keep sweeping, report at the end
            logger.error("sweep point %s failed: %s", tag, e)
            failures.append((tag, str(e)))
    if failures:
        logger.error("%d/%d sweep points failed: %s",
                     len(failures), len(grid), [t for t, _ in failures])
        sys.exit(1)


if __name__ == "__main__":
    main()
