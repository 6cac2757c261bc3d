"""The check's two readings on the chip, for setting a cell's limits:
runs the cell at its own size on each seed given, in one process, and
prints one JSON line per seed with the numbers the check compares for the
program and for the control (``compare.CONTROL``: the reference in the
next precision below the recipe), each judged by the cell's own limits
(``correct`` and ``control_correct``), with the run's end-to-end metrics.

    python3 -m perfbench.control --workload <name> --seconds <s> --seeds <n> [<n> ...]

Exits with 1 where the control passed every limit on some seed (the
check cannot tell it from the program) or the program failed one, after
every seed has run. The benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    run.cache_env()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    bad = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run.run_cell(args.workload, seed, args.seconds,
                           bool(args.trace), "cuda",
                           control=True, t0=t0)
        control_check, control_correct = res["_control"]
        if control_correct or not res["correct"]:
            bad.append(seed)
        for k, c in control_check.items():
            print(f"seed {seed}: check {k} = {res['check'][k]['value']}, "
                  f"control {c['value']} (limit {c['limit']})",
                  file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "control_correct": control_correct,
                          "found": res["_found"], "check": res["check"],
                          "control_check": control_check,
                          "metrics": res["metrics"],
                          "window": res["_window"],
                          "device": res["device"],
                          "breakdown": res.get("breakdown"),
                          "wall_s": time.perf_counter() - t0}), flush=True)
    if bad:
        print(f"perfbench.control: {args.workload}: the control passed, or "
              f"the program failed, on seeds {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
