"""Collect perplexity / harness result JSONs under a checkpoints tree into
flat CSVs (port of ``lqer_tpu/collect.py``; ``python -m lqer_tpu_torch.cli
collect-results <dir>``). It reads files only: no device."""

import argparse
import json
from pathlib import Path

from .utils import flatten_dict


def collect_perplexity(path, json_name="*.json", exclude=("harness",)):
    rows = []
    for f in sorted(Path(path).rglob(json_name)):
        if any(e in f.name for e in exclude):
            continue
        try:
            with open(f) as fh:
                result = json.load(fh)
        except json.JSONDecodeError:
            continue
        if not isinstance(result, dict) or "perplexity" not in result:
            continue
        rows.append({"run": str(f.parent), **result})
    return rows


def collect_harness(path, json_name="harness_results*.json"):
    rows = []
    for f in sorted(Path(path).rglob(json_name)):
        with open(f) as fh:
            result = json.load(fh).get("results", {})
        flat = {}
        flatten_dict(result, flat, join=":", name="")
        rows.append({"run": str(f.parent),
                     **{k.removeprefix(":"): v for k, v in flat.items()}})
    return rows


def _to_csv(rows, out):
    try:
        import pandas as pd

        df = pd.DataFrame(rows)
        df.to_csv(out, index=False)
        print(df.to_string())
    except ImportError:
        import csv

        keys = sorted({k for r in rows for k in r})
        with open(out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
    print(f"wrote {out} ({len(rows)} rows)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lqer_tpu_torch.cli collect-results")
    ap.add_argument("path", type=str)
    ap.add_argument("--out-prefix", type=str, default="collected")
    args = ap.parse_args(argv)

    ppl = collect_perplexity(args.path)
    if ppl:
        _to_csv(ppl, f"{args.out_prefix}_perplexity.csv")
    harness = collect_harness(args.path)
    if harness:
        _to_csv(harness, f"{args.out_prefix}_harness.csv")
    if not ppl and not harness:
        print("no results found under", args.path)


if __name__ == "__main__":
    main()
