#!/usr/bin/env python
"""One-command reproduction of the BASELINE.md quality table (port of
``experiments/reproduce_baseline.py``).

With checkpoints and the dataset at hand this runs, per model row, the
4-stage pipeline (profile → approximate → perplexity → harness) of the
translated reference template with the published overrides, each as
``python -m lqer_tpu_torch.cli pipeline`` on ``--device``, then scores the
measured wikitext2 perplexity against BASELINE.md's published value with
the 0.1-ppl acceptance.

``--plan`` prints the run matrix (templates, published numbers,
acceptance thresholds) and checks that every template, with the published
overrides, carries the documented W4A8 rank-32 setup. ``--check DIR``
scores result JSONs already under ``DIR``. Both read files only.

    python -m lqer_tpu_torch.experiments.reproduce_baseline --plan
    python -m lqer_tpu_torch.experiments.reproduce_baseline --models llama-7b [--device cpu] [-- --a:b=v ...]
    python -m lqer_tpu_torch.experiments.reproduce_baseline --check checkpoints/baseline_repro

A run launches pipelines on ``--device`` (``cuda`` by default; without a
card it raises before it launches anything).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from ..device import resolve_device
from ..utils import load_config, override_args

ROOT = Path(__file__).resolve().parents[2]
TEMPLATES = ROOT / "experiments" / "configs" / "template"

# (template, fp16 ppl, l2qer W4A8 ppl, W/X block) — BASELINE.md
# "Wikitext2 perplexity"; block 32 rows are marked so there, everything
# else is block 16.
ROWS = {
    "llama-7b": ("llama-7b.toml", 5.67108, 5.89474, 16),
    "llama-13b": ("llama-13b.toml", 5.10043, 5.21430, 16),
    "llama-2-7b": ("llama-2-7b.toml", 5.47892, 5.68963, 16),
    "llama-2-13b": ("llama-2-13b.toml", 4.89806, 5.01783, 16),
    "vicuna-7b-v1.5": ("vicuna-7b-v1.5.toml", 6.78452, 7.01455, 16),
    "vicuna-13b-v1.5": ("vicuna-13b-v1.5.toml", 5.92077, 6.04087, 16),
    "mistral-7b": ("mistral-7b.toml", 6.47004, 6.70544, 16),
    "opt-125m": ("opt-125m.toml", 27.65, 29.8207, 32),
    "opt-1.3b": ("opt-1.3b.toml", 14.63, 15.0160, 32),
    "opt-2.7b": ("opt-2.7b.toml", 12.47, 12.7350, 32),
    "opt-6.7b": ("opt-6.7b.toml", 10.86, 11.0039, 16),
    "opt-13b": ("opt-13b.toml", 10.13, 10.2685, 16),
    "opt-30b": ("opt-30b.toml", 9.56, 9.66998, 16),
}
ACCEPTANCE_PPL = 0.1  # BASELINE.md: within 0.1 wikitext2 ppl of the ref
RANK = 32  # BASELINE.md header: L²QER = lqer-act, W4A8 MXINT, rank 32


def _published_overrides(block: int) -> list[str]:
    """CLI overrides turning a faithful reference template into the
    published run configuration. The reference templates carry sweep
    leftovers (OPT: W2A4 ablation widths; rank 1/128); its published
    numbers come from its sweep scripts' overrides, which also keep
    w_quantizer ≡ approximator.W_quantizer and l_config.rank ≡
    approximator.rank, as these do."""
    o = []
    for tgt in ("q_config:linear:w_quantizer",
                "approximate:approximator:default:W_quantizer"):
        o += [f"--{tgt}:name=block_fp", f"--{tgt}:width=4",
              f"--{tgt}:block_size=:ast:[1, {block}]"]
    o += ["--q_config:linear:x_quantizer:width=8",
          f"--q_config:linear:x_quantizer:block_size=:ast:[1, {block}]"]
    o += [f"--l_config:linear:rank={RANK}",
          f"--approximate:approximator:default:rank={RANK}",
          "--approximate:name=lqer-act"]
    return o


def _expected_setup(cfg: dict, block: int) -> list[str]:
    """What keeps template + published overrides from the documented
    L²QER W4A8 rank-32 setup (BASELINE.md header); empty when nothing."""
    problems = []
    lin = cfg.get("q_config", {}).get("linear", {})
    wq = lin.get("w_quantizer", {})
    xq = lin.get("x_quantizer", {})
    if wq.get("width") != 4:
        problems.append(f"w width {wq.get('width')} != 4")
    if xq.get("width") != 8:
        problems.append(f"x width {xq.get('width')} != 8")
    if list(wq.get("block_size", ())) != [1, block]:
        problems.append(f"w block {wq.get('block_size')} != [1, {block}]")
    rank = cfg.get("l_config", {}).get("linear", {}).get("rank")
    if rank != RANK:
        problems.append(f"rank {rank} != {RANK}")
    app = cfg.get("approximate", {})
    if app.get("name") != "lqer-act":
        problems.append(f"approximator {app.get('name')}")
    app_d = app.get("approximator", {}).get("default", {}) or {}
    if rank != app_d.get("rank"):
        problems.append(f"rank invariant broken: {rank} != {app_d.get('rank')}")
    if app_d.get("W_quantizer", {}).get("width") != wq.get("width"):
        problems.append("W_quantizer invariant broken")
    return problems


def plan(models: list[str]) -> int:
    """Print and check the run matrix; 1 if a template is missing or off
    the documented setup."""
    ok = True
    print(f"{'model':<16} {'template':<22} {'FP16':>8} {'L2QER':>8} "
          f"{'accept ≤':>9}  setup (template + published overrides)")
    for name in models:
        tmpl, fp, lq, block = ROWS[name]
        path = TEMPLATES / tmpl
        if not path.exists():
            print(f"{name:<16} {tmpl:<22} MISSING TEMPLATE")
            ok = False
            continue
        cfg = load_config(path)
        override_args(cfg, _published_overrides(block))
        problems = _expected_setup(cfg, block)
        status = "ok" if not problems else "; ".join(problems)
        if problems:
            ok = False
        print(f"{name:<16} {tmpl:<22} {fp:>8.4f} {lq:>8.4f} "
              f"{lq + ACCEPTANCE_PPL:>9.4f}  {status}")
    base_dir = TEMPLATES.parent / "baseline"
    have = sorted(p.stem for p in base_dir.glob("*.toml"))
    print(f"\nBaseline-eval configs (reference configs/baseline/ rows): "
          f"{len(have)} present in {base_dir}")
    print("Run matrix per model: "
          "[1] python -m lqer_tpu_torch.experiments.baselines "
          "experiments/configs/baseline/<model>.toml --method fp16 (FP row),"
          " or with the config's own method (the reference's quantized-"
          "baseline rows: AWQ/GPTQ/LLM.int8/int4)  "
          "[2] python -m lqer_tpu_torch.cli pipeline <template> <published "
          "overrides> (profile→approximate→ppl→harness)")
    print("Artifacts: <out-dir>/<model>/evaluate_perplexity/wikitext2.json, "
          "<out-dir>/<model>/evaluate_harness_downstream/"
          "harness_results.json")
    return 0 if ok else 1


def run(models: list[str], out_dir: Path, extra: list[str],
        device: str = "cuda") -> int:
    """The pipeline of each row in a subprocess on ``device``, its
    artifacts under ``out_dir/<model>``; then :func:`check`.

    The JAX script passes ``--project_dir``, a key no runner reads, so its
    artifacts land in the template's ``checkpoint_path`` and its check
    finds none under ``out_dir``; ``--checkpoint_path`` puts them there."""
    resolve_device(device)
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    rc = 0
    for name in models:
        tmpl, _, _, block = ROWS[name]
        cmd = [
            sys.executable, "-m", "lqer_tpu_torch.cli", "pipeline",
            str(TEMPLATES / tmpl),
            f"--checkpoint_path={out_dir / name}",
            "--overwrite_checkpoint=true",
            *_published_overrides(block),
            *extra,
            "--device", device,
        ]
        print("+", " ".join(cmd), flush=True)
        r = subprocess.run(cmd, cwd=ROOT)
        if r.returncode:
            print(f"[reproduce] {name} FAILED rc={r.returncode}")
            rc = 1
    return rc or check(out_dir, models)


def check(results_dir: Path, models: list[str]) -> int:
    """Score the newest ``wikitext2.json`` of each row under
    ``results_dir`` (a path naming the row) against BASELINE.md; 1 unless
    every row passes."""
    rows, rc = [], 0
    for name in models:
        _, _, lq_ref, _ = ROWS[name]
        hits = sorted(Path(results_dir).rglob("wikitext2.json"))
        hits = [h for h in hits if name in str(h)]
        if not hits:
            rows.append((name, None, lq_ref, "NO RESULT"))
            rc = 1
            continue
        with open(hits[-1]) as f:
            got = json.load(f).get("perplexity")
        passed = got is not None and abs(got - lq_ref) <= ACCEPTANCE_PPL
        rows.append((name, got, lq_ref, "PASS" if passed else "FAIL"))
        rc |= 0 if passed else 1
    print(f"{'model':<16} {'measured':>9} {'reference':>9}  verdict")
    for name, got, ref, verdict in rows:
        g = f"{got:.4f}" if got is not None else "-"
        print(f"{name:<16} {g:>9} {ref:>9.4f}  {verdict}")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lqer_tpu_torch.experiments."
                                      "reproduce_baseline")
    ap.add_argument("--models", nargs="+", default=sorted(ROWS),
                    choices=sorted(ROWS))
    ap.add_argument("--plan", action="store_true",
                    help="print and check the run matrix, run nothing")
    ap.add_argument("--check", type=Path, default=None,
                    help="re-score existing result JSONs under this dir")
    ap.add_argument("--out-dir", type=Path,
                    default=ROOT / "checkpoints" / "baseline_repro")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("extra", nargs="*",
                    help="extra --a:b:c=v overrides passed to the pipeline")
    args = ap.parse_args(argv)
    if args.plan:
        return plan(args.models)
    if args.check is not None:
        return check(args.check, args.models)
    return run(args.models, args.out_dir, args.extra, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
