"""The port's other experiment entry points against the JAX scripts:

- ``hw_performance/cost_model.py``: ``headline_table()`` equal to JAX's;
- ``infer_sharding_plan.py``: for ``meta-llama/Llama-2-7b-hf`` at 8
  devices, every printed row (name, shape, the dimension sharded over tp,
  MB per device) and the total equal to JAX's (JAX's script builds a
  one-layer model at full width; here its ``init_params`` gives shapes only,
  through ``jax.eval_shape``; the port reads them on the ``meta`` device);
- ``hw_performance/profile_llm_int8.py``: ``thresholds.json`` equal to
  JAX's on a seeded checkpoint of a tiny Llama, at a threshold where
  the census counts outlier columns;
- ``reproduce_baseline.py``: ``--plan``'s table rows equal to JAX's;
  ``check`` over a written results tree (PASS, FAIL and NO RESULT rows and
  the return code); the JAX script's ``check``, which unpacks the rows'
  four fields into three names, raises ``ValueError`` (a fault of the
  reference, pinned); ``run`` of one row pointed at
  ``experiments/configs/debug/opt-tiny.toml`` on the CPU;
- every entry point that runs on a device raises without a card by
  default, and no module of ``lqer_tpu_torch/experiments/`` imports JAX,
  ``lqer_tpu`` or the top-level ``experiments`` package.
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.experiments import baselines as tb
from lqer_tpu_torch.experiments import infer_sharding_plan as tplan
from lqer_tpu_torch.experiments import kv_cache_quality as tkv
from lqer_tpu_torch.experiments import lm_head_quality as tlm
from lqer_tpu_torch.experiments import reproduce_baseline as trb
from lqer_tpu_torch.experiments.hw_performance import cost_model as tcost
from lqer_tpu_torch.experiments.hw_performance import profile_llm_int8 as tpl
from lqer_tpu_torch.runners import build_model_config
from lqer_tpu_torch.testing import one_torch_thread_fixture
from lqer_tpu_torch.utils import save_config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from experiments import infer_sharding_plan as jplan  # noqa: E402
from experiments import reproduce_baseline as jrb  # noqa: E402
from experiments.hw_performance import cost_model as jcost  # noqa: E402
from experiments.hw_performance import profile_llm_int8 as jpl  # noqa: E402

_one_torch_thread = one_torch_thread_fixture()


def test_cost_model_headline_table_equals_jax():
    assert tcost.headline_table() == jcost.headline_table()
    kw = dict(hidden_in=5120, hidden_out=13824, rank=64, num_hp_cols=120)
    assert tcost.headline_table(**kw) == jcost.headline_table(**kw)


_ROW = re.compile(r"^  (\S+)\s+(\(.*?\))\s+(.*\S)\s+(\S+MB)/dev$")


def _plan_rows(text: str) -> tuple[list, str]:
    """(rows of (name, shape, the dimension sharded over tp or None, MB),
    the total line) of a printed plan; JAX's specs print as
    ``PartitionSpec(...)``, the port's as tuples."""
    rows = []
    for line in text.splitlines():
        m = _ROW.match(line)
        if m:
            name, shape, spec, mb = m.groups()
            spec = ast.literal_eval(spec.removeprefix("PartitionSpec"))
            spec = spec if isinstance(spec, tuple) else (spec,)
            axis = spec.index("tp") if "tp" in spec else None
            rows.append((name, ast.literal_eval(shape), axis, mb))
    total = [ln for ln in text.splitlines() if "per device" in ln]
    return rows, total[0]


def test_sharding_plan_equals_jax(monkeypatch, capsys):
    init = jmodels.init_params
    monkeypatch.setattr(jmodels, "init_params",
                        lambda cfg, key: jax.eval_shape(
                            lambda k: init(cfg, k), key))
    args = ["meta-llama/Llama-2-7b-hf", "--devices", "8"]
    monkeypatch.setattr(sys, "argv", ["infer_sharding_plan.py", *args])
    jplan.main()
    want = capsys.readouterr().out
    rows, total = tplan.main(args)
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0] == (
        "model=meta-llama/Llama-2-7b-hf mesh=(dp=1, tp=8)")
    assert _plan_rows(got) == _plan_rows(want)
    assert len(rows) == 12 and "0.52 GB" in _plan_rows(got)[1]
    sharded = {r[0]: r[2] for r in _plan_rows(got)[0]}
    assert sharded["model.layers.0.self_attn.q_proj.weight"] == 0
    assert sharded["model.layers.0.mlp.down_proj.weight"] == 1
    assert sharded["model.norm.weight"] is None


def _tiny_checkpoint(tmp_path: Path) -> str:
    """A config whose ``model_dir`` holds a tiny Llama drawn with numpy
    (normal at 0.02, norms one), with a synthetic profile split."""
    from safetensors.numpy import save_file

    model = dict(arch="llama", vocab_size=256, hidden_size=64,
                 intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64)
    shapes = tmodels.init_params(build_model_config({"model": model}),
                                 torch.Generator(), device="meta")
    rng = np.random.RandomState(1)
    weights = {k: (np.ones(t.shape, np.float32) if k.endswith("norm.weight")
                   else (rng.randn(*t.shape) * 0.02).astype(np.float32))
               for k, t in shapes.items()}
    (tmp_path / "ckpt").mkdir()
    save_file(weights, str(tmp_path / "ckpt" / "model.safetensors"))
    config = {"model_name": "test/llama-tiny", "model": model,
              "model_dir": str(tmp_path / "ckpt"),
              "profile": {"dataset": "synthetic", "max_length": 32,
                          "synthetic": {"vocab_size": 256, "num_train": 6,
                                        "num_test": 0, "seed": 2}}}
    save_config(config, tmp_path / "census.toml")
    return str(tmp_path / "census.toml")


def test_profile_llm_int8_equals_jax(tmp_path, monkeypatch):
    path = _tiny_checkpoint(tmp_path)
    args = [path, "--threshold", "2.5", "--seq-len", "32",
            "--num-samples", "6", "--batch-size", "2"]
    monkeypatch.setattr(sys, "argv", ["profile_llm_int8.py", *args,
                                      "--save-dir", str(tmp_path / "jax")])
    jpl.main()
    got = tpl.main([*args, "--save-dir", str(tmp_path / "port"),
                    "--device", "cpu"])
    with open(tmp_path / "jax" / "thresholds.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "thresholds.json") as f:
        assert json.load(f) == want
    assert (tmp_path / "jax" / "thresholds.csv").read_text() == (
        tmp_path / "port" / "thresholds.csv").read_text()
    assert len(got) == 15                 # 14 linears and the head
    counts = {k: v["num_activation_columns_in_high_precision"]
              for k, v in got.items()}
    assert counts["model.layers.0.self_attn.q_proj.threshold"] > 0
    assert min(counts.values()) == 0      # the attention output: none


def _table(text: str) -> list[str]:
    """The plan's table rows: the header and one line per model."""
    return text.split("\n\n")[0].splitlines()


def test_plan_rows_equal_jax(capsys):
    assert jrb.plan(sorted(jrb.ROWS)) == 0
    want = capsys.readouterr().out
    assert trb.main(["--plan"]) == 0
    got = capsys.readouterr().out
    assert _table(got) == _table(want)
    assert len(_table(got)) == 1 + len(trb.ROWS)
    assert "python -m lqer_tpu_torch.cli pipeline" in got


def _results_tree(root: Path) -> Path:
    """llama-7b within 0.1 of its published 5.89474, opt-125m outside it,
    mistral-7b without a result; an older run of llama-7b elsewhere."""
    for name, ppl in (("llama-7b", 5.95), ("opt-125m", 30.1)):
        d = root / name / "evaluate_perplexity"
        d.mkdir(parents=True)
        (d / "wikitext2.json").write_text(json.dumps({"perplexity": ppl}))
    return root


def test_check_scores_a_results_tree(tmp_path, capsys):
    root = _results_tree(tmp_path / "results")
    assert trb.main(["--check", str(root), "--models", "llama-7b"]) == 0
    assert trb.check(root, ["llama-7b", "opt-125m", "mistral-7b"]) == 1
    lines = capsys.readouterr().out.splitlines()
    verdicts = {ln.split()[0]: ln.split()[-1] for ln in lines[1:]
                if ln.split()[0] in trb.ROWS}
    assert verdicts == {"llama-7b": "PASS", "opt-125m": "FAIL",
                        "mistral-7b": "RESULT"}
    assert any(ln.startswith("mistral-7b") and "NO RESULT" in ln
               for ln in lines)
    assert trb.check(root, ["opt-125m"]) == 1


def test_jax_check_raises(tmp_path):
    """The reference fault: ``check`` unpacks ``ROWS[name]`` (four fields)
    into three names."""
    root = _results_tree(tmp_path / "results")
    assert all(len(row) == 4 for row in jrb.ROWS.values())
    with pytest.raises(ValueError, match="too many values to unpack"):
        jrb.check(root, ["llama-7b"])


def test_run_one_row_on_the_cpu(tmp_path, monkeypatch):
    """One row pointed at the debug OPT config with the published
    overrides: its pipeline runs to its end on the CPU in a subprocess,
    its artifacts under ``--out-dir``, and ``run`` hands them to
    ``check``."""
    debug = ROOT / "experiments" / "configs" / "debug"
    monkeypatch.setattr(trb, "TEMPLATES", debug)
    monkeypatch.setattr(trb, "ROWS", {"opt-tiny": ("opt-tiny.toml", 0.0,
                                                   0.0, 16)})
    checked = []
    monkeypatch.setattr(trb, "check",
                        lambda d, models: checked.append((d, models)) or 0)
    out = tmp_path / "repro"
    assert trb.run(["opt-tiny"], out, [], device="cpu") == 0
    assert checked == [(out.resolve(), ["opt-tiny"])]
    with open(out / "opt-tiny" / "evaluate_perplexity" / "synthetic.json") as f:
        assert np.isfinite(json.load(f)["perplexity"])
    config = (out / "opt-tiny" / "pipeline" / "config.toml").read_text()
    assert "rank = 32" in config and 'name = "lqer-act"' in config


ENTRY_POINTS = {
    "baselines": lambda: tb.main(["unused.toml"]),
    "profile_llm_int8": lambda: tpl.main(["unused.toml"]),
    "lm_head_quality": lambda: tlm.main([]),
    "kv_cache_quality": lambda: tkv.main([]),
    "reproduce_baseline": lambda: trb.main(["--models", "opt-125m"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name]()


def test_experiments_import_no_jax():
    """Every module of ``lqer_tpu_torch/experiments/`` imported in a fresh
    process leaves JAX, ``lqer_tpu`` and the top-level ``experiments``
    package unimported."""
    pkg = ROOT / "lqer_tpu_torch" / "experiments"
    names = sorted("lqer_tpu_torch." + ".".join(
        p.relative_to(ROOT / "lqer_tpu_torch").with_suffix("").parts)
        .removesuffix(".__init__") for p in pkg.rglob("*.py"))
    assert len(names) == 9, names
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lqer_tpu', 'experiments')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
