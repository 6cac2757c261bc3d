"""The port's harness stage (``runners.run_evaluate_harness_downstream``, in
``run_pipeline`` after the perplexity) against the JAX package's, on both
debug configs (``opt-tiny.toml``; ``llama-tiny-pallas.toml``, whose
evaluation runs the kernel backend and the fused prefill attention: JAX's
Pallas kernels in interpret mode, the port's plain versions), over one
seeded checkpoint (``model_dir``).

- With the configs' own task, ``lambada_openai``: without lm_eval both
  packages skip it with a warning, then the stage; the pipeline writes the
  same stage configs and ends "✅ Done.".
- With every ``tiny_*`` task and the fake tokenizer of
  ``tests/test_harness_adapter.py`` patched in on both sides (no tokenizer
  is downloaded), the port's evaluation of JAX's ``low_rank_dict`` writes
  a ``harness_results.json`` whose accuracies (``acc``, ``acc_norm``,
  ``exact_match``) equal JAX's and whose perplexities are within rtol
  ``PPL_RTOL``: the two forwards sum in other f32 orders, which may flip
  one 8-bit activation rounding (``test_torch_pipeline``: 1.2e-5 to
  2.6e-5 of a perplexity); a stage run again writes
  ``harness_results_0.json``. ``max_length`` is 128, the debug models'
  ``max_position_embeddings``: the port's OPT engine refuses a longer
  cache, where the JAX engine would read its position table past the end.
  The fused prefill attention is off: its kernel takes only lengths that
  are multiples of 16, in both packages (JAX asserts it, the port raises),
  and the harness's batches are as wide as their longest request.
"""

import json

import numpy as np
import pytest

from lqer_tpu import runners as jrunners
from lqer_tpu_torch import cli as tcli
from lqer_tpu_torch import runners as trunners
from lqer_tpu_torch.evaluate.minieval import TASK_REGISTRY
from lqer_tpu_torch.testing import one_torch_thread_fixture
from lqer_tpu_torch.utils import load_config

from test_harness_adapter import FakeTok
from test_torch_pipeline import CONFIGS, _argv, _write_checkpoint

_one_torch_thread = one_torch_thread_fixture()

PPL_RTOL = 1e-3
ACCURACIES = ("acc", "acc_norm", "exact_match")
PIPELINE_FILES = {"config.toml", "config_after_profiling.toml",
                  "config_after_approximation.toml",
                  "config_after_harness_downstream_evaluation.toml"}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, tmp_path_factory):
    """(name, JAX output dir, port output dir): each package's pipeline
    with the harness stage on its configured task, the perplexity off."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    ckpt = _write_checkpoint(name, tmp / "ckpt")
    extra = ("--enable_harness_downstream_evaluation=:ast:True",
             "--enable_perplexity_evaluation=:ast:False")
    jrunners.run_pipeline(_argv(name, tmp / "jax", ckpt, *extra))
    assert tcli.main(["pipeline", *_argv(name, tmp / "port", ckpt, *extra),
                      "--device", "cpu"]) == 0
    return name, tmp / "jax", tmp / "port"


def test_unknown_task_skips_the_stage(runs, monkeypatch):
    """``lambada_openai`` is skipped, then the stage, as in JAX: no results
    file, the same stage configs."""
    _, jout, tout = runs
    for out in (jout, tout):
        assert not list((out / "evaluate_harness_downstream").iterdir())
        assert {p.name for p in (out / "pipeline").iterdir()} == \
            PIPELINE_FILES
        cfg = load_config(out / "pipeline/config.toml")
        assert cfg["enable_harness_downstream_evaluation"] is False
    config = load_config(tout / "pipeline/config_after_approximation.toml")
    config["enable_harness_downstream_evaluation"] = True
    warned = []
    monkeypatch.setattr(trunners.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    assert trunners.run_evaluate_harness_downstream(
        config, tout / "evaluate_harness_downstream", device="cpu") is config
    assert "lambada_openai" in warned[0] and "skipping stage" in warned[1]


def _tiny_results(run, config, out, monkeypatch):
    monkeypatch.setattr(jrunners, "_get_tokenizer", lambda c: FakeTok())
    monkeypatch.setattr(trunners, "_get_tokenizer", lambda c: FakeTok())
    out.mkdir(parents=True, exist_ok=True)
    run(config, out)
    with open(out / "harness_results.json") as f:
        return json.load(f)


def test_tiny_tasks_match_jax(runs, tmp_path, monkeypatch):
    """Every tiny task through both packages' stage on JAX's factors."""
    _, jout, _ = runs
    config = load_config(jout / "pipeline/config_after_approximation.toml")
    config["evaluate"]["harness_downstream"].update(
        datasets=sorted(TASK_REGISTRY), max_length=128)
    config["evaluate"]["fused_attention"] = False
    want = _tiny_results(jrunners.run_evaluate_harness_downstream,
                         config, tmp_path / "jax", monkeypatch)
    got = _tiny_results(
        lambda c, p: trunners.run_evaluate_harness_downstream(c, p, "cpu"),
        config, tmp_path / "port", monkeypatch)
    assert sorted(got) == sorted(want)
    for key in ("versions", "n-shot", "configs"):
        assert got[key] == want[key], key
    assert sorted(got["results"]) == sorted(TASK_REGISTRY)
    for task, metrics in want["results"].items():
        ours = got["results"][task]
        assert sorted(ours) == sorted(metrics), task
        for k, v in metrics.items():
            base = k.split(",")[0].removesuffix("_stderr")
            if k == "alias" or base in ACCURACIES:
                assert ours[k] == v, (task, k)
            else:
                np.testing.assert_allclose(ours[k], v, rtol=PPL_RTOL,
                                           err_msg=f"{task} {k}")
    # a second run of the stage writes beside the first
    trunners.run_evaluate_harness_downstream(config, tmp_path / "port", "cpu")
    assert (tmp_path / "port/harness_results_0.json").exists()
