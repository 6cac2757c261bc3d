"""The port's offline pipeline (``runners.run_pipeline`` through
``python -m lqer_tpu_torch.cli pipeline``, ``--device cpu``) against the
JAX package's ``run_pipeline`` on the debug configs
``experiments/configs/debug/opt-tiny.toml`` and ``llama-tiny-pallas.toml``
(profile → approximate → perplexity; the second evaluates through the
kernel backend and the fused prefill attention: JAX's Pallas kernels in
interpret mode, the port's plain versions).

The port's random init cannot draw ``jax.random``'s values, so both read
one checkpoint through ``model_dir``: a ``model.safetensors`` this test
writes from seeded numpy arrays (nothing is downloaded). One JAX run per
config is shared by the cases (a module-scoped fixture).

Limits:

- the scale dicts at rtol 1e-5: the per-channel means of the same
  activations, whose f32 sums run in another order;
- each weight's ``A_q B_q`` within the approximator test's relative
  Frobenius error (``test_torch_approximator.PRODUCT_REL_ERR``, 1e-2);
- the perplexities at rtol 1e-3 (8-bit roundings of activations and
  factors may flip one code step between the two packages, and the
  factors come from two SVDs); with JAX's ``low_rank_dict`` fed to the
  port's evaluation, at rtol 1e-4: the factors are then the same, but one
  flipped rounding of an activation remains possible, and on opt-tiny's
  first test batch one does flip (1.06 code steps at most, 0.10 RMS over
  the logits), which moves the perplexity by 1.2e-5 (2.6e-5 on
  llama-tiny-pallas); the other batches differ by the f32 order alone
  (under 1e-4 code steps);
- the same artifacts under the same names, and the stage configs.

The verify skill's probes run on the port: resuming from
``config_after_approximation.toml`` skips the first two stages;
``--evaluate:perplexity:batch_size=4`` overrides; ``--overwrite_checkpoint
=false`` on a non-empty directory raises ``RuntimeError``; without
``--device cpu`` and without a card the run raises before it makes a
directory; the harness stage raises before any work.
"""

import contextlib
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lqer_tpu import runners as jrunners
from lqer_tpu_torch import cli as tcli
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch import runners as trunners
from lqer_tpu_torch.models.checkpoint import load_tensor_dict
from lqer_tpu_torch.utils import load_config, save_config
from lqer_tpu_torch.testing import one_torch_thread_fixture

from test_torch_approximator import PRODUCT_REL_ERR

_one_torch_thread = one_torch_thread_fixture()

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {name: ROOT / "experiments/configs/debug" / f"{name}.toml"
           for name in ("opt-tiny", "llama-tiny-pallas")}
STAGES = ("profile", "approximate", "evaluate_perplexity", "pipeline")


def _write_checkpoint(name, path: Path) -> Path:
    """A ``model.safetensors`` of the config's model: seeded normal
    weights (scale 0.02), random biases, norms one."""
    from safetensors.numpy import save_file

    config = load_config(CONFIGS[name])
    cfg = trunners.build_model_config(config)
    shapes = tmodels.init_params(cfg, torch.Generator())
    rng = np.random.default_rng(11)
    arrays = {}
    for k, v in shapes.items():
        if "norm" in k and k.endswith(".weight"):
            arrays[k] = np.ones(v.shape, np.float32)
        else:
            arrays[k] = (rng.standard_normal(tuple(v.shape)) * 0.02).astype(
                np.float32)
    path.mkdir(parents=True, exist_ok=True)
    save_file(arrays, str(path / "model.safetensors"))
    return path


def _argv(name, out: Path, ckpt: Path, *extra):
    return [str(CONFIGS[name]), "pytest", f"--checkpoint_path={out}",
            f"--model_dir={ckpt}", "--overwrite_checkpoint=:ast:True",
            *extra]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, tmp_path_factory):
    """(name, checkpoint, JAX output dir, port output dir)."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    ckpt = _write_checkpoint(name, tmp / "ckpt")
    jrunners.run_pipeline(_argv(name, tmp / "jax", ckpt))
    assert tcli.main(["pipeline", *_argv(name, tmp / "port", ckpt),
                      "--device", "cpu"]) == 0
    return name, ckpt, tmp / "jax", tmp / "port"


def _ppl(out: Path):
    with open(out / "evaluate_perplexity/synthetic.json") as f:
        return json.load(f)


def test_artifacts_match_jax(runs):
    _, _, jout, tout = runs
    for stage in STAGES:
        assert (sorted(p.name for p in (tout / stage).iterdir())
                == sorted(p.name for p in (jout / stage).iterdir())), stage
    for after in ("profiling", "approximation", "perplexity_evaluation"):
        tcfg = load_config(tout / f"pipeline/config_after_{after}.toml")
        jcfg = load_config(jout / f"pipeline/config_after_{after}.toml")
        for k in ("enable_profiling", "enable_approximation",
                  "enable_perplexity_evaluation"):
            assert tcfg[k] == jcfg[k], (after, k)
    jres, tres = _ppl(jout), _ppl(tout)
    assert {k: tres[k] for k in ("num_samples", "seq_len", "batch_size")} \
        == {k: jres[k] for k in ("num_samples", "seq_len", "batch_size")}
    import pandas as pd

    jdf = pd.read_pickle(jout / "approximate/results.pkl")
    tdf = pd.read_pickle(tout / "approximate/results.pkl")
    assert list(tdf["name"]) == list(jdf["name"])
    np.testing.assert_allclose(tdf["l1_norm(AB-Q_error_T)/n"],
                               jdf["l1_norm(AB-Q_error_T)/n"], rtol=1e-3)


def test_scale_dicts_agree(runs):
    _, _, jout, tout = runs
    jsd = load_tensor_dict(jout / "profile/scale_dict.safetensors")
    tsd = load_tensor_dict(tout / "profile/scale_dict.safetensors")
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], rtol=1e-5, atol=0,
                                   err_msg=k)


def test_low_rank_products_agree(runs):
    _, _, jout, tout = runs
    jlr = load_tensor_dict(jout / "approximate/low_rank_dict.safetensors")
    tlr = load_tensor_dict(tout / "approximate/low_rank_dict.safetensors")
    assert sorted(tlr) == sorted(jlr)
    for k in jlr:
        if k.endswith(".A"):
            m = k[:-2]
            want = jlr[m + ".A"].astype(np.float64) @ jlr[m + ".B"]
            got = tlr[m + ".A"].astype(np.float64) @ tlr[m + ".B"]
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= PRODUCT_REL_ERR, (m, err)


def test_perplexity_agrees(runs):
    _, _, jout, tout = runs
    assert _ppl(tout)["perplexity"] == pytest.approx(
        _ppl(jout)["perplexity"], rel=1e-3)


def test_jax_low_rank_dict_in_port_eval(runs):
    """The port's evaluation of JAX's factors gives JAX's perplexity
    (rtol 1e-4: one flipped activation rounding moves it by 1.2e-5)."""
    _, _, jout, tout = runs
    config = load_config(jout / "pipeline/config_after_approximation.toml")
    out = tout.parent / "port-eval"
    (out / "evaluate_perplexity").mkdir(parents=True)
    trunners.run_evaluate_perplexity(config, out / "evaluate_perplexity",
                                     device="cpu")
    assert _ppl(out)["perplexity"] == pytest.approx(
        _ppl(jout)["perplexity"], rel=1e-4)


def test_evaluation_backend(runs):
    """With ``evaluate.pallas_backend`` the evaluated model carries the
    kernel backend, and it packs at least one linear; without it, none."""
    _, _, _, tout = runs
    config = load_config(tout / "pipeline/config_after_approximation.toml")
    *_, backend, _ = trunners._build_quantized_forward(
        config, False, torch.float32, "cpu")
    if config["evaluate"].get("pallas_backend", False):
        assert backend["meta"]
    else:
        assert backend is None


def test_resume_and_override_probes(runs, monkeypatch):
    """Resuming from ``config_after_approximation.toml`` runs only the
    evaluation; an override reaches it."""
    name, ckpt, _, tout = runs

    def refuse(*a, **kw):
        raise AssertionError("a finished stage ran again")

    monkeypatch.setattr(trunners, "run_profiler", refuse)
    monkeypatch.setattr(trunners, "run_approximator", refuse)
    resume = tout / "pipeline/config_after_approximation.toml"
    out = tout.parent / "resumed"
    ran = []

    @contextlib.contextmanager
    def hook(folder):
        ran.append(folder)
        yield

    config = trunners.run_pipeline(
        [str(resume), "resume", f"--checkpoint_path={out}",
         "--evaluate:perplexity:batch_size=4", "--device", "cpu"],
        stage_hook=hook)
    assert ran == ["evaluate_perplexity"]
    assert config["enable_perplexity_evaluation"] is False
    assert not (out / "profile").exists()
    res = _ppl(out)
    assert res["batch_size"] == 4
    assert res["perplexity"] == pytest.approx(_ppl(tout)["perplexity"],
                                              rel=1e-6)


def test_clobber_and_device_probes(runs, monkeypatch):
    name, ckpt, _, tout = runs
    with pytest.raises(RuntimeError, match="not empty"):
        trunners.run_pipeline(_argv(name, tout, ckpt, "--device", "cpu",
                                    "--overwrite_checkpoint=false"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fresh = tout.parent / "no-card"
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.main(["pipeline", *_argv(name, fresh, ckpt)])
    assert not fresh.exists()


def test_harness_stage_refused(tmp_path):
    config = load_config(CONFIGS["opt-tiny"])
    config["enable_harness_downstream_evaluation"] = True
    path = tmp_path / "harness.toml"
    save_config(config, path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trunners.run_pipeline([str(path), f"--checkpoint_path={tmp_path}/x",
                               "--device", "cpu"])
    assert not (tmp_path / "x").exists()


def test_save_config_round_trip(tmp_path):
    """``save_config`` writes what ``load_config`` reads back (None as
    "NA", quoted regex keys), as the JAX package's does."""
    from lqer_tpu.utils import config as jconfig

    config = load_config(CONFIGS["llama-tiny-pallas"])
    config["extra"] = {"none": None, "nested": {"x": [1, 2.5, "a\"b"]}}
    save_config(copy.deepcopy(config), tmp_path / "t.toml")
    jconfig.save_config(copy.deepcopy(config), tmp_path / "j.toml")
    assert (tmp_path / "t.toml").read_text() == \
        (tmp_path / "j.toml").read_text()
    assert load_config(tmp_path / "t.toml") == config
