"""The port's baseline evaluation (``lqer_tpu_torch/experiments/baselines.py``)
against the JAX script (``experiments/baselines.py``) on the same seeded
checkpoints and synthetic split.

- ``build_llm_int_qcfgs``: the tiny OPT of ``tests/test_llm_int8.py``
  through both packages' forwards with each package's LLM.int8()/int4
  configs, at the bitsandbytes threshold 6.0 (no outlier column at this
  scale) and at 1.5 (outlier columns in every linear): logits within
  rtol = atol = 2e-4 (``testing.RTOL``), the f32 sums' order apart.
- ``main`` for every method on a tiny Llama whose weights are drawn with
  numpy and written as a local checkpoint (``model_dir``); GPTQ (both
  zero-offset modes) and AWQ checkpoints packed by the port's packers,
  which equal JAX's to the bit (``tests/test_torch_quant_checkpoints.py``).
  The perplexities agree within 1e-5 relative in f32 (the order of f32
  sums, and one 8-bit rounding per linear for the int methods) and 2e-3
  in bf16/fp16 (one half-precision rounding of each product).
- Every ``experiments/configs/baseline/*.toml`` resolves in the port and
  names a method the port accepts (as ``tests/test_templates.py``).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import OPTConfig as JOPTConfig
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import params_from_jax
from lqer_tpu_torch.experiments import baselines as tb
from lqer_tpu_torch.models import quant_checkpoints as tqc
from lqer_tpu_torch.runners import build_model_config
from lqer_tpu_torch.testing import ATOL, RTOL, one_torch_thread_fixture
from lqer_tpu_torch.utils import load_config, save_config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from experiments import baselines as jb  # noqa: E402

_one_torch_thread = one_torch_thread_fixture()

BASELINE_DIR = ROOT / "experiments" / "configs" / "baseline"
GROUP = 32
PPL_RTOL = {"bf16": 2e-3, "fp16": 2e-3}
PPL_RTOL_F32 = 1e-5
MODEL = dict(arch="llama", vocab_size=256, hidden_size=64,
             intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4,
             max_position_embeddings=64)


@pytest.mark.parametrize("method", ["llm_int8", "llm_int4"])
@pytest.mark.parametrize("threshold", [6.0, 1.5])
def test_llm_int_qcfgs_logits_equal_jax(method, threshold):
    jcfg = JOPTConfig.tiny(vocab_size=64, hidden=32, layers=2, heads=2,
                           ffn=48)
    cfg = tmodels.OPTConfig.tiny(vocab_size=64, hidden=32, layers=2,
                                 heads=2, ffn=48)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    ids = np.random.RandomState(5).randint(0, 64, (2, 8))
    want = np.asarray(jmodels.forward(
        params, jnp.asarray(ids), jcfg,
        jb.build_llm_int_qcfgs(jcfg, method, threshold)))
    got = tmodels.forward(
        params_from_jax(jax.tree.map(np.asarray, params)),
        torch.as_tensor(ids), cfg,
        tb.build_llm_int_qcfgs(cfg, method, threshold))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    fp = tmodels.forward(params_from_jax(jax.tree.map(np.asarray, params)),
                         torch.as_tensor(ids), cfg)
    assert not torch.equal(got, fp)       # the method took effect


def _weights():
    """The tiny Llama's params drawn with numpy (normal at 0.02, norms
    one), named and shaped as the port's ``init_params`` names them."""
    cfg = build_model_config({"model": MODEL})
    shapes = tmodels.init_params(cfg, torch.Generator(), device="meta")
    rng = np.random.RandomState(0)
    return {k: (np.ones(t.shape, np.float32) if k.endswith("norm.weight")
                else (rng.randn(*t.shape) * 0.02).astype(np.float32))
            for k, t in shapes.items()}, cfg


def _save(tensors: dict, path: Path) -> str:
    from safetensors.numpy import save_file

    path.mkdir(parents=True)
    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()},
              str(path / "model.safetensors"))
    return str(path)


def _packed(weights: dict, cfg, fmt: str, zero_offset=True) -> dict:
    linears = {p + ".weight" for i in range(cfg.num_hidden_layers)
               for p, _ in tmodels.quantizable_module_prefixes(cfg, i)}
    out = {k: v for k, v in weights.items() if k not in linears}
    for name in linears:
        w = torch.from_numpy(weights[name])
        if fmt == "gptq":
            packed = tqc.pack_gptq_weight(w, GROUP, zero_offset=zero_offset)
            suffixes = (".qweight", ".qzeros", ".scales", ".g_idx")
        else:
            packed = tqc.pack_awq_weight(w, GROUP)
            suffixes = (".qweight", ".qzeros", ".scales")
        for s, t in zip(suffixes, packed):
            out[name[:-len(".weight")] + s] = t.numpy()
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The config (``model_dir``: the fp checkpoint) and the quantized
    checkpoints' directories."""
    tmp = tmp_path_factory.mktemp("baselines")
    weights, cfg = _weights()
    dirs = {"fp": _save(weights, tmp / "fp"),
            "gptq": _save(_packed(weights, cfg, "gptq"), tmp / "gptq"),
            "gptq_nz": _save(_packed(weights, cfg, "gptq", False),
                             tmp / "gptq_nz"),
            "awq": _save(_packed(weights, cfg, "awq"), tmp / "awq")}
    synthetic = {"vocab_size": 256, "num_train": 0, "num_test": 4,
                 "seed": 3}
    config = {"model_name": "test/llama-tiny", "model_dir": dirs["fp"],
              "model": MODEL,
              "evaluate": {"hf_quant_method": "gptq", "perplexity": {
                  "dataset": "synthetic", "batch_size": 2,
                  "max_length": 32, "synthetic": synthetic}}}
    path = tmp / "baseline.toml"
    save_config(config, path)
    return str(path), dirs, tmp


def _jax_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["baselines.py", *argv])
    jb.main()


CASES = [("fp32", []), ("bf16", []), ("fp16", []), ("llm_int8", []),
         ("llm_int4", []), ("llm_int8", ["--int8-threshold", "1.5"]),
         ("gptq", ["--model-dir", "gptq"]),
         ("gptq", ["--model-dir", "gptq_nz", "--gptq-no-zero-offset"]),
         ("awq", ["--model-dir", "awq"])]


@pytest.mark.parametrize("method,extra", CASES,
                         ids=["-".join([m, *e]) for m, e in CASES])
def test_main_matches_jax(setup, method, extra, monkeypatch):
    path, dirs, tmp = setup
    extra = [dirs[a] if a in dirs else a for a in extra]
    case = tmp / "-".join([method, *(Path(a).name for a in extra)])
    argv = [path, "--method", method, *extra]
    _jax_main([*argv, "--save-dir", str(case / "jax")], monkeypatch)
    got = tb.main([*argv, "--save-dir", str(case / "port"),
                   "--device", "cpu"])
    with open(case / "jax" / "synthetic.json") as f:
        want = json.load(f)
    with open(case / "port" / "synthetic.json") as f:
        assert json.load(f) == got
    assert got["method"] == want["method"] == method
    assert (got["num_samples"], got["seq_len"]) == (4, 32)
    assert got["perplexity"] == pytest.approx(
        want["perplexity"], rel=PPL_RTOL.get(method, PPL_RTOL_F32))


def test_methods_differ(setup):
    """Each method changes the perplexity (the negative control of the
    chip run's baselines); the config's ``hf_quant_method`` is the
    default."""
    path, dirs, _ = setup
    ppl = {m: tb.main([path, "--method", m, "--device", "cpu"])["perplexity"]
           for m in ("fp32", "llm_int4")}
    default = tb.main([path, "--model-dir", dirs["gptq"], "--device", "cpu"])
    assert default["method"] == "gptq"
    assert len({ppl["fp32"], ppl["llm_int4"], default["perplexity"]}) == 3


def test_quantized_method_needs_a_checkpoint(setup, tmp_path):
    path, _, _ = setup
    config = load_config(path)
    config.pop("model_dir")
    bare = tmp_path / "bare.toml"
    save_config(config, bare)
    with pytest.raises(FileNotFoundError):
        tb.main([str(bare), "--method", "awq", "--device", "cpu"])


@pytest.mark.parametrize("path", sorted(BASELINE_DIR.glob("*.toml")),
                         ids=lambda p: p.stem)
def test_baseline_config_resolves(path):
    """Each baseline config resolves to the port's model config and names
    a method the port's ``main`` accepts as its default."""
    cfg = load_config(path)
    arch_cfg = build_model_config(cfg)
    assert arch_cfg.num_hidden_layers > 0
    assert cfg["evaluate"]["hf_quant_method"] in tb.METHODS
    assert sorted(tb.METHODS) == sorted(
        list(jb.METHOD_DTYPES) + list(jb.QUANT_METHODS) + list(jb.INT_METHODS))
