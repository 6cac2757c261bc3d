"""The serving CLI: ``python -m lqer_tpu_torch.serving.cli`` against the JAX
package's ``serving/cli.py::main``, and the pieces it builds the model
from (``runners.build_model_config`` / ``build_params``,
``models/checkpoint.py``, ``utils/config.py``).

Each test writes a tiny HF-format checkpoint with numpy and
``safetensors`` into ``tmp_path`` (half-precision weights, upcast to f32
on load) and a low-rank dict with the JAX package's ``save_tensor_dict``,
and points a copy of a debug config at both (``model_dir``,
``evaluate.low_rank_dict``). Both ``build_params`` load the same values,
and both CLIs print the same token lines: on ``opt-tiny.toml`` at
``--max-len 64`` with the linears emulated, and on ``llama-tiny-pallas.toml``
with ``--pallas`` (the JAX kernels in interpret mode, the port's plain
versions on the CPU). Without a checkpoint the port draws its random init
from ``torch.Generator``, so its tokens differ from the JAX CLI's; it
still prints one line per prompt in the JAX format.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lqer_tpu import runners as jrunners
from lqer_tpu.models.checkpoint import save_tensor_dict as jsave
from lqer_tpu.serving import cli as jcli
from lqer_tpu.utils import load_config as jload_config
from lqer_tpu.utils import save_config as jsave_config
from lqer_tpu_torch import runners as trunners
from lqer_tpu_torch.models import checkpoint as tcheckpoint
from lqer_tpu_torch.serving import cli as tcli
from lqer_tpu_torch.utils import convert_str_na_to_none, load_config
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

ROOT = Path(__file__).resolve().parents[1]
DEBUG = ROOT / "experiments" / "configs" / "debug"
ARGS = ["--prompt", "1 2 3", "--prompt", "7 8", "--max-new-tokens", "6",
        "--slots", "2", "--max-len", "64"]
LINE = re.compile(r"^\[(\d)\] tokens: \[([0-9, ]*)\]$")


def _checkpoint(tmp_path, toml: str, rank: int):
    """A tiny HF-format checkpoint of ``toml``'s ``[model]`` (f16 weights of
    scale 0.05, norms near one) and a rank-``rank`` low-rank dict of
    bf16-exact values for every quantized linear; returns the config path
    that points at both."""
    config = jload_config(DEBUG / toml)
    cfg = jrunners.build_model_config(config)
    import jax

    from lqer_tpu import models as jmodels

    shapes = {k: v.shape for k, v in jmodels.init_params(
        cfg, jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(7)
    weights, lrd = {}, {}
    for name, shape in sorted(shapes.items()):
        base = 1.0 if name.endswith("norm.weight") else 0.0
        scale = 0.1 if "embed" in name else 0.05
        weights[name] = (base + rng.standard_normal(shape) * scale).astype(
            np.float16)
        prefix = name.removesuffix(".weight")
        if name.endswith(".weight") and len(shape) == 2 \
                and ".layers." in name and "norm" not in name:
            o, i = shape
            for key, s in (("A", (i, rank)), ("B", (rank, o))):
                v = torch.from_numpy(rng.standard_normal(s) * 0.05).to(
                    torch.bfloat16).float().numpy()
                lrd[f"{prefix}.{key}"] = v
    ckpt = tmp_path / "checkpoint"
    ckpt.mkdir()
    from safetensors.numpy import save_file

    save_file(weights, str(ckpt / "model.safetensors"))
    jsave(lrd, tmp_path / "low_rank_dict.safetensors")
    config["model_dir"] = str(ckpt)
    config.setdefault("evaluate", {})["low_rank_dict"] = str(
        tmp_path / "low_rank_dict.safetensors")
    path = tmp_path / toml
    jsave_config(config, path)
    return path


def _token_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if LINE.match(ln)]


@pytest.mark.parametrize("toml,extra,rank", [
    ("opt-tiny.toml", [], 8),
    ("llama-tiny-pallas.toml", ["--pallas"], 16),
])
def test_cli_matches_jax_cli(tmp_path, capsys, toml, extra, rank):
    path = _checkpoint(tmp_path, toml, rank)
    config = load_config(path)
    assert config == jload_config(path)
    cfg = trunners.build_model_config(config)
    tparams = trunners.build_params(config, cfg, trunners._get_dtype(None))
    jparams = jrunners.build_params(jload_config(path),
                                    jrunners.build_model_config(config))
    assert sorted(tparams) == sorted(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v), k)
    jcli.main([str(path), *ARGS, *extra])
    want = _token_lines(capsys.readouterr().out)
    tcli.main([str(path), *ARGS, *extra, "--device", "cpu"])
    got = _token_lines(capsys.readouterr().out)
    assert got == want and len(got) == 2
    tcli.main([str(path), *ARGS, *extra, "--device", "cpu", "--scan-layers"])
    assert _token_lines(capsys.readouterr().out) == want


@pytest.mark.parametrize("toml,extra", [
    ("opt-tiny.toml", []), ("llama-tiny-pallas.toml", ["--pallas"]),
    ("llama-tiny-pallas.toml", ["--cache-dtype", "mxint8-staged",
                                "--max-len", "128", "--lm-head-width", "8",
                                "--pallas"]),
    ("opt-tiny.toml", ["--fp", "--cache-dtype", "float32"]),
])
def test_cli_random_init_prints_one_line_per_prompt(capsys, tmp_path, toml,
                                                    extra):
    """The debug configs' random init (no checkpoint): one ``[i] tokens:
    [...]`` line per prompt with ``--max-new-tokens`` tokens, as the JAX
    CLI prints them; ``--trace-dir`` writes a torch.profiler trace."""
    tcli.main([str(DEBUG / toml), *ARGS, *extra, "--device", "cpu",
               "--trace-dir", str(tmp_path / "trace")])
    lines = _token_lines(capsys.readouterr().out)
    assert [LINE.match(ln).group(1) for ln in lines] == ["0", "1"]
    for ln in lines:
        assert len(LINE.match(ln).group(2).split(",")) == 6
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_checkpoint_io_and_config(tmp_path):
    """``save_tensor_dict`` / ``load_tensor_dict`` round trips (safetensors,
    npz, a list of chunks, the reference's torch ``.pt``); a missing
    checkpoint directory resolves to None (random init), as in JAX;
    ``"NA"`` reads back as None."""
    rng = np.random.default_rng(0)
    d = {"a.A": rng.standard_normal((4, 2)).astype(np.float32),
         "a.B": rng.standard_normal((2, 4)).astype(np.float32)}
    for suffix in (".safetensors", ".npz"):
        tcheckpoint.save_tensor_dict(d, tmp_path / f"x{suffix}")
        got = tcheckpoint.load_tensor_dict(tmp_path / f"x{suffix}")
        assert sorted(got) == sorted(d)
        for k in d:
            np.testing.assert_array_equal(got[k], d[k])
    tcheckpoint.save_tensor_dict({"b": torch.ones(3)}, tmp_path / "y.npz")
    merged = tcheckpoint.load_tensor_dict([tmp_path / "x.npz",
                                           tmp_path / "y.npz"])
    assert sorted(merged) == ["a.A", "a.B", "b"]
    torch.save({"c": torch.zeros(2, dtype=torch.float16)}, tmp_path / "z.pt")
    assert tcheckpoint.load_tensor_dict(tmp_path / "z.pt")["c"].dtype \
        == np.float32
    with pytest.raises(ValueError):
        tcheckpoint.save_tensor_dict(d, tmp_path / "x.bin")
    assert tcheckpoint.resolve_model_source(
        "test/none", str(tmp_path / "missing")) is None
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tcheckpoint.load_hf_pretrained(tmp_path / "empty")
    assert convert_str_na_to_none({"a": ["NA", 1], "b": ("NA",)}) == \
        {"a": [None, 1], "b": (None,)}
    assert load_config(DEBUG / "opt-tiny.toml") == \
        jload_config(DEBUG / "opt-tiny.toml")
