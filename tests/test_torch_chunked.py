"""The port's chunked approximation (``lqer_tpu_torch/chunked_runners.py``)
against the JAX package's, as ``tests/test_chunked.py`` drives it, on the
debug config ``experiments/configs/debug/opt-tiny.toml`` (lqer-act: the
scaled SVD) over one seeded checkpoint (``model_dir``) and one scale dict,
which the JAX profiler writes and both packages read.

Its 12 weights go in 3 chunks of 5. The chunk and merged artifacts carry
the same names, chunk counts and error rows as JAX's; the merged
``low_rank_dict`` (the list of chunk paths) holds each weight's
``A_q B_q`` within the approximator test's relative error
(``PRODUCT_REL_ERR``, 1e-2: two SVDs) of JAX's merged one, and equals the
port's own unchunked ``run_approximator`` output to the bit. The CLI's
``chunked-approximate`` and ``merge-chunks`` write the same files.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from lqer_tpu import chunked_runners as jchunked
from lqer_tpu import runners as jrunners
from lqer_tpu_torch import chunked_runners as tchunked
from lqer_tpu_torch import cli as tcli
from lqer_tpu_torch import runners as trunners
from lqer_tpu_torch.models.checkpoint import load_tensor_dict
from lqer_tpu_torch.testing import one_torch_thread_fixture
from lqer_tpu_torch.utils import load_config

from test_torch_approximator import PRODUCT_REL_ERR
from test_torch_pipeline import CONFIGS, _write_checkpoint

_one_torch_thread = one_torch_thread_fixture()

CHUNK_SIZE, NUM_CHUNKS = 5, 3


def _product(lr: dict, name: str) -> np.ndarray:
    return lr[name + ".A"].astype(np.float64) @ lr[name + ".B"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(base config with the scale dict, JAX chunk dir, port chunk dir)."""
    tmp = tmp_path_factory.mktemp("chunked")
    ckpt = _write_checkpoint("opt-tiny", tmp / "ckpt")
    config = load_config(CONFIGS["opt-tiny"])
    config["model_dir"] = str(ckpt)
    (tmp / "profile").mkdir()
    config = jrunners.run_profiler(config, tmp / "profile")
    dirs = {}
    for side, run in (("jax", jchunked.run_approximator_chunk),
                      ("port", lambda c, p: tchunked.run_approximator_chunk(
                          c, p, device="cpu"))):
        out = dirs[side] = tmp / side
        out.mkdir()
        for idx in range(NUM_CHUNKS):
            cfg = copy.deepcopy(config)
            cfg["approximate"].update(chunk_size=CHUNK_SIZE, chunk_idx=idx)
            run(cfg, out)
    return config, dirs["jax"], dirs["port"]


def test_chunk_artifacts_match_jax(setup):
    _, jdir, tdir = setup
    names = sorted(p.relative_to(jdir).as_posix() for p in jdir.rglob("*"))
    assert sorted(p.relative_to(tdir).as_posix()
                  for p in tdir.rglob("*")) == names
    assert sum(n.startswith("config_chunk_") for n in names) == NUM_CHUNKS
    for idx in range(NUM_CHUNKS):
        tag = f"chunk_{idx:02d}_of_{NUM_CHUNKS:02d}"
        tcfg = load_config(tdir / f"config_{tag}.toml")
        jcfg = load_config(jdir / f"config_{tag}.toml")
        assert tcfg["approximate"] == jcfg["approximate"]
        assert Path(tcfg["evaluate"]["low_rank_dict"]).name == f"{tag}.safetensors"
        with open(tdir / f"results_{tag}.json") as f, \
                open(jdir / f"results_{tag}.json") as g:
            assert [r["name"] for r in json.load(f)] == \
                [r["name"] for r in json.load(g)]


def test_merged_matches_jax_and_unchunked(setup, tmp_path):
    config, jdir, tdir = setup
    jmerged = jchunked.merge_chunks(jdir)
    tmerged = tchunked.merge_chunks(tdir)
    paths = tmerged["evaluate"]["low_rank_dict"]
    assert isinstance(paths, list) and len(paths) == NUM_CHUNKS
    assert [Path(p).name for p in paths] == \
        [Path(p).name for p in jmerged["evaluate"]["low_rank_dict"]]
    assert load_config(tdir / "config_merged.toml")["evaluate"][
        "low_rank_dict"] == paths
    with open(tdir / "results_merged.json") as f, \
            open(jdir / "results_merged.json") as g:
        rows, jrows = json.load(f), json.load(g)
    assert [r["name"] for r in rows] == [r["name"] for r in jrows]
    assert len(rows) == 12
    ours, theirs = load_tensor_dict(paths), load_tensor_dict(
        jmerged["evaluate"]["low_rank_dict"])
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        if k.endswith(".A"):
            m = k[:-2]
            want = _product(theirs, m)
            err = np.linalg.norm(_product(ours, m) - want) / np.linalg.norm(
                want)
            assert err <= PRODUCT_REL_ERR, (m, err)
    # the port's unchunked approximation of the same weights
    (tmp_path / "approximate").mkdir()
    full = trunners.run_approximator(copy.deepcopy(config),
                                     tmp_path / "approximate", device="cpu")
    whole = load_tensor_dict(full["evaluate"]["low_rank_dict"])
    assert sorted(whole) == sorted(ours)
    for k in whole:
        np.testing.assert_array_equal(ours[k], whole[k], err_msg=k)


def test_cli_chunk_and_merge(setup, tmp_path):
    """``chunked-approximate`` (config overrides choose the chunk) and
    ``merge-chunks`` through the CLI, on ``--device cpu``; ``merge-chunks``
    without a directory exits 2."""
    config, _, tdir = setup
    from lqer_tpu_torch.utils import save_config

    path = tmp_path / "base.toml"
    save_config(copy.deepcopy(config), path)
    out = tmp_path / "run"
    for idx in range(NUM_CHUNKS):
        assert tcli.main([
            "chunked-approximate", str(path), "cli",
            f"--checkpoint_path={out}", "--device", "cpu",
            f"--approximate:chunk_size=:ast:{CHUNK_SIZE}",
            f"--approximate:chunk_idx=:ast:{idx}"]) == 0
    prj = out / "approximate_chunked"
    assert tcli.main(["merge-chunks", str(prj)]) == 0
    assert tcli.main(["merge-chunks"]) == 2
    merged = load_tensor_dict(load_config(prj / "config_merged.toml")[
        "evaluate"]["low_rank_dict"])
    want = load_tensor_dict([
        tdir / "low_rank_dict" / f"chunk_{i:02d}_of_{NUM_CHUNKS:02d}.safetensors"
        for i in range(NUM_CHUNKS)])
    assert sorted(merged) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(merged[k], want[k], err_msg=k)
