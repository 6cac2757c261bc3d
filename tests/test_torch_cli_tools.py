"""The port's sweep, result collector, tracing and console dispatch
against the JAX package's (``lqer_tpu/sweep.py``, ``collect.py``,
``cli.py``; ``utils/tracing.py`` is ``torch.profiler`` here):

- ``sweep --dry-run`` prints, per grid point, the JAX sweep's pipeline
  argv (``build_overrides`` for every method), run through
  ``python -m lqer_tpu_torch.cli pipeline`` on ``--device``;
- ``collect-results`` gathers the same rows from the same result files
  and writes the same CSVs;
- ``trace`` writes a chrome trace holding the step's span (a no-op without
  a directory); ``annotate`` keeps the function's return value and name;
- ``cli.main`` dispatches each of its six subcommands, and its usage names
  them all; an unknown one, or ``merge-chunks`` without a directory,
  exits 2.
"""

import json
from pathlib import Path

import pytest

from lqer_tpu import collect as jcollect
from lqer_tpu import sweep as jsweep
from lqer_tpu_torch import cli as tcli
from lqer_tpu_torch import collect as tcollect
from lqer_tpu_torch import sweep as tsweep
from lqer_tpu_torch.testing import one_torch_thread_fixture
from lqer_tpu_torch.utils.tracing import annotate, trace

_one_torch_thread = one_torch_thread_fixture()

CONFIG = str(Path(__file__).resolve().parents[1]
             / "experiments/configs/debug/opt-tiny.toml")
METHODS = ("lqer-act", "lqer-svd", "no-lqer", "lqer-act-int",
           "lqer-act-w-only")


def _dry_runs(out: str, first: str) -> list[list[str]]:
    """Each printed command line's arguments after its ``first`` words."""
    runs = []
    for block in out.split(first)[1:]:
        args = [a.strip() for a in block.split("\\\n")]
        runs.append([a for a in args if a])
    return runs


@pytest.mark.parametrize("method", METHODS)
def test_sweep_dry_run_matches_jax(method, capsys):
    argv = [CONFIG, "--method", method, "--ranks", "8", "32", "--w-bits",
            "4", "3", "--x-blocks", "[1,16]", "[1,32]", "--dry-run"]
    for point in ((8, 4, 8, "[1,16]", "[1,32]"),):
        assert tsweep.build_overrides(method, *point, "s", 16) == \
            jsweep.build_overrides(method, *point, "s", 16)
    jsweep.main(argv)
    want = _dry_runs(capsys.readouterr().out, "pipeline.py")
    tsweep.main(argv + ["--device", "cpu"])
    got = _dry_runs(capsys.readouterr().out,
                    "python -m lqer_tpu_torch.cli pipeline")
    assert len(got) == len(want) == 8
    for ours, theirs in zip(got, want):
        assert ours == theirs + ["--device=cpu"]


def _result_tree(root: Path) -> None:
    for i, (ppl, acc) in enumerate(((5.5, 0.25), (7.25, 0.5))):
        run = root / f"run{i}" / "evaluate"
        run.mkdir(parents=True)
        (run / "wikitext2.json").write_text(json.dumps(
            {"perplexity": ppl, "loss": 1.7 + i, "num_samples": 8}))
        (run / "harness_results.json").write_text(json.dumps(
            {"results": {"tiny_boolq": {"acc": acc, "acc,none": acc,
                                        "alias": "tiny_boolq"}},
             "versions": {"tiny_boolq": 0}}))
    (root / "run0/evaluate/notes.json").write_text(json.dumps([1, 2]))
    (root / "run1/evaluate/broken.json").write_text("{")
    (root / "run1/evaluate/config.json").write_text(json.dumps({"a": 1}))


def test_collect_matches_jax(tmp_path, monkeypatch, capsys):
    _result_tree(tmp_path / "tree")
    rows = tcollect.collect_perplexity(tmp_path / "tree")
    assert rows == jcollect.collect_perplexity(tmp_path / "tree")
    assert [r["perplexity"] for r in rows] == [5.5, 7.25]
    harness = tcollect.collect_harness(tmp_path / "tree")
    assert harness == jcollect.collect_harness(tmp_path / "tree")
    assert harness[1]["tiny_boolq:acc"] == 0.5
    for side, module in (("port", tcollect), ("jax", jcollect)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        module.main([str(tmp_path / "tree")])
    for name in ("collected_perplexity.csv", "collected_harness.csv"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    (tmp_path / "empty").mkdir()
    capsys.readouterr()
    tcollect.main([str(tmp_path / "empty")])
    assert "no results found" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    @annotate("lqer_matmul")
    def matmul(a, b):
        """Multiply."""
        return a @ b

    a = torch.ones(4, 4)
    with trace(None):                 # no directory: nothing is written
        assert torch.equal(matmul(a, a), 4 * a)
    assert not list(tmp_path.iterdir())
    with trace(str(tmp_path / "t"), "step_a"):
        out = matmul(a, a)
    assert torch.equal(out, 4 * a)
    assert matmul.__name__ == "matmul" and matmul.__doc__ == "Multiply."
    text = (tmp_path / "t/trace.json").read_text()
    events = json.loads(text)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"step_a", "lqer_matmul"} <= names


def test_cli_dispatches_every_subcommand(monkeypatch, capsys):
    assert tcli.main([]) == 0
    usage = capsys.readouterr().out
    for cmd in ("pipeline", "serve", "sweep", "collect-results",
                "chunked-approximate", "merge-chunks"):
        assert f"lqer_tpu_torch.cli {cmd} " in usage, cmd
    assert tcli.main(["bogus"]) == 2
    assert tcli.main(["merge-chunks"]) == 2
    seen = []
    from lqer_tpu_torch import chunked_runners, collect, runners, sweep
    from lqer_tpu_torch.serving import cli as serve_cli

    for module, name in ((runners, "run_pipeline"), (serve_cli, "main"),
                         (sweep, "main"), (collect, "main"),
                         (chunked_runners, "run_chunked_approximator"),
                         (chunked_runners, "merge_chunks")):
        monkeypatch.setattr(module, name,
                            lambda arg, _n=f"{module.__name__}.{name}":
                            seen.append((_n, arg)))
    for cmd in ("pipeline", "serve", "sweep", "collect-results",
                "chunked-approximate"):
        assert tcli.main([cmd, "x.toml", "--device", "cpu"]) == 0
    assert tcli.main(["merge-chunks", "dir"]) == 0
    assert seen == [
        ("lqer_tpu_torch.runners.run_pipeline", ["x.toml", "--device", "cpu"]),
        ("lqer_tpu_torch.serving.cli.main", ["x.toml", "--device", "cpu"]),
        ("lqer_tpu_torch.sweep.main", ["x.toml", "--device", "cpu"]),
        ("lqer_tpu_torch.collect.main", ["x.toml", "--device", "cpu"]),
        ("lqer_tpu_torch.chunked_runners.run_chunked_approximator",
         ["x.toml", "--device", "cpu"]),
        ("lqer_tpu_torch.chunked_runners.merge_chunks", "dir")]
