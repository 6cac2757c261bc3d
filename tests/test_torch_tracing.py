"""The program's spans (``lqer_tpu_torch/utils/tracing.py``) on the CPU:

- a span inside a ``torch.profiler`` is a ``user_annotation`` of its name,
  nested in the span around it; with no profiler running, entering one
  never enters ``record_function``;
- one ``evaluate_perplexity`` batch of a tiny Llama, Mistral and OPT with
  the kernel backend holds the expected spans, every ``lqer.quantize`` sits
  in a linear, MLP, correction or attention, and every matrix product in a
  linear, MLP, head or attention span (what ``linear_span_roofline.eval``
  needs to stay under its bound);
- ``serving/cli.py --trace-dir`` writes a trace that holds the engine's
  spans and the forward's.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lqer_tpu_torch import models
from lqer_tpu_torch.evaluate import evaluate_perplexity
from lqer_tpu_torch.models.llama import LlamaConfig
from lqer_tpu_torch.models.opt import OPTConfig
from lqer_tpu_torch.serving import cli as tcli
from lqer_tpu_torch.serving.random_model import build_random_model
from lqer_tpu_torch.testing import one_torch_thread_fixture
from lqer_tpu_torch.utils import tracing

_one_torch_thread = one_torch_thread_fixture()

ROOT = Path(__file__).resolve().parents[1]
DEBUG = ROOT / "experiments" / "configs" / "debug"
PRODUCTS = ("aten::mm", "aten::bmm", "aten::matmul", "aten::addmm")
LINEAR_WORK = ("lqer.linear", "lqer.mlp", "lqer.head", "lqer.attention")
QUANT_PARENTS = ("lqer.linear", "lqer.mlp", "lqer.correction",
                 "lqer.attention")


def _events(prof):
    """(annotations, ops): the profiler's host ranges as (start, end,
    name), the program's spans and the operators apart."""
    spans, ops = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (spans if e.is_user_annotation() else ops).append(rec)
    return spans, ops


def _enclosing(spans, t0, t1):
    """Names of the spans that hold ``[t0, t1]``, outermost first."""
    return [n for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1]))
            if s <= t0 and t1 <= e]


def _layer(name):
    return name.split(":", 1)[0]


def test_span_nests_in_its_parent_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.FORWARD:
            with tracing.LAYER:
                with tracing.QUANTIZE:
                    torch.ones(8).abs()
            with tracing.HEAD:
                torch.ones(4, 4) @ torch.ones(4, 4)
    spans, ops = _events(prof)
    names = sorted(n for *_, n in spans)
    assert names == ["lqer.forward", "lqer.head", "lqer.layer",
                     "lqer.quantize"]
    q = next(x for x in spans if x[2] == "lqer.quantize")
    assert _enclosing(spans, q[0], q[1]) == ["lqer.forward", "lqer.layer",
                                             "lqer.quantize"]
    abs_op = next(x for x in ops if x[2] == "aten::abs")
    assert _enclosing(spans, abs_op[0], abs_op[1])[-1] == "lqer.quantize"
    # one instance per name, entered again after it closed
    assert not tracing.QUANTIZE._open and not tracing.FORWARD._open


def test_no_profiler_no_record_function(monkeypatch):
    entered = []

    class Counting(torch.autograd.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(tracing, "record_function", Counting)

    @tracing.annotate("lqer_matmul")
    def matmul(a, b):
        return a @ b

    a = torch.ones(4, 4)
    with tracing.FORWARD, tracing.QUANTIZE:
        assert torch.equal(matmul(a, a), 4 * a)
    cfg, params, backend, qcfgs = _tiny("llama", 64)
    ids = torch.zeros(1, 64, dtype=torch.int64)
    models.get_arch_module(cfg).forward(params, ids, cfg, qcfgs,
                                        backend=backend)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.FORWARD:
            matmul(a, a)
    assert entered == ["lqer.forward", "lqer_matmul"]
    assert tracing.annotate(tracing.HEAD)(lambda: 3)() == 3


def test_names_are_the_documented_set():
    assert len(set(tracing.NAMES)) == len(tracing.NAMES) == 18
    for n in tracing.NAMES:
        assert n.startswith("lqer.") and not n.startswith("bench.")
        assert ":" not in n or n.split(":")[1] in (
            "kernel", "largeM", "emulated", "eager")


def _tiny(arch: str, max_pos: int, window=None):
    """(cfg, params, backend, qcfgs): a 2-layer model whose every linear
    the kernel backend packs (widths of 256), rank 16, on the CPU."""
    if arch == "opt":
        cfg = OPTConfig.tiny(hidden=256, heads=4, ffn=512, max_pos=max_pos)
    else:
        cfg = LlamaConfig.tiny(hidden=256, heads=4, inter=512,
                               max_pos=max_pos,
                               kv_heads=2 if arch == "mistral" else None)
        if arch == "mistral":
            cfg = dataclasses.replace(cfg, sliding_window=window,
                                      arch="mistral")
    backend, params, qcfgs = build_random_model(cfg, rank=16, device="cpu")
    return cfg, params, backend, qcfgs


# (arch, sequence length, batch, the spans of the attention and the routes)
CASES = {
    "llama-largeM": ("llama", 256, 2, None,
                     {"lqer.attention:kernel", "lqer.linear:largeM",
                      "lqer.mlp:largeM", "lqer.unpack"}),
    "llama-kernel": ("llama", 64, 2, None,
                     {"lqer.attention:kernel", "lqer.linear:kernel",
                      "lqer.mlp:kernel"}),
    "mistral-window": ("mistral", 256, 2, 128,
                       {"lqer.attention:eager", "lqer.linear:largeM",
                        "lqer.mlp:largeM", "lqer.unpack"}),
    "opt-largeM": ("opt", 256, 2, None,
                   {"lqer.attention:eager", "lqer.linear:largeM",
                    "lqer.mlp:largeM", "lqer.unpack"}),
}
COMMON = {"lqer.eval.batch", "lqer.loss", "lqer.forward", "lqer.prologue",
          "lqer.layer", "lqer.head", "lqer.correction", "lqer.quantize"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_batch_spans(case):
    arch, s, bs, window, routes = CASES[case]
    cfg, params, backend, qcfgs = _tiny(arch, s + 2, window)
    kw = {"fused_attention": True} if arch != "opt" else {}
    fwd = models.get_arch_module(cfg).forward
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (bs, s))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            evaluate_perplexity(
                lambda x: fwd(params, x, cfg, qcfgs, backend=backend, **kw),
                ids, batch_size=bs, device="cpu")
    spans, ops = _events(prof)
    names = {n for *_, n in spans}
    assert names == COMMON | routes, case
    assert names <= set(tracing.NAMES)
    count = {n: sum(1 for *_, m in spans if m == n) for n in names}
    assert count["lqer.layer"] == cfg.num_hidden_layers
    assert count["lqer.eval.batch"] == count["lqer.forward"] == 1
    for t0, t1, n in spans:
        if n == "lqer.quantize":
            outer = [m for m in _enclosing(spans, t0, t1)
                     if m != "lqer.quantize"]
            assert _layer(outer[-1]) in QUANT_PARENTS, outer
    products = [x for x in ops if x[2] in PRODUCTS]
    assert products
    for t0, t1, n in products:
        around = {_layer(m) for m in _enclosing(spans, t0, t1)}
        assert around & set(LINEAR_WORK), (n, around)


def test_serving_cli_trace_holds_the_spans(tmp_path, capsys):
    out = tmp_path / "trace"
    tcli.main([str(DEBUG / "llama-tiny-pallas.toml"), "--prompt", "1 2 3",
               "--prompt", "7 8", "--max-new-tokens", "3", "--slots", "2",
               "--max-len", "64", "--pallas", "--device", "cpu",
               "--trace-dir", str(out)])
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[")]) == 2
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"serve", "lqer.engine.admit", "lqer.engine.step",
            "lqer.forward", "lqer.prologue", "lqer.layer", "lqer.head",
            "lqer.linear:kernel", "lqer.mlp:kernel",
            "lqer.quantize"} <= names, names
    assert {n for n in names if n.startswith("lqer.")} <= set(tracing.NAMES)
