"""``program_spans.py`` on synthetic profiler events: a kernel goes to the
innermost ``lqer.*`` span open when it was launched, and counts once
toward each distinct name around it; an idle stretch is named by the span
open at its middle; the four readers of the program's spans return None
where the trace holds none."""

import importlib.util
import types
from pathlib import Path

import pytest

from perfbench import program_spans, spec as spec_mod
from perfbench.metrics._roofline import batch_bounds
from perfbench.peaks import peak_rates
from perfbench.spans import Spans
from perfbench.tests.rehearsal import MIXES, config_path

METRICS = Path(__file__).resolve().parents[1] / "metrics"
READERS = ("quantize_share.eval", "attn_share.eval",
           "linear_span_roofline.eval", "prologue_idle_ms.eval")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ev:
    """One profiler event with the methods ``program_spans`` reads."""

    def __init__(self, name, t0, t1, *, device="CPU", corr=0,
                 annotation=False):
        self._n, self._t0, self._d = name, t0, t1 - t0
        self._dev, self._corr, self._ann = device, corr, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._ann


def span(name, t0, t1):
    """A span on the host, and its range on the device's timeline."""
    return [Ev(name, t0, t1, annotation=True),
            Ev(name, t0 + 5, t1 + 5, device="CUDA", annotation=True)]


def kernel(name, launch, t0, t1, corr):
    """A runtime launch on the host at ``launch`` and its kernel on the
    device over ``[t0, t1]``."""
    return [Ev("cudaLaunchKernel", launch, launch + 1, corr=corr),
            Ev(name, t0, t1, device="CUDA", corr=corr)]


def events(with_program=True):
    """One traced batch over [0, 1000] ns: a forward over [10, 900] with a
    prologue [10, 100], a linear [100, 400] holding a quantizer [120, 200],
    an eager attention [400, 700] holding another eager attention (the
    admission's ``_attend`` around ``eager_attention``) [410, 600]."""
    ev = span("bench.batch", 0, 1000)
    if with_program:
        for name, t0, t1 in (("lqer.forward", 10, 900),
                             ("lqer.prologue", 10, 100),
                             ("lqer.linear:largeM", 100, 400),
                             ("lqer.quantize", 120, 200),
                             ("lqer.attention:eager", 400, 700),
                             ("lqer.attention:eager", 410, 600)):
            ev += span(name, t0, t1)
    ev.append(Ev("aten::abs", 125, 160, corr=1))      # a host operator
    # launches on the host, kernels on the device later (a queue)
    ev += kernel("abs_kernel", 130, 150, 170, 1)       # quantize
    ev += kernel("nvjet_gemm", 250, 170, 260, 2)       # linear
    ev += kernel("softmax_kernel", 500, 300, 340, 3)   # attention, inner
    ev += kernel("sgemm_kernel", 650, 340, 400, 4)     # attention, outer
    ev += kernel("add_kernel", 800, 800, 810, 5)       # forward
    ev += kernel("late_kernel", 1500, 1500, 1600, 6)   # after the batch
    ev.append(Ev("Memcpy HtoD", 60, 150, device="CUDA", corr=7))
    return ev


def summary(with_program=True, group_of=None):
    return program_spans.summarize(
        program_spans.from_events(events(with_program)), group_of)


def test_a_kernel_goes_to_the_innermost_span_at_its_launch():
    s = summary()
    ns = 1e-9
    assert s["kernel_s"] == pytest.approx((20 + 90 + 40 + 60 + 10) * ns)
    assert s["innermost"] == pytest.approx({
        "lqer.quantize": 20 * ns, "lqer.linear:largeM": 90 * ns,
        "lqer.attention:eager": 100 * ns, "lqer.forward": 10 * ns})
    # the innermost spans and the kernels in none add up to the batches'
    assert sum(s["innermost"].values()) == pytest.approx(s["kernel_s"])
    assert s["quantize_by_parent"] == pytest.approx(
        {"lqer.linear:largeM": 20 * ns})
    assert s["batches"] == 1
    assert s["names"] == ["lqer.attention:eager", "lqer.forward",
                          "lqer.linear:largeM", "lqer.prologue",
                          "lqer.quantize"]


def test_nested_spans_count_toward_each_enclosing_name_once():
    s = summary()
    ns = 1e-9
    names = program_spans.by_name(s)
    assert names["lqer.forward"] == pytest.approx(s["kernel_s"])
    assert names["lqer.linear:largeM"] == names["lqer.linear"] == \
        pytest.approx(110 * ns)
    # an attention inside an attention of the same name counts once
    assert names["lqer.attention:eager"] == names["lqer.attention"] == \
        pytest.approx(100 * ns)
    assert program_spans.inside(
        s, lambda n: program_spans.layer(n) in ("lqer.linear",
                                                "lqer.attention")) == \
        pytest.approx(210 * ns)


def test_kernel_groups_per_span():
    s = summary(group_of=lambda k: ["linear"] if "gemm" in k else [])
    ns = 1e-9
    assert s["groups"]["lqer.attention:eager"] == pytest.approx(
        {"linear": 60 * ns})
    assert s["groups"]["lqer.linear:largeM"] == pytest.approx(
        {"linear": 90 * ns})


def test_an_idle_stretch_is_named_by_the_span_at_its_middle():
    s = summary()
    ns = 1e-9
    # busy: [60, 260] (the copy, then three kernels), [300, 400], [800, 810]
    assert s["window_s"] == pytest.approx(1000 * ns)
    assert s["busy_s"] == pytest.approx((200 + 100 + 10) * ns)
    assert s["idle"] == pytest.approx({
        "lqer.prologue": 60 * ns,            # [0, 60], middle 30
        "lqer.linear:largeM": 40 * ns,       # [260, 300], middle 280
        "lqer.attention:eager": 400 * ns,    # [400, 800], middle 600
        "-": 190 * ns})                      # [810, 1000], middle 905


def test_summary_needs_a_batch_a_kernel_and_a_span():
    assert summary(with_program=False) is None
    no_batch = [e for e in events() if e.name() != "bench.batch"]
    assert program_spans.summarize(program_spans.from_events(no_batch)) \
        is None


def _ctx(evs):
    spec = spec_mod.load_config("tiny-mistral", config_path("tiny-mistral"))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    spans = Spans()
    spans.phase = "trace"
    with spans.span("batch"):
        pass
    return types.SimpleNamespace(
        prof=prof, spec=spec, mix=MIXES["eval"], spans=spans,
        peaks=peak_rates("NVIDIA H100 80GB HBM3"), groups=None)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_program_spans(name):
    assert reader(name)(_ctx(events(with_program=False))) is None
    assert reader(name)(types.SimpleNamespace(prof=None)) is None


def test_readers_on_the_spans():
    ctx = _ctx(events())
    k = 220.0
    assert reader("quantize_share.eval")(ctx) == pytest.approx(100 * 20 / k)
    assert reader("attn_share.eval")(ctx) == pytest.approx(100 * 100 / k)
    assert reader("prologue_idle_ms.eval")(ctx) == pytest.approx(60e-6)
    assert reader("linear_span_roofline.eval")(ctx) == pytest.approx(
        100 * batch_bounds(ctx, "linear") / 110e-9)
    # read once a run
    assert ctx._program_spans is program_spans.of(ctx)


def test_a_dump_reads_back_the_same_summary(tmp_path):
    path = tmp_path / "events.json.gz"
    program_spans.dump(events(), path)
    back = program_spans.load_dump(path)
    assert program_spans.summarize(program_spans.from_events(back)) == \
        summary()
