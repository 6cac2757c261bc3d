"""The program's own spans in the traced phase: each device event tied to
the ``lqer.*`` spans (``lqer_tpu_torch/utils/tracing.py``) open on the host
when it was launched.

The profiler keeps its events after the one chrome export ``trace.py``
makes: ``ctx.prof.profiler.kineto_results.events()``, read once a run and
cached on ``ctx``. As in ``trace.read``, a device event is tied by its
correlation id to the host time of the runtime call that launched it (its
own start where none is found), only kernels launched inside a traced
``bench.batch`` span count, the traced window runs from the first
``bench.*`` span's start to the last one's end, and idle stretches are the
window less the union of device intervals. ::

    python3 -m perfbench.program_spans --workload <cell> --seed <n> \
        [--seconds 51] [--dump events.json.gz]

runs the cell once with ``--trace 1`` and prints the breakdown
(:func:`breakdown`) as one JSON line, beside ``trace.read``'s kernel time
of the same batches; ``--dump`` writes the profiler's events, which
:func:`load_dump` reads back for :func:`from_events`."""

from __future__ import annotations

import argparse
import gzip
import json
import sys
from collections import defaultdict

from .stats import union

FIELDS = ("name", "start_ns", "duration_ns", "device_type", "correlation_id",
          "is_user_annotation")
PREFIX = "lqer."
QUANTIZE = "lqer.quantize"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def layer(name: str) -> str:
    """A span name without its ``:<kind>``."""
    return name.split(":", 1)[0]


def _kind(ev) -> str:
    """The chrome trace's category of a profiler event: ``user_annotation``
    (a span on the host), ``cuda_runtime`` (a launch), a device kind, or
    ``other`` (a host operator, a span's range on the device's
    timeline)."""
    name = ev.name()
    if "CPU" in str(ev.device_type()).upper():
        if ev.is_user_annotation():
            return "user_annotation"
        return "cuda_runtime" if name.startswith("cu") else "other"
    if ev.is_user_annotation():
        return "other"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def from_events(events) -> dict:
    """Profiler events (``name()``, ``start_ns()``, ``duration_ns()``,
    ``device_type()``, ``correlation_id()``, ``is_user_annotation()``) as ``spans`` (the ``lqer.*`` ranges),
    ``bench`` (the ``bench.*`` ranges, without the prefix), ``launch``
    (correlation id → host time) and ``device`` ((start, end, kind, host
    time of the launch, name)); times in integer ns, the profiler's own."""
    spans, bench, launch, dev = [], [], {}, []
    for ev in events:
        kind = _kind(ev)
        t0 = int(ev.start_ns())
        t1 = t0 + int(ev.duration_ns())
        if kind == "user_annotation":
            name = ev.name()
            if name.startswith(PREFIX):
                spans.append((t0, t1, name))
            elif name.startswith("bench."):
                bench.append((t0, t1, name[len("bench."):]))
        elif kind == "cuda_runtime":
            launch[ev.correlation_id()] = t0
        elif kind in DEVICE_KINDS:
            dev.append((t0, t1, kind, ev.correlation_id(), ev.name()))
    device = [(s, e, k, launch.get(c, s), n) for s, e, k, c, n in dev]
    return {"spans": spans, "bench": bench, "device": device}


def _open_at(spans, times):
    """For each of ``times`` (ascending), the names of the spans open at it
    (ends included), outermost first."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(order) and order[j][0] <= t:
            stack.append(order[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(s[2] for s in stack if s[1] >= t))
    return out


def summarize(parsed: dict, group_of=None) -> dict | None:
    """The kernels launched inside the traced batches (:func:`from_events`,
    times in ns) by the spans open at their launch, and the traced window's
    idle stretches by the innermost span open at their middle, in seconds.
    None where there is no traced batch, no device event or no ``lqer.*``
    span.

    ``kernel_s``: the batches' kernel seconds; ``sets``: frozenset of the
    distinct span names open at a launch → kernel seconds (a kernel counts
    once for each distinct name); ``innermost``: innermost span name (``-``
    for none) → kernel seconds; ``quantize_by_parent``: the innermost span
    around a ``lqer.quantize`` that is not one → its kernel seconds;
    ``groups``: span name → ``group_of(kernel name)`` group → seconds;
    ``idle``: innermost span at the middle (``-`` for none) → idle
    seconds; ``names``: every span name the trace holds; ``batches``,
    ``window_s``, ``busy_s``."""
    spans, device = parsed["spans"], parsed["device"]
    batches = sorted((s, e) for s, e, n in parsed["bench"] if n == "batch")
    if not spans or not device or not batches:
        return None
    lo = min(s for s, _, _ in parsed["bench"])
    hi = max(e for _, e, _ in parsed["bench"])

    def in_batch(t):
        return any(s <= t <= e for s, e in batches)

    kernels = sorted((k for k in device if k[2] == "kernel"
                      and k[1] >= lo and k[0] <= hi and in_batch(k[3])),
                     key=lambda k: k[3])
    sets, innermost = defaultdict(float), defaultdict(float)
    by_parent = defaultdict(float)
    groups = defaultdict(lambda: defaultdict(float))
    kernel_s = 0.0
    for k, names in zip(kernels, _open_at(spans, [k[3] for k in kernels])):
        secs = (k[1] - k[0]) * 1e-9
        kernel_s += secs
        sets[frozenset(names)] += secs
        innermost[names[-1] if names else "-"] += secs
        if QUANTIZE in names:
            outer = [n for n in names if n != QUANTIZE]
            by_parent[outer[-1] if outer else "-"] += secs
        if group_of is not None:
            for g in group_of(k[4]):
                for n in set(names):
                    groups[n][g] += secs
    busy = union([(s, e) for s, e, *_ in device], lo, hi)
    gaps = [(a[1], b[0]) for a, b in zip([[lo, lo]] + busy, busy + [[hi, hi]])
            if b[0] > a[1]]
    gaps.sort(key=lambda g: g[0] + g[1])
    idle = defaultdict(float)
    for (s, e), names in zip(gaps, _open_at(spans, [(s + e) // 2
                                                    for s, e in gaps])):
        idle[names[-1] if names else "-"] += (e - s) * 1e-9
    return {"kernel_s": kernel_s, "sets": dict(sets),
            "innermost": dict(innermost), "quantize_by_parent": dict(by_parent),
            "groups": {n: dict(g) for n, g in groups.items()},
            "idle": dict(idle), "names": sorted({n for _, _, n in spans}),
            "batches": len(batches),
            "window_s": (hi - lo) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9}


def inside(summary: dict, pred) -> float:
    """Kernel seconds launched inside any span whose name satisfies
    ``pred``, each kernel once."""
    return sum(v for names, v in summary["sets"].items()
               if any(pred(n) for n in names))


def by_name(summary: dict) -> dict:
    """Inclusive kernel seconds per span name and per layer (the name
    without its kind)."""
    out = defaultdict(float)
    for names, v in summary["sets"].items():
        for n in names | {layer(n) for n in names}:
            out[n] += v
    return dict(out)


def of(ctx) -> dict | None:
    """The traced phase's :func:`summarize`, read once a run (None without
    a trace or without the program's spans)."""
    if "_program_spans" not in vars(ctx):
        prof = getattr(ctx, "prof", None)
        summary = None
        if prof is not None:
            try:
                events = prof.profiler.kineto_results.events()
            except (AttributeError, RuntimeError):
                events = None
            if events:
                groups = getattr(ctx, "groups", None)
                summary = summarize(from_events(events),
                                    groups.of if groups else None)
        ctx._program_spans = summary
    return ctx._program_spans


def breakdown(summary: dict) -> dict:
    """The summary per traced batch, in ms: kernel time by span name and
    layer (inclusive) and by innermost span, the quantizers by parent span,
    each span's kernel groups, idle by innermost span."""
    n = summary["batches"]

    def ms(d):
        return {k: round(v * 1e3 / n, 3) for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])}

    return {"batches": n, "kernel_ms": round(summary["kernel_s"] * 1e3 / n, 3),
            "by_name": ms(by_name(summary)),
            "innermost": ms(summary["innermost"]),
            "quantize_by_parent": ms(summary["quantize_by_parent"]),
            "groups": {k: ms(v) for k, v in summary["groups"].items()},
            "idle": ms(summary["idle"]),
            "window_ms": round(summary["window_s"] * 1e3 / n, 3),
            "busy_ms": round(summary["busy_s"] * 1e3 / n, 3)}


def dump(events, path) -> None:
    """The events' :data:`FIELDS`, one JSON list each, gzipped."""
    with gzip.open(path, "wt") as f:
        for ev in events:
            row = []
            for k in FIELDS:
                v = getattr(ev, k, None)
                v = v() if v is not None else None
                row.append(v if isinstance(v, (int, float, bool, str,
                                               type(None))) else str(v))
            f.write(json.dumps(row) + "\n")


class _Dumped:
    """An event read back from :func:`dump`."""

    def __init__(self, row):
        self._row = dict(zip(FIELDS, row))

    def __getattr__(self, k):
        if k.startswith("_"):
            raise AttributeError(k)
        return lambda: self._row[k]


def load_dump(path) -> list:
    with gzip.open(path, "rt") as f:
        return [_Dumped(json.loads(line)) for line in f]


def main(argv=None) -> int:
    from . import run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--dump", default=None)
    args = p.parse_args(argv)
    run.cache_env()
    held = []
    res = run.run_cell(args.workload, args.seed, args.seconds, True, "cuda",
                       hooks=held.append)
    ctx = held[0].ctx
    summary = of(ctx)
    if args.dump:
        dump(ctx.prof.profiler.kineto_results.events(), args.dump)
    host = [x["t1"] - x["t0"] for x in ctx.spans.of("batch", phase="trace")]
    out = {"workload": args.workload, "seed": args.seed,
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "correct": res["correct"],
           "batch_host_ms": [round(h * 1e3, 3) for h in host],
           "trace_batch_kernel_ms": None, "spans": None}
    t = ctx.trace and ctx.trace["spans"].get("batch")
    if t:
        out["trace_batch_kernel_ms"] = round(t["kernel_s"] * 1e3 / t["n"], 3)
    if summary is not None:
        out["spans"] = breakdown(summary)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
