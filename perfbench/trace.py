"""The traced phase of a run: ``torch.profiler`` over a fixed number of
steps, and the reading of its chrome trace.

The benchmark's own spans are ``record_function("bench.<name>")`` ranges
around the engine's and the evaluation's calls (``spans.py``). Each device
event (kernel, memcpy, memset) is tied to the host time of the runtime
call that launched it (the trace's ``correlation`` ids) and so to the span
that launched it. The traced window runs from the first traced span's
start to the last one's end; the device is busy where the union of device
intervals covers it. Idle stretches are named by the span and the
innermost host operator running at their middle."""

from __future__ import annotations

import bisect
import heapq
import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path

from .stats import union

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def kernel_name(key: str) -> str:
    """A kernel key without its return type, namespaces and argument list:
    ``void ns::k<8, 1>(ns::Args)`` gives ``k<8, 1>`` (copied from the port's
    ``chip_smoke.py``)."""
    depth = 0
    for i in range(len(key) - 1, -1, -1):
        if key[i] == ")":
            depth += 1
        elif key[i] == "(":
            depth -= 1
            if depth == 0:
                key = key[:i]
                break
    start, depth = 0, 0
    for i, ch in enumerate(key):
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and (ch == " " or key[i:i + 2] == "::"):
            start = i + (1 if ch == " " else 2)
    return key[start:].strip() or key.strip()


class Groups:
    """``kernel_groups.json``: group name → regular expressions over the
    stripped kernel name; ``port_namespace`` marks the port's own kernels
    (the anonymous namespaces of ``csrc/``)."""

    def __init__(self, path: Path):
        raw = json.loads(Path(path).read_text())
        self.port_tag = raw["port_namespace"]
        self.port_not = raw.get("port_excludes", [])
        self.groups = {g: [re.compile(p) for p in pats]
                       for g, pats in raw["groups"].items()}

    def of(self, name: str) -> list:
        short = kernel_name(name)
        return [g for g, pats in self.groups.items()
                if any(p.search(short) for p in pats)]

    def is_port(self, name: str) -> bool:
        return self.port_tag in name and not any(x in name
                                                 for x in self.port_not)


def profiler(wait: int, active: int):
    """A started ``torch.profiler`` that records host and device activity
    for ``active`` steps after ``wait`` warm-up steps (``.step()`` at each
    step boundary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   schedule=schedule(wait=0, warmup=wait, active=active,
                                     repeat=1))
    prof.start()
    return prof


def export(prof) -> dict:
    """Stop ``prof``, write its chrome trace under ``TMPDIR``, read it
    back and delete it."""
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    return raw


def read(raw, groups: Groups) -> dict | None:
    """The traced window's summary: ``window_s``, ``busy_s``, per span
    name the traced spans and the device seconds of each kernel group
    launched inside them, kernel counts, the top device operations and the
    idle stretches by host context. None where the trace holds no device
    event."""
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    spans, ops, launch, dev = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat == "user_annotation" and name.startswith("bench."):
            spans.append((ts, ts + dur, name[len("bench."):]))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, name))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = ts
        elif cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name, cat,
                        e.get("args", {}).get("correlation")))
    if not dev or not spans:
        return None
    spans.sort()
    lo, hi = spans[0][0], spans[-1][1]
    starts = [s for s, _, _ in spans]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            return i
        return None

    per_span = defaultdict(lambda: {"n": 0, "seconds": 0.0, "kernels": 0,
                                    "groups": defaultdict(float),
                                    "port_s": 0.0, "kernel_s": 0.0,
                                    "device_s": 0.0})
    for _, _, name in spans:
        per_span[name]["n"] += 1
    for s, e, name in spans:
        per_span[name]["seconds"] += (e - s) * 1e-6
    by_op = defaultdict(float)
    for s, e, name, cat, corr in dev:
        if e < lo or s > hi:
            continue
        secs = (e - s) * 1e-6
        by_op[kernel_name(name) if cat == "kernel" else name] += secs
        i = span_at(launch.get(corr, s))
        if i is None:
            continue
        rec = per_span[spans[i][2]]
        rec["device_s"] += secs
        if cat != "kernel":
            continue
        rec["kernels"] += 1
        rec["kernel_s"] += secs
        for g in groups.of(name):
            rec["groups"][g] += secs
        if groups.is_port(name):
            rec["port_s"] += secs
    busy = union([(s, e) for s, e, *_ in dev], lo, hi)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = [(a[1], b[0]) for a, b in zip([[lo, lo]] + busy, busy + [[hi, hi]])
            if b[0] > a[1]]
    idle = _name_gaps(gaps, spans, ops)
    return {
        "window_s": (hi - lo) * 1e-6, "busy_s": busy_s,
        "spans": {k: {**v, "groups": dict(v["groups"])}
                  for k, v in per_span.items()},
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
    }


def _name_gaps(gaps, spans, ops) -> dict:
    """Idle seconds by ``<span>/<innermost host op>`` at each gap's middle
    (``between_spans`` outside the benchmark's spans)."""
    out = defaultdict(float)
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
    ops = sorted(ops)
    sp = sorted(spans)
    heap, j, k = [], 0, 0
    for mid, dur in mids:
        while j < len(ops) and ops[j][0] <= mid:
            s, e, name = ops[j]
            heapq.heappush(heap, (-s, e, name))   # latest start first
            j += 1
        while k < len(sp) - 1 and sp[k + 1][0] <= mid:
            k += 1
        inner = "-"
        for neg_s, e, name in heapq.nsmallest(len(heap), heap):
            if e >= mid:
                inner = name
                break
        heap = [h for h in heap if h[1] >= mid]
        heapq.heapify(heap)
        span = (sp[k][2] if sp and sp[k][0] <= mid <= sp[k][1]
                else "between_spans")
        out[f"{span}/{inner}"] += dur * 1e-6
    return out
