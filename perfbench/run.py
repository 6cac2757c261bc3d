"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with the
cards the cell asks for. The cell names a configuration
(``perfbench/configs/``) and a traffic mix (``perfbench/traffic/``, whose
``kind`` picks ``perfbench/drivers/<kind>.py``); each metric is read by
``perfbench/metrics/<name>.py``. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared beside its limit, also the last lines of standard error).
Without the cards, or where JAX or the JAX package was loaded, it prints
no result and exits with another code than 0."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lqer_tpu")


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; one
    host thread for PyTorch's and OpenMP's pools (the load comes from one
    process whose host work is launching kernels); keep libraries that
    could load JAX from doing so."""
    build = CHECKOUT / "build"
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def manifest() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def cell_of(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_for(man: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: a metric with ``workloads`` where it lists the cell, else where
    the cell reports what it moves."""
    e2e = [m for m in man["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell["name"] in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in reported)]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def limits(workload: str) -> dict:
    """The cell's compared numbers and their limits,
    ``perfbench/limits/<workload>.json`` (``{"limits": {name: limit}}``)."""
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def judge(found: dict, lims: dict, prefix: str = "") -> tuple:
    """``(check, correct)``: each compared number (``found[prefix +
    name]``) beside its limit, and whether every one is there and within
    it. A number that is missing fails."""
    check = {k: {"value": found.get(prefix + k), "limit": v}
             for k, v in lims.items()}
    ok = bool(check) and all(c["value"] is not None
                             and c["value"] <= c["limit"]
                             for c in check.values())
    return check, ok


class Context(types.SimpleNamespace):
    """What a driver and the metric readers see of one run."""

    def start_trace(self):
        from . import trace

        self.prof = trace.profiler(self.trace_wait, self.trace_active)
        self.trace_steps = 0
        self.spans.phase = "trace_warmup"

    def step_trace(self):
        if self.prof is None:
            return
        self.prof.step()
        self.trace_steps += 1
        if self.trace_steps == self.trace_wait:
            self.spans.phase = "trace"
        elif self.trace_steps == self.trace_wait + self.trace_active:
            self.spans.phase = "after_trace"

    def trace_done(self) -> bool:
        return (self.prof is not None
                and self.trace_steps >= self.trace_wait + self.trace_active)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", *, man: dict | None = None,
             config_path=None, mix_override: dict | None = None,
             control: bool = False, t0: float | None = None,
             hooks=None) -> dict:
    """One run of a cell: set-up, the window, the traced phase, the check.
    Returns the result object, with ``_found`` (every number the check
    read) and ``_window`` (count and seconds of the window's spans by
    name); ``device.build_s`` is the part of set-up that built or loaded
    the kernels. ``config_path`` and ``mix_override`` swap in other sizes
    (the CPU tests); ``control`` reads the control's numbers too
    (``compare.CONTROL``) and adds ``_control``: the control's numbers
    beside the same limits and whether it passed them.
    ``hooks(driver)`` runs after set-up (the CPU tests plant faults
    there)."""
    import torch

    from . import spec as spec_mod
    from . import trace as trace_mod
    from .peaks import peak_rates
    from .spans import Spans

    t0 = T0 if t0 is None else t0
    man = manifest() if man is None else man
    cell = cell_of(man, workload)
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    spec = spec_mod.load_config(conf["name"], config_path
                                or CHECKOUT / conf["file"])
    mix = spec_mod.load_json("traffic", cell["traffic"])
    mix.update(mix_override or {})
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    ctx = Context(
        spec=spec, mix=mix, cell=cell, seed=int(seed), seconds=seconds,
        traced=bool(trace), device=dev, control=control, spans=Spans(),
        prof=None, trace_steps=0, trace_wait=mix["trace"]["wait_steps"],
        trace_active=mix["trace"]["active_steps"], peaks=peak_rates(name),
        groups=trace_mod.Groups(HERE / "kernel_groups.json"), trace=None,
        build_s=0.0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        from lqer_tpu_torch.ops.kernels._build import build_all

        torch.set_num_threads(1)
        t_build = time.perf_counter()
        build_all()
        ctx.build_s = time.perf_counter() - t_build
        torch.cuda.reset_peak_memory_stats(dev)
    driver = importlib.import_module(f"perfbench.drivers.{mix['kind']}").Driver(ctx)
    driver.setup()
    if hooks is not None:
        hooks(driver)
    gc.collect()
    gc.freeze()     # set-up's objects leave the collector's scans
    t_open, t_close = driver.run()
    gc.unfreeze()
    ctx.setup_s = t_open - t0
    if ctx.prof is not None:
        ctx.trace = trace_mod.read(trace_mod.export(ctx.prof), ctx.groups)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    ctx.record = driver.record()
    metrics = {}
    for m in metrics_for(man, cell, trace):
        v = load_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    sample = driver.sample()
    driver.free()
    gc.collect()

    found = driver.compare(sample) if sample else {}
    check, ok = judge(found, limits(cell["name"]))
    attempted = ctx.record["attempted"]
    result = {
        "correct": ok,
        "attempted": attempted,
        "failed": 0 if ok else attempted,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": name, "count": int(cell["chips"]),
                   "memory_peak_bytes": peak,
                   "build_s": ctx.build_s},
    }
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace["busy_s"]
        result["device"]["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in ctx.trace["device_ops"]],
            "idle_gaps": [[k, v] for k, v in ctx.trace["idle_gaps"]]}
    result["check"] = check
    result["_found"] = found
    if control:
        result["_control"] = judge(found, limits(cell["name"]), "control.")
    names = sorted({x["name"] for x in ctx.spans.items})
    result["_window"] = {k: (len(ctx.spans.of(k)), sum(
        x["t1"] - x["t0"] for x in ctx.spans.of(k))) for k in names}
    return result


def main(argv=None) -> int:
    cache_env()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    man = manifest()
    cell = cell_of(man, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", man=man)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}; the benchmark "
              "measures the port alone", file=sys.stderr)
        return 3
    from .peaks import power_limit_w

    result["device"]["power_limit_w"] = power_limit_w()
    found = result.pop("_found")
    window = result.pop("_window")
    print(f"perfbench: {args.workload} seed {args.seed}: kernels' build "
          f"{result['device']['build_s']:.2f} s of set-up; spans (count, s) "
          f"{json.dumps(window)}; compared " + json.dumps(
              {k: v for k, v in found.items() if k not in result["check"]}),
          file=sys.stderr)
    for k, c in result["check"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
