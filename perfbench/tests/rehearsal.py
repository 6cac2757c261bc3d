"""Small mixes and configurations for rehearsing a cell on the CPU: the
drivers, the metric readers and the check at a size a test can hold."""

import copy
from pathlib import Path

HERE = Path(__file__).resolve().parent

MIXES = {
    "serve": {"slots": 4, "max_len": 128, "requests": 24, "block": 4,
              "prompt_tokens": {"dist": "lognormal", "median": 16,
                                "sigma": 0.6, "min": 6, "max": 40},
              "output_tokens": {"dist": "lognormal", "median": 24,
                                "sigma": 0.5, "min": 8, "max": 60,
                                "total_max": 96},
              "warmup_steps": 2, "check": {"requests": 8},
              "trace": {"wait_steps": 1, "active_steps": 2}},
    "eval": {"seq_len": 64, "batch_size": 2, "batches": 64,
             "trace": {"wait_steps": 1, "active_steps": 2}},
}


def config_path(name: str) -> Path:
    return HERE / f"{name}.json"


SERVE_CELL = {"name": "opt6.7b.decode", "config": "opt-6.7b-w4a8-r32",
              "traffic": "sharegpt", "chips": 1,
              "why": "the serving cell kept ready: ShareGPT's lengths on "
                     "64 slots"}


def with_serving(man: dict) -> dict:
    """``man`` (``BENCHMARK.json``) with the serving cell whose mix,
    driver, readers and limits ``perfbench/`` keeps but whose runs spread
    too far to be listed yet (``PERF.md``)."""
    out = copy.deepcopy(man)
    out["workloads"].append(dict(SERVE_CELL))
    return out
