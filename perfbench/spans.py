"""The benchmark's own spans: host-clock intervals around the calls it
makes into the program, each also a ``record_function("bench.<name>")``
range while the profiler records. The program itself carries no span."""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self):
        self.items = []     # {"name", "t0", "t1", "phase", **info}
        self.phase = "setup"

    @contextlib.contextmanager
    def span(self, name: str, **info):
        rec = None
        if self.phase == "trace":
            from torch.profiler import record_function

            rec = record_function(f"bench.{name}")
            rec.__enter__()
        t0 = time.perf_counter()
        item = {"name": name, "t0": t0, "t1": None, "phase": self.phase,
                **info}
        try:
            yield item
        finally:
            item["t1"] = time.perf_counter()
            if rec is not None:
                rec.__exit__(None, None, None)
            self.items.append(item)

    def of(self, name: str, phase: str = "window") -> list:
        return [s for s in self.items if s["name"] == name
                and s["phase"] == phase]
