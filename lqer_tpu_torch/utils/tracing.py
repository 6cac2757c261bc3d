"""Runtime tracing through ``torch.profiler`` (port of
``lqer_tpu/utils/tracing.py``, which wraps ``jax.profiler``).

:func:`trace` profiles a block (the host's operators, and the card's
kernels where there is one) and writes a chrome trace,
``<trace_dir>/trace.json``, readable in ``chrome://tracing`` or Perfetto;
:func:`annotate` names a function's span in such a trace
(``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import functools
from pathlib import Path

from .logging import get_logger

logger = get_logger("tracing")


@contextlib.contextmanager
def trace(trace_dir: str | None, step_name: str = "lqer"):
    """Profile the block into ``<trace_dir>/trace.json`` under a span named
    ``step_name`` (a no-op when ``trace_dir`` is None). The card, where
    there is one, is synchronised before the profile ends, so its kernels
    land in the trace."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    path = Path(trace_dir)
    path.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    logger.info("capturing trace of %s into %s", step_name, path)
    with profile(activities=activities) as prof:
        with record_function(step_name):
            yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / "trace.json"))
    logger.info("trace saved to %s", path / "trace.json")


def annotate(name: str):
    """Decorator: the function runs inside a ``record_function(name)``
    span and returns what it returns."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            from torch.profiler import record_function

            with record_function(name):
                return fn(*a, **k)

        return wrapper

    return deco
