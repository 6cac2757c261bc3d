"""Runtime tracing through ``torch.profiler`` (port of
``lqer_tpu/utils/tracing.py``, which wraps ``jax.profiler``).

:func:`trace` profiles a block (the host's operators, and the card's
kernels where there is one) and writes a chrome trace,
``<trace_dir>/trace.json``, readable in ``chrome://tracing`` or Perfetto.

:class:`span` names a range of the program in such a trace: while a
``torch.profiler`` records, entering it enters
``torch.profiler.record_function(name)``, so the range shares the
profiler's clock and the correlation ids that tie each kernel to the host
call that launched it, and nests in the span open around it. While no
profiler records, entering and leaving it reads one flag and does nothing
else. :func:`annotate` is its decorator form.

The program's spans are the fixed set :data:`NAMES`, ``lqer.<layer>``
with an optional ``:<kind>``, one shared instance each (below). A name
carries no index and no size: the chrome trace does not export
``record_function``'s arguments. The parent span names the site (a
``lqer.quantize`` inside ``lqer.correction`` is the correction's).

==========================  ==================================================
``lqer.eval.batch``         one batch of ``evaluate_perplexity``: forward,
                            loss, the host read of the loss
``lqer.loss``               ``causal_lm_loss`` and its ``float()``
``lqer.forward``            a whole forward (``models/<arch>.forward``,
                            the engine's step)
``lqer.prologue``           embedding, rotary tables, positions and masks
``lqer.layer``              one decoder layer
``lqer.linear:<kind>``      a quantized linear: ``kernel`` (kernel 1, fewer
                            than 512 rows), ``largeM`` (unpack + dense
                            product), ``emulated`` (``ops/qlinear.qlinear``)
``lqer.mlp:<kind>``         a layer's whole MLP: ``kernel`` (the megakernel)
                            or ``largeM``
``lqer.head``               the head product
``lqer.attention:<kind>``   an attention: ``kernel`` (the prefill or decode
                            kernels) or ``eager`` (PyTorch)
``lqer.correction``         the rank-k LQER correction in PyTorch
``lqer.unpack``             the unpack kernel of the large-M route (row 2)
``lqer.quantize``           every quantizer that runs in PyTorch
``lqer.engine.admit``       ``DecodeEngine._admit_batch``
``lqer.engine.step``        ``DecodeEngine.decode_step``
==========================  ==================================================

A span instance is entered and left in order on the host thread that runs
the forward (the port runs it on one; a mesh's ranks are processes).
"""

from __future__ import annotations

import contextlib
import functools
from pathlib import Path

from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

from .logging import get_logger

logger = get_logger("tracing")


class span:
    """A named range of the program in a ``torch.profiler`` trace
    (``with span_instance:``); a no-op but for one flag read while no
    profiler records."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = []     # the records this instance entered, innermost last

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            rec = record_function(self.name)
            rec.__enter__()
            self._open.append(rec)
        return self

    def __exit__(self, *exc):
        if self._open:
            self._open.pop().__exit__(*exc)
        return False


EVAL_BATCH = span("lqer.eval.batch")
LOSS = span("lqer.loss")
FORWARD = span("lqer.forward")
PROLOGUE = span("lqer.prologue")
LAYER = span("lqer.layer")
LINEAR = {k: span(f"lqer.linear:{k}") for k in ("kernel", "largeM",
                                                 "emulated")}
MLP = {k: span(f"lqer.mlp:{k}") for k in ("kernel", "largeM")}
HEAD = span("lqer.head")
ATTENTION = {k: span(f"lqer.attention:{k}") for k in ("kernel", "eager")}
CORRECTION = span("lqer.correction")
UNPACK = span("lqer.unpack")
QUANTIZE = span("lqer.quantize")
ENGINE_ADMIT = span("lqer.engine.admit")
ENGINE_STEP = span("lqer.engine.step")

NAMES = tuple(s.name for s in (
    EVAL_BATCH, LOSS, FORWARD, PROLOGUE, LAYER, *LINEAR.values(),
    *MLP.values(), HEAD, *ATTENTION.values(), CORRECTION, UNPACK, QUANTIZE,
    ENGINE_ADMIT, ENGINE_STEP))


def annotate(name: str | span):
    """Decorator: the function runs inside the span ``name`` (a
    :class:`span` or a name) and returns what it returns; while no
    profiler records, one flag read."""
    s = name if isinstance(name, span) else span(name)

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*a, **k)
            with s:
                return fn(*a, **k)

        return wrapper

    return deco


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
    from torch.profiler import ProfilerActivity, profile

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
