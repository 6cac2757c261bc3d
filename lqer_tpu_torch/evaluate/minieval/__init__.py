"""minieval — a minimal, protocol-faithful vendored lm-evaluation-harness.

The pipeline's harness stage calls ``lm_eval.simple_evaluate`` where
lm_eval is installed; without it, this package runs the same protocol
offline (the port's own copy of ``lqer_tpu/evaluate/minieval``, which
imports nothing of JAX):

* :class:`Instance` reproduces lm_eval v0.4's ``api.instance.Instance``
  dataclass **exactly** (field names, ``metadata`` 3-tuple unpacked in
  ``__post_init__``, the ``args`` property) so any ``LM`` implementation that
  works here works unchanged against real lm_eval.
* :func:`simple_evaluate` follows lm_eval's evaluator flow: build all
  request Instances per task (with fewshot), group by ``request_type``,
  dispatch each group through the model ONCE, write ``resps`` back, then
  per-doc ``process_results`` + mean/stderr aggregation.
* The bundled tasks (:mod:`.tasks`) are tiny self-contained fixtures with
  the same *shapes* as the templates' seven 0-shot tasks (multiple-choice
  loglikelihood, binary yes/no, greedy generation) — they exercise the full
  protocol offline. They are deliberately named ``tiny_*``: their accuracy
  numbers are NOT the published benchmarks. When real lm_eval is installed
  the adapter (:mod:`..harness`) uses it instead.
"""

from .api import Instance, LM
from .evaluator import make_table, simple_evaluate
from .tasks import TASK_REGISTRY, MiniTask

__all__ = [
    "Instance",
    "LM",
    "simple_evaluate",
    "make_table",
    "TASK_REGISTRY",
    "MiniTask",
]
