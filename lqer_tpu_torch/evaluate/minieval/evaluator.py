"""Evaluator: lm_eval's ``simple_evaluate`` flow over the bundled tasks.

Flow parity with lm_eval v0.4 (`evaluator.py` there): build every task's
Instances up front, bucket ALL instances by ``request_type``, dispatch each
bucket through the model once (so the model sees cross-task batches exactly
like the real harness), write ``resps`` back onto the Instances, then group
per (task, doc) and ``process_results`` → aggregate mean/stderr. Output dict
carries the same top-level keys as lm_eval's (the pipeline's
``harness_results.json`` and ``collect.collect_harness`` read ``results``
and per-task ``acc``): ``results``, ``versions``, ``n-shot``, ``configs``.
"""

from __future__ import annotations

from collections import defaultdict

from .api import Instance
from .tasks import TASK_REGISTRY, MiniTask


def simple_evaluate(
    model,
    tasks: list,
    num_fewshot: int = 0,
    limit: int | None = None,
    **_ignored,
) -> dict:
    """Evaluate ``model`` (an ``LM``) on ``tasks`` (names from
    :data:`TASK_REGISTRY` or :class:`MiniTask` objects)."""
    task_objs: dict[str, MiniTask] = {}
    for t in tasks:
        if isinstance(t, MiniTask):
            task_objs[t.name] = t
        elif t in TASK_REGISTRY:
            task_objs[t] = TASK_REGISTRY[t]()
        else:
            raise KeyError(
                f"unknown minieval task {t!r}; available: "
                f"{sorted(TASK_REGISTRY)} (install lm_eval for real tasks)"
            )

    # 1. build all requests
    all_instances: list[Instance] = []
    for task in task_objs.values():
        insts = task.build_all_requests(num_fewshot)
        if limit is not None:
            insts = [i for i in insts if i.doc_id < limit]
        all_instances.extend(insts)

    # 2. bucket by request type, dispatch each bucket once
    buckets: dict[str, list[Instance]] = defaultdict(list)
    for inst in all_instances:
        buckets[inst.request_type].append(inst)
    for rtype, insts in buckets.items():
        resps = getattr(model, rtype)(insts)
        assert len(resps) == len(insts), (rtype, len(resps), len(insts))
        for inst, resp in zip(insts, resps):
            inst.resps.append(resp)
            inst.filtered_resps["none"] = resp

    # 3. per-doc scoring + aggregation
    results: dict[str, dict] = {}
    for name, task in task_objs.items():
        by_doc: dict[int, list[Instance]] = defaultdict(list)
        for inst in all_instances:
            if inst.task_name == name:
                by_doc[inst.doc_id].append(inst)
        per_doc = []
        for doc_id in sorted(by_doc):
            insts = sorted(by_doc[doc_id], key=lambda i: i.idx)
            doc = insts[0].doc
            per_doc.append(
                task.process_results(doc, [i.resps[0] for i in insts])
            )
        agg = task.aggregate(per_doc)
        # both lm_eval 0.3-style bare keys and 0.4-style "metric,filter"
        results[name] = {
            **agg,
            **{f"{k},none": v for k, v in agg.items()},
            "alias": name,
        }

    return {
        "results": results,
        "versions": {name: t.VERSION for name, t in task_objs.items()},
        "n-shot": {name: num_fewshot for name in task_objs},
        "configs": {
            name: {"output_type": t.output_type, "num_docs": len(t.docs)}
            for name, t in task_objs.items()
        },
    }


def make_table(result_dict: dict) -> str:
    """Markdown results table (API parity with
    ``lm_eval.utils.make_table``)."""
    lines = ["|Task|Metric|Value|Stderr|", "|---|---|---:|---:|"]
    for task, metrics in result_dict["results"].items():
        for metric, value in sorted(metrics.items()):
            if metric == "alias" or "," in metric or metric.endswith("_stderr"):
                continue
            stderr = metrics.get(f"{metric}_stderr", 0.0)
            lines.append(f"|{task}|{metric}|{value:.4f}|{stderr:.4f}|")
    return "\n".join(lines)
