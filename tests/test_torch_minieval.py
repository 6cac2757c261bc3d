"""The port's copy of minieval (``lqer_tpu_torch.evaluate.minieval``)
against the JAX package's, as ``tests/test_minieval.py`` drives it: the
``Instance`` protocol field for field, the task registry (the same
fixtures in the same order), every ``tiny_*`` task through
``simple_evaluate`` on the same numpy forward (the port's adapter against
the JAX one), few-shot contexts, ``limit``, unknown task names,
``make_table`` and the artifact's keys. The scoring is numpy on equal
logits, so every result equals JAX's exactly.
"""

import dataclasses
import json

import numpy as np
import pytest

from lqer_tpu.evaluate import minieval as jmini
from lqer_tpu_torch.evaluate import minieval as tmini
from lqer_tpu_torch.evaluate.harness import TorchCausalLM
from lqer_tpu_torch.testing import one_torch_thread_fixture

from test_torch_harness_adapter import LOGITS, _pair

_one_torch_thread = one_torch_thread_fixture()


def test_instance_protocol_matches_jax():
    """Field for field lm_eval v0.4's ``Instance``: metadata unpacked in
    ``__post_init__``, ``args`` tuple-wraps a scalar, empty responses."""
    fields = [f.name for f in dataclasses.fields(tmini.Instance)]
    assert fields == [f.name for f in dataclasses.fields(jmini.Instance)]
    for args in (("ctx", " cont"), "just-a-string"):
        kw = dict(request_type="loglikelihood", doc={"q": 1}, arguments=args,
                  idx=2, metadata=("taskname", 7, 3))
        ours, theirs = tmini.Instance(**kw), jmini.Instance(**kw)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.args == theirs.args
        assert (ours.task_name, ours.doc_id, ours.repeats) == \
            ("taskname", 7, 3)
        assert ours.resps == [] and ours.filtered_resps == {}
    assert tmini.Instance("generate_until", {}, "s", 0).args == ("s",)
    assert sorted(tmini.LM.__abstractmethods__) == sorted(
        jmini.LM.__abstractmethods__)


def test_task_registry_matches_jax():
    """The same task names in the same order, each with the same output
    type, docs and requests at 0 and 2 shots."""
    assert list(tmini.TASK_REGISTRY) == list(jmini.TASK_REGISTRY)
    for name in tmini.TASK_REGISTRY:
        ours, theirs = tmini.TASK_REGISTRY[name](), jmini.TASK_REGISTRY[name]()
        assert (ours.name, ours.output_type, ours.docs, ours.VERSION) == \
            (theirs.name, theirs.output_type, theirs.docs, theirs.VERSION)
        for shots in (0, 2):
            a = [dataclasses.asdict(i) for i in ours.build_all_requests(shots)]
            b = [dataclasses.asdict(i)
                 for i in theirs.build_all_requests(shots)]
            assert a == b, (name, shots)


@pytest.mark.parametrize("kind", sorted(LOGITS))
def test_simple_evaluate_all_tiny_tasks_matches_jax(kind):
    """Every tiny task in one evaluation: the port's results dict equals
    JAX's (accuracies, perplexities, stderrs, versions, configs), with
    both metric spellings and finite values; the artifact is
    JSON-serialisable; ``make_table`` prints the same table."""
    jlm, tlm = _pair(kind, max_length=64, batch_size=4)
    tasks = sorted(tmini.TASK_REGISTRY)
    out = tmini.simple_evaluate(tlm, tasks, num_fewshot=0)
    assert out == jmini.simple_evaluate(jlm, tasks, num_fewshot=0)
    assert set(out) >= {"results", "versions", "n-shot", "configs"}
    assert set(out["results"]) == set(tasks)
    for task in tasks:
        metrics = out["results"][task]
        bare = [k for k in metrics
                if k != "alias" and "," not in k and not k.endswith("_stderr")]
        assert bare, task
        for k in bare:
            assert f"{k},none" in metrics and f"{k}_stderr" in metrics
            assert np.isfinite(metrics[k])
    for t in ("tiny_arc_easy", "tiny_boolq", "tiny_piqa"):
        assert 0.0 <= out["results"][t]["acc"] <= 1.0
    json.dumps(out)
    assert tmini.make_table(out) == jmini.make_table(out)
    assert "tiny_arc_easy" in tmini.make_table(out)


def test_fewshot_lengthens_contexts():
    """``num_fewshot > 0`` lengthens the scored contexts, as in JAX."""
    captured = []

    class SpyLM(TorchCausalLM):
        def loglikelihood(self, requests):
            captured.extend(len(r.args[0]) for r in requests)
            return super().loglikelihood(requests)

    _, tlm = _pair("uniform", max_length=128)
    lm = SpyLM(tlm.forward_fn, tlm.tokenizer, max_length=128, device="cpu")
    tmini.simple_evaluate(lm, ["tiny_boolq"], num_fewshot=0)
    len0 = max(captured)
    captured.clear()
    out = tmini.simple_evaluate(lm, ["tiny_boolq"], num_fewshot=2)
    assert max(captured) > len0
    jlm, _ = _pair("uniform", max_length=128)
    assert out == jmini.simple_evaluate(jlm, ["tiny_boolq"], num_fewshot=2)


def test_limit_and_unknown_task():
    jlm, tlm = _pair("seeded", max_length=64)
    out = tmini.simple_evaluate(tlm, ["tiny_arc_easy"], limit=2)
    assert out == jmini.simple_evaluate(jlm, ["tiny_arc_easy"], limit=2)
    assert out["configs"]["tiny_arc_easy"]["num_docs"] == 8  # whole fixture
    with pytest.raises(KeyError):
        tmini.simple_evaluate(tlm, ["arc_easy"])  # real names need lm_eval
