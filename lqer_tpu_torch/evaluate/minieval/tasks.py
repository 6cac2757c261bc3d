"""Bundled tiny tasks exercising every request type of the harness protocol
(a copy of ``lqer_tpu/evaluate/minieval/tasks.py``: the same fixtures in
the same order).

Shapes mirror the 0-shot suite of the experiment templates
(``harness_downstream.datasets`` of ``experiments/configs/``):
multiple-choice loglikelihood (arc_easy/arc_challenge/openbookqa: 4-way,
piqa/winogrande: 2-way, boolq: yes/no), lambada-style last-word scoring
(acc from greedy match + perplexity), plus one ``generate_until`` task to
cover the generation path. Fixture data is synthetic and deterministic —
these validate protocol + plumbing offline, not model quality (hence the
``tiny_`` prefix; real benchmark numbers require real lm_eval + datasets).
"""

from __future__ import annotations

import math

from .api import Instance


def _mean(xs):
    return sum(xs) / len(xs) if xs else 0.0


def _stderr(xs):
    n = len(xs)
    if n < 2:
        return 0.0
    m = _mean(xs)
    var = sum((x - m) ** 2 for x in xs) / (n - 1)
    return math.sqrt(var / n)


class MiniTask:
    """A configurable task mirroring lm_eval's ConfigurableTask flow:
    ``build_all_requests`` emits :class:`Instance` objects; after the model
    fills ``resps``, ``process_results(doc, results)`` maps each doc's
    responses to per-doc metric values; docs aggregate by mean + stderr."""

    VERSION = 0

    def __init__(self, name: str, output_type: str, docs: list[dict]):
        self.name = name
        self.output_type = output_type
        self.docs = docs

    # -- prompt construction ------------------------------------------------
    def doc_to_text(self, doc: dict) -> str:
        return doc["query"]

    def doc_to_target(self, doc: dict) -> str:
        if self.output_type == "multiple_choice":
            return " " + doc["choices"][doc["gold"]]
        return " " + doc["answer"]

    def _fewshot_context(self, doc: dict, num_fewshot: int) -> str:
        if num_fewshot <= 0:
            return self.doc_to_text(doc)
        shots = [d for d in self.docs if d is not doc][:num_fewshot]
        parts = [
            self.doc_to_text(d) + self.doc_to_target(d) for d in shots
        ]
        return "\n\n".join(parts + [self.doc_to_text(doc)])

    # -- request construction ------------------------------------------------
    def build_all_requests(self, num_fewshot: int = 0) -> list[Instance]:
        instances: list[Instance] = []
        for doc_id, doc in enumerate(self.docs):
            if self.output_type == "loglikelihood_rolling":
                instances.append(Instance(
                    request_type="loglikelihood_rolling",
                    doc=doc,
                    arguments=(doc["text"],),
                    idx=0,
                    metadata=(self.name, doc_id, 1),
                ))
                continue
            ctx = self._fewshot_context(doc, num_fewshot)
            if self.output_type == "multiple_choice":
                for idx, choice in enumerate(doc["choices"]):
                    instances.append(Instance(
                        request_type="loglikelihood",
                        doc=doc,
                        arguments=(ctx, " " + choice),
                        idx=idx,
                        metadata=(self.name, doc_id, 1),
                    ))
            elif self.output_type == "loglikelihood":
                # lambada-style: score the target continuation; acc = greedy
                instances.append(Instance(
                    request_type="loglikelihood",
                    doc=doc,
                    arguments=(ctx, " " + doc["answer"]),
                    idx=0,
                    metadata=(self.name, doc_id, 1),
                ))
            elif self.output_type == "generate_until":
                instances.append(Instance(
                    request_type="generate_until",
                    doc=doc,
                    arguments=(ctx, {"until": ["\n"], "max_gen_toks": 8}),
                    idx=0,
                    metadata=(self.name, doc_id, 1),
                ))
            else:  # pragma: no cover
                raise ValueError(self.output_type)
        return instances

    # -- scoring --------------------------------------------------------------
    def process_results(self, doc: dict, results: list) -> dict:
        if self.output_type == "multiple_choice":
            lls = [r[0] for r in results]
            pred = max(range(len(lls)), key=lls.__getitem__)
            lengths = [max(len(c), 1) for c in doc["choices"]]
            norm = [ll / ln for ll, ln in zip(lls, lengths)]
            pred_norm = max(range(len(norm)), key=norm.__getitem__)
            return {
                "acc": float(pred == doc["gold"]),
                "acc_norm": float(pred_norm == doc["gold"]),
            }
        if self.output_type == "loglikelihood":
            ll, is_greedy = results[0]
            return {"acc": float(is_greedy), "perplexity": math.exp(-ll)}
        if self.output_type == "generate_until":
            text = results[0].strip()
            return {"exact_match": float(text == doc["answer"])}
        if self.output_type == "loglikelihood_rolling":
            (ll,) = results
            words = max(len(doc["text"].split()), 1)
            return {"word_perplexity": math.exp(-ll / words)}
        raise ValueError(self.output_type)  # pragma: no cover

    def aggregate(self, per_doc: list[dict]) -> dict:
        out = {}
        for metric in per_doc[0]:
            vals = [d[metric] for d in per_doc]
            out[metric] = _mean(vals)
            out[f"{metric}_stderr"] = _stderr(vals)
        return out


# ---------------------------------------------------------------------------
# fixture data — deterministic, content-free protocol exercisers
# ---------------------------------------------------------------------------
_COLORS = ["red", "green", "blue", "yellow"]
_OBJECTS = ["apple", "leaf", "sky", "sun", "rose", "grass", "sea", "lemon"]
_PAIRS = list(zip(_OBJECTS, [0, 1, 2, 3, 0, 1, 2, 3]))


def _mc4(name: str) -> MiniTask:
    docs = [
        {
            "query": f"Question: What color is the {obj}?\nAnswer:",
            "choices": _COLORS,
            "gold": gold,
        }
        for obj, gold in _PAIRS
    ]
    return MiniTask(name, "multiple_choice", docs)


def _mc2(name: str, choices: list[str]) -> MiniTask:
    docs = [
        {
            "query": f"Statement: the {obj} is {_COLORS[gold]}. "
                     f"True or false?\nAnswer:",
            "choices": choices,
            "gold": gold % 2,
        }
        for obj, gold in _PAIRS
    ]
    return MiniTask(name, "multiple_choice", docs)


def _lambada(name: str) -> MiniTask:
    docs = [
        {
            "query": f"The {obj} in the garden was very",
            "answer": _COLORS[gold],
        }
        for obj, gold in _PAIRS
    ]
    return MiniTask(name, "loglikelihood", docs)


def _gen(name: str) -> MiniTask:
    docs = [
        {
            "query": f"Repeat the word '{obj}':",
            "answer": obj,
        }
        for obj, _ in _PAIRS
    ]
    return MiniTask(name, "generate_until", docs)


def _rolling(name: str) -> MiniTask:
    docs = [
        {"text": f"The {obj} is {_COLORS[gold]} and the garden is full."}
        for obj, gold in _PAIRS[:4]
    ]
    return MiniTask(name, "loglikelihood_rolling", docs)


TASK_REGISTRY = {
    "tiny_arc_easy": lambda: _mc4("tiny_arc_easy"),
    "tiny_arc_challenge": lambda: _mc4("tiny_arc_challenge"),
    "tiny_openbookqa": lambda: _mc4("tiny_openbookqa"),
    "tiny_piqa": lambda: _mc2("tiny_piqa", ["true", "false"]),
    "tiny_winogrande": lambda: _mc2("tiny_winogrande", ["he", "she"]),
    "tiny_boolq": lambda: _mc2("tiny_boolq", ["yes", "no"]),
    "tiny_lambada_openai": lambda: _lambada("tiny_lambada_openai"),
    "tiny_gen": lambda: _gen("tiny_gen"),
    "tiny_wikitext": lambda: _rolling("tiny_wikitext"),
}
