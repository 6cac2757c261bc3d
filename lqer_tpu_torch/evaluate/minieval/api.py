"""lm_eval-compatible request/model protocol types.

``Instance`` mirrors lm-evaluation-harness v0.4 ``lm_eval/api/instance.py``
field-for-field (``request_type``, ``doc``, ``arguments``, ``idx``, the
``metadata = (task_name, doc_id, repeats)`` tuple unpacked in
``__post_init__``, mutable ``resps``/``filtered_resps``, and the ``args``
property that tuple-wraps scalar arguments). An ``LM`` written against these
objects runs unchanged under the real harness.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Literal, Optional, Tuple

OutputType = Literal[
    "loglikelihood",
    "loglikelihood_rolling",
    "generate_until",
    "multiple_choice",
]


@dataclass
class Instance:
    request_type: OutputType
    doc: dict
    arguments: tuple
    idx: int
    metadata: Tuple[Optional[str], Optional[int], Optional[int]] = field(
        default_factory=lambda: (None, None, None)
    )
    resps: list = field(default_factory=list)
    filtered_resps: dict = field(default_factory=dict)

    # derived (unpacked from metadata, like lm_eval)
    task_name: Optional[str] = None
    doc_id: Optional[int] = None
    repeats: Optional[int] = None

    def __post_init__(self) -> None:
        self.task_name, self.doc_id, self.repeats = self.metadata

    @property
    def args(self) -> tuple:
        """Request arguments; scalar arguments are tuple-wrapped (matches
        lm_eval's property of the same name)."""
        return (
            self.arguments if isinstance(self.arguments, tuple)
            else (self.arguments,)
        )


class LM(abc.ABC):
    """Abstract model interface (lm_eval ``api/model.py`` signature subset
    actually used by the evaluator): each method takes a list of
    :class:`Instance` and returns one response per instance, in order."""

    @abc.abstractmethod
    def loglikelihood(self, requests: list) -> list:
        """[(ctx, continuation)] -> [(logprob, is_greedy)]"""

    @abc.abstractmethod
    def loglikelihood_rolling(self, requests: list) -> list:
        """[(text,)] -> [logprob]"""

    @abc.abstractmethod
    def generate_until(self, requests: list) -> list:
        """[(ctx, gen_kwargs)] -> [generated_text]"""
