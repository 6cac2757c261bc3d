"""LLM.int8()-style outlier census (port of
``lqer_tpu/profiler/threshold.py``): per linear, the count of activation
columns where any ``|x|`` reaches the threshold (6.0 by default), and the
high- and low-precision sub-matrix shapes derived from it."""

from __future__ import annotations

import math

import torch


def batch_threshold_tap(stats: dict, threshold: float):
    """A tap that records this batch's count of high-precision columns
    under ``<name>.threshold``."""

    def tap(name: str, x: torch.Tensor):
        is_large = (x.abs() >= threshold).reshape(-1, x.shape[-1])
        stats[name + ".threshold"] = is_large.any(0).sum()

    return tap


class ThresholdAccumulator:
    """The per-batch column counts, finalised into the shape report."""

    def __init__(self, threshold: float, seq_len: int):
        self.threshold = threshold
        self.seq_len = seq_len
        self.counts: dict[str, list[int]] = {}
        self.weight_shapes: dict[str, tuple[int, int]] = {}

    def register(self, name: str, out_features: int, in_features: int
                 ) -> None:
        self.weight_shapes[name + ".threshold"] = (out_features, in_features)

    def update(self, batch_stats: dict) -> None:
        for name, n in batch_stats.items():
            self.counts.setdefault(name, []).append(int(n))

    def finalize(self) -> dict[str, dict]:
        results = {}
        for name, counts in self.counts.items():
            x_n_cols_hp = math.ceil(sum(counts) / len(counts))
            w_shape = self.weight_shapes.get(name)
            result = {
                "weight_shape": w_shape,
                "threshold": self.threshold,
                "seq_len": self.seq_len,
                "num_activation_columns_in_high_precision": x_n_cols_hp,
                "high_precision_activation_shape": (self.seq_len,
                                                    x_n_cols_hp),
            }
            if w_shape is not None:
                result["high_precision_weight_shape"] = (w_shape[0],
                                                         x_n_cols_hp)
                result["low_precision_weight_shape"] = (
                    w_shape[0], w_shape[1] - x_n_cols_hp)
                result["low_precision_activation_shape"] = (
                    self.seq_len, w_shape[1] - x_n_cols_hp)
            results[name] = result
        return results
