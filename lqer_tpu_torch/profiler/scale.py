"""Per-channel activation scales (port of ``lqer_tpu/profiler/scale.py``):
per linear and input channel, ``scale = max over batches of
mean over tokens |x|``, finalised with ``clamp(1e-4)`` and then divided by
``sqrt(min · max)``. The forward's ``tap(name, x)`` hook takes each
linear's input; the per-batch reduction runs on the forward's device and
the running max stays there."""

from __future__ import annotations

import torch

SCALE_CLAMP_MIN = 1e-4


def batch_mean_abs_tap(stats: dict):
    """A tap that records each linear's per-channel mean ``|x|`` of this
    batch under ``<name>.scale``, in f32."""

    def tap(name: str, x: torch.Tensor):
        xf = x.to(torch.float32).abs()
        stats[name + ".scale"] = xf.reshape(-1, x.shape[-1]).mean(0)

    return tap


def make_profiled_forward(forward_fn):
    """``forward_fn(params, input_ids, tap=)`` → a function returning
    ``(logits, stats)``."""

    def profiled(params, input_ids):
        stats: dict = {}
        logits = forward_fn(params, input_ids, tap=batch_mean_abs_tap(stats))
        return logits, stats

    return profiled


class ScaleAccumulator:
    """The running max over calibration batches, and the finalised
    scales."""

    def __init__(self):
        self.scales: dict[str, torch.Tensor] = {}

    def update(self, batch_stats: dict) -> None:
        for name, s in batch_stats.items():
            if name in self.scales:
                self.scales[name] = torch.maximum(self.scales[name], s)
            else:
                self.scales[name] = s

    def finalize(self) -> dict[str, torch.Tensor]:
        out = {}
        for name, scale in self.scales.items():
            scale = scale.clamp(min=SCALE_CLAMP_MIN)
            out[name] = scale / torch.sqrt(scale.min() * scale.max())
        return out
