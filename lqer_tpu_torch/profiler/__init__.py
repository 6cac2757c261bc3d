"""Activation-statistics calibration (port of ``lqer_tpu/profiler``)."""

from .scale import (
    SCALE_CLAMP_MIN,
    ScaleAccumulator,
    batch_mean_abs_tap,
    make_profiled_forward,
)
from .threshold import ThresholdAccumulator, batch_threshold_tap

__all__ = ["SCALE_CLAMP_MIN", "ScaleAccumulator", "ThresholdAccumulator",
           "batch_mean_abs_tap", "batch_threshold_tap",
           "make_profiled_forward"]
