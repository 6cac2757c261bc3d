"""Offline low-rank approximation of the quantization error (port of
``lqer_tpu/approximate``): ``lqer-svd`` (``A, B ≈ SVD_k((W − W_q)^T)``)
and ``lqer-act`` (L²QER, the SVD of the error scaled by the calibrated
per-channel activation magnitudes)."""

from .approximator import (
    ModelApproximator,
    approximate_weight,
    get_model_approximator,
)

__all__ = ["ModelApproximator", "approximate_weight",
           "get_model_approximator"]
