"""PyTorch/CUDA port of ``lqer_tpu`` for an NVIDIA H100 (Hopper, sm_90a).

The JAX package ``lqer_tpu`` is the reference; this package mirrors its
module layout (``ops/``, ``ops/kernels/``, ``models/``, ``serving/``,
``parallel/``) so every module's counterpart is easy to find. It imports
``torch`` and numpy only, never ``jax`` or ``lqer_tpu``.

Every Pallas kernel on the ported path has a hand-written CUDA C++ kernel
under ``csrc/`` with a plain PyTorch version beside its wrapper in
``ops/kernels/``. A wrapper runs the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
