"""Block partitioning for shared-exponent quantization.

Port of ``lqer_tpu/ops/blocking.py``: pad each dim to a multiple of its
block dim, take the interleaved ``(n0, b0, n1, b1, ...)`` reshape view,
reduce over the block axes with ``keepdim`` and let broadcasting carry the
per-block statistic back to every element.

* ``infer_block_shape`` right-aligns ``block_shape`` with the array shape;
  missing leading dims become ``-1``; ``-1`` or oversized entries clamp to
  the dim size.
* ``skip_first_dim=True`` infers against ``[1, *shape[1:]]`` so the first
  block dim is always 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def infer_block_shape(x_shape, block_shape, skip_first_dim: bool = False
                      ) -> list[int]:
    x_shape = list(x_shape)
    if isinstance(block_shape, int):
        block_shape = [block_shape]
    block_shape = list(block_shape)
    shape_for_infer = list(x_shape)
    if skip_first_dim:
        shape_for_infer[0] = 1
    ndim = len(shape_for_infer)
    if len(block_shape) >= ndim:
        eff = block_shape[-ndim:]
    else:
        eff = [-1] * (ndim - len(block_shape)) + block_shape
    return [d if (b == -1 or b > d) else b for b, d in zip(eff, shape_for_infer)]


def padded_shape(x_shape, eff_block) -> list[int]:
    return [-(-d // b) * b for d, b in zip(x_shape, eff_block)]


def pad_to_blocks(x: torch.Tensor, eff_block) -> torch.Tensor:
    target = padded_shape(x.shape, eff_block)
    if list(x.shape) == target:
        return x
    pads: list[int] = []
    for d, t in reversed(list(zip(x.shape, target))):
        pads += [0, t - d]
    return F.pad(x, pads)


def blocked_view(x: torch.Tensor, eff_block) -> torch.Tensor:
    new_shape: list[int] = []
    for d, b in zip(x.shape, eff_block):
        new_shape += [d // b, b]
    return x.reshape(new_shape)


def block_axes(ndim: int) -> tuple[int, ...]:
    return tuple(2 * i + 1 for i in range(ndim))


def per_block_absmax(x: torch.Tensor, block_shape, skip_first_dim=False):
    """``(blocked_x, per_block_absmax, eff_block)``; the absmax keeps dims
    and broadcasts against ``blocked_x``."""
    eff = infer_block_shape(x.shape, block_shape, skip_first_dim)
    v = blocked_view(pad_to_blocks(x, eff), eff)
    bmax = torch.amax(v.abs(), dim=block_axes(x.ndim), keepdim=True)
    return v, bmax, eff


def unblock(blocked: torch.Tensor, x_shape, eff_block) -> torch.Tensor:
    padded = blocked.reshape(padded_shape(x_shape, eff_block))
    return padded[tuple(slice(0, d) for d in x_shape)]
