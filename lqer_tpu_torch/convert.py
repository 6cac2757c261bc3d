"""Weights carried across from the JAX package, through numpy.

* :func:`params_from_jax` turns the JAX flat ``{hf_name: array}`` dict into
  torch tensors.
* :func:`backend_from_jax` turns a JAX ``prepare_serving_params`` (plus
  ``pack_lm_head``) backend, its arrays as numpy, into the port's packed
  layout: the tile-major K-split slabs are read back to codes and exponents
  and repacked as ``ops/storage.py`` words, bit for bit.

Neither imports JAX: the caller hands over numpy arrays and the JAX meta
dicts, whose format objects are read by attribute only.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.storage import MXFormat, codes_exps_from_jax_tiles, pack_weight


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(params_np: dict) -> dict:
    return {k: _tensor(v) for k, v in params_np.items()}


def _entry_from_jax(arrays: dict, fmt: MXFormat, tile_k: int) -> dict:
    tiles = _tensor(arrays["tiles"])
    stacked = tiles.ndim == 5
    layers = list(tiles) if stacked else [tiles]
    packs = [pack_weight(*codes_exps_from_jax_tiles(t, tile_k, fmt), fmt)
             for t in layers]
    out = {k: (torch.stack([p[k] for p in packs]) if stacked else packs[0][k])
           for k in ("codes", "exps")}
    for k in ("a", "b"):
        out[k] = None if arrays.get(k) is None else \
            _tensor(arrays[k]).to(torch.bfloat16)
    bias = arrays.get("bias")
    out["bias"] = None if bias is None else \
        _tensor(bias).to(torch.float32).squeeze(-2)  # (.., 1, N) -> (.., N)
    return out


def backend_from_jax(arrays_np: dict, meta: dict) -> dict:
    """JAX backend ``{"arrays", "meta"}`` (arrays as numpy) → the port's
    backend. MLP-megakernel entries (``fuse_mlp=True``) are refused: their
    kernel is not ported yet."""
    arrays, out_meta = {}, {}
    for key, m in meta.items():
        if m.get("kind") == "mlp":
            raise NotImplementedError(
                f"{key}: MLP-megakernel packing is not ported; pack the JAX "
                "backend with fuse_mlp=False")
        fmt = MXFormat(width=m["fmt"].width,
                       exponent_width=m["fmt"].exponent_width,
                       group_size=m["fmt"].group_size)
        arrays[key] = _entry_from_jax(arrays_np[key], fmt, m["tile_k"])
        out_meta[key] = {"fmt": fmt, "xa_width": m["xa_width"],
                         "out_width": m["out_width"]}
        for extra in ("splits", "n_real"):
            if extra in m:
                out_meta[key][extra] = m[extra]
    return {"arrays": arrays, "meta": out_meta}
