"""Weights carried across from the JAX package, through numpy.

* :func:`params_from_jax` turns the JAX flat ``{hf_name: array}`` dict into
  torch tensors, value for value: the served params, or the dense
  unprepared ones (``models.prepare_ptq`` of them then quantizes exactly
  as the JAX package's does).
* :func:`backend_from_jax` turns a JAX ``prepare_serving_params`` (plus
  ``pack_lm_head``) backend, its arrays as numpy, into the port's packed
  layout: the tile-major K-split slabs are read back to codes and exponents
  and repacked as ``ops/storage.py`` words, bit for bit. MLP-megakernel
  entries (``kind == "mlp"``, packed with ``fuse_mlp=True``: Llama's gated
  MLP, or OPT's relu MLP with its biases and no up half) keep the JAX
  package's zero padding of the intermediate dim.

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


def _words_from_jax(tiles, fmt: MXFormat, tile_k: int) -> dict:
    """Tile-major slabs (``(L, ...)`` when layer-stacked) → ``{codes,
    exps}``."""
    tiles = _tensor(tiles)
    stacked = tiles.ndim == 5
    layers = list(tiles) if stacked else [tiles]
    packs = [pack_weight(*codes_exps_from_jax_tiles(t, tile_k, fmt), fmt)
             for t in layers]
    return {k: (torch.stack([p[k] for p in packs]) if stacked else packs[0][k])
            for k in ("codes", "exps")}


def _bf16(arr):
    return None if arr is None else _tensor(arr).to(torch.bfloat16)


def _bias(arr):
    """A JAX bias (``(.., 1, N)`` f32) → ``(.., N)`` f32."""
    return None if arr is None else \
        _tensor(arr).to(torch.float32).squeeze(-2)


def _mlp_from_jax(arrays: dict, m: dict, fmt: MXFormat) -> dict:
    out = {}
    for half, tiles, tile_k in (("g", "tg", m["tile_k"]),
                                ("u", "tu", m["tile_k"]),
                                ("d", "td", m["tile_k2"])):
        w = ({"codes": None, "exps": None} if arrays.get(tiles) is None
             else _words_from_jax(arrays[tiles], fmt, tile_k))
        out[f"codes_{half}"], out[f"exps_{half}"] = w["codes"], w["exps"]
    for k in ("a_gu", "b_g", "b_u", "a_d", "b_d"):
        out[k] = _bf16(arrays.get(k))
    for k in ("bias_g", "bias_u", "bias_d"):
        out[k] = _bias(arrays.get(k))
    return out


def _entry_from_jax(arrays: dict, fmt: MXFormat, tile_k: int) -> dict:
    out = _words_from_jax(arrays["tiles"], fmt, tile_k)
    for k in ("a", "b"):
        out[k] = _bf16(arrays.get(k))
    out["bias"] = _bias(arrays.get("bias"))
    return out


def backend_from_jax(arrays_np: dict, meta: dict) -> dict:
    """JAX backend ``{"arrays", "meta"}`` (arrays as numpy) → the port's
    backend, with the megakernel entries of ``fuse_mlp=True``."""
    arrays, out_meta = {}, {}
    for key, m in meta.items():
        fmt = MXFormat(width=m["fmt"].width,
                       exponent_width=m["fmt"].exponent_width,
                       group_size=m["fmt"].group_size)
        if m.get("kind") == "mlp":
            arrays[key] = _mlp_from_jax(arrays_np[key], m, fmt)
            out_meta[key] = {"kind": "mlp", "fmt": fmt,
                             **{k: m[k] for k in ("act_width", "xa_width",
                                                  "out_width")}}
            continue
        arrays[key] = _entry_from_jax(arrays_np[key], fmt, m["tile_k"])
        out_meta[key] = {"fmt": fmt, "xa_width": m["xa_width"],
                         "out_width": m["out_width"]}
        for extra in ("splits", "n_real"):
            if extra in m:
                out_meta[key][extra] = m[extra]
    return {"arrays": arrays, "meta": out_meta}
