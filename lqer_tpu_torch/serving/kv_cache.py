"""KV caches (port of ``lqer_tpu/serving/kv_cache.py``).

Three layouts, each layer-stacked with a leading layer axis:

- the fp cache (``init_kv_cache``, bf16 or f32): ``k``, ``v`` of shape
  ``(NL, B, KVH, L, d)``, token-major;
- the MXINT cache (``init_quantized_kv_cache``): codes and exponents keep the
  JAX package's token-axis-last layout, codes ``(NL, B, KVH, d, L)`` (MXINT8)
  or ``(NL, B, KVH, d/2, L)`` (MXINT4, nibble-packed d-split: packed row
  ``i`` holds value ``i`` low and ``i + d/2`` high), exps
  ``(NL, B, KVH, d/16, L)``; decode tokens are written straight into
  column ``pos``;
- with ``staged``, the MXINT8 or MXINT4 cache adds a 64-lane staging ring
  of the same row shapes that takes each decode token at lane ``pos % 64``;
  per slot, ``flushed`` (32-aligned) splits positions between the main
  cache ``[0, flushed)`` and the ring ``[flushed, pos]``. The flush and
  :func:`stage_boundary_sync` copy whole code rows, packed or not.

On the card the token-axis-last layout reads consecutive tokens across a
warp in both phases of the decode kernels (``csrc/decode_common.cuh``).

The eager step's writes (:func:`write_layer_rows`, and
:func:`update_layer_cache` / :func:`update_layer_cache_quantized` with the
post-update layer views) are plain PyTorch, as the JAX
package writes them in XLA, and update the cache in place.
"""

from __future__ import annotations

import torch

STAGE_WIDTH = 64  # the flush trigger (residue 48) assumes exactly 64 lanes

MAIN_KEYS = ("k_codes", "k_exps", "v_codes", "v_exps")
STAGE_KEYS = ("k_stage_codes", "k_stage_exps", "v_stage_codes",
              "v_stage_exps")


def init_kv_cache(num_layers: int, batch: int, kv_heads: int, head_dim: int,
                  max_len: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed fp cache ``{"k", "v"}`` of shape (NL, B, KVH, L, d)."""
    shape = (num_layers, batch, kv_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_quantized_kv_cache(num_layers: int, batch: int, kv_heads: int,
                            head_dim: int, max_len: int, group: int = 16,
                            staged: bool = False,
                            stage_width: int = STAGE_WIDTH,
                            code_width: int = 8, device="cuda") -> dict:
    """Zeroed MXINT8 (``code_width=8``) or MXINT4 (``code_width=4``) cache;
    with ``staged`` the 64-lane rings of the same rows and ``flushed``
    too."""
    if code_width not in (4, 8):
        raise ValueError(f"code_width must be 4 or 8 (got {code_width})")
    if head_dim % (group if code_width == 8 else 2 * group):
        raise ValueError(f"head_dim {head_dim} does not split into groups "
                         f"of {group} at code width {code_width}")
    code_rows = head_dim if code_width == 8 else head_dim // 2
    shape_c = (num_layers, batch, kv_heads, code_rows, max_len)
    shape_e = (num_layers, batch, kv_heads, head_dim // group, max_len)
    out = {}
    for side in ("k", "v"):
        out[f"{side}_codes"] = torch.zeros(shape_c, dtype=torch.int8,
                                           device=device)
        out[f"{side}_exps"] = torch.zeros(shape_e, dtype=torch.int8,
                                          device=device)
    if not staged:
        return out
    if stage_width != STAGE_WIDTH:
        raise ValueError(
            f"stage_width must be {STAGE_WIDTH}: the decode step flushes when "
            f"a slot's ring residue reaches 48, which keeps it below 64 lanes "
            f"(got {stage_width})")
    if max_len % 128:
        raise ValueError(f"the staged cache needs max_len % 128 == 0 "
                         f"(max_len={max_len})")
    for side in ("k", "v"):
        out[f"{side}_stage_codes"] = torch.zeros(
            shape_c[:-1] + (stage_width,), dtype=torch.int8, device=device)
        out[f"{side}_stage_exps"] = torch.zeros(
            shape_e[:-1] + (stage_width,), dtype=torch.int8, device=device)
    out["flushed"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return out


def cache_group(cache: dict) -> int:
    """Quantization group (16: codes rows d or d/2, exps rows d/16)."""
    r = cache["k_codes"].shape[-2] // cache["k_exps"].shape[-2]
    return 16 if r in (8, 16) else r


def cache_code_width(cache: dict) -> int:
    """8 (one int8 code per value) or 4 (two codes per byte)."""
    r = cache["k_codes"].shape[-2] // cache["k_exps"].shape[-2]
    return 4 if r == 8 else 8


def cache_max_len(cache: dict) -> int:
    """Token capacity: the last axis of the codes, dim 3 of the fp cache."""
    if is_quantized_cache(cache):
        return cache["k_codes"].shape[-1]
    return cache["k"].shape[3]


def is_quantized_cache(cache: dict) -> bool:
    return "k_codes" in cache


def is_staged_cache(cache: dict) -> bool:
    return "k_stage_codes" in cache


def stage_boundary_sync(cache: dict, new_positions: torch.Tensor) -> dict:
    """After a prefill wrote tokens ``[0, new_positions)`` into the main
    cache: ``flushed = floor32(new_positions)`` and the boundary tokens
    ``[flushed, new_positions)`` copied into the ring (lane = token % SW).
    Updates in place."""
    SW = cache["k_stage_codes"].shape[-1]
    L = cache["k_codes"].shape[-1]
    fl = (new_positions // 32) * 32
    j = torch.arange(SW, device=fl.device)[None, :]
    t = fl[:, None] + torch.remainder(j - fl[:, None], SW)          # (B, SW)
    valid = t < new_positions[:, None]
    tc = t.clamp(0, L - 1).to(torch.int64)
    for main_key, stage_key in zip(MAIN_KEYS, STAGE_KEYS):
        main = cache[main_key]
        idx = tc[None, :, None, None, :].expand(*main.shape[:-1], SW)
        gathered = torch.gather(main, -1, idx)
        ring = cache[stage_key]
        ring.copy_(torch.where(valid[None, :, None, None, :], gathered, ring))
    cache["flushed"].copy_(fl.to(torch.int32))
    return cache


def _write_starts(positions: torch.Tensor, s: int, length: int
                  ) -> torch.Tensor:
    """(b, s) token indices of an ``s``-token write at ``positions``, each
    start clamped to ``[0, length - s]`` as ``lax.dynamic_update_slice``
    clamps it."""
    start = positions.to(torch.int64).clamp(0, length - s)
    return start[:, None] + torch.arange(s, device=positions.device)


def write_layer_rows(cache: dict, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, positions: torch.Tensor) -> dict:
    """Write ``k_new``, ``v_new`` (b, kv_heads, s, d) into layer ``layer``
    at ``positions`` (b,), in place: the rows into the fp cache in its
    dtype, or their encode at an MXINT cache's code width (exact
    exponents, zero fill 1.0) token-axis-last."""
    if not is_quantized_cache(cache):
        idx = _write_starts(positions, k_new.shape[2], cache["k"].shape[3])
        for key, new in (("k", k_new), ("v", v_new)):
            arr = cache[key][layer]
            val = new.to(arr.dtype)
            arr.scatter_(2, idx[:, None, :, None].expand_as(val), val)
        return cache
    from ..parallel.collectives import mx4_encode, mx8_encode

    group = cache_group(cache)
    enc = mx4_encode if cache_code_width(cache) == 4 else mx8_encode
    idx = _write_starts(positions, k_new.shape[2], cache["k_codes"].shape[-1])
    for side, new in (("k", k_new), ("v", v_new)):
        codes, exps = enc(new, group, zero_fill=1.0)
        for key, val in ((f"{side}_codes", codes), (f"{side}_exps", exps)):
            arr = cache[key][layer]                    # (B, KVH, rows, L)
            val_t = val.transpose(-1, -2)              # (B, KVH, rows, s)
            arr.scatter_(-1, idx[:, None, None, :].expand_as(val_t), val_t)
    return cache


def update_layer_cache(cache: dict, layer: int, k_new: torch.Tensor,
                       v_new: torch.Tensor, positions: torch.Tensor
                       ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """:func:`write_layer_rows` into the fp cache; returns the cache and
    the post-update layer views (b, kv_heads, max_len, d)."""
    write_layer_rows(cache, layer, k_new, v_new, positions)
    return cache, cache["k"][layer], cache["v"][layer]


def update_layer_cache_quantized(cache: dict, layer: int, k_new: torch.Tensor,
                                 v_new: torch.Tensor, positions: torch.Tensor,
                                 compute_dtype=torch.float32
                                 ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """:func:`write_layer_rows` into an MXINT cache; returns the cache and
    the decoded post-update layer views (b, kv_heads, max_len, d) in
    ``compute_dtype``."""
    from ..parallel.collectives import mx4_decode, mx8_decode

    write_layer_rows(cache, layer, k_new, v_new, positions)
    group = cache_group(cache)
    dec = mx4_decode if cache_code_width(cache) == 4 else mx8_decode
    views = tuple(dec(cache[f"{side}_codes"][layer].transpose(-1, -2),
                      cache[f"{side}_exps"][layer].transpose(-1, -2), group,
                      compute_dtype) for side in ("k", "v"))
    return (cache, *views)


def decode_mask(lengths: torch.Tensor, max_len: int, dtype=torch.float32
                ) -> torch.Tensor:
    """(b, 1, 1, max_len) additive mask over the cache: 0 below
    ``lengths`` (the tokens held, the current one included), else
    ``finfo(dtype).min``."""
    ok = torch.arange(max_len, device=lengths.device)[None, :] < \
        lengths[:, None]
    return _additive(ok, dtype)[:, None, None, :]


def prefill_mask(seq_len: int, lengths: torch.Tensor, dtype=torch.float32
                 ) -> torch.Tensor:
    """(b, 1, s, s) causal mask of a right-padded prompt batch: key k is
    seen by query q where k <= q and k < the slot's ``lengths``."""
    q = torch.arange(seq_len, device=lengths.device)[:, None]
    k = torch.arange(seq_len, device=lengths.device)[None, :]
    ok = (k <= q)[None] & (k[None] < lengths[:, None, None])
    return _additive(ok, dtype)[:, None, :, :]


def _additive(ok: torch.Tensor, dtype) -> torch.Tensor:
    zero = torch.zeros((), dtype=dtype, device=ok.device)
    low = torch.full((), torch.finfo(dtype).min, dtype=dtype,
                     device=ok.device)
    return torch.where(ok, zero, low)
