"""In-place KV-cache writes: the flush of the staging ring into the main
cache, the one-row-per-slot decode write into one layer or every layer, the
same with the MXINT8 encode in the launch, and the cache-row encode (MXINT8
or MXINT4) the decode kernels use.

Port of ``flush_stage_to_main``, ``write_kv_rows_stacked``,
``write_kv_rows_all_layers``, ``write_kv_tokens_fused`` and ``_encode_t`` of
``lqer_tpu/ops/pallas/cache_write.py``. The four CUDA kernels are in
``csrc/cache_write.cu``; :func:`flush_plain`, :func:`write_rows_plain`,
:func:`write_rows_all_layers_plain` and :func:`encode_write_plain` are their
plain PyTorch versions. All write in place and bit-exact:

- the flush, for every layer, slot, kv head and row,
  ``main[..., t] = ring[..., t % SW]`` for ``t`` in
  ``[flushed[b], new_flushed[b])``;
- the row write, for each layer-stacked array and slot ``b``, the slot's new
  row at token ``positions[b]`` of layer ``layer_index``, on dim 3 (bf16 K/V
  rows of the fp cache, f32 rows rounded to nearest even) or dim 4 (int8
  MXINT code and exponent columns); a position outside ``[0, L)`` writes
  nothing;
- the row write of every layer, the same for each layer of the arrays, the
  new rows carrying a leading layer axis, in one launch;
- the fused write, the fresh K/V rows MXINT8-encoded (:func:`encode_rows`)
  and written as the row write writes the four columns.
"""

from __future__ import annotations

import torch

from ...parallel.collectives import mx4_encode, mx8_encode
from . import _build


def _encode_t(vals_t: torch.Tensor, group: int = 16, width: int = 8):
    """MXINT8 (``width`` 8) or MXINT4 (``width`` 4: codes clamped to ±7 and
    nibble-packed d-split, value i low and value i + d/2 high) encode of
    TRANSPOSED values ``(…, d, N)``: groups of ``group`` along d, exact
    exponents, all-zero groups take exponent 0 (fill 1.0). Returns (codes
    int8 (…, d, N) or (…, d/2, N), exps int8 (…, d/group, N)); the bytes of
    ``mx8_encode`` / ``mx4_encode(zero_fill=1.0)`` on the untransposed
    values, the JAX ``_encode_t(mb=7)`` / ``_encode_t(mb=3, pack=True)``."""
    enc = {8: mx8_encode, 4: mx4_encode}[width]
    codes, exps = enc(vals_t.transpose(-1, -2), group, zero_fill=1.0)
    return codes.transpose(-1, -2), exps.transpose(-1, -2)


def encode_rows(kh: torch.Tensor, vh: torch.Tensor, group: int = 16) -> tuple:
    """Fresh (B, KVH, 1, d) K/V rows → the four MXINT8 cache columns
    (codes (B, KVH, d, 1), exps (B, KVH, d/16, 1)) of ``_encode_t``."""
    out = []
    for new in (kh, vh):
        out += _encode_t(new[:, :, 0, :].to(torch.float32)[..., None], group)
    return tuple(out)


def flush_plain(cache_arrays, stage_arrays, flushed, new_flushed) -> tuple:
    L = cache_arrays[0].shape[-1]
    SW = stage_arrays[0].shape[-1]
    t = torch.arange(L, device=flushed.device)
    valid = (t[None, :] >= flushed[:, None]) & (t[None, :] < new_flushed[:, None])
    for main, ring in zip(cache_arrays, stage_arrays):
        tiled = ring[..., t % SW]
        main.copy_(torch.where(valid[None, :, None, None, :], tiled, main))
    return tuple(cache_arrays)


def flush_stage_to_main(cache_arrays: tuple, stage_arrays: tuple,
                        flushed: torch.Tensor, new_flushed: torch.Tensor
                        ) -> tuple:
    """Migrate every layer's staged tokens ``[flushed, new_flushed)`` from
    the 4 rings ``(NL, B, KVH, rows, SW)`` into the 4 main arrays
    ``(NL, B, KVH, rows, L)``, in place; returns the main arrays. CPU
    tensors run :func:`flush_plain`; CUDA tensors launch
    ``csrc/cache_write.cu`` once, its grid sized for spans of at most SW
    tokens (longer spans walk on, slower), 16 bytes of each of 4 rows a
    thread where ``flushed`` and ``new_flushed`` are multiples of 16."""
    main0 = cache_arrays[0]
    if main0.device.type == "cpu":
        return flush_plain(cache_arrays, stage_arrays, flushed, new_flushed)
    if not main0.is_cuda:
        raise ValueError(f"unsupported device {main0.device}")
    NL, B, KVH, _, L = main0.shape
    SW = stage_arrays[0].shape[-1]
    for m, s in zip(cache_arrays, stage_arrays):
        if not (m.is_cuda and s.is_cuda and m.dtype == s.dtype == torch.int8
                and m.is_contiguous() and s.is_contiguous()
                and m.shape[:4] == s.shape[:4] and m.shape[-1] == L
                and s.shape[-1] == SW):
            raise ValueError("flush needs contiguous int8 CUDA arrays of "
                             "matching (NL, B, KVH, rows) shapes")
    fl = flushed.to(torch.int32).contiguous()
    nf = new_flushed.to(torch.int32).contiguous()
    _build.launch("cache_write", *(m.data_ptr() for m in cache_arrays),
                  *(s.data_ptr() for s in stage_arrays),
                  *(m.shape[3] for m in cache_arrays), fl.data_ptr(),
                  nf.data_ptr(), NL, B, KVH, L, SW)
    flush_stage_to_main.launches += 1
    return tuple(cache_arrays)


flush_stage_to_main.launches = 0


def _token_axis_last(array: torch.Tensor, new: torch.Tensor) -> bool:
    """The orientation rule of the JAX kernel: a new row ``(B, KVH, R, 1)``
    is a column on dim 4, a new row ``(B, KVH, 1, C)`` a row on dim 3."""
    return new.shape[3] == 1 and array.shape[4] > 1


def write_rows_plain(cache_arrays, new_rows, layer_index: int,
                     positions: torch.Tensor) -> tuple:
    for arr, new in zip(cache_arrays, new_rows):
        lane = _token_axis_last(arr, new)
        dim = 3 if lane else 2                     # in the layer view
        L = arr.shape[dim + 1]
        layer = arr[layer_index]                   # (B, KVH, R, C) view
        ok = ((positions >= 0) & (positions < L))[:, None, None, None]
        idx = positions.clamp(0, L - 1).to(torch.int64)[
            :, None, None, None].expand(new.shape)
        val = torch.where(ok, new.to(arr.dtype), torch.gather(layer, dim, idx))
        layer.scatter_(dim, idx, val)
    return tuple(cache_arrays)


def write_kv_rows_stacked(cache_arrays: tuple, new_rows: tuple,
                          layer_index: int, positions: torch.Tensor) -> tuple:
    """Write one new row per slot into layer ``layer_index`` of up to four
    layer-stacked arrays ``(NL, B, KVH, ·, ·)``, in place; returns them.
    ``new_rows``: ``(B, KVH, 1, C)`` rows (token axis on dim 3; f32 or bf16
    into a bf16 array) or ``(B, KVH, R, 1)`` int8 columns (token axis on
    dim 4); ``positions`` (B,). CPU tensors run :func:`write_rows_plain`;
    CUDA tensors launch ``csrc/cache_write.cu`` (one launch for all
    arrays)."""
    a0 = cache_arrays[0]
    if a0.device.type == "cpu":
        return write_rows_plain(cache_arrays, new_rows, layer_index, positions)
    if not a0.is_cuda:
        raise ValueError(f"unsupported device {a0.device}")
    if not 0 <= layer_index < a0.shape[0]:
        raise ValueError(f"layer {layer_index} of {a0.shape[0]}")
    cols = _row_columns(cache_arrays, new_rows)
    _launch_rows("row_write", cols, new_rows, positions, int(layer_index))
    write_kv_rows_stacked.launches += 1
    return tuple(cache_arrays)


def _row_columns(cache_arrays: tuple, new_rows: tuple) -> dict:
    """Check up to four CUDA arrays ``(NL, B, KVH, ·, ·)`` against one
    layer's new rows; returns the row-write kernel's per-array arguments
    (``kind`` 1: f32 or bf16 rows stored into a bf16 array; 0: int8)."""
    a0 = cache_arrays[0]
    NL, B, KVH = a0.shape[:3]
    if not 1 <= len(cache_arrays) == len(new_rows) <= 4:
        raise ValueError("need 1 to 4 arrays and as many rows")
    cols = {"dst": [], "lane": [], "rows": [], "cols": [], "kind": []}
    for arr, new in zip(cache_arrays, new_rows):
        lane = _token_axis_last(arr, new)
        want = ((B, KVH, arr.shape[3], 1) if lane
                else (B, KVH, 1, arr.shape[4]))
        if not (arr.is_cuda and new.is_cuda and arr.is_contiguous()
                and arr.ndim == 5 and tuple(arr.shape[:3]) == (NL, B, KVH)
                and tuple(new.shape) == want):
            raise ValueError(f"row write needs contiguous CUDA arrays "
                             f"(NL, B, KVH, ·, ·) and rows {want} (got "
                             f"{tuple(arr.shape)} and {tuple(new.shape)})")
        if arr.dtype == torch.bfloat16 and new.dtype in (torch.float32,
                                                         torch.bfloat16):
            kind = 1
        elif arr.dtype == new.dtype == torch.int8:
            kind = 0
        else:
            raise ValueError(f"row write stores f32/bf16 into bf16 or int8 "
                             f"into int8 (got {new.dtype} into {arr.dtype})")
        for key, val in (("dst", arr), ("lane", int(lane)),
                         ("rows", arr.shape[3]), ("cols", arr.shape[4]),
                         ("kind", kind)):
            cols[key].append(val)
    return cols


def _launch_rows(entry: str, cols: dict, new_rows, positions: torch.Tensor,
                 layer_arg: int) -> None:
    """One launch of a row-write entry: ``row_write`` (``layer_arg`` the
    layer) or ``row_write_all`` (``layer_arg`` the layer count); the kernel
    reads rows for a bf16 array as f32."""
    n = len(cols["dst"])
    srcs = [(r.to(torch.float32) if k == 1 else r).contiguous()
            for r, k in zip(new_rows, cols["kind"])]
    pad = 4 - n
    B, KVH = cols["dst"][0].shape[1:3]
    pos = positions.to(torch.int32).contiguous()
    _build.launch(entry,
                  *(a.data_ptr() for a in cols["dst"]), *[None] * pad,
                  *(s.data_ptr() for s in srcs), *[None] * pad,
                  *(cols[k][i] if i < n else 0 for k in ("lane", "rows",
                                                          "cols", "kind")
                    for i in range(4)),
                  pos.data_ptr(), n, layer_arg, B, KVH)


write_kv_rows_stacked.launches = 0


def write_rows_all_layers_plain(cache_arrays, new_rows,
                                positions: torch.Tensor) -> tuple:
    """:func:`write_rows_plain` of each layer's new rows."""
    for li in range(new_rows[0].shape[0]):
        write_rows_plain(cache_arrays, tuple(r[li] for r in new_rows), li,
                         positions)
    return tuple(cache_arrays)


def write_kv_rows_all_layers(cache_arrays: tuple, new_rows: tuple,
                             positions: torch.Tensor) -> tuple:
    """:func:`write_kv_rows_stacked` for every layer at once: ``new_rows``
    carry a leading layer axis, ``(NL, B, KVH, 1, C)`` rows or ``(NL, B,
    KVH, R, 1)`` columns (the orientation rule of each layer's rows), and
    layer ``l`` of each array takes layer ``l`` of its rows at
    ``positions[b]``, in place; returns the arrays. CPU tensors run
    :func:`write_rows_all_layers_plain`; CUDA tensors launch
    ``csrc/cache_write.cu`` once."""
    a0 = cache_arrays[0]
    NL = a0.shape[0]
    if any(r.ndim != 5 or r.shape[0] != NL for r in new_rows):
        raise ValueError(f"rows of every layer need a leading axis of {NL} "
                         f"(got {[tuple(r.shape) for r in new_rows]})")
    if a0.device.type == "cpu":
        return write_rows_all_layers_plain(cache_arrays, new_rows, positions)
    if not a0.is_cuda:
        raise ValueError(f"unsupported device {a0.device}")
    cols = _row_columns(cache_arrays, tuple(r[0] for r in new_rows))
    _launch_rows("row_write_all", cols, new_rows, positions, NL)
    write_kv_rows_all_layers.launches += 1
    return tuple(cache_arrays)


write_kv_rows_all_layers.launches = 0


def encode_write_plain(cache_arrays, kh, vh, layer_index: int,
                       positions: torch.Tensor, group: int = 16) -> tuple:
    return write_rows_plain(cache_arrays, encode_rows(kh, vh, group),
                            layer_index, positions)


def write_kv_tokens_fused(cache_arrays: tuple, kh: torch.Tensor,
                          vh: torch.Tensor, layer_index: int,
                          positions: torch.Tensor) -> tuple:
    """MXINT8-encode the fresh rows kh, vh (B, KVH, 1, d) and write them into
    column ``positions[b]`` of layer ``layer_index`` of the four
    layer-stacked arrays (k codes, k exps, v codes, v exps) of shapes
    ``(NL, B, KVH, d, L)`` and ``(NL, B, KVH, d/16, L)``, in place; returns
    them. CPU tensors run :func:`encode_write_plain`; CUDA tensors launch
    ``csrc/cache_write.cu`` (one launch)."""
    kc = cache_arrays[0]
    NL, B, KVH, d, L = kc.shape
    shapes = [(NL, B, KVH, d, L), (NL, B, KVH, d // 16, L)] * 2
    if (len(cache_arrays) != 4 or d % 16
            or [tuple(a.shape) for a in cache_arrays] != shapes
            or tuple(kh.shape) != (B, KVH, 1, d) or vh.shape != kh.shape
            or not 0 <= layer_index < NL):
        raise ValueError(f"the fused write takes four arrays {shapes}, rows "
                         f"(B, KVH, 1, d) and a layer in [0, {NL}) (got "
                         f"{[tuple(a.shape) for a in cache_arrays]}, rows "
                         f"{tuple(kh.shape)}, layer {layer_index})")
    if kc.device.type == "cpu":
        return encode_write_plain(cache_arrays, kh, vh, layer_index, positions)
    if not kc.is_cuda:
        raise ValueError(f"unsupported device {kc.device}")
    for a in (*cache_arrays, kh, vh, positions):
        if not a.is_cuda:
            raise ValueError("the fused write needs CUDA tensors")
    for a in cache_arrays:
        if not (a.dtype == torch.int8 and a.is_contiguous()):
            raise ValueError("cache arrays must be contiguous int8 CUDA "
                             "tensors")
    # the kernel reads f32 rows at their own slot and head strides: the
    # served V is a view of the fused q|k|v output, read in place
    khf, vhf = (t if t.dtype == torch.float32 and t.stride(-1) == 1
                else t.to(torch.float32).contiguous() for t in (kh, vh))
    pos = positions.to(torch.int32).contiguous()
    _build.launch("encode_write_tokens", khf.data_ptr(), vhf.data_ptr(),
                  *(a.data_ptr() for a in cache_arrays), pos.data_ptr(),
                  khf.stride(0), khf.stride(1), vhf.stride(0), vhf.stride(1),
                  int(layer_index), B, KVH, d, L)
    write_kv_tokens_fused.launches += 1
    return tuple(cache_arrays)


write_kv_tokens_fused.launches = 0
