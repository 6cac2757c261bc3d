"""Cache-aware Llama and OPT steps (admission prefill and decode).

Port of ``lqer_tpu/serving/decode.py``: the eager step :func:`model_step`
(``_llama_step`` / ``_opt_step``, a Python loop over per-prefix weights,
the JAX engine's default) and the stacked step :func:`llama_step_scan` /
:func:`opt_step_scan` (the ``lax.scan`` over layers becomes a Python loop;
each kernel takes per-layer views of the layer-stacked weights and cache,
``stacked[li]`` is a zero-copy view). The cache is updated in place.

Per Llama layer: RMSNorm → q|k|v → rotary → attention → o → RMSNorm → the
MLP. A linear the backend packed runs through the kernels (kernel 1, the
whole MLP in one megakernel launch, or at 512 rows and more the large-M
route); any other linear, and every linear without a backend, runs the
software emulation ``ops/qlinear.py::qlinear`` on the PTQ-prepared weights
(``models.prepare_ptq``), as the JAX package decides per prefix
(:func:`_lin`). An OPT layer has learned positions instead of rotary,
LayerNorm before (or, post-LN, after) each block, the query scaled before
its quantizer (``scale_query``), biases on every linear and the relu MLP.
Without ``layer_qcfgs`` the model serves unquantized (``FP_LAYER_LLAMA`` /
``FP_LAYER_OPT``).

Attention follows the JAX package per layer and step:

- an admission (``fresh_prefill``, positions 0 on a zeroed cache) whose
  configuration the prefill kernel takes (:func:`_fresh_prefill_attend`)
  attends through it, and its rows are written in plain PyTorch;
- a decode step (s = 1) where :func:`_use_attn_kernel` allows (a backend,
  the MXINT attention formats, max_len >= 128, 16-aligned dims, a bf16 or
  f32 cache within the fp kernel's one-pass length) runs the decode
  kernels:
  on a staged cache the staged kernel writes the ring and attends (rows 7
  and 9); otherwise the stacked step takes :func:`decode_route`'s kernels
  (the row write, the fused MXINT8 write + attend, the fused encode +
  write) and the eager step writes in plain PyTorch
  (``kv_cache.write_layer_rows``) and attends through row 5, 6 or 8
  (:func:`decode_route` with ``eager=True``);
- everything else (a sliding-window or chunked prefill, an fp cache past
  that length, short or unaligned caches, fp or mismatched attention configs, no
  backend, ``LQER_DISABLE_ATTN_KERNEL``) writes the cache and attends
  eagerly (:func:`_attend` with the additive :func:`_cache_mask`), a staged
  cache through :func:`_staged_eager_update`. This plain PyTorch attention
  has no TPU kernel behind it.

A staged cache flushes its rings into the main cache (row 14) before a
decode step once any slot's ring residue reaches 48, and takes its stage
boundary after an admission. Past the one-pass length (:func:`streams`; at
Llama-2-7B width about 23K tokens) the MXINT caches stream L as the JAX
package does. The W8 lm_head is kernel 1 again (OPT's 50272-row head stays
a dense product, as in the JAX package).
"""

from __future__ import annotations

import functools
import logging
import os

import torch
from torch.nn.functional import relu, silu

from .. import models
from ..models import llama as llama_mod
from ..models import opt as opt_mod
from ..models.common import (
    _std_a8,
    apply_rotary,
    fused_quantized_attention,
    layer_norm,
    merge_heads,
    repeat_kv,
    rms_norm,
    rotary_tables,
    supports_fused_attention,
)
from ..models.fp_config import FP_LAYER_LLAMA, FP_LAYER_OPT
from ..ops.kernels.attention import HEAD_DIMS
from ..ops.kernels.cache_write import (
    flush_stage_to_main,
    write_kv_rows_stacked,
    write_kv_tokens_fused,
)
from ..ops.kernels.decode_attention import (
    decode_attention_quantized_staged,
    key_mask,
)
from ..ops.kernels.fp_decode import (
    decode_attention_fp,
    decode_attention_widths,
    supports_decode_attention,
)
from ..ops.kernels.quantized_decode import (
    decode_attention_quantized,
    decode_attention_quantized_write,
    decode_attention_widths_quantized,
)
from ..ops.kernels.streaming_decode import (
    decode_attention_quantized_streaming,
    decode_attention_quantized_streaming_staged,
)
from ..ops.kernels.dequant_gemm import qlinear_w4_dense_largeM, qlinear_w4_fused
from ..ops.qlinear import promoted_matmul, qlinear, resolve_qmatmul
from ..parallel.collectives import mx4_decode, mx4_encode, mx8_decode, mx8_encode
from ..utils import tracing
from .kernel_backend import (
    _LARGEM_THRESHOLD,
    serving_linear,
    serving_linear_split,
    serving_mlp,
)
from .kv_cache import (
    MAIN_KEYS,
    STAGE_KEYS,
    cache_code_width,
    cache_group,
    cache_max_len,
    init_kv_cache,
    init_quantized_kv_cache,
    is_quantized_cache,
    is_staged_cache,
    stage_boundary_sync,
    write_layer_rows,
)

FLUSH_RESIDUE = 48  # flush once a ring holds 48 tokens: < 64 lanes always
CACHE_DTYPES = ("bfloat16", "float32", "mxint8", "mxint8-staged", "mxint4",
                "mxint4-staged")
STAGED_KINDS = ("mxint8-staged", "mxint4-staged")

logger = logging.getLogger(__name__)

# one (cos, sin) table pair per (head_dim, length, theta, device)
_rotary = functools.lru_cache(maxsize=8)(rotary_tables)


def _fp_cache_kernel_fits(max_len: int, head_dim: int, itemsize: int) -> bool:
    """The JAX fp-cache kernel's one-pass length: one head's double-buffered
    whole-L K and V in its 12 MB budget (beyond it the JAX package takes the
    eager path)."""
    return 2 * max_len * head_dim * itemsize * 2 <= 12 * 1024 * 1024


def _kvh_chunk_fits(max_len: int, head_dim: int, group: int = 16) -> bool:
    """The JAX MXINT-cache kernels' one-pass length (beyond it the JAX
    package streams L in chunks: ``decode_attention_quantized_streaming``
    and ``write_kv_tokens_fused``)."""
    return 2 * max_len * head_dim * (1 + 1 / group) * 2 <= 12 * 1024 * 1024


def _cache_kind(cache: dict) -> str:
    if is_staged_cache(cache):
        return f"mxint{cache_code_width(cache)}-staged"
    if is_quantized_cache(cache):
        return f"mxint{cache_code_width(cache)}"
    return {torch.bfloat16: "bfloat16", torch.float32: "float32"}.get(
        cache["k"].dtype, str(cache["k"].dtype))


def _use_attn_kernel(backend, s: int, attn_cfg, max_len: int, head_dim: int,
                     cache: dict | None = None) -> bool:
    """The JAX package's decode-kernel eligibility: a decode step (s = 1)
    with a backend, the canonical MXINT attention formats (K/V at the
    cache's width) and max_len >= 128 with max_len and the head dim
    multiples of 16; an fp cache also within the fp kernel's one-pass
    length. ``LQER_DISABLE_ATTN_KERNEL`` forces the eager path;
    ``LQER_FP_ATTN_KERNEL`` routes an unquantized (fp) attention config
    through the kernels too, all operand quantizers off."""
    if os.environ.get("LQER_DISABLE_ATTN_KERNEL"):
        return False
    if s != 1 or max_len < 128 or max_len % 16 or head_dim % 16:
        return False
    if cache is not None and not is_quantized_cache(cache):
        if not _fp_cache_kernel_fits(max_len, head_dim,
                                     cache["k"].element_size()):
            return False
    if attn_cfg.qk_cfg is None and attn_cfg.pv_cfg is None:
        return bool(os.environ.get("LQER_FP_ATTN_KERNEL"))
    if backend is None:
        return False
    cw = (cache_code_width(cache)
          if cache is not None and is_quantized_cache(cache) else 8)
    return supports_decode_attention(attn_cfg, cache_width=cw)


def streams(kind: str, max_len: int, head_dim: int) -> bool:
    """Whether decode over an MXINT cache of this kind takes the streaming
    kernels: past the JAX package's one-pass length (``_kvh_chunk_fits``),
    where it streams L too. The one-pass kernels (rows 6, 7 and 10) split L
    over blocks, so nothing in shared memory bounds their length and every
    MXINT cache takes exactly JAX's route."""
    return kind in ("mxint8", "mxint4", *STAGED_KINDS) \
        and not _kvh_chunk_fits(max_len, head_dim)


def decode_route(kind: str, max_len: int, head_dim: int, n_rep: int,
                 eager: bool = False) -> tuple[str, ...]:
    """The kernels (``ops.kernels.KERNELS`` names) that a decode step
    launches, in order, for each layer over a cache of this kind where
    :func:`_use_attn_kernel` allows; the staged cache's flush runs besides,
    once for all layers, when a ring fills. ``eager``: the eager step's
    (:func:`model_step`), which writes a direct cache in plain PyTorch and
    then attends (the JAX package's ``_cache_update`` + ``_attend_auto``).
    The route is the same at every ``n_rep`` the kernels take, as in the
    JAX package."""
    stream = streams(kind, max_len, head_dim)
    if kind in STAGED_KINDS:   # either width, read off the cache's rows
        return (("decode_attention_streaming_staged",) if stream
                else ("decode_attention",))
    if eager:
        return {
            "bfloat16": ("decode_attention_fp",),
            "float32": ("decode_attention_fp",),
            "mxint8": ("decode_attention_streaming",) if stream
            else ("decode_attention_quantized",),
            "mxint4": ("decode_attention_streaming",) if stream
            else ("decode_attention_quantized",),
        }[kind]
    return {
        "bfloat16": ("row_write", "decode_attention_fp"),
        "float32": ("row_write", "decode_attention_fp"),
        "mxint8": (("encode_write_tokens", "decode_attention_streaming")
                   if stream else ("decode_attention_write",)),
        "mxint4": ("row_write", "decode_attention_streaming" if stream
                   else "decode_attention_quantized"),
    }[kind]


def make_cache(cfg, batch: int, max_len: int, dtype="bfloat16",
               device="cuda") -> dict:
    """The JAX package's ``make_cache``: ``"bfloat16"`` (the default;
    ``torch.bfloat16`` too), ``"float32"`` (``torch.float32``),
    ``"mxint8"``, ``"mxint8-staged"``, ``"mxint4"`` and ``"mxint4-staged"``.
    As in JAX, a staged name under a sliding window (or where
    ``max_len % 128 != 0``) gives the direct-write cache of its width, and
    the MXINT4 caches need ``head_dim % 32 == 0``."""
    name = {torch.bfloat16: "bfloat16", torch.float32: "float32"}.get(dtype,
                                                                      dtype)
    if name not in CACHE_DTYPES:
        raise ValueError(f"unknown cache dtype {dtype!r} ({CACHE_DTYPES})")
    window = getattr(cfg, "sliding_window", None)
    if name.startswith("mxint4") and cfg.head_dim % 32:
        raise ValueError(f"the MXINT4 cache needs head_dim % 32 == 0 "
                         f"(head_dim {cfg.head_dim})")
    staged = name.endswith("-staged") and window is None \
        and max_len % 128 == 0
    if name.endswith("-staged") and not staged:
        logger.info("%s ineligible (window=%s, max_len=%d): using the "
                    "direct-write %s cache", name, window, max_len,
                    name.removesuffix("-staged"))
    kind = name.removesuffix("-staged") if not staged else name
    shape = (cfg.num_hidden_layers, batch, cfg.kv_heads, cfg.head_dim,
             max_len)
    if kind in ("bfloat16", "float32"):
        return init_kv_cache(*shape, dtype=getattr(torch, kind),
                             device=device)
    return init_quantized_kv_cache(
        *shape, staged=staged,
        code_width=4 if kind.startswith("mxint4") else 8, device=device)


def _cache_mask(q_abs: torch.Tensor, max_len: int, dtype,
                window: int | None = None) -> torch.Tensor:
    """(b, 1, s, max_len) additive mask of the eager attention: 0 where the
    query at absolute position p sees cache slot j (the decode kernels'
    ``key_mask``), else ``finfo(dtype).min`` in the stream
    dtype, as the JAX package builds it (its softmax and P quantizer then
    see the same values)."""
    ok = key_mask(max_len, q_abs, window)
    zero = torch.zeros((), dtype=dtype, device=q_abs.device)
    low = torch.full((), torch.finfo(dtype).min, dtype=dtype,
                     device=q_abs.device)
    return torch.where(ok, zero, low)[:, None, :, :]


def _cache_layer_views(cache: dict, li: int):
    """Decoded ``(k_l, v_l)`` bf16 (B, KVH, L, d) of layer ``li`` for the
    eager attention: the fp cache's own rows, or an MXINT cache's decode."""
    if not is_quantized_cache(cache):
        return cache["k"][li], cache["v"][li]
    group = cache_group(cache)
    dec = mx4_decode if cache_code_width(cache) == 4 else mx8_decode
    return tuple(dec(cache[f"{side}_codes"][li].transpose(-1, -2),
                     cache[f"{side}_exps"][li].transpose(-1, -2), group,
                     torch.bfloat16) for side in ("k", "v"))


def _kv_config_is_cache_format(attn_cfg, width: int) -> bool:
    """The K/V-side operand quantizers coincide with the MXINT cache's
    write grid (only then does the cache format stand in for them)."""
    qk, pv = attn_cfg.qk_cfg, attn_cfg.pv_cfg
    if qk is None or pv is None:
        return qk is None and pv is None
    kx = qk.get("w_quantizer") or qk.get("default")
    vx = pv.get("w_quantizer") or pv.get("default")
    return all(_std_a8(c) and c.get("width") == width for c in (kx, vx))


def _kv_skip_matmuls(attn_cfg):
    """The matmuls over an MXINT cache whose format is the K/V operands'
    (quantize once at write): the K/V-side quantizer passes through, q and
    p quantize as configured."""
    def strip(cfg):
        return None if cfg is None else {**cfg,
                                         "w_quantizer": {"name": "passthrough"}}

    return (resolve_qmatmul(strip(attn_cfg.qk_cfg)),
            resolve_qmatmul(strip(attn_cfg.pv_cfg)))


def _expand_kv(x: torch.Tensor, n_rep: int, heads: int, q_off: int = 0
               ) -> torch.Tensor:
    """(b, kv_heads, ...) → the kv head of each of ``heads`` q heads: every
    kv head repeated ``n_rep`` times, from q head ``q_off`` on where the
    caller holds only some q heads (a tensor-parallel rank that keeps every
    kv head)."""
    x = repeat_kv(x, n_rep)
    return x if x.shape[1] == heads else x[:, q_off:q_off + heads]


@tracing.annotate(tracing.ATTENTION["eager"])
def _attend(qh, k_l, v_l, mask, attn_cfg, scaling, n_rep, scale_query=False,
            kv_pre_quantized=False, cache_width=8, q_off=0):
    """Eager cache attention (the JAX package's ``serving/decode.py::
    _attend``), in plain PyTorch: quantized matmuls on (b·h, ...) operands,
    so quantizer groups never span heads; K^T quantizes in groups of 16
    tokens over the whole ``max_len``, whose invalid slots are zero; with
    ``kv_pre_quantized`` (an MXINT cache whose format is the configured
    K/V one) the K/V-side quantizers pass through. Scores scale in q's
    dtype (the scalar rounded to it first, as JAX's weakly typed one), the
    additive ``mask`` is added, the softmax runs in f32 and the
    probabilities return to q's dtype. ``q_off``: see :func:`_expand_kv`.
    (b, h, s, d) in and out."""
    if kv_pre_quantized and _kv_config_is_cache_format(attn_cfg,
                                                       cache_width):
        qk_matmul, pv_matmul = _kv_skip_matmuls(attn_cfg)
    else:
        qk_matmul, pv_matmul = attn_cfg.qk_matmul, attn_cfg.pv_matmul
    b, h, s, d = qh.shape
    k_full = _expand_kv(k_l, n_rep, h, q_off)
    v_full = _expand_kv(v_l, n_rep, h, q_off)
    kv_len = k_full.shape[2]
    q3 = qh.reshape(b * h, s, d)
    k3 = k_full.reshape(b * h, kv_len, d)
    v3 = v_full.reshape(b * h, kv_len, d)
    if scale_query:
        q3 = q3 * torch.tensor(scaling, dtype=q3.dtype)
        scores = qk_matmul(q3, k3.transpose(-1, -2))
    else:
        scores = qk_matmul(q3, k3.transpose(-1, -2))
        scores = scores * torch.tensor(scaling, dtype=scores.dtype)
    scores = scores.reshape(b, h, s, kv_len) + mask
    scores = scores.clamp_min(torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(qh.dtype)
    out = pv_matmul(probs.reshape(b * h, s, kv_len), v3)
    return out.reshape(b, h, s, d)


def check_card_shapes(head_dim: int, device_type: str) -> None:
    """On the card (``device_type == "cuda"``), raise
    ``NotImplementedError`` for a head dim its attention kernels do not
    take (every one is built for ``attention.HEAD_DIMS``), before any work.
    The JAX kernels take any multiple of 16, and so do the plain versions
    that serve CPU tensors. (The MXINT4 caches' ``head_dim % 32`` is
    ``make_cache``'s, on every device.)"""
    if device_type == "cuda" and head_dim not in HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {head_dim}: the card's attention kernels take "
            f"{HEAD_DIMS} (csrc/*.cu, instantiated per head dim)")


def _prefill_kernel_takes(attn_cfg, cache: dict, window, head_dim: int
                          ) -> bool:
    """Whether an admission over ``cache`` can reach the prefill kernel
    (:func:`_fresh_prefill_attend`'s tests that do not depend on the
    chunk's length)."""
    quantized = is_quantized_cache(cache)
    if window is not None or head_dim % 16 or not supports_fused_attention(
            attn_cfg, kv_pre_quantized=quantized):
        return False
    return not quantized or _kv_config_is_cache_format(
        attn_cfg, cache_code_width(cache))


def check_servable(cache: dict, attn_cfgs, head_dim: int,
                   window: int | None = None, *, backend: bool = True,
                   scan: bool = True, admission: bool = True) -> None:
    """Raise ``NotImplementedError`` before any work where a step over
    ``cache`` on the card would hand a kernel what it does not take: a
    head dim outside ``attention.HEAD_DIMS`` (:func:`check_card_shapes`)
    wherever an attention kernel or the stacked step's MXINT encode +
    write is reached. ``backend``: the engine serves with a kernel
    backend; ``scan``: the stacked step; ``admission``: the call may run an
    admission (``fresh_prefill``), the one place the prefill kernel runs
    (an engine admits; a decode step or a prefill into a filled cache
    reaches no prefill kernel). On the CPU every regime the JAX
    package serves is served; on the card too, within those head dims (the
    ``float32`` cache through the f32 entries of the fp decode kernel and
    the row write)."""
    if next(iter(cache.values())).device.type != "cuda":
        return
    max_len = cache_max_len(cache)
    # layers resolved from one config share its matmul dicts
    cfgs = {(id(c.qk_cfg), id(c.pv_cfg)): c for c in attn_cfgs}.values()
    decode_kernel = any(_use_attn_kernel(True if backend else None, 1, c,
                                         max_len, head_dim, cache)
                        for c in cfgs)
    prefill_kernel = admission and any(
        _prefill_kernel_takes(c, cache, window, head_dim) for c in cfgs)
    if decode_kernel or prefill_kernel or (scan and is_quantized_cache(cache)):
        check_card_shapes(head_dim, "cuda")


def stack_backend(backend: dict, cfg, consume: bool = False) -> dict:
    """Prefix-keyed backend → rel-keyed layer-stacked arrays ``(n, ...)``,
    one stack per run of consecutive layers that pack alike (the same
    entries with the same metadata: a per-layer config override, the
    reference's ``model_layer_{i}``, can pack a layer otherwise; the JAX
    package's ``_scan_segments`` runs one scan per such run of configs).
    Returns ``{"segments": [(start, end, {"arrays", "meta"})], "arrays",
    "meta"}``, the last two holding the non-layer entries (the packed
    ``lm_head``); :func:`layer_backend` finds a layer's segment.
    ``consume`` drops each per-layer array from ``backend`` once
    stacked."""
    arch = models.get_arch_module(cfg)
    n = cfg.num_hidden_layers
    prefixes = [arch.layer_prefix(i) + "." for i in range(n)]
    metas = [{k[len(p):]: v for k, v in backend["meta"].items()
              if k.startswith(p)} for p in prefixes]
    segments, start = [], 0
    for end in range(1, n + 1):
        if end < n and metas[end] == metas[start]:
            continue
        arrays = {}
        for rel in metas[start]:
            keys = [prefixes[i] + rel for i in range(start, end)]
            first = backend["arrays"][keys[0]]
            arrays[rel] = {
                k: (None if first[k] is None
                    else torch.stack([backend["arrays"][p][k] for p in keys]))
                for k in first}
            if consume:
                for p in keys:
                    backend["arrays"].pop(p, None)
        segments.append((start, end, {"arrays": arrays,
                                      "meta": metas[start]}))
        start = end
    layer_root = prefixes[0].rsplit(".", 2)[0]
    rest = [k for k in backend["meta"] if not k.startswith(layer_root)]
    return {"segments": segments,
            "arrays": {k: backend["arrays"][k] for k in rest},
            "meta": {k: backend["meta"][k] for k in rest}}


def layer_backend(backend_stacked: dict | None, li: int
                  ) -> tuple[dict | None, int | None]:
    """The stacked entries of the segment that holds layer ``li``
    (:func:`stack_backend`) and ``li``'s index inside it; ``(None, None)``
    without a backend."""
    if backend_stacked is None:
        return None, None
    for start, end, seg in backend_stacked["segments"]:
        if start <= li < end:
            return seg, li - start
    raise IndexError(f"layer {li} is in no segment of the backend")


# -- linears: the per-prefix (eager) and the stacked (scan) lookups -----------
def _lin(x, params, prefix, qc, backend):
    """A quantized linear: the kernels when the backend packed ``prefix``,
    else the software emulation on the prepared params."""
    if backend is not None and prefix in backend["meta"]:
        return serving_linear(x, prefix, backend, qc)
    return qlinear(x, {k: params.get(f"{prefix}.{k}")
                       for k in ("weight", "bias", "A", "B", "shard")}, qc)


def _lin_group(x, params, layer_prefix, fused_rel, member_rels, qcs,
               backend):
    """Projections sharing one input: one launch when the backend packed
    the group fused, else per-member linears (:func:`_lin`)."""
    key = f"{layer_prefix}.{fused_rel}"
    if backend is not None and key in backend["meta"]:
        return serving_linear_split(x, key, backend, qcs[0])
    return [_lin(x, params, f"{layer_prefix}.{rel}", qc, backend)
            for rel, qc in zip(member_rels, qcs)]


def _mlp_fused_or_none(x, layer_prefix, qc_first, backend):
    """The whole MLP through the megakernel when the backend packed it
    (``{layer}.mlp_fused``), else None (the caller runs the per-linear
    path)."""
    key = f"{layer_prefix}.mlp_fused"
    if backend is None or key not in backend["meta"]:
        return None
    return serving_mlp(x, key, backend, qc_first)


def _lin_slice(x, stacked, li, rel, qc, seg, lj):
    """A linear of the stacked step: the kernels on the segment's stacked
    entry (layer ``lj`` of it) when packed, else the emulation on layer
    ``li`` of the stacked params."""
    if seg is not None and rel in seg["meta"]:
        return serving_linear(x, rel, seg, qc, layer_index=lj)
    return qlinear(x, _slice_mod(stacked, li, rel), qc)


def _slice_mod(stacked, li, rel) -> dict:
    """``{weight, bias, A, B, shard}`` of layer ``li`` of a stacked
    module."""
    return {k: (stacked[f"{rel}.{k}"][li] if f"{rel}.{k}" in stacked
                else None) for k in ("weight", "bias", "A", "B", "shard")}


def _lin_group_slice(x, stacked, li, fused_rel, member_rels, qcs, seg, lj):
    """Stacked counterpart of :func:`_lin_group`."""
    if seg is not None and fused_rel in seg["meta"]:
        return serving_linear_split(x, fused_rel, seg, qcs[0],
                                    layer_index=lj)
    return [_lin_slice(x, stacked, li, rel, qc, seg, lj)
            for rel, qc in zip(member_rels, qcs)]


def _mlp_slice_or_none(x, qc_first, seg, lj):
    if seg is None or "mlp_fused" not in seg["meta"]:
        return None
    return serving_mlp(x, "mlp_fused", seg, qc_first, layer_index=lj)


def _heads(y: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, _ = y.shape
    return y.reshape(b, s, num_heads, -1).transpose(1, 2)


def _last_valid_h(h, valid_lengths, s, logits_last_only):
    """(b, s, e) → (b, 1, e) at each slot's last valid position."""
    if not logits_last_only or s == 1:
        return h
    if valid_lengths is None:
        return h[:, -1:, :]
    b, _, e = h.shape
    idx = (valid_lengths - 1).clamp(0, s - 1).to(torch.int64)
    return torch.gather(h, 1, idx[:, None, None].expand(b, 1, e))


def _lm_head_logits(h, lm_head, backend):
    """Packed W8 head through kernel 1, or the large-M route at 512 rows
    and more (activation enters as bf16, unquantized; padded vocab sliced
    off), else the dense matmul (``lm_head.weight``, or the tied embedding:
    OPT's head, whose vocab does not tile)."""
    if backend is not None and "lm_head" in backend["meta"]:
        meta = backend["meta"]["lm_head"]
        b, s, k = h.shape
        route = (qlinear_w4_dense_largeM if b * s >= _LARGEM_THRESHOLD
                 else qlinear_w4_fused)
        y = route(h.to(torch.bfloat16).reshape(b * s, k),
                  backend["arrays"]["lm_head"], meta["fmt"],
                  quant_xa_width=None, quant_out_width=None)
        return y[:, :meta["n_real"]].reshape(b, s, -1).to(h.dtype)
    return promoted_matmul(h, lm_head.T)


# -- cache writes ---------------------------------------------------------------
def _cache_write_full(cache, li, kh, vh, positions):
    """Plain write of the new rows at ``positions[b] + t``: every write of
    the eager step (the JAX package's ``_cache_update``), and an admission's
    or an unaligned decode write of the stacked step (the plain half of
    JAX's ``_cache_write_full``). The rows into the fp cache, or their
    MXINT8/MXINT4 encode (exact exponents, zero fill 1.0) token-axis-last
    into the MXINT cache."""
    write_layer_rows(cache, li, kh, vh, positions)


def _cache_write_row(cache, li, kh, vh, positions):
    """Decode write (s = 1) through the row-write kernel: the bf16 rows
    into the fp cache, or the four MXINT4 columns of the encoded rows."""
    if not is_quantized_cache(cache):
        write_kv_rows_stacked((cache["k"], cache["v"]), (kh, vh), li,
                              positions)
        return
    group = cache_group(cache)
    cols = []
    for new in (kh, vh):
        cols += [t.transpose(-1, -2) for t in mx4_encode(new, group,
                                                         zero_fill=1.0)]
    write_kv_rows_stacked(tuple(cache[k] for k in MAIN_KEYS), tuple(cols),
                          li, positions)


def _scan_cache_write(cache, li, kh, vh, positions):
    """The stacked step's write before its eager attention (the JAX
    package's ``_cache_write_full``): at s = 1 the fused MXINT8 encode +
    write where the main cache is 128-aligned, the row write where the
    token axis is aligned (32 rows of the fp cache, 128 columns of an
    MXINT one), else the plain write."""
    s, L = kh.shape[2], cache_max_len(cache)
    quantized = is_quantized_cache(cache)
    if s == 1 and quantized and cache_code_width(cache) == 8 and L % 128 == 0:
        write_kv_tokens_fused(tuple(cache[k] for k in MAIN_KEYS), kh, vh, li,
                              positions)
    elif s == 1 and L % (128 if quantized else 32) == 0:
        _cache_write_row(cache, li, kh, vh, positions)
    else:
        _cache_write_full(cache, li, kh, vh, positions)


# -- attention ------------------------------------------------------------------
def _fresh_prefill_attend(qh, kh, vh, attn_cfg, scaling, n_rep, cache,
                          window, scale_query=False, q_off=0):
    """Admission attention (positions 0, fresh cache) through the prefill
    kernel, or None where the JAX package's ``_fresh_prefill_attend`` is
    ineligible (a sliding window, non-canonical formats, unaligned dims, a
    chunk of fewer than 16 or not a multiple of 16 tokens): the caller then
    attends eagerly. Over an MXINT cache K/V enter as their cache-write
    grid (the round trip through the cache's encode); over the fp cache as
    the rows, quantized at use (K^T per 16 tokens, V per 16 along d). OPT
    (``scale_query``) scales q before its quantizer."""
    b, h, s, d = qh.shape
    if not _prefill_kernel_takes(attn_cfg, cache, window, d) \
            or s % 16 or s < 16:
        return None
    quantized = is_quantized_cache(cache)
    if quantized:
        g = cache_group(cache)
        if d % g:
            return None
        enc, dec = ((mx4_encode, mx4_decode) if cache_code_width(cache) == 4
                    else (mx8_encode, mx8_decode))
        kh = dec(*enc(kh, g, zero_fill=1.0), g, torch.bfloat16)
        vh = dec(*enc(vh, g, zero_fill=1.0), g, torch.bfloat16)
    return fused_quantized_attention(
        qh, _expand_kv(kh, n_rep, h, q_off), _expand_kv(vh, n_rep, h, q_off),
        attn_cfg, scaling,
        scale_query=scale_query, kv_values_pre_quantized=quantized)


@tracing.annotate(tracing.ATTENTION["kernel"])
def _decode_attend(cache, qh, kh, vh, positions, li, attn_cfg, scaling,
                   route, scale_query=False, window=None):
    """Decode attention (s = 1) through the kernels of ``route``
    (:func:`decode_route`), in order: the fresh token lands in layer ``li``
    of the cache in place (a staged cache's rings; the eager route's
    caller writes a direct cache first), and the last kernel's attention
    is returned. OPT (``scale_query``) scales q before its quantizer;
    ``window`` is the sliding window (a staged cache has none:
    ``make_cache`` falls back to the direct-write one)."""
    def main():     # read in place at ``li`` (the JAX ``_quant_slices``)
        return tuple(cache[k] for k in MAIN_KEYS)

    def staged():
        return (*(cache[k][li] for k in MAIN_KEYS),
                *(cache[k][li] for k in STAGE_KEYS))

    def widths(**window):
        return dict(decode_attention_widths_quantized(attn_cfg),
                    scale_query=scale_query, **window)

    kernels = {
        "row_write": lambda: _cache_write_row(cache, li, kh, vh, positions),
        "encode_write_tokens": lambda: write_kv_tokens_fused(
            main(), kh, vh, li, positions),
        "decode_attention_write": lambda: decode_attention_quantized_write(
            qh, *main(), kh, vh, positions, li, scaling=scaling,
            **widths(window=window)),
        "decode_attention_quantized": lambda: decode_attention_quantized(
            qh, *main(), positions, li, scaling=scaling,
            **widths(window=window)),
        "decode_attention_streaming":
            lambda: decode_attention_quantized_streaming(
                qh, *main(), positions, li, scaling=scaling,
                **widths(window=window)),
        "decode_attention": lambda: decode_attention_quantized_staged(
            qh, *staged(), kh, vh, positions, cache["flushed"],
            scaling=scaling, **widths()),
        "decode_attention_streaming_staged":
            lambda: decode_attention_quantized_streaming_staged(
                qh, *staged(), kh, vh, positions, cache["flushed"],
                scaling=scaling, **widths()),
        "decode_attention_fp": lambda: decode_attention_fp(
            qh, cache["k"], cache["v"], positions, li, scaling=scaling,
            scale_query=scale_query, window=window,
            **decode_attention_widths(attn_cfg)),
    }
    for name in route:
        attn = kernels[name]()
    return attn


def _staged_eager_update(cache, li, kh, vh, positions, compute_dtype):
    """Eager staged decode write + views (s = 1; the JAX package's
    ``_staged_eager_update``): the fresh token's encode into ring lane
    ``pos % 64`` of layer ``li``, then the layer's (b, kv_heads, max_len,
    d) K/V views in ``compute_dtype``: the main cache's decode with
    columns ``[flushed, pos]`` taken from the ring (lane j holds token
    ``j mod 64``). The staged kernel's function without its savings; it
    serves where no decode kernel does (no backend,
    ``LQER_DISABLE_ATTN_KERNEL``, other attention formats)."""
    group = cache_group(cache)
    enc, dec = ((mx4_encode, mx4_decode) if cache_code_width(cache) == 4
                else (mx8_encode, mx8_decode))
    SW = cache["k_stage_codes"].shape[-1]
    L = cache["k_codes"].shape[-1]
    lane = torch.remainder(positions, SW).to(torch.int64)
    for side, new in (("k", kh), ("v", vh)):
        codes, exps = enc(new, group, zero_fill=1.0)   # (B, KVH, 1, ·)
        for key, val in ((f"{side}_stage_codes", codes),
                         (f"{side}_stage_exps", exps)):
            ring = cache[key][li]                        # (B, KVH, rows, SW)
            val_t = val.transpose(-1, -2)                # (B, KVH, rows, 1)
            ring.scatter_(-1, lane[:, None, None, None].expand_as(val_t),
                          val_t)
    col = torch.arange(L, device=positions.device)[None, :]
    valid = (col >= cache["flushed"][:, None]) & (col <= positions[:, None])

    def view(side):
        main = dec(cache[f"{side}_codes"][li].transpose(-1, -2),
                   cache[f"{side}_exps"][li].transpose(-1, -2), group,
                   compute_dtype)                        # (B, KVH, L, d)
        ring = dec(cache[f"{side}_stage_codes"][li].transpose(-1, -2),
                   cache[f"{side}_stage_exps"][li].transpose(-1, -2), group,
                   compute_dtype)                        # (B, KVH, SW, d)
        tiled = ring.repeat(1, 1, L // SW, 1)
        return torch.where(valid[:, None, :, None], tiled, main)

    return cache, view("k"), view("v")


def _staged_flush_maybe(cache, positions):
    """When any slot's ring residue reaches 48, move every slot's completed
    32-blocks of every layer into the main cache (kernel 4, in place)."""
    if not bool(torch.any(positions - cache["flushed"] >= FLUSH_RESIDUE)):
        return cache
    nf = ((positions // 32) * 32).to(torch.int32)
    flush_stage_to_main(tuple(cache[k] for k in MAIN_KEYS),
                        tuple(cache[k] for k in STAGE_KEYS),
                        cache["flushed"], nf)
    cache["flushed"].copy_(nf)
    return cache


def _kv_valid_mask(valid_lengths, s, device):
    """(b, s) mask of each admitted row's real tokens, or None."""
    if valid_lengths is None:
        return None
    return torch.arange(s, device=device)[None, :] < valid_lengths[:, None]


def _attention(cache, qh, kh, vh, positions, li, attn_cfg, scaling, n_rep,
               kv_valid, mask, *, use_ak, fresh_prefill, scan,
               scale_query=False, window=None, q_off=0):
    """One layer's attention, in the JAX package's order of eligibility
    (the branches of its ``_llama_step`` / scan bodies and
    ``_attend_auto``):
    padding rows of K/V zeroed; the prefill kernel at an admission it takes
    (then the rows written in plain PyTorch); at s = 1 with
    :func:`_use_attn_kernel`'s ``use_ak`` the decode kernels of
    :func:`decode_route` (``scan``: the stacked step's, else the eager
    step's after its plain write); a staged cache at s = 1 otherwise
    through :func:`_staged_eager_update`; everything else writes (the
    stacked step through :func:`_scan_cache_write`) and attends eagerly
    over the layer's decoded cache with the additive ``mask()``."""
    if kv_valid is not None:
        kh = kh * kv_valid[:, None, :, None].to(kh.dtype)
        vh = vh * kv_valid[:, None, :, None].to(vh.dtype)
    s = qh.shape[2]
    if fresh_prefill and s > 1:
        pre = _fresh_prefill_attend(qh, kh, vh, attn_cfg, scaling, n_rep,
                                    cache, window, scale_query, q_off)
        if pre is not None:
            _cache_write_full(cache, li, kh, vh, positions)
            return pre
    quantized = is_quantized_cache(cache)
    width = cache_code_width(cache) if quantized else 8
    kind = _cache_kind(cache)
    if s == 1 and use_ak:
        route = decode_route(kind, cache_max_len(cache), qh.shape[-1], n_rep,
                             eager=not scan)
        if not scan and not is_staged_cache(cache):
            _cache_write_full(cache, li, kh, vh, positions)
        return _decode_attend(cache, qh, kh, vh, positions, li, attn_cfg,
                              scaling, route, scale_query, window)
    if s == 1 and is_staged_cache(cache):
        _, k_l, v_l = _staged_eager_update(cache, li, kh, vh, positions,
                                           qh.dtype)
        return _attend(qh, k_l, v_l, mask(), attn_cfg, scaling, n_rep,
                       scale_query, kv_pre_quantized=True, cache_width=width,
                       q_off=q_off)
    (_scan_cache_write if scan else _cache_write_full)(cache, li, kh, vh,
                                                       positions)
    return _attend(qh, *_cache_layer_views(cache, li), mask(), attn_cfg,
                   scaling, n_rep, scale_query, kv_pre_quantized=quantized,
                   cache_width=width, q_off=q_off)


# -- steps ----------------------------------------------------------------------
def _layer_qcfgs(layer_qcfg, cfg) -> list:
    """Per-layer resolved configs: the list, one config for every layer, or
    the unquantized model's (None)."""
    if layer_qcfg is None:
        return [FP_LAYER_OPT if cfg.arch == "opt"
                else FP_LAYER_LLAMA] * cfg.num_hidden_layers
    if isinstance(layer_qcfg, list):
        return layer_qcfg
    return [layer_qcfg] * cfg.num_hidden_layers


def _begin_step(cache, cfg, layer_qcfg, backend, positions, s, scan,
                window=None, fresh_prefill=False):
    """Checks and set-up shared by the steps: the per-layer configs, the
    card's shape checks (for this step: an admission only where it is one),
    and the staged cache's flush before a decode step."""
    qcfgs = _layer_qcfgs(layer_qcfg, cfg)
    check_servable(cache, [q["attn"] for q in qcfgs], cfg.head_dim, window,
                   backend=backend is not None, scan=scan,
                   admission=fresh_prefill and s > 1)
    if s == 1 and is_staged_cache(cache):
        _staged_flush_maybe(cache, positions)
    return qcfgs


def _step_masks(positions, s, cache, dtype, window, device):
    """The step's absolute positions (b, s) and a memoized builder of the
    eager attention's additive mask (built only if a layer attends
    eagerly)."""
    q_abs = (positions[:, None] + torch.arange(s, device=device)).to(
        torch.int64)
    return q_abs, functools.cache(
        lambda: _cache_mask(q_abs, cache_max_len(cache), dtype, window))


def _end_step(h, cache, positions, valid_lengths, logits_last_only,
              lm_head, backend, tp=None):
    """The last valid rows' logits (gathered over tp with a ``tp`` shard);
    after an admission, the staged cache's stage boundary."""
    s = h.shape[1]
    h = _last_valid_h(h, valid_lengths, s, logits_last_only)
    if s > 1 and is_staged_cache(cache):
        new_pos = positions + (valid_lengths if valid_lengths is not None
                               else s)
        stage_boundary_sync(cache, new_pos)
    with tracing.HEAD:
        if tp is not None:
            return tp.logits(h, lm_head), cache
        return _lm_head_logits(h, lm_head, backend), cache


def model_step(params: dict, input_ids: torch.Tensor, cache: dict,
               positions: torch.Tensor, cfg, layer_qcfgs: list | None = None,
               backend: dict | None = None, valid_lengths=None,
               fresh_prefill: bool = False, logits_last_only: bool = False,
               tp=None):
    """Run ``input_ids (b, s)`` at ``positions (b,)`` through the model,
    updating ``cache`` in place; returns ``(logits (b, s, vocab), cache)``
    (``logits_last_only``: (b, 1, vocab) at each slot's last valid
    position). ``s > 1`` is a prefill (``fresh_prefill``: an admission at
    positions 0 on a zeroed cache; else a chunk into a filled cache),
    ``s == 1`` a decode step. ``backend``: the per-prefix kernel backend
    (``kernel_backend.prepare_serving_params``; None: every linear
    emulated); ``layer_qcfgs`` None serves the model unquantized.
    ``valid_lengths (b,)``: the real tokens of each right-padded row (K/V
    past it are zeroed before the write). ``tp``: one rank's tensor-parallel
    shard (``parallel.tp_forward.TPShard``; no backend): ``params`` and
    ``cache`` hold its heads, each sharded linear carries its ``shard``
    hook (``parallel.step.linear_hook``: o_proj and down_proj, out_proj and
    fc2, sum exactly over tp), and the logits are gathered over tp."""
    step = _opt_step if cfg.arch == "opt" else _llama_step
    return step(params, input_ids, cache, positions, cfg, layer_qcfgs,
                backend, valid_lengths, fresh_prefill, logits_last_only, tp)


def _tp_heads(cfg, tp):
    """(q heads, kv heads, q head offset) the step holds."""
    if tp is None:
        return cfg.num_attention_heads, cfg.kv_heads, 0
    return tp.heads, tp.kv_heads, tp.q_off


@tracing.annotate(tracing.FORWARD)
def _llama_step(params, input_ids, cache, positions, cfg, layer_qcfgs,
                backend=None, valid_lengths=None, fresh_prefill=False,
                logits_last_only=False, tp=None):
    b, s = input_ids.shape
    window = getattr(cfg, "sliding_window", None)
    with tracing.PROLOGUE:
        qcfgs = _begin_step(cache, cfg, layer_qcfgs, backend, positions, s,
                            scan=False, window=window,
                            fresh_prefill=fresh_prefill)
        max_len = cache_max_len(cache)
        heads, kv_heads, q_off = _tp_heads(cfg, tp)
        embed = params["model.embed_tokens.weight"]
        h = embed[input_ids] if tp is None else tp.embed(embed, input_ids)
        q_abs, mask = _step_masks(positions, s, cache, h.dtype, window,
                                  h.device)
        kv_valid = _kv_valid_mask(valid_lengths, s, h.device)
        cos, sin = _rotary(cfg.head_dim,
                           max(max_len, cfg.max_position_embeddings),
                           cfg.rope_theta, h.device)
        n_rep = cfg.num_attention_heads // cfg.kv_heads
        scaling = cfg.head_dim ** -0.5
    for i in range(cfg.num_hidden_layers):
        with tracing.LAYER:
            q = qcfgs[i]
            attn_cfg = q["attn"]
            use_ak = _use_attn_kernel(backend, s, attn_cfg, max_len,
                                      cfg.head_dim, cache)
            p = llama_mod.layer_prefix(i)
            residual = h
            hn = rms_norm(h, {"weight": params[f"{p}.input_layernorm.weight"]},
                          cfg.rms_norm_eps)
            qy, ky, vy = _lin_group(
                hn, params, p, "self_attn.qkv_proj",
                ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
                (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj), backend)
            qh = _heads(qy, heads)
            kh = _heads(ky, kv_heads)
            vh = _heads(vy, kv_heads)
            qh, kh = apply_rotary(qh, kh, cos, sin, q_abs)
            attn = _attention(cache, qh, kh, vh, positions, i, attn_cfg,
                              scaling, n_rep, kv_valid, mask, use_ak=use_ak,
                              fresh_prefill=fresh_prefill, scan=False,
                              window=window, q_off=q_off)
            attn = _lin(merge_heads(attn), params, f"{p}.self_attn.o_proj",
                        attn_cfg.o_proj, backend)
            h = residual + attn
            residual = h
            hn = rms_norm(h, {"weight":
                              params[f"{p}.post_attention_layernorm.weight"]},
                          cfg.rms_norm_eps)
            y = _mlp_fused_or_none(hn, p, q["gate_proj"], backend)
            if y is None:
                gate, up = _lin_group(hn, params, p, "mlp.gateup_proj",
                                      ("mlp.gate_proj", "mlp.up_proj"),
                                      (q["gate_proj"], q["up_proj"]), backend)
                y = _lin(silu(gate) * up, params, f"{p}.mlp.down_proj",
                         q["down_proj"], backend)
            h = residual + y
    h = rms_norm(h, {"weight": params["model.norm.weight"]}, cfg.rms_norm_eps)
    return _end_step(h, cache, positions, valid_lengths, logits_last_only,
                     params.get("lm_head.weight", embed), backend, tp)


@tracing.annotate(tracing.FORWARD)
def _opt_step(params, input_ids, cache, positions, cfg, layer_qcfgs,
              backend=None, valid_lengths=None, fresh_prefill=False,
              logits_last_only=False, tp=None):
    b, s = input_ids.shape
    with tracing.PROLOGUE:
        qcfgs = _begin_step(cache, cfg, layer_qcfgs, backend, positions, s,
                            scan=False, fresh_prefill=fresh_prefill)
        max_len = cache_max_len(cache)
        heads = _tp_heads(cfg, tp)[0]
        embed = params["model.decoder.embed_tokens.weight"]
        h = embed[input_ids] if tp is None else tp.embed(embed, input_ids)
        if params.get("model.decoder.project_in.weight") is not None:
            h = promoted_matmul(h, params["model.decoder.project_in.weight"].T)
        q_abs, mask = _step_masks(positions, s, cache, h.dtype, None, h.device)
        h = h + params["model.decoder.embed_positions.weight"][q_abs + 2]
        kv_valid = _kv_valid_mask(valid_lengths, s, h.device)
        scaling = cfg.head_dim ** -0.5

    def norm(x, prefix):
        return layer_norm(x, opt_mod._mod(params, prefix))

    pre = cfg.do_layer_norm_before
    for i in range(cfg.num_hidden_layers):
        with tracing.LAYER:
            q = qcfgs[i]
            attn_cfg = q["attn"]
            use_ak = _use_attn_kernel(backend, s, attn_cfg, max_len,
                                      cfg.head_dim, cache)
            p = opt_mod.layer_prefix(i)
            residual = h
            hn = norm(h, f"{p}.self_attn_layer_norm") if pre else h
            qy, ky, vy = _lin_group(
                hn, params, p, "self_attn.qkv_proj",
                ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
                (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj), backend)
            qh, kh, vh = (_heads(y, heads) for y in (qy, ky, vy))
            attn = _attention(cache, qh, kh, vh, positions, i, attn_cfg,
                              scaling, 1, kv_valid, mask, use_ak=use_ak,
                              fresh_prefill=fresh_prefill, scan=False,
                              scale_query=True)
            attn = _lin(merge_heads(attn), params, f"{p}.self_attn.out_proj",
                        attn_cfg.o_proj, backend)
            h = residual + attn
            if not pre:
                h = norm(h, f"{p}.self_attn_layer_norm")
            residual = h
            hn = norm(h, f"{p}.final_layer_norm") if pre else h
            y = _mlp_fused_or_none(hn, p, q["fc1"], backend)
            if y is None:
                y = relu(_lin(hn, params, f"{p}.fc1", q["fc1"], backend))
                y = _lin(y, params, f"{p}.fc2", q["fc2"], backend)
            h = residual + y
            if not pre:
                h = norm(h, f"{p}.final_layer_norm")
    if params.get("model.decoder.final_layer_norm.weight") is not None:
        h = norm(h, "model.decoder.final_layer_norm")
    if params.get("model.decoder.project_out.weight") is not None:
        h = promoted_matmul(h, params["model.decoder.project_out.weight"].T)
    return _end_step(h, cache, positions, valid_lengths, logits_last_only,
                     params.get("lm_head.weight", embed), backend, tp)


@tracing.annotate(tracing.FORWARD)
def llama_step_scan(params, input_ids, cache, positions, cfg, layer_qcfg,
                    stacked=None, rest=None, backend_stacked=None,
                    valid_lengths=None, fresh_prefill=False,
                    logits_last_only=False, tp=None):
    """:func:`model_step` for Llama over layer-stacked params (the JAX
    package's ``llama_step_scan``): ``backend_stacked`` from
    :func:`stack_backend` (None: every linear emulated on the stacked
    params); ``layer_qcfg`` one resolved layer config, the per-layer list,
    or None (unquantized). Mistral (``cfg.sliding_window``) attends within
    its window. The rotary table spans ``max(max_len,
    max_position_embeddings)``, so a cache longer than the model's
    positions serves, as in JAX. ``tp``: as in :func:`model_step`."""
    if stacked is None or rest is None:
        stacked, rest = llama_mod.stack_layer_params(params, cfg)
    b, s = input_ids.shape
    window = getattr(cfg, "sliding_window", None)
    with tracing.PROLOGUE:
        qcfgs = _begin_step(cache, cfg, layer_qcfg, backend_stacked, positions,
                            s, scan=True, window=window,
                            fresh_prefill=fresh_prefill)
        max_len = cache_max_len(cache)
        heads, kv_heads, q_off = _tp_heads(cfg, tp)
        embed = rest["model.embed_tokens.weight"]
        h = embed[input_ids] if tp is None else tp.embed(embed, input_ids)
        h_dtype = h.dtype
        q_abs, mask = _step_masks(positions, s, cache, h.dtype, window,
                                  h.device)
        cos, sin = _rotary(cfg.head_dim,
                           max(max_len, cfg.max_position_embeddings),
                           cfg.rope_theta, h.device)
        n_rep = cfg.num_attention_heads // cfg.kv_heads
        scaling = cfg.head_dim ** -0.5
        kv_valid = _kv_valid_mask(valid_lengths, s, h.device)

    for li in range(cfg.num_hidden_layers):
        with tracing.LAYER:
            q = qcfgs[li]
            attn_cfg = q["attn"]
            use_ak = _use_attn_kernel(backend_stacked, s, attn_cfg, max_len,
                                      cfg.head_dim, cache)
            seg, lj = layer_backend(backend_stacked, li)
            residual = h
            hn = rms_norm(h, {"weight": stacked["input_layernorm.weight"][li]},
                          cfg.rms_norm_eps)
            qy, ky, vy = _lin_group_slice(
                hn, stacked, li, "self_attn.qkv_proj",
                ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
                (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj), seg, lj)
            qh = _heads(qy, heads)
            kh = _heads(ky, kv_heads)
            vh = _heads(vy, kv_heads)
            qh, kh = apply_rotary(qh, kh, cos, sin, q_abs)
            attn = _attention(cache, qh, kh, vh, positions, li, attn_cfg,
                              scaling, n_rep, kv_valid, mask, use_ak=use_ak,
                              fresh_prefill=fresh_prefill, scan=True,
                              window=window, q_off=q_off)
            attn = _lin_slice(merge_heads(attn), stacked, li,
                              "self_attn.o_proj", attn_cfg.o_proj, seg, lj)
            h = residual + attn
            residual = h
            hn = rms_norm(h, {"weight":
                              stacked["post_attention_layernorm.weight"][li]},
                          cfg.rms_norm_eps)
            y = _mlp_slice_or_none(hn, q["gate_proj"], seg, lj)
            if y is None:
                gate, up = _lin_group_slice(hn, stacked, li, "mlp.gateup_proj",
                                            ("mlp.gate_proj", "mlp.up_proj"),
                                            (q["gate_proj"], q["up_proj"]),
                                            seg, lj)
                y = _lin_slice(silu(gate) * up, stacked, li, "mlp.down_proj",
                               q["down_proj"], seg, lj)
            h = (residual + y).to(h_dtype)

    h = rms_norm(h, {"weight": rest["model.norm.weight"]}, cfg.rms_norm_eps)
    return _end_step(h, cache, positions, valid_lengths, logits_last_only,
                     rest.get("lm_head.weight", embed), backend_stacked, tp)


@tracing.annotate(tracing.FORWARD)
def opt_step_scan(params, input_ids, cache, positions, cfg, layer_qcfg,
                  stacked=None, rest=None, backend_stacked=None,
                  valid_lengths=None, fresh_prefill=False,
                  logits_last_only=False, tp=None):
    """OPT analogue of :func:`llama_step_scan` (JAX
    ``serving/decode.py::opt_step_scan``): learned positions
    ``embed_positions[pos + 2]``, pre-LN or post-LN
    (``do_layer_norm_before``), q|k|v and out_proj with biases, attention
    with the query scaled before its quantizer, the relu MLP with biases,
    ``project_in``/``project_out`` (OPT-350m) and the final LayerNorm from
    ``rest``. The positions must stay inside the table: the engine refuses
    ``max_len > cfg.max_position_embeddings``. ``tp``: as in
    :func:`model_step`."""
    if stacked is None or rest is None:
        stacked, rest = opt_mod.stack_layer_params(params, cfg)
    b, s = input_ids.shape
    with tracing.PROLOGUE:
        qcfgs = _begin_step(cache, cfg, layer_qcfg, backend_stacked, positions,
                            s, scan=True, fresh_prefill=fresh_prefill)
        max_len = cache_max_len(cache)
        heads = _tp_heads(cfg, tp)[0]
        embed = rest["model.decoder.embed_tokens.weight"]
        h = embed[input_ids] if tp is None else tp.embed(embed, input_ids)
        h_dtype = h.dtype
        if rest.get("model.decoder.project_in.weight") is not None:
            h = promoted_matmul(h, rest["model.decoder.project_in.weight"].T)
        q_abs, mask = _step_masks(positions, s, cache, h.dtype, None, h.device)
        h = h + rest["model.decoder.embed_positions.weight"][q_abs + 2]
        scaling = cfg.head_dim ** -0.5
        kv_valid = _kv_valid_mask(valid_lengths, s, h.device)

    def norm(x, rel, li):
        return layer_norm(x, {k: stacked[f"{rel}.{k}"][li]
                              for k in ("weight", "bias")
                              if f"{rel}.{k}" in stacked})

    pre = cfg.do_layer_norm_before
    for li in range(cfg.num_hidden_layers):
        with tracing.LAYER:
            q = qcfgs[li]
            attn_cfg = q["attn"]
            use_ak = _use_attn_kernel(backend_stacked, s, attn_cfg, max_len,
                                      cfg.head_dim, cache)
            seg, lj = layer_backend(backend_stacked, li)
            residual = h
            hn = norm(h, "self_attn_layer_norm", li) if pre else h
            qy, ky, vy = _lin_group_slice(
                hn, stacked, li, "self_attn.qkv_proj",
                ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
                (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj), seg, lj)
            qh, kh, vh = (_heads(y, heads) for y in (qy, ky, vy))
            attn = _attention(cache, qh, kh, vh, positions, li, attn_cfg,
                              scaling, 1, kv_valid, mask, use_ak=use_ak,
                              fresh_prefill=fresh_prefill, scan=True,
                              scale_query=True)
            attn = _lin_slice(merge_heads(attn), stacked, li,
                              "self_attn.out_proj", attn_cfg.o_proj, seg, lj)
            h = residual + attn
            if not pre:
                h = norm(h, "self_attn_layer_norm", li)
            residual = h
            hn = norm(h, "final_layer_norm", li) if pre else h
            y = _mlp_slice_or_none(hn, q["fc1"], seg, lj)
            if y is None:
                y = relu(_lin_slice(hn, stacked, li, "fc1", q["fc1"], seg, lj))
                y = _lin_slice(y, stacked, li, "fc2", q["fc2"], seg, lj)
            h = residual + y
            if not pre:
                h = norm(h, "final_layer_norm", li)
            h = h.to(h_dtype)

    if rest.get("model.decoder.final_layer_norm.weight") is not None:
        h = layer_norm(h, opt_mod._mod(rest,
                                       "model.decoder.final_layer_norm"))
    if rest.get("model.decoder.project_out.weight") is not None:
        h = promoted_matmul(h, rest["model.decoder.project_out.weight"].T)
    return _end_step(h, cache, positions, valid_lengths, logits_last_only,
                     rest.get("lm_head.weight", embed), backend_stacked, tp)
