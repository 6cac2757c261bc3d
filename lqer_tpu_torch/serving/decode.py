"""Cache-aware Llama and OPT steps (admission prefill and decode) through
the kernels.

Port of the serving path of ``lqer_tpu/serving/decode.py``:
``llama_step_scan`` and ``opt_step_scan`` on the packed backend. The
``lax.scan`` over layers becomes a Python loop; each kernel takes per-layer
views of the layer-stacked weights and cache (``stacked[li]`` is a
zero-copy view), so no slice is copied. The cache is updated in place.

Per Llama layer: RMSNorm → fused q|k|v (kernel 1) → rotary → attention → o
(kernel 1) → RMSNorm → the whole MLP in one megakernel launch (with
``fuse_mlp=False`` packing: fused gate|up (kernel 1) → silu·up → down
(kernel 1)). An OPT layer (:func:`opt_step_scan`) has learned positions
instead of rotary, LayerNorm before (or, post-LN, after) each block, the
query scaled before its quantizer (``scale_query``), biases on every
linear and the relu variant of the megakernel. At admission, attention is
the prefill kernel and the new rows are written into the cache in plain
PyTorch (the JAX package's XLA update). Under a sliding window (Mistral,
``cfg.sliding_window``) an admission writes the cache first, then attends
over the layer's decoded cache with the eager :func:`_attend` and the
additive :func:`_cache_mask`, as the JAX package does (its prefill kernel
takes no window); this plain PyTorch attention has no TPU kernel behind it.
At s = 1 the route follows the cache (``make_cache``), each decode kernel
taking the window:

- ``mxint8-staged`` and ``mxint4-staged``: the staged decode kernel
  writes the fresh token into the ring at the cache's code width and
  attends; a step first flushes the rings into the main cache once any
  slot's ring residue reaches 48;
- ``mxint8``: one launch encodes the fresh token into column ``pos`` and
  attends (``decode_attention_quantized_write``);
- ``mxint4``: the fresh rows MXINT4-encoded, the row-write kernel stores
  the four columns, the quantized decode kernel attends at width 4;
- ``bfloat16`` (the default, as in the JAX package): the row-write kernel
  stores the bf16 rows, the fp-cache decode kernel attends, quantizing
  every operand at use.

Past the one-pass length (:func:`streams`; at Llama-2-7B width about 23K
tokens) the MXINT caches stream L as the JAX package does: the staged
caches through the streaming staged kernel, ``mxint8`` through the fused MXINT8
encode + write and the streaming kernel, ``mxint4`` through its row write
and the streaming kernel at width 4. :func:`decode_route` holds each
route, and the decode step runs the kernels it names.

The W8 lm_head is kernel 1 again (OPT's 50272-row head stays a dense
product, as in the JAX package). At 512 rows and more (an admission of
8 x 64 tokens, a 2048-token prompt) every packed linear, the MLP and the
head take the large-M route instead: unpack each weight once, then one
dense product. Regimes for which the JAX package takes a path without a
ported kernel raise ``NotImplementedError`` before any work.
"""

from __future__ import annotations

import functools
import logging

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
from ..ops.qlinear import resolve_qmatmul
from ..parallel.collectives import mx4_decode, mx4_encode, mx8_decode, mx8_encode
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


def _check_cache_regime(kind: str, max_len: int, head_dim: int) -> None:
    """Raise ``NotImplementedError`` where the JAX package serves a cache of
    this kind and length through a path the port has no kernel for."""
    if kind == "float32":
        raise NotImplementedError(
            "the float32 cache is not ported (JAX: init_kv_cache with "
            "dtype=float32, served by the eager path serving/decode.py::"
            "_attend)")
    if kind not in ("bfloat16", "mxint8", "mxint4", *STAGED_KINDS):
        raise NotImplementedError(f"cache {kind!r} is not ported")
    if max_len < 128 or max_len % 16 or head_dim % 16:
        raise NotImplementedError(
            f"decode at max_len={max_len}, head_dim={head_dim} takes the JAX "
            "package's eager path (serving/decode.py::_attend; its kernels "
            "need max_len >= 128 and max_len, head_dim multiples of 16), "
            "which is not ported")
    if kind == "bfloat16" and not _fp_cache_kernel_fits(max_len, head_dim, 2):
        raise NotImplementedError(
            f"the bf16 cache at max_len={max_len} is past the fp kernel's "
            "one-pass length (serving/decode.py::_fp_cache_kernel_fits); the "
            "JAX package takes its eager path (_attend), which is not ported")


def streams(kind: str, max_len: int, head_dim: int) -> bool:
    """Whether decode over an MXINT cache of this kind takes the streaming
    kernels: past the JAX package's one-pass length (``_kvh_chunk_fits``),
    where it streams L too. The one-pass kernels (rows 6, 7 and 10) split L
    over blocks, so nothing in shared memory bounds their length and every
    MXINT cache takes exactly JAX's route."""
    return kind in ("mxint8", "mxint4", *STAGED_KINDS) \
        and not _kvh_chunk_fits(max_len, head_dim)


def decode_route(kind: str, max_len: int, head_dim: int, n_rep: int
                 ) -> tuple[str, ...]:
    """The kernels (``ops.kernels.KERNELS`` names) that a decode step
    launches, in order, for each layer over a cache of this kind; the
    staged cache's flush runs besides, once for all layers, when a ring
    fills. The route is the same at every ``n_rep`` the kernels take, as
    in the JAX package."""
    stream = streams(kind, max_len, head_dim)
    if kind in STAGED_KINDS:   # either width, read off the cache's rows
        return (("decode_attention_streaming_staged",) if stream
                else ("decode_attention",))
    return {
        "bfloat16": ("row_write", "decode_attention_fp"),
        "mxint8": (("encode_write_tokens", "decode_attention_streaming")
                   if stream else ("decode_attention_write",)),
        "mxint4": ("row_write", "decode_attention_streaming" if stream
                   else "decode_attention_quantized"),
    }[kind]


def make_cache(cfg, batch: int, max_len: int, dtype="bfloat16",
               device="cuda") -> dict:
    """The JAX package's ``make_cache``: ``"bfloat16"`` (the default;
    ``torch.bfloat16`` too), ``"mxint8"``, ``"mxint8-staged"``,
    ``"mxint4"`` and ``"mxint4-staged"``. As in JAX, a staged name under a
    sliding window (or where ``max_len % 128 != 0``) gives the direct-write
    cache of its width, and the MXINT4 caches need ``head_dim % 32 == 0``.
    ``"float32"`` and lengths the kernels do not serve raise
    ``NotImplementedError``."""
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
    _check_cache_regime(kind, max_len, cfg.head_dim)
    shape = (cfg.num_hidden_layers, batch, cfg.kv_heads, cfg.head_dim,
             max_len)
    if kind == "bfloat16":
        return init_kv_cache(*shape, dtype=torch.bfloat16, device=device)
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


def _attend(qh, k_l, v_l, mask, attn_cfg, scaling, n_rep, scale_query=False,
            kv_pre_quantized=False, cache_width=8):
    """Eager cache attention (the JAX package's ``serving/decode.py::
    _attend``), in plain PyTorch: quantized matmuls on (b·h, ...) operands,
    so quantizer groups never span heads; K^T quantizes in groups of 16
    tokens over the whole ``max_len``, whose invalid slots are zero; with
    ``kv_pre_quantized`` (an MXINT cache whose format is the configured
    K/V one) the K/V-side quantizers pass through. Scores scale in q's
    dtype (the scalar rounded to it first, as JAX's weakly typed one), the
    additive ``mask`` is added, the softmax runs in f32 and the
    probabilities return to q's dtype. (b, h, s, d) in and out."""
    if kv_pre_quantized and _kv_config_is_cache_format(attn_cfg,
                                                       cache_width):
        qk_matmul, pv_matmul = _kv_skip_matmuls(attn_cfg)
    else:
        qk_matmul, pv_matmul = attn_cfg.qk_matmul, attn_cfg.pv_matmul
    k_full = repeat_kv(k_l, n_rep)
    v_full = repeat_kv(v_l, n_rep)
    b, h, s, d = qh.shape
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


def check_servable(cache: dict, attn_cfgs, head_dim: int,
                   window: int | None = None) -> None:
    """Raise ``NotImplementedError`` unless every admission and decode step
    over ``cache`` with these attention configs runs through a ported
    path: a decode kernel at every step, and an admission through the
    prefill kernel, or under a sliding window the eager :func:`_attend`
    (as in the JAX package, whose prefill kernel takes no window). A cache
    on the card also needs a head dim its kernels take
    (:func:`check_card_shapes`)."""
    kind = _cache_kind(cache)
    max_len = cache_max_len(cache)
    _check_cache_regime(kind, max_len, head_dim)
    check_card_shapes(head_dim, next(iter(cache.values())).device.type)
    quantized = is_quantized_cache(cache)
    width = cache_code_width(cache) if quantized else 8
    # layers resolved from one config share its matmul dicts
    for attn_cfg in {(id(c.qk_cfg), id(c.pv_cfg)): c
                     for c in attn_cfgs}.values():
        if not supports_decode_attention(attn_cfg, width):
            raise NotImplementedError(
                f"decode attention of this configuration over the {kind} "
                "cache takes the JAX package's eager path (serving/decode.py"
                "::_attend; the kernels need the MXINT attention formats "
                f"with K/V at the cache's width {width}), which the port "
                "does not take at decode")
        if window is None and (
                not supports_fused_attention(attn_cfg,
                                             kv_pre_quantized=quantized)
                or (quantized and not _kv_config_is_cache_format(attn_cfg,
                                                                 width))):
            raise NotImplementedError(
                f"admission attention of this configuration over the {kind} "
                "cache takes the JAX package's eager path (serving/decode.py"
                "::_fresh_prefill_attend returns None), which the port takes "
                "only under a sliding window")


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


def layer_backend(backend_stacked: dict, li: int) -> tuple[dict, int]:
    """The stacked entries of the segment that holds layer ``li``
    (:func:`stack_backend`) and ``li``'s index inside it."""
    for start, end, seg in backend_stacked["segments"]:
        if start <= li < end:
            return seg, li - start
    raise IndexError(f"layer {li} is in no segment of the backend")


def _lin_group(x, fused_rel, member_rels, qcs, backend, li):
    """Projections sharing one input: one launch when the backend packed
    the group fused, else one launch per member."""
    if fused_rel in backend["meta"]:
        return serving_linear_split(x, fused_rel, backend, qcs[0],
                                    layer_index=li)
    return [serving_linear(x, rel, backend, qc, layer_index=li)
            for rel, qc in zip(member_rels, qcs)]


def _mlp_fused_or_none(x, qc_first, backend, li):
    """The whole MLP through the megakernel when the backend packed it
    (``mlp_fused``), else None (the caller runs the per-linear path)."""
    if "mlp_fused" not in backend["meta"]:
        return None
    return serving_mlp(x, "mlp_fused", backend, qc_first, layer_index=li)


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
    return torch.matmul(h, lm_head.T.to(h.dtype))


def _cache_write_full(cache, li, kh, vh, positions):
    """Admission write (s > 1) of the new rows at ``positions[b] + t``: the
    bf16 rows into the fp cache, or their MXINT8/MXINT4 encode (exact
    exponents, zero fill 1.0) token-axis-last into the MXINT cache."""
    s = kh.shape[2]
    idx_t = (positions[:, None] + torch.arange(s, device=kh.device)).to(
        torch.int64)
    if not is_quantized_cache(cache):
        for key, new in (("k", kh), ("v", vh)):
            arr = cache[key][li]                       # (B, KVH, L, d)
            val = new.to(arr.dtype)
            arr.scatter_(2, idx_t[:, None, :, None].expand_as(val), val)
        return
    group = cache_group(cache)
    enc = mx4_encode if cache_code_width(cache) == 4 else mx8_encode
    for side, new in (("k", kh), ("v", vh)):
        codes, exps = enc(new, group, zero_fill=1.0)
        for key, val in ((f"{side}_codes", codes), (f"{side}_exps", exps)):
            arr = cache[key][li]                       # (B, KVH, rows, L)
            val_t = val.transpose(-1, -2)              # (B, KVH, rows, s)
            idx = idx_t[:, None, None, :].expand_as(val_t)
            arr.scatter_(-1, idx, val_t)


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


def _fresh_prefill_attend(qh, kh, vh, attn_cfg, scaling, n_rep, cache,
                          scale_query=False):
    """Admission attention (positions 0, fresh cache) through the prefill
    kernel. Over an MXINT cache K/V enter as their cache-write grid (the
    round trip through the cache's encode); over the fp cache as the f32
    rows, quantized at use (K^T per 16 tokens, V per 16 along d). OPT
    (``scale_query``) scales q before its quantizer."""
    b, h, s, d = qh.shape
    if d % 16 or s % 16 or s < 16:
        raise ValueError(f"prefill chunk must be a multiple of 16 (s={s})")
    quantized = is_quantized_cache(cache)
    if quantized:
        g = cache_group(cache)
        enc, dec = ((mx4_encode, mx4_decode) if cache_code_width(cache) == 4
                    else (mx8_encode, mx8_decode))
        kh = dec(*enc(kh, g, zero_fill=1.0), g, torch.bfloat16)
        vh = dec(*enc(vh, g, zero_fill=1.0), g, torch.bfloat16)
    return fused_quantized_attention(
        qh, repeat_kv(kh, n_rep), repeat_kv(vh, n_rep), attn_cfg, scaling,
        scale_query=scale_query, kv_values_pre_quantized=quantized)


def _decode_attend(cache, qh, kh, vh, positions, li, attn_cfg, scaling,
                   route, scale_query=False, window=None):
    """Decode attention (s = 1) through the kernels of ``route``
    (:func:`decode_route`), in order: the fresh token lands in layer ``li``
    of the cache in place (a staged cache's rings), and the last kernel's
    attention is returned. OPT (``scale_query``) scales q before its
    quantizer; ``window`` is the sliding window (a staged cache has none:
    ``make_cache`` falls back to the direct-write one)."""
    def main():
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


def _begin_step(cache, cfg, layer_qcfg, backend_stacked, positions, s,
                fresh_prefill, window=None):
    """Checks and set-up shared by the steps: the per-layer configs, the
    decode route, and the staged cache's flush before a decode step."""
    if backend_stacked is None:
        raise NotImplementedError("the port serves through the kernel "
                                  "backend only (backend_stacked)")
    if s > 1 and not fresh_prefill:
        raise NotImplementedError("chunked prefill into a filled cache is "
                                  "not ported")
    qcfgs = (layer_qcfg if isinstance(layer_qcfg, list)
             else [layer_qcfg] * cfg.num_hidden_layers)
    n_rep = cfg.num_attention_heads // cfg.kv_heads
    check_servable(cache, [q["attn"] for q in qcfgs], cfg.head_dim, window)
    route = decode_route(_cache_kind(cache), cache_max_len(cache),
                         cfg.head_dim, n_rep)
    if s == 1 and is_staged_cache(cache):
        _staged_flush_maybe(cache, positions)
    return qcfgs, route, n_rep


def _kv_valid(valid_lengths, s, device):
    """(b, s) mask of each admitted row's real tokens, or None."""
    if valid_lengths is None:
        return None
    return torch.arange(s, device=device)[None, :] < valid_lengths[:, None]


def _attention(cache, qh, kh, vh, positions, li, attn_cfg, scaling, n_rep,
               route, kv_valid, scale_query=False, window=None, mask=None):
    """One layer's attention: padding rows of K/V zeroed; an admission
    through the prefill kernel, then its rows written into the cache (under
    a sliding ``window``: the rows written first, then the eager
    :func:`_attend` over the layer's decoded cache with the additive
    ``mask``); a decode step through the kernels of ``route``."""
    if kv_valid is not None:
        kh = kh * kv_valid[:, None, :, None].to(kh.dtype)
        vh = vh * kv_valid[:, None, :, None].to(vh.dtype)
    if qh.shape[2] > 1 and window is not None:
        _cache_write_full(cache, li, kh, vh, positions)
        quantized = is_quantized_cache(cache)
        return _attend(qh, *_cache_layer_views(cache, li), mask, attn_cfg,
                       scaling, n_rep, scale_query,
                       kv_pre_quantized=quantized,
                       cache_width=cache_code_width(cache) if quantized
                       else 8)
    if qh.shape[2] > 1:
        attn = _fresh_prefill_attend(qh, kh, vh, attn_cfg, scaling, n_rep,
                                     cache, scale_query)
        _cache_write_full(cache, li, kh, vh, positions)
        return attn
    return _decode_attend(cache, qh, kh, vh, positions, li, attn_cfg,
                          scaling, route, scale_query, window)


def _end_step(h, cache, positions, valid_lengths, logits_last_only,
              lm_head, backend_stacked):
    """The last valid rows' logits; after an admission, the staged cache's
    stage boundary."""
    s = h.shape[1]
    h = _last_valid_h(h, valid_lengths, s, logits_last_only)
    if s > 1 and is_staged_cache(cache):
        new_pos = positions + (valid_lengths if valid_lengths is not None
                               else s)
        stage_boundary_sync(cache, new_pos)
    return _lm_head_logits(h, lm_head, backend_stacked), cache


def llama_step_scan(params, input_ids, cache, positions, cfg, layer_qcfg,
                    stacked=None, rest=None, backend_stacked=None,
                    valid_lengths=None, fresh_prefill=False,
                    logits_last_only=False):
    """One model step over ``input_ids (b, s)`` at ``positions (b,)``:
    ``s > 1`` is an admission prefill (``fresh_prefill``: positions 0 on a
    zeroed cache), ``s == 1`` a decode step. Returns ``(logits, cache)``.
    ``layer_qcfg`` is one resolved layer config or the per-layer list.
    Mistral (``cfg.sliding_window``) attends within its window: eagerly at
    admission, through the decode kernels' window argument at s = 1. The
    rotary table spans ``max(max_len, max_position_embeddings)``, so a
    cache longer than the model's positions serves, as in JAX."""
    if stacked is None or rest is None:
        stacked, rest = llama_mod.stack_layer_params(params, cfg)
    b, s = input_ids.shape
    window = getattr(cfg, "sliding_window", None)
    qcfgs, route, n_rep = _begin_step(cache, cfg, layer_qcfg,
                                      backend_stacked, positions, s,
                                      fresh_prefill, window)
    embed = rest["model.embed_tokens.weight"]
    h = embed[input_ids]
    h_dtype = h.dtype
    q_abs = (positions[:, None] + torch.arange(s, device=h.device)).to(
        torch.int64)
    cos, sin = _rotary(cfg.head_dim,
                       max(cache_max_len(cache), cfg.max_position_embeddings),
                       cfg.rope_theta, h.device)
    scaling = cfg.head_dim ** -0.5
    kv_valid = _kv_valid(valid_lengths, s, h.device)
    mask = (_cache_mask(q_abs, cache_max_len(cache), h.dtype, window)
            if s > 1 and window is not None else None)

    for li in range(cfg.num_hidden_layers):
        q = qcfgs[li]
        attn_cfg = q["attn"]
        lb, lj = layer_backend(backend_stacked, li)
        residual = h
        hn = rms_norm(h, {"weight": stacked["input_layernorm.weight"][li]},
                      cfg.rms_norm_eps)
        qy, ky, vy = _lin_group(
            hn, "self_attn.qkv_proj",
            ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
            (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj),
            lb, lj)
        qh = _heads(qy, cfg.num_attention_heads)
        kh = _heads(ky, cfg.kv_heads)
        vh = _heads(vy, cfg.kv_heads)
        qh, kh = apply_rotary(qh, kh, cos, sin, q_abs)
        attn = _attention(cache, qh, kh, vh, positions, li, attn_cfg,
                          scaling, n_rep, route, kv_valid, window=window,
                          mask=mask)
        attn = serving_linear(merge_heads(attn),
                              "self_attn.o_proj", lb,
                              attn_cfg.o_proj, layer_index=lj)
        h = residual + attn
        residual = h
        hn = rms_norm(h, {"weight":
                          stacked["post_attention_layernorm.weight"][li]},
                      cfg.rms_norm_eps)
        y = _mlp_fused_or_none(hn, q["gate_proj"], lb, lj)
        if y is None:
            gate, up = _lin_group(hn, "mlp.gateup_proj",
                                  ("mlp.gate_proj", "mlp.up_proj"),
                                  (q["gate_proj"], q["up_proj"]),
                                  lb, lj)
            y = serving_linear(silu(gate) * up, "mlp.down_proj",
                               lb, q["down_proj"],
                               layer_index=lj)
        h = (residual + y).to(h_dtype)

    h = rms_norm(h, {"weight": rest["model.norm.weight"]}, cfg.rms_norm_eps)
    return _end_step(h, cache, positions, valid_lengths, logits_last_only,
                     rest.get("lm_head.weight", embed), backend_stacked)


def opt_step_scan(params, input_ids, cache, positions, cfg, layer_qcfg,
                  stacked=None, rest=None, backend_stacked=None,
                  valid_lengths=None, fresh_prefill=False,
                  logits_last_only=False):
    """OPT analogue of :func:`llama_step_scan` (JAX
    ``serving/decode.py::opt_step_scan``): learned positions
    ``embed_positions[pos + 2]``, pre-LN or post-LN
    (``do_layer_norm_before``), q|k|v and out_proj with biases, attention
    with the query scaled before its quantizer, the relu MLP with biases,
    ``project_in``/``project_out`` (OPT-350m) and the final LayerNorm from
    ``rest``. The positions must stay inside the table: the engine refuses
    ``max_len > cfg.max_position_embeddings``."""
    if stacked is None or rest is None:
        stacked, rest = opt_mod.stack_layer_params(params, cfg)
    b, s = input_ids.shape
    qcfgs, route, n_rep = _begin_step(cache, cfg, layer_qcfg,
                                      backend_stacked, positions, s,
                                      fresh_prefill)
    embed = rest["model.decoder.embed_tokens.weight"]
    h = embed[input_ids]
    h_dtype = h.dtype
    if rest.get("model.decoder.project_in.weight") is not None:
        h = torch.matmul(h, rest["model.decoder.project_in.weight"].T)
    q_abs = (positions[:, None] + torch.arange(s, device=h.device)).to(
        torch.int64)
    h = h + rest["model.decoder.embed_positions.weight"][q_abs + 2]
    scaling = cfg.head_dim ** -0.5
    kv_valid = _kv_valid(valid_lengths, s, h.device)

    def norm(x, rel, li):
        return layer_norm(x, {k: stacked[f"{rel}.{k}"][li]
                              for k in ("weight", "bias")
                              if f"{rel}.{k}" in stacked})

    pre = cfg.do_layer_norm_before
    for li in range(cfg.num_hidden_layers):
        q = qcfgs[li]
        attn_cfg = q["attn"]
        lb, lj = layer_backend(backend_stacked, li)
        residual = h
        hn = norm(h, "self_attn_layer_norm", li) if pre else h
        qy, ky, vy = _lin_group(
            hn, "self_attn.qkv_proj",
            ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
            (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj),
            lb, lj)
        qh, kh, vh = (_heads(y, cfg.num_attention_heads)
                      for y in (qy, ky, vy))
        attn = _attention(cache, qh, kh, vh, positions, li, attn_cfg,
                          scaling, n_rep, route, kv_valid, scale_query=True)
        attn = serving_linear(merge_heads(attn), "self_attn.out_proj",
                              lb, attn_cfg.o_proj,
                              layer_index=lj)
        h = residual + attn
        if not pre:
            h = norm(h, "self_attn_layer_norm", li)
        residual = h
        hn = norm(h, "final_layer_norm", li) if pre else h
        y = _mlp_fused_or_none(hn, q["fc1"], lb, lj)
        if y is None:
            y = relu(serving_linear(hn, "fc1", lb, q["fc1"],
                                    layer_index=lj))
            y = serving_linear(y, "fc2", lb, q["fc2"],
                               layer_index=lj)
        h = residual + y
        if not pre:
            h = norm(h, "final_layer_norm", li)
        h = h.to(h_dtype)

    if rest.get("model.decoder.final_layer_norm.weight") is not None:
        h = layer_norm(h, opt_mod._mod(rest,
                                       "model.decoder.final_layer_norm"))
    if rest.get("model.decoder.project_out.weight") is not None:
        h = torch.matmul(h, rest["model.decoder.project_out.weight"].T)
    return _end_step(h, cache, positions, valid_lengths, logits_last_only,
                     rest.get("lm_head.weight", embed), backend_stacked)
