"""Cache-aware Llama step (admission prefill and decode) through the
kernels.

Port of the Llama serving path of ``lqer_tpu/serving/decode.py``:
``llama_step_scan`` on the packed backend with the ring-staged MXINT8
cache. The ``lax.scan`` over layers becomes a Python loop; each kernel takes
per-layer views of the layer-stacked weights and cache (``stacked[li]`` is
a zero-copy view), so no slice is copied. The cache is updated in place.

Per layer: RMSNorm → fused q|k|v (kernel 1) → rotary → attention → o
(kernel 1) → RMSNorm → the whole MLP in one megakernel launch (kernel 5;
with ``fuse_mlp=False`` packing: fused gate|up (kernel 1) → silu·up → down
(kernel 1)). Attention is the prefill kernel (kernel 2) at admission and
the staged decode kernel (kernel 3) at s = 1; a decode step first flushes
the rings into the main cache (kernel 4) once any slot's ring residue
reaches 48. The W8 lm_head is kernel 1 again. At 512 rows and more (an
admission of 8 x 64 tokens, a 2048-token prompt) every packed linear, the
MLP and the head take the large-M route instead: unpack each weight once
(kernel 6), then one dense product.
"""

from __future__ import annotations

import functools

import torch
from torch.nn.functional import silu

from .. import models
from ..models import llama as llama_mod
from ..models.common import (
    _std_a8,
    apply_rotary,
    fused_quantized_attention,
    merge_heads,
    repeat_kv,
    rms_norm,
    rotary_tables,
    supports_fused_attention,
)
from ..ops.kernels.cache_write import flush_stage_to_main
from ..ops.kernels.decode_attention import decode_attention_quantized_staged
from ..ops.kernels.dequant_gemm import qlinear_w4_dense_largeM, qlinear_w4_fused
from ..parallel.collectives import mx8_decode, mx8_encode
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
    init_quantized_kv_cache,
    is_staged_cache,
    stage_boundary_sync,
)

FLUSH_RESIDUE = 48  # flush once a ring holds 48 tokens: < 64 lanes always

# one (cos, sin) table pair per (head_dim, length, theta, device)
_rotary = functools.lru_cache(maxsize=8)(rotary_tables)


def make_cache(cfg, batch: int, max_len: int, dtype="mxint8-staged",
               device="cuda") -> dict:
    """Only the ring-staged MXINT8 cache is ported (``"mxint8-staged"``)."""
    if dtype != "mxint8-staged":
        raise NotImplementedError(f"cache dtype {dtype!r} is not ported; "
                                  "use 'mxint8-staged'")
    if getattr(cfg, "sliding_window", None) is not None:
        raise NotImplementedError("sliding-window attention is not ported")
    return init_quantized_kv_cache(cfg.num_hidden_layers, batch, cfg.kv_heads,
                                   cfg.head_dim, max_len, device=device)


def stack_backend(backend: dict, cfg, consume: bool = False) -> dict:
    """Prefix-keyed backend → rel-keyed layer-stacked arrays ``(L, ...)``
    with layer 0's metadata (every layer must pack alike); non-layer
    entries (the packed ``lm_head``) carry over. ``consume`` drops each
    per-layer array from ``backend`` once stacked."""
    arch = models.get_arch_module(cfg)
    p0 = arch.layer_prefix(0) + "."
    rels = [k[len(p0):] for k in backend["meta"] if k.startswith(p0)]
    arrays, meta = {}, {}
    for rel in rels:
        prefixes = [f"{arch.layer_prefix(i)}.{rel}"
                    for i in range(cfg.num_hidden_layers)]
        for p in prefixes:
            if backend["meta"][p] != backend["meta"][p0 + rel]:
                raise ValueError(f"per-layer packing differs: {p} vs layer 0")
        first = backend["arrays"][prefixes[0]]
        arrays[rel] = {
            k: (None if first[k] is None
                else torch.stack([backend["arrays"][p][k] for p in prefixes]))
            for k in first}
        meta[rel] = backend["meta"][p0 + rel]
        if consume:
            for p in prefixes:
                backend["arrays"].pop(p, None)
    layer_root = p0.rsplit(".", 2)[0]
    for k in backend["meta"]:
        if not k.startswith(layer_root):
            arrays[k] = backend["arrays"][k]
            meta[k] = backend["meta"][k]
    return {"arrays": arrays, "meta": meta}


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


def _widths(attn_cfg) -> tuple[int, int]:
    """(q_width, p_width) of the attention kernels; the K/V side is the
    cache's MXINT8 write grid."""
    qk, pv = attn_cfg.qk_cfg, attn_cfg.pv_cfg
    cfgs = [None if c is None else (c.get(k) or c.get("default"))
            for c in (qk, pv) for k in ("x_quantizer", "w_quantizer")]
    if not all(_std_a8(c) and c["width"] <= 9 for c in cfgs) \
            or cfgs[1]["width"] != 8 or cfgs[3]["width"] != 8:
        raise NotImplementedError(
            "the ported attention kernels need the MXINT8 activation format "
            f"on both matmuls with 8-bit K/V (got {qk}, {pv})")
    return int(cfgs[0]["width"]), int(cfgs[2]["width"])


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
    off), else the dense matmul."""
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
    """Prefill write (s > 1): MXINT8-encode the new rows (exact exponents,
    zero fill 1.0) and store them token-axis-last at ``positions[b] + t``."""
    s = kh.shape[2]
    group = cache_group(cache)
    idx_t = (positions[:, None] + torch.arange(s, device=kh.device)).to(
        torch.int64)
    for side, new in (("k", kh), ("v", vh)):
        codes, exps = mx8_encode(new, group, zero_fill=1.0)
        for key, val in ((f"{side}_codes", codes), (f"{side}_exps", exps)):
            arr = cache[key][li]                       # (B, KVH, rows, L)
            val_t = val.transpose(-1, -2)              # (B, KVH, rows, s)
            idx = idx_t[:, None, None, :].expand_as(val_t)
            arr.scatter_(-1, idx, val_t)


def _fresh_prefill_attend(qh, kh, vh, attn_cfg, scaling, n_rep, cache):
    """Admission attention (positions 0, fresh cache) through the prefill
    kernel; K/V enter as their MXINT8 cache-write grid."""
    if cache_code_width(cache) != 8 or not supports_fused_attention(
            attn_cfg, kv_pre_quantized=True):
        raise NotImplementedError("prefill attention needs the MXINT8 cache "
                                  "and the MXINT8 attention formats")
    b, h, s, d = qh.shape
    if d % 16 or s % 16 or s < 16:
        raise ValueError(f"prefill chunk must be a multiple of 16 (s={s})")
    g = cache_group(cache)
    kr = mx8_decode(*mx8_encode(kh, g, zero_fill=1.0), g, torch.bfloat16)
    vr = mx8_decode(*mx8_encode(vh, g, zero_fill=1.0), g, torch.bfloat16)
    return fused_quantized_attention(
        qh, repeat_kv(kr, n_rep), repeat_kv(vr, n_rep), attn_cfg, scaling,
        kv_values_pre_quantized=True)


def _staged_write_attend(cache, qh, kh, vh, positions, li, attn_cfg,
                         scaling):
    """Decode attention through the staged kernel; the fresh rows land in
    layer ``li``'s rings in place."""
    q_width, p_width = _widths(attn_cfg)
    return decode_attention_quantized_staged(
        qh, *(cache[k][li] for k in MAIN_KEYS),
        *(cache[k][li] for k in STAGE_KEYS), kh, vh, positions,
        cache["flushed"], scaling=scaling, q_width=q_width, p_width=p_width)


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


def llama_step_scan(params, input_ids, cache, positions, cfg, layer_qcfg,
                    stacked=None, rest=None, backend_stacked=None,
                    valid_lengths=None, fresh_prefill=False,
                    logits_last_only=False):
    """One model step over ``input_ids (b, s)`` at ``positions (b,)``:
    ``s > 1`` is an admission prefill (``fresh_prefill``: positions 0 on a
    zeroed cache), ``s == 1`` a decode step. Returns ``(logits, cache)``.
    ``layer_qcfg`` is one resolved layer config or the per-layer list."""
    if stacked is None or rest is None:
        stacked, rest = llama_mod.stack_layer_params(params, cfg)
    if backend_stacked is None:
        raise NotImplementedError("the port serves through the kernel "
                                  "backend only (backend_stacked)")
    if not is_staged_cache(cache):
        raise NotImplementedError("the port serves the staged cache only")
    b, s = input_ids.shape
    if s > 1 and not fresh_prefill:
        raise NotImplementedError("chunked prefill into a filled cache is "
                                  "not ported")
    max_len = cache["k_codes"].shape[-1]
    if s == 1:
        _staged_flush_maybe(cache, positions)
    embed = rest["model.embed_tokens.weight"]
    h = embed[input_ids]
    h_dtype = h.dtype
    q_abs = (positions[:, None] + torch.arange(s, device=h.device)).to(
        torch.int64)
    cos, sin = _rotary(cfg.head_dim, max(max_len, cfg.max_position_embeddings),
                       cfg.rope_theta, h.device)
    n_rep = cfg.num_attention_heads // cfg.kv_heads
    scaling = cfg.head_dim ** -0.5
    kv_valid = None
    if valid_lengths is not None:
        kv_valid = (torch.arange(s, device=h.device)[None, :]
                    < valid_lengths[:, None])
    qcfgs = (layer_qcfg if isinstance(layer_qcfg, list)
             else [layer_qcfg] * cfg.num_hidden_layers)

    for li in range(cfg.num_hidden_layers):
        q = qcfgs[li]
        attn_cfg = q["attn"]
        residual = h
        hn = rms_norm(h, {"weight": stacked["input_layernorm.weight"][li]},
                      cfg.rms_norm_eps)
        qy, ky, vy = _lin_group(
            hn, "self_attn.qkv_proj",
            ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
            (attn_cfg.q_proj, attn_cfg.k_proj, attn_cfg.v_proj),
            backend_stacked, li)
        qh = _heads(qy, cfg.num_attention_heads)
        kh = _heads(ky, cfg.kv_heads)
        vh = _heads(vy, cfg.kv_heads)
        qh, kh = apply_rotary(qh, kh, cos, sin, q_abs)
        if kv_valid is not None:
            kh = kh * kv_valid[:, None, :, None].to(kh.dtype)
            vh = vh * kv_valid[:, None, :, None].to(vh.dtype)
        if s > 1:
            attn = _fresh_prefill_attend(qh, kh, vh, attn_cfg, scaling,
                                         n_rep, cache)
            _cache_write_full(cache, li, kh, vh, positions)
        else:
            attn = _staged_write_attend(cache, qh, kh, vh, positions, li,
                                        attn_cfg, scaling)
        attn = serving_linear(merge_heads(attn),
                              "self_attn.o_proj", backend_stacked,
                              attn_cfg.o_proj, layer_index=li)
        h = residual + attn
        residual = h
        hn = rms_norm(h, {"weight":
                          stacked["post_attention_layernorm.weight"][li]},
                      cfg.rms_norm_eps)
        y = _mlp_fused_or_none(hn, q["gate_proj"], backend_stacked, li)
        if y is None:
            gate, up = _lin_group(hn, "mlp.gateup_proj",
                                  ("mlp.gate_proj", "mlp.up_proj"),
                                  (q["gate_proj"], q["up_proj"]),
                                  backend_stacked, li)
            y = serving_linear(silu(gate) * up, "mlp.down_proj",
                               backend_stacked, q["down_proj"],
                               layer_index=li)
        h = (residual + y).to(h_dtype)

    h = rms_norm(h, {"weight": rest["model.norm.weight"]}, cfg.rms_norm_eps)
    h = _last_valid_h(h, valid_lengths, s, logits_last_only)
    if s > 1:
        new_pos = positions + (valid_lengths if valid_lengths is not None
                               else s)
        stage_boundary_sync(cache, new_pos)
    lm_head = rest.get("lm_head.weight", embed)
    return _lm_head_logits(h, lm_head, backend_stacked), cache

