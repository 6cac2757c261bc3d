"""The tensor-parallel forward with explicit (optionally quantized)
collectives (port of ``lqer_tpu/parallel/tp_forward.py``).

Every rank runs the decoder on its shard (``sharding.shard_params``'
Megatron layout): column-parallel q/k/v and gate/up on its heads and
columns, the attention on its heads, and the row-parallel o_proj and
down_proj reduced over tp. With ``quantized_collectives`` each of those
two reductions per layer is JAX's quantized ring: ``quantized_psum_scatter``
then ``quantized_all_gather`` (MXINT8 codes and int8 exponents on the
wire); without, one exact all-reduce. The partial X·A of a row-parallel
correction is summed exactly before ``a_out_quantizer``, as in JAX. The
vocab-sharded embedding is a masked local lookup summed over tp, and the
logits are gathered over tp. Data parallelism splits the batch over dp:
each rank returns its dp rows of logits, for every vocab column.

Scope and refusals are JAX's: Llama/Mistral and OPT (pre/post-LN, learned
positions, the query scaled before its quantizer, the ReLU MLP), a
``ValueError`` for dimensions tp does not divide (heads, kv heads, hidden
and intermediate in 16-groups, vocab), ``NotImplementedError`` for
OPT-350m's ``project_in``/``project_out`` and other architectures. As in
JAX, the mask is the plain causal one (no sliding window).

:class:`TPShard` carries the embedding lookup and the logits gather into
the serving step (``serving/decode.py``) for ``DecodeEngine(mesh=...)``,
whose linears run ``parallel.step``'s shard hooks.
"""

from __future__ import annotations

import torch
from torch.nn.functional import relu, silu

from ..models.common import (
    apply_rotary,
    causal_mask,
    eager_attention,
    layer_norm,
    merge_heads,
    repeat_kv,
    rms_norm,
    rotary_tables,
)
from ..models.llama import _mod
from ..ops.qlinear import promoted_matmul
from .collectives import (
    all_gather,
    all_reduce,
    quantized_all_gather,
    quantized_psum_scatter,
)
from .mesh import axis_size


def dp_rows(input_ids: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch split over dp."""
    dp, d = axis_size(mesh, "dp"), mesh.get_local_rank("dp")
    if input_ids.shape[0] % dp:
        raise ValueError(f"a batch of {input_ids.shape[0]} rows does not "
                         f"split over dp = {dp}")
    return input_ids.chunk(dp)[d]


def sharded_embed_lookup(embed_l: torch.Tensor, ids: torch.Tensor, group
                         ) -> torch.Tensor:
    """Vocab-sharded embedding: each rank looks up the ids in its rows
    (zeros elsewhere), summed exactly over the group."""
    vocab_l = embed_l.shape[0]
    offset = torch.distributed.get_rank(group) * vocab_l
    local = (ids - offset).clamp(0, vocab_l - 1)
    in_shard = (ids >= offset) & (ids < offset + vocab_l)
    h = torch.where(in_shard[..., None], embed_l[local],
                    torch.zeros((), dtype=embed_l.dtype,
                                device=embed_l.device))
    return all_reduce(h, group)


def col_linear(x, mod: dict, qc) -> torch.Tensor:
    """Column-parallel linear (JAX ``col_linear``): ``x`` replicated, the
    weight, bias and B this rank's output columns, A replicated; returns
    the rank's columns (the correction quantized over them)."""
    x_q = qc.x_quantizer(x)
    y = promoted_matmul(x_q, mod["weight"].T)
    if mod.get("bias") is not None:
        y = y + mod["bias"]
    if qc.is_lqer and mod.get("A") is not None:
        xa = qc.a_out_quantizer(promoted_matmul(x_q, mod["A"]))
        y = y + qc.b_out_quantizer(promoted_matmul(xa, mod["B"]))
    return y


def reduce_row_parallel(y: torch.Tensor, group, quantized: bool,
                        group_size: int = 16) -> torch.Tensor:
    """Sum the partial outputs of a row-parallel linear over ``group``:
    one exact all-reduce, or JAX's quantized reduce-scatter + all-gather
    over the feature axis (each rank's f/tp features in 16-groups)."""
    if not quantized:
        return all_reduce(y, group)
    *lead, f = y.shape
    flat = y.reshape(-1, f)
    red = quantized_psum_scatter(flat, group, scatter_axis=1,
                                 group_size=group_size)
    return quantized_all_gather(red, group, gather_axis=1,
                                group_size=group_size,
                                dtype=y.dtype).reshape(*lead, f)


def row_linear(x_loc, mod: dict, qc, group, quantized: bool = False,
               group_size: int = 16) -> torch.Tensor:
    """Row-parallel linear (JAX ``row_linear``): ``x_loc`` this rank's input
    features, the weight and A their rows, B and the bias replicated;
    returns the replicated output. The partial X·A is summed exactly before
    ``a_out_quantizer``; the main partials through
    :func:`reduce_row_parallel`."""
    x_q = qc.x_quantizer(x_loc)
    y = reduce_row_parallel(promoted_matmul(x_q, mod["weight"].T), group,
                            quantized, group_size)
    if mod.get("bias") is not None:
        y = y + mod["bias"]
    if qc.is_lqer and mod.get("A") is not None:
        xa = all_reduce(promoted_matmul(x_q, mod["A"]), group)
        y = y + qc.b_out_quantizer(promoted_matmul(qc.a_out_quantizer(xa),
                                                   mod["B"]))
    return y


def check_tp_dims(cfg, tp: int) -> None:
    """JAX ``make_tp_forward``'s refusals."""
    is_opt = getattr(cfg, "arch", None) == "opt"
    if not is_opt and cfg.arch not in ("llama", "mistral"):
        raise NotImplementedError(f"tp_forward does not cover arch "
                                  f"{cfg.arch}")
    if is_opt and cfg.embed_dim != cfg.hidden_size:
        raise NotImplementedError(
            "OPT-350m project_in/out is not tensor-parallelized")
    heads = cfg.num_attention_heads
    kv = cfg.kv_heads
    inter = cfg.ffn_dim if is_opt else cfg.intermediate_size
    if heads % tp or kv % tp or cfg.hidden_size % (tp * 16) or \
            inter % (tp * 16) or cfg.vocab_size % tp:
        raise ValueError(
            f"model dims not divisible for tp={tp}: heads={heads} kv={kv} "
            f"hidden={cfg.hidden_size} inter={inter} "
            f"vocab={cfg.vocab_size}")


def make_tp_forward(cfg, layer_qcfgs, mesh, *,
                    quantized_collectives: bool = True, group: int = 16):
    """``fwd(params_local, input_ids) -> logits``, run on every rank of
    ``mesh``: ``params_local`` is the rank's ``shard_params`` output,
    ``input_ids`` the whole batch (b, s); the result is the rank's dp rows
    of logits (b / dp, s, vocab)."""
    from ..models.fp_config import FP_LAYER_LLAMA, FP_LAYER_OPT

    tp = axis_size(mesh, "tp")
    check_tp_dims(cfg, tp)
    tp_group = mesh.get_group("tp")
    is_opt = cfg.arch == "opt"
    heads_l = cfg.num_attention_heads // tp
    kv_l = cfg.kv_heads // tp
    n_rep = cfg.num_attention_heads // cfg.kv_heads
    scaling = cfg.head_dim ** -0.5

    def q(i):
        if layer_qcfgs is not None:
            return layer_qcfgs[i]
        return FP_LAYER_OPT if is_opt else FP_LAYER_LLAMA

    def row(x, mod, qc):
        return row_linear(x, mod, qc, tp_group, quantized_collectives, group)

    def heads_of(y, n):
        b, s, _ = y.shape
        return y.reshape(b, s, n, -1).transpose(1, 2)

    def logits(h, lm_head):
        return all_gather(promoted_matmul(h, lm_head.T), tp_group, axis=-1)

    def body_llama(params, ids):
        b, s = ids.shape
        embed_l = params["model.embed_tokens.weight"]
        h = sharded_embed_lookup(embed_l, ids, tp_group)
        cos, sin = rotary_tables(cfg.head_dim,
                                 max(s, cfg.max_position_embeddings),
                                 cfg.rope_theta, device=h.device)
        positions = torch.arange(s, device=h.device)
        mask = causal_mask(s, dtype=h.dtype, device=h.device)
        for i in range(cfg.num_hidden_layers):
            p = f"model.layers.{i}"
            lq = q(i)
            attn_cfg = lq["attn"]
            residual = h
            hn = rms_norm(h, {"weight": params[f"{p}.input_layernorm.weight"]},
                          cfg.rms_norm_eps)
            qh = heads_of(col_linear(hn, _mod(params, f"{p}.self_attn.q_proj"),
                                     attn_cfg.q_proj), heads_l)
            kh = heads_of(col_linear(hn, _mod(params, f"{p}.self_attn.k_proj"),
                                     attn_cfg.k_proj), kv_l)
            vh = heads_of(col_linear(hn, _mod(params, f"{p}.self_attn.v_proj"),
                                     attn_cfg.v_proj), kv_l)
            qh, kh = apply_rotary(qh, kh, cos, sin, positions)
            attn = eager_attention(qh, repeat_kv(kh, n_rep),
                                   repeat_kv(vh, n_rep), mask,
                                   attn_cfg.qk_matmul, attn_cfg.pv_matmul,
                                   scaling=scaling)
            h = residual + row(merge_heads(attn),
                               _mod(params, f"{p}.self_attn.o_proj"),
                               attn_cfg.o_proj)
            residual = h
            hn = rms_norm(
                h, {"weight": params[f"{p}.post_attention_layernorm.weight"]},
                cfg.rms_norm_eps)
            gate = col_linear(hn, _mod(params, f"{p}.mlp.gate_proj"),
                              lq["gate_proj"])
            up = col_linear(hn, _mod(params, f"{p}.mlp.up_proj"),
                            lq["up_proj"])
            h = residual + row(silu(gate) * up,
                               _mod(params, f"{p}.mlp.down_proj"),
                               lq["down_proj"])
        h = rms_norm(h, {"weight": params["model.norm.weight"]},
                     cfg.rms_norm_eps)
        return logits(h, params.get("lm_head.weight", embed_l))

    def body_opt(params, ids):
        b, s = ids.shape
        embed_l = params["model.decoder.embed_tokens.weight"]
        h = sharded_embed_lookup(embed_l, ids, tp_group)
        positions = torch.arange(s, device=h.device) + 2
        h = h + params["model.decoder.embed_positions.weight"][positions]
        mask = causal_mask(s, dtype=h.dtype, device=h.device)

        def norm(x, prefix):
            return layer_norm(x, _mod(params, prefix))

        pre = cfg.do_layer_norm_before
        for i in range(cfg.num_hidden_layers):
            p = f"model.decoder.layers.{i}"
            lq = q(i)
            attn_cfg = lq["attn"]
            residual = h
            if pre:
                h = norm(h, f"{p}.self_attn_layer_norm")
            qh, kh, vh = (
                heads_of(col_linear(h, _mod(params, f"{p}.self_attn.{proj}"),
                                    getattr(attn_cfg, proj)), heads_l)
                for proj in ("q_proj", "k_proj", "v_proj"))
            attn = eager_attention(qh, kh, vh, mask, attn_cfg.qk_matmul,
                                   attn_cfg.pv_matmul, scaling=scaling,
                                   scale_query=True)
            h = residual + row(merge_heads(attn),
                               _mod(params, f"{p}.self_attn.out_proj"),
                               attn_cfg.o_proj)
            if not pre:
                h = norm(h, f"{p}.self_attn_layer_norm")
            residual = h
            if pre:
                h = norm(h, f"{p}.final_layer_norm")
            y = relu(col_linear(h, _mod(params, f"{p}.fc1"), lq["fc1"]))
            h = residual + row(y, _mod(params, f"{p}.fc2"), lq["fc2"])
            if not pre:
                h = norm(h, f"{p}.final_layer_norm")
        if params.get("model.decoder.final_layer_norm.weight") is not None:
            h = norm(h, "model.decoder.final_layer_norm")
        return logits(h, params.get("lm_head.weight", embed_l))

    body = body_opt if is_opt else body_llama

    def fwd(params_local, input_ids):
        return body(params_local, dp_rows(input_ids, mesh))

    return fwd


class TPShard:
    """One rank's part of a tp group in the serving step
    (``serving/decode.py``'s ``tp``): its q heads and kv heads (all kv
    heads where tp does not divide them: the rank then attends its q heads
    to the kv heads they map to, from ``q_off`` on), the vocab-sharded
    embedding lookup, and the logits gathered over tp."""

    def __init__(self, cfg, group):
        self.group = group
        tp = torch.distributed.get_world_size(group)
        rank = torch.distributed.get_rank(group)
        self.heads = cfg.num_attention_heads // tp
        self.kv_heads = (cfg.kv_heads // tp if cfg.kv_heads % tp == 0
                         else cfg.kv_heads)
        self.q_off = (0 if self.kv_heads * tp == cfg.kv_heads
                      else rank * self.heads)
        self.vocab_sharded = cfg.vocab_size % tp == 0

    def embed(self, embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if not self.vocab_sharded:
            return embed[ids]
        return sharded_embed_lookup(embed, ids, self.group)

    def logits(self, h, lm_head) -> torch.Tensor:
        y = promoted_matmul(h, lm_head.T)
        return all_gather(y, self.group, axis=-1) if self.vocab_sharded \
            else y


__all__ = ["TPShard", "col_linear", "dp_rows", "make_tp_forward",
           "reduce_row_parallel", "row_linear", "sharded_embed_lookup"]
