"""The sharded forward and train step over a (dp, tp) mesh (port of
``lqer_tpu/parallel/step.py``).

JAX lets GSPMD run ``models.forward`` on params placed by
``shard_params``. Here every rank runs the model's own forward
(``models.forward``'s arch module, ``return_hidden=True``) on a view of
its local shards:

* a linear whose weight arrived sharded runs its column or row form
  through ``qlinear``'s ``shard`` hook: the column form gathers its output
  columns (and the correction's, before ``b_out_quantizer``) over tp, the
  row form takes its slice of the whole quantized input and sums the
  partial products (and the partial X·A, before ``a_out_quantizer``) with
  an exact all-reduce; a linear whose weight arrived replicated runs whole
  on the rank. Activations stay whole on every rank, so every quantizer
  sees the values it sees in ``models.forward``;
* the vocab-sharded embedding is a masked local lookup summed over tp
  (handed to the forward as a table of the batch's rows), and the
  vocab-sharded head's logits are gathered over tp.

So the result is ``models.forward``'s for every configuration it runs,
OPT-350m and Mistral's window included, up to the f32 summation order.

:func:`make_train_step` differentiates that forward. Every collective's
gradient is the sum of the ranks' gradients, and each rank back-propagates
``loss / tp``: a tp-sharded parameter's gradient is then complete on its
rank, and a replicated one's (norms, a column-parallel A, a row-parallel
B, an unsharded head) is the sum over tp of the ranks' parts. Every
gradient is then averaged over dp, and the update is plain SGD, so every
rank's copy of a replicated parameter stays the same.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist

from .. import models
from ..evaluate.perplexity import causal_lm_loss
from ..ops.blocking import infer_block_shape
from ..ops.qlinear import promoted_matmul
from .collectives import all_gather, all_reduce
from .mesh import axis_size
from .sharding import param_specs, shard_params
from .tp_forward import dp_rows, sharded_embed_lookup

COL_PROJS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1")


def _blocks_split_at(qcfg: dict | None, shape, axis: int, n: int) -> bool:
    """Whether ``qcfg``'s quantizer groups of the whole tensor (``shape`` a
    shard, one of ``n`` along ``axis``) stay inside each shard, so that
    quantizing the shard is quantizing its part of the whole."""
    if not qcfg or qcfg.get("name") != "block_fp":
        return True
    whole = list(shape)
    whole[axis] *= n
    eff = infer_block_shape(tuple(whole), qcfg.get("block_size", [16]),
                            qcfg.get("skip_first_dim", True))
    return shape[axis] % eff[axis] == 0


def _quantized_shard(t, quantizer, qcfg, group, axis: int):
    """``quantizer`` of the whole tensor on this rank's shard ``t`` (one of
    the group's along ``axis``): the shard's own quantization where the
    groups stay inside it, else the gathered whole's, sliced."""
    n, axis = dist.get_world_size(group), axis % t.ndim
    if _blocks_split_at(qcfg, t.shape, axis, n):
        return quantizer(t)
    return quantizer(all_gather(t, group, axis)).chunk(n, axis)[
        dist.get_rank(group)]


def _llm_int(x, mod, qc, group, axis):
    from ..ops.llm_int8 import llm_int_linear

    bias = mod.get("bias")
    if bias is not None and axis == 0:
        bias = all_gather(bias, group, 0)
    return llm_int_linear(x, all_gather(mod["weight"], group, axis), bias,
                          bits=qc.int_bits, threshold=qc.int_threshold)


def col_local(x, mod: dict, qc, group) -> torch.Tensor:
    """A column-parallel linear with ``qlinear``'s semantics: ``x`` whole,
    the weight, bias and B this rank's output columns, A replicated;
    returns the rank's columns of the whole linear's output (every
    quantizer as it acts on the whole tensor)."""
    if qc.mode == "llm_int8":
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return _llm_int(x, mod, qc, group, 0).chunk(n, -1)[r]
    w, b = mod["weight"], mod.get("bias")
    if not qc.is_ptq:
        w = _quantized_shard(w, qc.w_quantizer, qc.w_cfg, group, 0)
        if b is not None:
            b = _quantized_shard(b, qc.b_quantizer, qc.b_cfg, group, 0)
    x_q = qc.x_quantizer(x)
    y = promoted_matmul(x_q, w.T)
    if b is not None:
        y = y + b
    if qc.is_lqer and mod.get("A") is not None:
        xa = qc.a_out_quantizer(promoted_matmul(x_q, mod["A"]))
        y = y + _quantized_shard(promoted_matmul(xa, mod["B"]),
                                 qc.b_out_quantizer, qc.b_out_cfg, group, -1)
    return y


def row_local(x_loc, mod: dict, qc, group) -> torch.Tensor:
    """A row-parallel linear with ``qlinear``'s semantics: ``x_loc`` this
    rank's input features, the weight and A their rows, B and the bias
    replicated; returns the whole output, the partial products (and the
    partial X·A, before ``a_out_quantizer``) summed by an exact
    all-reduce."""
    if qc.mode == "llm_int8":
        return _llm_int(all_gather(x_loc, group, -1), mod, qc, group, 1)
    w, b = mod["weight"], mod.get("bias")
    if not qc.is_ptq:
        w = _quantized_shard(w, qc.w_quantizer, qc.w_cfg, group, 1)
        if b is not None:
            b = qc.b_quantizer(b)
    x_q = _quantized_shard(x_loc, qc.x_quantizer, qc.x_cfg, group, -1)
    y = all_reduce(promoted_matmul(x_q, w.T), group)
    if b is not None:
        y = y + b
    if qc.is_lqer and mod.get("A") is not None:
        xa = all_reduce(promoted_matmul(x_q, mod["A"]), group)
        y = y + qc.b_out_quantizer(promoted_matmul(qc.a_out_quantizer(xa),
                                                   mod["B"]))
    return y


def col_shard(x, mod: dict, qc, group) -> torch.Tensor:
    """:func:`col_local`, gathered to the whole output."""
    return all_gather(col_local(x, mod, qc, group), group, -1)


def row_shard(x, mod: dict, qc, group) -> torch.Tensor:
    """:func:`row_local` on this rank's slice of the whole input ``x``."""
    r, in_l = dist.get_rank(group), mod["weight"].shape[1]
    return row_local(x[..., r * in_l:(r + 1) * in_l], mod, qc, group)


def linear_hook(proj: str, group, local_activations: bool = False):
    """The ``shard`` hook ``qlinear`` runs for a tp-sharded linear ``proj``:
    with whole activations (the sharded forward) :func:`col_shard` or
    :func:`row_shard`; with ``local_activations`` (the serving step, whose
    activations between a column- and a row-parallel linear are the rank's
    heads or columns) :func:`col_local` or :func:`row_local`."""
    if proj in COL_PROJS:
        form = col_local if local_activations else col_shard
    else:
        form = row_local if local_activations else row_shard
    return functools.partial(form, group=group)


def _embed_key(cfg) -> str:
    return ("model.decoder.embed_tokens.weight" if cfg.arch == "opt"
            else "model.embed_tokens.weight")


def sharded_model_forward(params: dict, input_ids: torch.Tensor, cfg,
                          layer_qcfgs, group, specs: dict) -> torch.Tensor:
    """``models.forward`` on one rank's shards (``specs``: each param's, from
    ``sharding.param_specs``): logits (b, s, vocab) of ``input_ids``."""
    view = dict(params)
    ek = _embed_key(cfg)
    embed = params[ek]
    b, s = input_ids.shape
    h0 = (sharded_embed_lookup(embed, input_ids, group)
          if specs[ek][0] == "tp" else embed[input_ids])
    view[ek] = h0.reshape(b * s, -1)
    rows = torch.arange(b * s, device=input_ids.device).reshape(b, s)
    for i in range(cfg.num_hidden_layers):
        for prefix, proj in models.quantizable_module_prefixes(cfg, i):
            spec = specs.get(prefix + ".weight", ())
            if "tp" not in spec:
                continue
            view[prefix + ".shard"] = linear_hook(proj, group)
    h = models.get_arch_module(cfg).forward(view, rows, cfg, layer_qcfgs,
                                            return_hidden=True)
    hk = "lm_head.weight" if "lm_head.weight" in params else ek
    logits = promoted_matmul(h, params[hk].T)
    return all_gather(logits, group, -1) if specs[hk][0] == "tp" else logits


def make_sharded_forward(cfg, layer_qcfgs, mesh) -> Callable:
    """``fwd(params_local, input_ids) -> logits``: ``models.forward`` of the
    whole batch (b, s, vocab) on every rank, each rank computing its dp
    rows on its tp shards, the rows gathered over dp."""
    tp_group, dp_group = mesh.get_group("tp"), mesh.get_group("dp")
    tp = axis_size(mesh, "tp")

    def fwd(params_local, input_ids):
        specs = param_specs(cfg, params_local, tp)
        logits = sharded_model_forward(params_local, dp_rows(input_ids, mesh),
                                       cfg, layer_qcfgs, tp_group, specs)
        return all_gather(logits, dp_group, 0)

    return fwd


def make_train_step(cfg, layer_qcfgs, mesh, lr: float = 1e-4) -> Callable:
    """``step(params_local, input_ids) -> (new_params_local, loss)``: one
    SGD step on the quantized model (gradients through the STE quantizers)
    of JAX's ``causal_lm_loss`` over the whole batch (each rank's dp rows;
    the loss returned is the batch's, the same on every rank)."""
    tp_group, dp_group = mesh.get_group("tp"), mesh.get_group("dp")
    tp, dp = axis_size(mesh, "tp"), axis_size(mesh, "dp")

    def step(params_local, input_ids):
        specs = param_specs(cfg, params_local, tp)
        leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in params_local.items()}
        ids = dp_rows(input_ids, mesh)
        loss = causal_lm_loss(sharded_model_forward(
            leaves, ids, cfg, layer_qcfgs, tp_group, specs), ids)
        (loss / tp).backward()
        new = {}
        with torch.no_grad():
            for k, p in leaves.items():
                if p.grad is None:
                    new[k] = params_local[k]
                    continue
                g = p.grad
                if "tp" not in specs[k]:
                    g = all_reduce(g, tp_group)
                g = all_reduce(g, dp_group) / dp
                new[k] = (p - lr * g).detach()
            loss = all_reduce(loss.detach(), dp_group) / dp
        return new, loss

    return step


def setup_sharded_model(config_cfg, params: dict, mesh) -> dict:
    """Each rank's shards of the full params (``shard_params``)."""
    return shard_params(params, mesh)


__all__ = ["COL_PROJS", "col_local", "col_shard", "linear_hook",
           "make_sharded_forward", "make_train_step", "row_local",
           "row_shard", "setup_sharded_model", "sharded_model_forward"]
