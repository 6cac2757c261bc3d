"""Tensor-parallel sharding rules for flat param dicts (port of
``lqer_tpu/parallel/sharding.py``).

Megatron layout per decoder layer, the JAX package's rules in its order:

* column-parallel (q/k/v/gate/up/fc1): weight ``(out, in)`` sharded on out,
  bias on out, the low-rank ``B (rank, out)`` on out, ``A (in, rank)``
  replicated;
* row-parallel (o_proj/out_proj/down/fc2): weight sharded on in, ``A`` on
  in, ``B`` and the bias replicated;
* token embeddings and the head vocab-sharded; positions, norms and
  everything else replicated.

A spec is a tuple with ``"tp"`` or None per dimension (the entries of
JAX's ``PartitionSpec``). :func:`shard_params` gives each rank its shard as
a plain local tensor: the tensor-parallel paths run on local tensors with
explicit collectives, as JAX's ``shard_map`` bodies do, and a slice needs
no communication. A dimension that tp does not divide stays replicated,
as in JAX; :func:`param_specs` recovers each local param's spec from the
model config.
"""

from __future__ import annotations

import re

import torch

from .mesh import axis_size

_COL = r"(q_proj|k_proj|v_proj|gate_proj|up_proj|fc1)"
_ROW = r"(o_proj|out_proj|down_proj|fc2)"

# (regex, spec): the first fullmatch wins. OPT and Llama/Mistral names.
_RULES: list[tuple[str, tuple]] = [
    (rf".*\.{_COL}\.weight", ("tp", None)),
    (rf".*\.{_COL}\.bias", ("tp",)),
    (rf".*\.{_COL}\.A", (None, None)),
    (rf".*\.{_COL}\.B", (None, "tp")),
    (rf".*\.{_ROW}\.weight", (None, "tp")),
    (rf".*\.{_ROW}\.bias", (None,)),
    (rf".*\.{_ROW}\.A", ("tp", None)),
    (rf".*\.{_ROW}\.B", (None, None)),
    (r".*embed_tokens\.weight", ("tp", None)),
    (r".*embed_positions\.weight", (None, None)),
    (r"lm_head\.weight", ("tp", None)),
    (r".*", ()),
]

_COMPILED = [(re.compile(pat), spec) for pat, spec in _RULES]


def param_sharding_rules() -> list[tuple[str, tuple]]:
    return list(_RULES)


def spec_for_param(name: str) -> tuple:
    for pat, spec in _COMPILED:
        if pat.fullmatch(name):
            return spec
    return ()


def _clip_spec(spec: tuple, ndim: int) -> tuple:
    """Truncate or pad a spec to the array's rank (1-D bias vs 2-D
    weight)."""
    return tuple((list(spec) + [None] * ndim)[:ndim])


def fixed_spec(name: str, shape, tp: int) -> tuple:
    """``name``'s spec at ``shape`` (the full one) with every dimension tp
    does not divide replicated, as JAX's ``shard_params`` fixes it."""
    spec = _clip_spec(spec_for_param(name), len(shape))
    return tuple(None if (a == "tp" and d % tp) else a
                 for d, a in zip(shape, spec))


def sharding_for_param(mesh, name: str, ndim: int) -> tuple:
    """``torch.distributed.tensor`` placements of ``name`` on the (dp, tp)
    mesh: replicated over dp, ``Shard(d)`` over tp where the rule shards
    dimension ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    spec = _clip_spec(spec_for_param(name), ndim)
    tp = Shard(spec.index("tp")) if "tp" in spec else Replicate()
    return (Replicate(), tp)


def local_shard(t: torch.Tensor, spec: tuple, tp: int, rank: int
                ) -> torch.Tensor:
    """Rank ``rank``'s part of the full ``t`` under ``spec``, contiguous."""
    if "tp" not in spec:
        return t
    d = spec.index("tp")
    return t.chunk(tp, dim=d)[rank].contiguous()


def shard_params(params: dict, mesh) -> dict:
    """Every rank's local shard of each full param (every rank holds the
    full dict, e.g. converted by ``convert.params_from_jax``, and slices
    its own part: no communication)."""
    tp, rank = axis_size(mesh, "tp"), mesh.get_local_rank("tp")
    return {name: local_shard(t, fixed_spec(name, t.shape, tp), tp, rank)
            for name, t in params.items()}


def _tp_dim_size(cfg, name: str) -> int | None:
    """The full size of the dimension ``name``'s rule shards over tp: the
    out features of a column-parallel linear, the in features of a
    row-parallel one, or the vocabulary."""
    if re.fullmatch(r".*embed_tokens\.weight|lm_head\.weight", name):
        return cfg.vocab_size
    m = re.fullmatch(rf".*\.({_COL[1:-1]}|{_ROW[1:-1]})\.\w+", name)
    if m is None:
        return None
    proj = m.group(1)
    if proj in ("k_proj", "v_proj"):
        return cfg.kv_heads * cfg.head_dim
    if proj in ("gate_proj", "up_proj", "down_proj"):
        return cfg.intermediate_size
    if proj in ("fc1", "fc2"):
        return cfg.ffn_dim
    return cfg.hidden_size


def param_specs(cfg, params: dict, tp: int) -> dict:
    """The spec each param of ``shard_params``' output was sliced by,
    from the model config (a local shard does not show whether its
    dimension was split)."""
    out = {}
    for name, t in params.items():
        spec = _clip_spec(spec_for_param(name), t.ndim)
        size = _tp_dim_size(cfg, name)
        out[name] = tuple(None if (a == "tp" and size % tp) else a
                          for a in spec) if size is not None else spec
    return out


__all__ = ["fixed_spec", "local_shard", "param_sharding_rules",
           "param_specs", "shard_params", "sharding_for_param",
           "spec_for_param"]
