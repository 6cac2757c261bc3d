"""Continuous-batching decode engine (port of ``lqer_tpu/serving/engine.py``).

A fixed number of slots decode together, one model step per token.
Waiting prompts are admitted in one right-padded batch (bucketed lengths)
on a freshly zeroed cache: all slots at once, or the admitted
slots scattered back into the running cache. Sampling happens on the
device: greedy argmax, or a temperature sample drawn with the engine's own
``torch.Generator``. With a (dp, tp) mesh every rank runs the same
scheduler on the same requests over its share of the slots, heads and
cache (:func:`_mesh_shard`).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from .. import models
from ..device import resolve_device
from ..utils import tracing
from . import decode
from .decode import (
    check_servable,
    llama_step_scan,
    make_cache,
    model_step,
    opt_step_scan,
    stack_backend,
)
from .kernel_backend import pack_lm_head


@dataclasses.dataclass
class Request:
    prompt_ids: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 -> greedy
    eos_token_id: int | None = None
    # filled by the engine:
    output_ids: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _mesh_shard(params: dict, cfg, mesh, num_slots: int):
    """One rank's part of a mesh engine (the JAX package's
    ``_shard_cache`` rule for the cache): slots over dp where dp divides
    them, else every rank serves every slot; q heads, gate/up (fc1) and
    the row-parallel inputs over tp (``sharding.shard_params``); kv heads
    over tp where tp divides them, else every rank computes and caches
    every kv head and attends its q heads to theirs; the vocab over tp
    where it divides. Each sharded linear gets its ``shard`` hook
    (``step.linear_hook`` on the rank's heads and columns), which gives it
    ``qlinear``'s quantizers as they act on the whole tensors. Returns
    ``(local params, TPShard, dp group or None, (first slot, end slot))``."""
    from ..parallel.mesh import axis_size
    from ..parallel.sharding import shard_params
    from ..parallel.step import linear_hook
    from ..parallel.tp_forward import TPShard

    tp, dp = axis_size(mesh, "tp"), axis_size(mesh, "dp")
    inter = cfg.ffn_dim if cfg.arch == "opt" else cfg.intermediate_size
    if cfg.num_attention_heads % tp or (cfg.hidden_size // tp) % 16 \
            or inter % tp or (inter // tp) % 16:
        raise ValueError(
            f"the mesh engine needs heads % tp == 0 and hidden / tp and "
            f"intermediate / tp in 16-groups (tp={tp}: heads="
            f"{cfg.num_attention_heads} hidden={cfg.hidden_size} "
            f"inter={inter})")
    local = shard_params(params, mesh)
    kv_whole = ("k_proj", "v_proj") if cfg.kv_heads % tp else ()
    for name in params:
        if any(f".{p}." in name for p in kv_whole):
            local[name] = params[name]
    tp_group = mesh.get_group("tp")
    for i in range(cfg.num_hidden_layers):
        for prefix, proj in models.quantizable_module_prefixes(cfg, i):
            if proj not in kv_whole:
                local[prefix + ".shard"] = linear_hook(
                    proj, tp_group, local_activations=True)
    lo, hi = 0, num_slots
    dp_group = None
    if num_slots % dp == 0 and dp > 1:
        n = num_slots // dp
        lo = mesh.get_local_rank("dp") * n
        hi = lo + n
        dp_group = mesh.get_group("dp")
    return local, TPShard(cfg, tp_group), dp_group, (lo, hi)


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj


class DecodeEngine:
    """Single-device continuous batching over one model step.

    ``scan_layers=False`` (the default, as in the JAX package) runs the
    eager step ``decode.model_step`` on per-prefix weights and backend
    entries; ``scan_layers=True`` the stacked step
    (``decode.llama_step_scan`` / ``opt_step_scan``) on layer-stacked
    params and ``decode.stack_backend``'s stacked backend (with
    ``consume_backend`` the per-prefix arrays are dropped as they stack).
    Each engine builds only the copy of the packed weights it reads.

    ``pallas_backend`` comes from ``kernel_backend.prepare_serving_params``
    (or ``convert.backend_from_jax``); None serves every linear through
    the software emulation on ``models.prepare_ptq``'s params, and a
    linear the backend did not pack takes it too. ``layer_qcfgs`` None
    serves the model unquantized. ``lm_head_width=8`` packs the head for
    the W8 kernel (with a backend; without one the head stays dense, as
    in JAX). ``cache_dtype`` is one of ``decode.make_cache``'s (the bf16
    cache by default, as in the JAX package). ``device`` defaults to the
    card and raises when there is none; params and backend move to it. A
    regime the card's kernels do not take (``decode.check_servable``)
    raises ``NotImplementedError`` here. The step follows ``cfg.arch``:
    OPT, or Llama and Mistral (its sliding window included).
    An OPT engine whose ``max_len`` exceeds ``max_position_embeddings``
    raises ``ValueError`` before any work: its learned positions would
    index past the table, which faults on the card. (The JAX engine takes
    such rows with ``jnp.take``, which fills them silently.)

    ``mesh``: a (dp, tp) ``DeviceMesh`` (``parallel.make_mesh``) whose
    every rank builds the engine from the full ``params`` and runs the same
    requests: each keeps its part (:func:`_mesh_shard`), its steps sum
    o_proj and down_proj over tp exactly and gather the logits over tp and
    dp, so every rank samples the same tokens. It serves without a
    backend, as the JAX package's mesh engine does (the prefill attention
    kernel and the staged flush run on each rank's heads); a
    ``pallas_backend`` with a mesh raises ``NotImplementedError``."""

    def __init__(self, params: dict, cfg, layer_qcfgs=None,
                 num_slots: int = 4, max_len: int = 512,
                 cache_dtype="bfloat16", rng_seed: int = 0,
                 pallas_backend: dict | None = None,
                 scan_layers: bool = False, consume_backend: bool = False,
                 lm_head_width: int | None = None, device="cuda",
                 mesh=None):
        if cfg.arch == "opt" and max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds OPT's max_position_embeddings "
                f"{cfg.max_position_embeddings}: positions past it have no "
                "row in embed_positions")
        if mesh is not None and pallas_backend is not None:
            raise NotImplementedError(
                "a pallas_backend with a mesh: the mesh engine serves the "
                "emulated linears, as the JAX package's does")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self._tp = self._dp_group = None
        self._slots = (0, num_slots)
        kv_heads = cfg.kv_heads
        if mesh is not None:
            params, self._tp, self._dp_group, self._slots = _mesh_shard(
                params, cfg, mesh, num_slots)
            kv_heads = self._tp.kv_heads
        params = _to(params, self.device)
        backend = _to(pallas_backend, self.device)
        if lm_head_width is not None and backend is not None:
            backend = pack_lm_head(backend, params, width=lm_head_width)
        cache_cfg = types.SimpleNamespace(
            num_hidden_layers=cfg.num_hidden_layers, kv_heads=kv_heads,
            head_dim=cfg.head_dim,
            sliding_window=getattr(cfg, "sliding_window", None))
        self.cache = make_cache(cache_cfg, self._slots[1] - self._slots[0],
                                max_len, cache_dtype, device=self.device)
        self._qcfgs = None if layer_qcfgs is None else list(layer_qcfgs)
        attn_cfgs = [q["attn"] for q in decode._layer_qcfgs(self._qcfgs, cfg)]
        check_servable(self.cache, attn_cfgs, cfg.head_dim,
                       getattr(cfg, "sliding_window", None),
                       backend=backend is not None, scan=scan_layers)
        self.lengths = np.zeros(num_slots, dtype=np.int32)  # tokens in cache
        self.slot_req: list[Request | None] = [None] * num_slots
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self._scan = scan_layers
        if scan_layers:
            arch = models.get_arch_module(cfg)
            self._stacked, self._rest = arch.stack_layer_params(params, cfg)
            self._backend = (None if backend is None else stack_backend(
                backend, cfg, consume=consume_backend))
            self._step_fn = (opt_step_scan if cfg.arch == "opt"
                             else llama_step_scan)
        else:
            self._params = params
            self._backend = backend

    # ------------------------------------------------------------------
    def _step(self, ids, cache, positions, **kw):
        if self._scan:
            return self._step_fn({}, ids, cache, positions, self.cfg,
                                 self._qcfgs, stacked=self._stacked,
                                 rest=self._rest,
                                 backend_stacked=self._backend, tp=self._tp,
                                 **kw)
        return model_step(self._params, ids, cache, positions, self.cfg,
                          self._qcfgs, backend=self._backend, tp=self._tp,
                          **kw)

    def _gather_rows(self, logits: torch.Tensor, rows: np.ndarray, n: int
                     ) -> torch.Tensor:
        """(n, vocab) logits with this rank's ``rows`` from ``logits`` (None:
        no rows here) and the other dp ranks' rows, in f32 (zeros summed
        in: exact); ``logits`` itself without a dp split."""
        if self._dp_group is None:
            return logits
        from ..parallel.collectives import all_reduce

        full = torch.zeros((n, self.cfg.vocab_size), dtype=torch.float32,
                           device=self.device)
        if len(rows):
            full[torch.as_tensor(rows, device=self.device)] = logits.float()
        return all_reduce(full, self._dp_group)

    def _sample(self, logits: torch.Tensor, temps: list[float]) -> torch.Tensor:
        """(n, vocab) logits → (n,) tokens: greedy where temp <= 0, else a
        categorical sample at ``logits / temp`` from the engine's
        generator."""
        greedy = torch.argmax(logits, dim=-1)
        if max(temps) <= 0.0:
            return greedy
        t = torch.tensor(temps, dtype=torch.float32, device=logits.device)
        probs = torch.softmax(logits.float() / t.clamp(min=1e-6)[:, None], -1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        return torch.where(t > 0.0, sampled, greedy)

    def decode_logits(self, tokens: np.ndarray) -> torch.Tensor:
        """One decode step for every slot at ``self.lengths`` (the caller
        advances them); returns the (slots, vocab) logits."""
        lo, hi = self._slots
        ids = torch.as_tensor(tokens[lo:hi], dtype=torch.int64,
                              device=self.device)[:, None]
        positions = torch.as_tensor(self.lengths[lo:hi], dtype=torch.int32,
                                    device=self.device)
        logits, self.cache = self._step(ids, self.cache, positions)
        return self._gather_rows(logits[:, 0, :], np.arange(lo, hi),
                                 self.num_slots)

    @tracing.annotate(tracing.ENGINE_STEP)
    def decode_step(self, tokens: np.ndarray, temps: list[float]
                    ) -> np.ndarray:
        return self._sample(self.decode_logits(tokens), temps).cpu().numpy()

    def prefill(self, padded: np.ndarray, slots: np.ndarray,
                lengths: np.ndarray) -> torch.Tensor:
        """Admit right-padded prompts ``padded (nb, pad_len)`` into
        ``slots`` on a freshly zeroed cache; returns the last valid
        position's logits (nb, vocab). A mesh rank runs the rows of its
        slots."""
        lo, hi = self._slots
        rows = np.flatnonzero((slots >= lo) & (slots < hi))
        n_all = padded.shape[0]
        if len(rows) == 0:
            return self._gather_rows(None, rows, n_all)
        padded, slots, lengths = padded[rows], slots[rows] - lo, lengths[rows]
        nb = padded.shape[0]
        full = nb == hi - lo and np.array_equal(slots, np.arange(hi - lo))
        ids = torch.as_tensor(padded, dtype=torch.int64, device=self.device)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        positions = torch.zeros(nb, dtype=torch.int32, device=self.device)
        if full:
            for v in self.cache.values():
                v.zero_()
            batch_cache = self.cache
        else:
            batch_cache = {k: torch.zeros_like(v[:nb] if v.ndim == 1
                                               else v[:, :nb])
                           for k, v in self.cache.items()}
        logits, batch_cache = self._step(
            ids, batch_cache, positions, valid_lengths=lens,
            fresh_prefill=True, logits_last_only=True)
        if not full:
            idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
            for k, v in self.cache.items():
                v.index_copy_(0 if v.ndim == 1 else 1, idx, batch_cache[k])
        return self._gather_rows(logits[:, 0, :], rows, n_all)

    def _check_truncation(self, req: Request) -> None:
        """A prompt of ``max_len`` tokens or more keeps its last
        ``max_len - max_new_tokens - 1`` (the JAX engine's rule), which
        needs ``max_new_tokens < max_len - 1``. The JAX engine slices
        anyway: at ``max_len - 1`` the whole prompt stays and numpy fails to
        pad it, past that a suffix of another length stays. The port
        refuses such a request before any work."""
        if len(req.prompt_ids) >= self.max_len \
                and req.max_new_tokens >= self.max_len - 1:
            raise ValueError(
                f"a prompt of {len(req.prompt_ids)} tokens must be cut to "
                f"max_len - max_new_tokens - 1 = "
                f"{self.max_len - req.max_new_tokens - 1} tokens "
                f"(max_len {self.max_len}, max_new_tokens "
                f"{req.max_new_tokens}): lower max_new_tokens below "
                f"{self.max_len - 1}")

    @tracing.annotate(tracing.ENGINE_ADMIT)
    def _admit_batch(self, pairs: list[tuple[Request, int]]) -> list[int]:
        prepped = []
        for req, slot in pairs:
            ids = req.prompt_ids
            if len(ids) >= self.max_len:
                ids = ids[-(self.max_len - req.max_new_tokens - 1):]
            prepped.append((req, slot, ids))
        pad_len = min(_bucket(max(len(ids) for _, _, ids in prepped)),
                      self.max_len)
        nb = len(prepped)
        padded = np.zeros((nb, pad_len), dtype=np.int64)
        slots = np.zeros(nb, dtype=np.int64)
        lengths = np.zeros(nb, dtype=np.int32)
        for r, (req, slot, ids) in enumerate(prepped):
            padded[r, :len(ids)] = ids
            slots[r] = slot
            lengths[r] = len(ids)
        last_logits = self.prefill(padded, slots, lengths)
        toks = self._sample(last_logits,
                            [req.temperature for req, _, _ in prepped])
        for req, slot, ids in prepped:
            self.lengths[slot] = len(ids)
            self.slot_req[slot] = req
        return [int(t) for t in toks.cpu()]

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve every request to completion; returns them with
        ``output_ids`` filled."""
        for req in requests:
            self._check_truncation(req)
        queue = list(requests)
        pending = np.zeros(self.num_slots, dtype=np.int64)
        active = np.zeros(self.num_slots, dtype=bool)

        def try_admit():
            pairs = []
            for s in range(self.num_slots):
                if not active[s] and queue:
                    pairs.append((queue.pop(0), s))
            if not pairs:
                return
            toks = self._admit_batch(pairs)
            for (req, s), tok in zip(pairs, toks):
                req.output_ids.append(tok)
                if req.eos_token_id is not None and tok == req.eos_token_id:
                    req.done = True
                    self.slot_req[s] = None
                    continue
                pending[s] = tok
                active[s] = True

        try_admit()
        while active.any() or queue:
            if not active.any():
                try_admit()
                continue
            temps = [self.slot_req[s].temperature if self.slot_req[s] else 0.0
                     for s in range(self.num_slots)]
            toks = self.decode_step(pending, temps)
            self.lengths += active.astype(np.int32)
            for s in range(self.num_slots):
                if not active[s]:
                    continue
                req = self.slot_req[s]
                tok = int(toks[s])
                req.output_ids.append(tok)
                hit_eos = (req.eos_token_id is not None
                           and tok == req.eos_token_id)
                if hit_eos or len(req.output_ids) >= req.max_new_tokens \
                        or self.lengths[s] + 1 >= self.max_len:
                    req.done = True
                    self.slot_req[s] = None
                    active[s] = False
                else:
                    pending[s] = tok
            try_admit()
        return requests


def generate(params: dict, cfg, prompt_ids: list[int],
             max_new_tokens: int = 32, layer_qcfgs=None, max_len: int = 256,
             temperature: float = 0.0, cache_dtype="bfloat16",
             device="cuda") -> list[int]:
    """One prompt through a one-slot eager engine (the JAX package's
    ``generate``); returns the new token ids."""
    engine = DecodeEngine(params, cfg, layer_qcfgs, num_slots=1,
                          max_len=max_len, cache_dtype=cache_dtype,
                          device=device)
    req = Request(prompt_ids=prompt_ids, max_new_tokens=max_new_tokens,
                  temperature=temperature)
    engine.run([req])
    return req.output_ids
