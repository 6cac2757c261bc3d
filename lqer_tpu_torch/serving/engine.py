"""Continuous-batching decode engine (port of ``lqer_tpu/serving/engine.py``).

A fixed number of slots decode together, one model step per token.
Waiting prompts are admitted in one right-padded batch (bucketed lengths)
on a freshly zeroed cache: all slots at once, or the admitted
slots scattered back into the running cache. Sampling happens on the
device: greedy argmax, or a temperature sample drawn with the engine's own
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import models
from ..device import resolve_device
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
    such rows with ``jnp.take``, which fills them silently.)"""

    def __init__(self, params: dict, cfg, layer_qcfgs=None,
                 num_slots: int = 4, max_len: int = 512,
                 cache_dtype="bfloat16", rng_seed: int = 0,
                 pallas_backend: dict | None = None,
                 scan_layers: bool = False, consume_backend: bool = False,
                 lm_head_width: int | None = None, device="cuda"):
        if cfg.arch == "opt" and max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds OPT's max_position_embeddings "
                f"{cfg.max_position_embeddings}: positions past it have no "
                "row in embed_positions")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        params = _to(params, self.device)
        backend = _to(pallas_backend, self.device)
        if lm_head_width is not None and backend is not None:
            backend = pack_lm_head(backend, params, width=lm_head_width)
        self.cache = make_cache(cfg, num_slots, max_len, cache_dtype,
                                device=self.device)
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
                                 backend_stacked=self._backend, **kw)
        return model_step(self._params, ids, cache, positions, self.cfg,
                          self._qcfgs, backend=self._backend, **kw)

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
        ids = torch.as_tensor(tokens, dtype=torch.int64,
                              device=self.device)[:, None]
        positions = torch.as_tensor(self.lengths, dtype=torch.int32,
                                    device=self.device)
        logits, self.cache = self._step(ids, self.cache, positions)
        return logits[:, 0, :]

    def decode_step(self, tokens: np.ndarray, temps: list[float]
                    ) -> np.ndarray:
        return self._sample(self.decode_logits(tokens), temps).cpu().numpy()

    def prefill(self, padded: np.ndarray, slots: np.ndarray,
                lengths: np.ndarray) -> torch.Tensor:
        """Admit right-padded prompts ``padded (nb, pad_len)`` into
        ``slots`` on a freshly zeroed cache; returns the last valid
        position's logits (nb, vocab)."""
        nb = padded.shape[0]
        full = nb == self.num_slots and np.array_equal(
            slots, np.arange(self.num_slots))
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
        return logits[:, 0, :]

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
