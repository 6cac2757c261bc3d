"""The plain reference: a configuration's whole-sequence causal forward in
PyTorch f32 (TF32 off), computed layer by layer, each layer's weights drawn
again from the seed (``perfbench/weights.py``) and freed after use.

It states the recipe's function and nothing of how the program computes
it: every linear is ``Y = Q8(X) Q4(W)^T + Q8(b) + Q8(Q8(Q8(X) A) B)`` (Q8
and Q4 the MXINT grids of ``quant.py`` along the last axis; the weight's
groups along its input features); attention quantizes q along the head
dim, K and V on the grid ``kv_grid`` names, and the softmax's
probabilities along the keys in groups of 16 from key 0, at width 8, then
``P V``. ``kv_grid="cache"`` is the MXINT cache's (each token's K and V
row along the head dim: what a served model attends to),
``kv_grid="matmul"`` the quantized matmul's (K^T along the tokens, V along
the head dim: what the evaluation's forward attends to). ``kv_width``
sets the K and V width and ``act_width`` every other activation-side
grid: the linears' inputs, their corrections' intermediates and outputs,
q and P (the recipe's 8, or 4 for a control).

Llama and Mistral: RMSNorm, HF rotary, grouped K/V heads, scores scaled
after ``q K^T``, the sliding window in the mask, the SiLU-gated MLP; the
W8 head (``head="w8"``: its weight on the MXINT8 grid, its input rounded
to bf16, as the recipe serves it) or the dense f32 head (``head="dense"``:
the evaluation's). OPT: learned positions at offset 2, pre-LayerNorm, q
scaled before ``q K^T``, the ReLU MLP with biases, the dense head tied to
the embedding. The residual stream stays f32 for every configuration.

Imports nothing of the program; only torch and the benchmark's own
``weights``, ``spec`` and ``quant``."""

from __future__ import annotations

import torch
from torch.nn.functional import relu, silu

from .. import weights
from ..spec import ModelSpec
from .quant import mx, mx_weight, cache_grid

ACT_WIDTH = 8
W_WIDTH = 4
HEAD_CHUNK = 8   # attention heads per block of the scores


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Reference:
    def __init__(self, spec: ModelSpec, seed: int, device, *,
                 kv_grid: str = "cache", head: str = "w8",
                 kv_width: int | None = None, act_width: int = ACT_WIDTH):
        if kv_grid not in ("cache", "matmul") or head not in ("w8", "dense"):
            raise ValueError(f"kv_grid {kv_grid!r}, head {head!r}")
        self.spec, self.seed, self.device = spec, seed, device
        self.kv_grid, self.head = kv_grid, head
        self.kv_width = kv_width or spec.kv_width
        self.act_width = act_width

    # -- pieces ------------------------------------------------------------
    def _prepared(self, drawn: dict) -> dict:
        out = {}
        for rel, d in drawn.items():
            out[rel] = {"wt": mx_weight(d["weight"], W_WIDTH).T.contiguous(),
                        "bias": (None if d.get("bias") is None
                                 else mx(d["bias"], ACT_WIDTH)),
                        "A": d.get("A"), "B": d.get("B")}
        return out

    def _lin(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        aw = self.act_width
        xq = mx(x, aw)
        y = xq @ w["wt"]
        if w["bias"] is not None:
            y = y + w["bias"]
        if w["A"] is not None:
            xa = mx(xq @ w["A"], aw)
            y = y + mx(xa @ w["B"], aw)
        return y

    def _kv(self, k: torch.Tensor, v: torch.Tensor):
        w = self.kv_width
        if self.kv_grid == "cache":
            return cache_grid(k, w), cache_grid(v, w)
        return mx(k.transpose(-1, -2), w).transpose(-1, -2), mx(v, w)

    def _attend(self, q, k, v, scale_query: bool) -> torch.Tensor:
        """q (H, s, d), k and v (KVH, s, d) → (H, s, d)."""
        spec = self.spec
        scaling = spec.head_dim ** -0.5
        kq, vq = self._kv(k, v)
        if scale_query:
            q = q * scaling
        qq = mx(q, self.act_width)
        s = q.shape[1]
        i = torch.arange(s, device=q.device)
        ok = i[None, :] <= i[:, None]
        if spec.window is not None:
            ok &= i[None, :] > i[:, None] - spec.window
        out = torch.empty_like(q)
        for h0 in range(0, spec.heads, HEAD_CHUNK):
            hs = torch.arange(h0, min(h0 + HEAD_CHUNK, spec.heads),
                              device=q.device)
            kh = kq[hs // spec.n_rep]
            vh = vq[hs // spec.n_rep]
            scores = qq[hs] @ kh.transpose(-1, -2)
            if not scale_query:
                scores = scores * scaling
            scores = scores.masked_fill(~ok, float("-inf"))
            p = mx(torch.softmax(scores, dim=-1), self.act_width)
            out[hs] = p @ vh
        return out

    @staticmethod
    def _rms(x, eps):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)

    @staticmethod
    def _ln(x, eps=1e-5):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)

    def _rotary(self, s: int):
        d = self.spec.head_dim
        inv = 1.0 / (self.spec.theta ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=self.device) / d))
        t = torch.arange(s, dtype=torch.float32, device=self.device)
        emb = torch.outer(t, inv)
        emb = torch.cat([emb, emb], dim=-1)
        return torch.cos(emb), torch.sin(emb)

    @staticmethod
    def _rot(x, cos, sin):
        half = x.shape[-1] // 2
        rh = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return x * cos + rh * sin

    def _layer(self, h: torch.Tensor, w: dict) -> torch.Tensor:
        """One layer over one sequence: h (s, hidden) f32."""
        spec = self.spec
        s, d = h.shape[0], spec.head_dim

        def heads(y, n):
            return y.reshape(s, n, d).transpose(0, 1)

        if spec.arch == "opt":
            hn = self._ln(h)
            q = heads(self._lin(hn, w["self_attn.q_proj"]), spec.heads)
            k = heads(self._lin(hn, w["self_attn.k_proj"]), spec.kv_heads)
            v = heads(self._lin(hn, w["self_attn.v_proj"]), spec.kv_heads)
            a = self._attend(q, k, v, scale_query=True)
            h = h + self._lin(a.transpose(0, 1).reshape(s, -1),
                              w["self_attn.out_proj"])
            hn = self._ln(h)
            y = self._lin(relu(self._lin(hn, w["fc1"])), w["fc2"])
            return h + y
        hn = self._rms(h, spec.eps)
        q = heads(self._lin(hn, w["self_attn.q_proj"]), spec.heads)
        k = heads(self._lin(hn, w["self_attn.k_proj"]), spec.kv_heads)
        v = heads(self._lin(hn, w["self_attn.v_proj"]), spec.kv_heads)
        cos, sin = self._rotary(s)
        q, k = self._rot(q, cos, sin), self._rot(k, cos, sin)
        a = self._attend(q, k, v, scale_query=False)
        h = h + self._lin(a.transpose(0, 1).reshape(s, -1),
                          w["self_attn.o_proj"])
        hn = self._rms(h, spec.eps)
        act = silu(self._lin(hn, w["mlp.gate_proj"])) \
            * self._lin(hn, w["mlp.up_proj"])
        return h + self._lin(act, w["mlp.down_proj"])

    # -- the forward -------------------------------------------------------
    @torch.no_grad()
    def logits(self, seqs: list, rows: list) -> list:
        """``seqs``: 1-D token id tensors; ``rows``: for each, the
        positions whose logits to return. Returns one f32 ``(len(rows[j]),
        vocab)`` tensor per sequence."""
        no_tf32()
        spec, dev = self.spec, self.device
        top = weights.non_layer(spec, self.seed, dev)
        hs = []
        for ids in seqs:
            ids = ids.to(dev)
            if spec.arch == "opt":
                pos = torch.arange(len(ids), device=dev) + 2
                h = (top["model.decoder.embed_tokens.weight"][ids].float()
                     + top["model.decoder.embed_positions.weight"][pos].float())
            else:
                h = top["model.embed_tokens.weight"][ids].float()
            hs.append(h)
        for i in range(spec.layers):
            w = self._prepared(weights.layer(spec, self.seed, i, dev))
            hs = [self._layer(h, w) for h in hs]
            del w
        if spec.arch == "opt":
            head = top["model.decoder.embed_tokens.weight"].float()
        else:
            head = top.get("lm_head.weight", top["model.embed_tokens.weight"])
        if self.head == "w8":
            head = mx_weight(head, ACT_WIDTH)
        out = []
        for h, r in zip(hs, rows):
            h = h[torch.as_tensor(r, device=dev)]
            h = self._ln(h) if spec.arch == "opt" else self._rms(h, spec.eps)
            if self.head == "w8":
                h = h.to(torch.bfloat16).float()
            out.append(h @ head.T)
        return out
