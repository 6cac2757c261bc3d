"""The numbers the check compares, from the reference's logits: the gap
by which a token the program (or a control) put first lies below the
reference's best logit, and the distance of the target tokens' log
probabilities. The control is the reference in the next precision below
the recipe's."""

from __future__ import annotations

import torch

# The control: the reference with every MXINT8 grid of the recipe's
# activations, q, K, V and P at MXINT4 (the next precision below int8).
CONTROL = {"kv_width": 4, "act_width": 4}


def gaps(ref: list, tokens: list) -> torch.Tensor:
    """Every position's gap of ``tokens`` below the reference's best (one
    tensor per sequence in each list); inf where a sequence's tokens are
    missing."""
    out = []
    for lg, tok in zip(ref, tokens):
        tok = tok.to(lg.device)
        if tok.shape[0] != lg.shape[0]:
            return torch.tensor([float("inf")])
        out.append(lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0])
    if len(tokens) != len(ref):
        return torch.tensor([float("inf")])
    return torch.cat(out)


def target_logprobs(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """log p of each next token: ``(rows, s)`` logits of ``(rows, s)`` ids
    → ``(rows, s - 1)``."""
    lg = logits.float()
    lse = torch.logsumexp(lg[:, :-1], -1)
    return lg[:, :-1].gather(-1, ids[:, 1:, None])[..., 0] - lse


def stats(prefix: str, g: torch.Tensor) -> dict:
    """The widest and the mean of ``g``."""
    return {prefix: float(g.max()), f"{prefix}_mean": float(g.mean())}
