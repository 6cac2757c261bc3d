"""The one traffic generator: reads a mix of ``perfbench/traffic/`` and
makes its inputs from the seed.

Serving mixes: the seed draws every request's prompt and output length
and its token ids. Lengths are drawn by strata, so that every window sees
close to the mix's distributions however many requests it finishes: each
block of ``block`` requests takes one length from each of ``block``
equal-probability strata of the prompt distribution, and one from each
of the output distribution's, each at a seeded point inside its stratum,
paired and ordered by seeded permutations. A distribution is a lognormal
(``median``, ``sigma``) truncated to ``[min, max]`` by its inverse CDF,
which draws as rejecting the lengths outside would; an output's upper end
is also ``total_max`` less its prompt (a filter on the request's whole
length). Token ids are uniform over the vocabulary."""

from __future__ import annotations

import math
import statistics

import numpy as np

_Z = statistics.NormalDist()


def truncated_lognormal(dist: dict, u: float, hi: int | None = None) -> int:
    """The length at probability ``u`` (0..1) of ``dist`` truncated to
    ``[min, max]`` (``hi`` lowers the upper end)."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    lo = dist["min"]
    hi = dist["max"] if hi is None else min(hi, dist["max"])
    mu, sigma = math.log(dist["median"]), dist["sigma"]

    def cdf(x):
        return _Z.cdf((math.log(x) - mu) / sigma)

    a, b = cdf(lo - 0.5 if lo > 1 else lo), cdf(hi + 0.5)
    p = min(max(a + u * (b - a), 1e-12), 1 - 1e-12)
    x = math.exp(mu + sigma * _Z.inv_cdf(p))
    return int(min(max(round(x), lo), hi))


def serve_lengths(mix: dict, seed: int) -> list:
    """``[(prompt_tokens, output_tokens), ...]`` of the mix's requests."""
    block, n = mix["block"], mix["requests"]
    pd, od = mix["prompt_tokens"], mix["output_tokens"]
    total = od.get("total_max")
    rng = np.random.default_rng([seed, 1])
    out = []
    while len(out) < n:
        up = (rng.permutation(block) + rng.random(block)) / block
        uo = (rng.permutation(block) + rng.random(block)) / block
        for a, b in zip(up, uo):
            p = truncated_lognormal(pd, float(a))
            o = truncated_lognormal(od, float(b),
                                    None if total is None else total - p)
            out.append((p, o))
    return out[:n]


def serve_requests(mix: dict, seed: int, vocab: int) -> list:
    """``[{"prompt_ids": [...], "max_new_tokens": n}, ...]`` of the mix."""
    rng = np.random.default_rng([seed, 2])
    return [{"prompt_ids": rng.integers(0, vocab, p).tolist(),
             "max_new_tokens": o} for p, o in serve_lengths(mix, seed)]


def eval_tokens(mix: dict, seed: int, vocab: int) -> np.ndarray:
    """``(batches * batch_size, seq_len)`` int64 token ids."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (mix["batches"] * mix["batch_size"],
                                   mix["seq_len"]), dtype=np.int64)
