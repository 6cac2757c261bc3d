"""The traffic generator: the same seed gives the same inputs, another
seed other lengths and ids, each block of requests one length from every
stratum of each distribution, within the mix's truncated ranges, and the
source's mean lengths over many blocks."""

import numpy as np
import pytest

from perfbench import spec, traffic

MIX = spec.load_json("traffic", "sharegpt")
EVAL = spec.load_json("traffic", "ppl_2048")
BIG_SEED = 2 ** 31 + 12345


def test_same_seed_same_requests():
    a = traffic.serve_requests(MIX, BIG_SEED, 50272)
    b = traffic.serve_requests(MIX, BIG_SEED, 50272)
    assert a == b
    c = traffic.serve_requests(MIX, BIG_SEED + 1, 50272)
    assert [len(r["prompt_ids"]) for r in a] != \
        [len(r["prompt_ids"]) for r in c]
    assert [r["max_new_tokens"] for r in a] != \
        [r["max_new_tokens"] for r in c]


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_truncated_ranges_and_vocab(seed):
    reqs = traffic.serve_requests(MIX, seed, 50272)
    assert len(reqs) == MIX["requests"]
    p, o = MIX["prompt_tokens"], MIX["output_tokens"]
    for r in reqs:
        n = len(r["prompt_ids"])
        assert 0 <= min(r["prompt_ids"]) and max(r["prompt_ids"]) < 50272
        assert p["min"] <= n <= p["max"]
        assert o["min"] <= r["max_new_tokens"] <= o["max"]
        assert n + r["max_new_tokens"] <= o["total_max"] <= MIX["max_len"]


@pytest.mark.parametrize("seed", [3, BIG_SEED])
def test_each_block_takes_one_prompt_from_every_stratum(seed):
    block = MIX["block"]
    lens = traffic.serve_lengths(MIX, seed)
    for b in range(0, len(lens) - block + 1, block):
        prompts = sorted(p for p, _ in lens[b:b + block])
        for k, n in enumerate(prompts):
            lo = traffic.truncated_lognormal(MIX["prompt_tokens"], k / block)
            hi = traffic.truncated_lognormal(MIX["prompt_tokens"],
                                             (k + 1) / block)
            assert lo <= n <= hi, (b, k, n, lo, hi)


def test_source_means_over_many_blocks():
    mix = dict(MIX, requests=64 * 100)
    lens = np.array(traffic.serve_lengths(mix, 11))
    assert lens[:, 0].mean() == pytest.approx(161.31, rel=0.03)
    assert lens[:, 1].mean() == pytest.approx(337.99, rel=0.03)


def test_truncated_lognormal_median_and_ends():
    d = {"dist": "lognormal", "median": 160, "sigma": 0.6, "min": 64,
         "max": 512}
    lens = [traffic.truncated_lognormal(d, (k + 0.5) / 64) for k in range(64)]
    assert lens == sorted(lens)
    assert min(lens) >= 64 and max(lens) <= 512
    assert abs(np.median(lens) - 160) <= 8
    assert traffic.truncated_lognormal(d, 0.0) == 64
    assert traffic.truncated_lognormal(d, 1.0) == 512
    assert traffic.truncated_lognormal(d, 1.0, hi=100) == 100


def test_eval_tokens_deterministic():
    a = traffic.eval_tokens(EVAL, BIG_SEED, 32000)
    assert a.shape == (EVAL["batches"] * EVAL["batch_size"], EVAL["seq_len"])
    assert np.array_equal(a, traffic.eval_tokens(EVAL, BIG_SEED, 32000))
    assert a.min() >= 0 and a.max() < 32000
