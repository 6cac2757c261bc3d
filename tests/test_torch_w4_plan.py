"""The launch plan of kernel 1 and the MLP megakernel (rows 1 and 3 of the
kernel table): every (column, K) range of a GEMM is covered by exactly one
block, every X·A block's K range and rank chunk once, and the scratch sizes
follow from (M, N, K, R). Also the wrapper's plain route at a rank that is
not a multiple of 16 and wider than 128 (one whole-row q_xa group, which
the kernel now takes) against the JAX package's kernel 1 (interpret mode)
and its dense route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops import storage as jstorage
from lqer_tpu.ops.pallas.dequant_gemm import (
    prepare_w4_weights as jax_prepare,
    qlinear_w4_dense_largeM,
    qlinear_w4_fused as jax_fused,
)
from lqer_tpu.ops.quantizers import block_fp_quantizer
from lqer_tpu_torch.convert import backend_from_jax
from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
from lqer_tpu_torch.ops.kernels import mlp_fused as k5
from lqer_tpu_torch.ops.storage import MXFormat
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

ROWS = [1, 8, 9, 64, 65, 256, 511]
# (N, K): Llama-2-7B's q|k|v, o, gate|up and down (padded I), Mistral's
# q|k|v and down, the W8 head, tiny widths
SHAPES = [(12288, 4096), (4096, 4096), (22528, 4096), (4096, 11264),
          (6144, 4096), (4096, 14336), (32000, 4096), (352, 272), (96, 64),
          (256, 16)]


def _cover(n_blocks, size, step):
    """The ranges [i * step, min(size, (i + 1) * step)) of n_blocks: each
    non-empty, together [0, size) once."""
    seen = np.zeros(size, dtype=np.int64)
    for i in range(n_blocks):
        lo, hi = i * step, min(size, (i + 1) * step)
        assert lo < hi, (i, step, size)
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("sms", [1, 132, 1000])
@pytest.mark.parametrize("n,k", SHAPES)
def test_gemm_plan_covers_once(n, k, sms):
    for m in ROWS:
        g = k1.gemm_plan(m, n, k, sms)
        assert (g["rows"], g["cols"]) == (k1.TILE_DECODE if m <= 8
                                          else k1.TILE_PREFILL)
        _cover(g["m_tiles"], m, g["rows"])
        _cover(g["n_tiles"], n, g["cols"])
        # K's 16-groups: every split non-empty, each group in one split
        _cover(g["splits"], k // 16, g["groups_per_split"])
        assert (g["splits"] == 1
                or g["groups_per_split"] >= k1.MIN_SPLIT_GROUPS)
        # two blocks an SM at most, past one split a tile: no partial
        # second wave
        tiles = g["m_tiles"] * g["n_tiles"]
        assert tiles * g["splits"] <= max(tiles, 2 * sms)


@pytest.mark.parametrize("max_ranges", [16, 32])
@pytest.mark.parametrize("k", [16, 272, 4096, 14336])
def test_xa_plan_covers_once(k, max_ranges):
    for m in ROWS:
        for w in (0, 32, 96, 136, 256, 384):
            xa = k1.xa_plan(m, k, w, 132, max_ranges=max_ranges)
            assert xa["k_range"] % 16 == 0
            assert xa["k_ranges"] <= max_ranges
            _cover(xa["k_ranges"], k, xa["k_range"])
            _cover(xa["row_tiles"], m, 8)
            if w:
                _cover(xa["rank_chunks"], w, k1.XA_RC)
            else:
                assert xa["rank_chunks"] == 1


@pytest.mark.parametrize("n,k,r", [(12288, 4096, 96), (6144, 4096, 384),
                                   (4096, 4096, 128), (32000, 4096, 0),
                                   (352, 272, 136)])
def test_kernel1_scratch_sizes(n, k, r):
    for m in ROWS:
        pl = k1.plan(m, n, k, r, 132)
        g, xa = pl["gemm"], pl["xa"]
        rows8 = -(-m // 8) * 8
        assert pl["xa_part"] == rows8 * -(-k // xa["k_range"]) * r
        assert pl["xa_values"] == rows8 * r
        tile_rows = -(-m // g["rows"]) * g["rows"]
        assert pl["gemm_part"] == (0 if g["splits"] == 1
                                   else g["splits"] * tile_rows * n)
        assert pl["counters"] == (2 + -(-m // g["rows"]) * -(-n // g["cols"])
                                  + -(-m // 8) * max(1, -(-r // 64)))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("k,i,n,r", [(4096, 11264, 4096, 32),
                                     (4096, 14336, 4096, 128),
                                     (4096, 16384, 4096, 32),
                                     (256, 512, 256, 0)])
def test_megakernel_plan(k, i, n, r, gated):
    for m in ROWS:
        _megakernel_plan(k, i, n, r, m, gated)


def _megakernel_plan(k, i, n, r, m, gated):
    pl = k5.plan(m, k, i, n, r, gated, 132)
    halves = 2 if gated else 1
    gu, dn = pl["gate_up"], pl["down"]
    xa_a, xa_c = pl["xa_gate_up"], pl["xa_down"]
    n_a = xa_a["row_tiles"] * xa_a["k_ranges"] * xa_a["rank_chunks"] if r else 0
    n_c = xa_c["row_tiles"] * xa_c["k_ranges"] * xa_c["rank_chunks"] if r else 0
    assert gu == k1.gemm_plan(m, i, k, 132, halves=halves, reserve=n_a)
    assert dn == k1.gemm_plan(m, n, i, 132, reserve=n_c)
    # the GEMM items of a phase fit one wave of two blocks an SM
    for g, h in ((gu, halves), (dn, 1)):
        tiles = g["m_tiles"] * g["n_tiles"] * h
        assert tiles * g["splits"] <= max(tiles, 2 * 132)
    _cover(gu["splits"], k // 16, gu["groups_per_split"])
    _cover(dn["splits"], i // 16, dn["groups_per_split"])
    rows8 = -(-m // 8) * 8
    tile_rows = -(-m // gu["rows"]) * gu["rows"]
    assert pl["h"] == rows8 * i
    assert pl["xa_values"] == rows8 * (halves * r + r)
    assert pl["xa_part"] == rows8 * max(
        pl["xa_gate_up"]["k_ranges"] * halves * r,
        pl["xa_down"]["k_ranges"] * r)
    part_b = (halves * gu["splits"] * tile_rows * i
              if gated or gu["splits"] > 1 else 0)
    part_d = dn["splits"] * tile_rows * n if dn["splits"] > 1 else 0
    assert pl["gemm_part"] == max(part_b, part_d)
    assert pl["counters"] == (
        gu["m_tiles"] * (gu["n_tiles"] + dn["n_tiles"])
        + -(-m // 8) * (max(1, -(-halves * r // 64)) + max(1, -(-r // 64)))
        + 2)


def test_rank_supported_any_width():
    assert all(k1.rank_supported(r) for r in (0, 8, 100, 128, 136, 200, 384))
    assert not k1.rank_supported(-1)


@pytest.mark.parametrize("m", [8, 65])
def test_rank_136_plain_matches_jax(m):
    """R = 136 (> 128, not a multiple of 16): q_xa quantizes each X·A row
    as one group of 136, as the JAX kernel does; the port's plain route
    against the JAX fused kernel (interpret mode) and dense route, within
    rtol = atol = 2e-4 (the products are exact; only the f32 summation
    order of X·A and of the correction differs)."""
    K, N, R = 256, 512, 136
    rng = np.random.default_rng(136 + m)
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((K, R)) * 0.05).astype(jnp.bfloat16)
    b = (rng.standard_normal((R, N)) * 0.05).astype(jnp.bfloat16)
    x = block_fp_quantizer(jnp.asarray(rng.standard_normal((m, K)),
                                       jnp.float32),
                           width=8, exponent_width=8, block_size=[1, 16],
                           skip_first_dim=True).astype(jnp.bfloat16)
    prep = jax_prepare(jnp.asarray(w), a=jnp.asarray(a), b=jnp.asarray(b),
                       fmt=jstorage.MXFormat(4), tile_k=128, tile_n=256)
    meta = {"fmt": prep["fmt"], "tile_k": prep["tile_k"], "xa_width": None,
            "out_width": None}
    arrays = {k: None if prep[k] is None else np.asarray(prep[k])
              for k in ("tiles", "a", "b", "bias")}
    tprep = backend_from_jax({"w": arrays}, {"w": meta})["arrays"]["w"]
    kw = dict(quant_xa_width=8, quant_out_width=8)
    ours = k1.qlinear_w4_fused(torch.from_numpy(np.array(
        x.astype(jnp.float32))), tprep, MXFormat(4), **kw).numpy()
    dense = np.asarray(qlinear_w4_dense_largeM(x, prep, **kw))
    np.testing.assert_allclose(ours, dense, rtol=2e-4, atol=2e-4)
    fused = np.asarray(jax_fused(x, prep, tile_m=128, interpret=True, **kw))
    np.testing.assert_allclose(ours, fused, rtol=2e-4, atol=2e-4)
