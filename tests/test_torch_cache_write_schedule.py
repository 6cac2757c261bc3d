"""Rows 13 and 14 of the kernel table, the fused MXINT8 encode + column
write and the staged-ring flush (``csrc/cache_write.cu``): each kernel's
work split emulated in torch on the CPU, thread by thread, and held bit for
bit against the JAX package's Pallas entries in interpret mode and the
port's plain versions, on seeded numpy inputs.

- Row 13 (``encode_columns_kernel``): a thread per code byte, the K rows
  then the V rows, each 16-value group's absmax from a butterfly of four
  xor-shuffles, each thread's code, the group's first lane storing the
  exponent, a position outside ``[0, L)`` storing nothing; at d 64, 80, 96
  and 128 and 1, 8 and 32 kv heads, with slots at positions 0, L - 1 and L,
  an all-zero group and a group whose absmax is one ulp above a power of
  two.
- Row 14 (``flush_pieces_kernel``): 16-byte pieces of each row, ceil(SW /
  16) a row, each from ring offset ``t % SW``, a thread's piece in 4 rows
  ceil(rows / 4) apart, pieces past a slot's span doing nothing, and a
  slot whose ``flushed`` or ``new_flushed`` is not a multiple of 16 copied
  byte by byte in the same pieces; at spans 0, 32 and 64, across the
  ring's wrap and across a 128-lane window of the main cache, with a
  (layer, slot)'s rows a multiple of 4 and not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.pallas.cache_write import flush_stage_to_main as jax_flush
from lqer_tpu.ops.pallas.cache_write import (
    write_kv_tokens_fused as jax_fused,
)
from lqer_tpu_torch.ops.kernels import cache_write as kcw
from lqer_tpu_torch.parallel.collectives import ceil_log2_exact, mx_mantissa
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

LI = 1


def emulate_encode_columns(arrays, kh, vh, li, positions):
    """Row 13's grid over the (NL, B, KVH, d, L) / (NL, B, KVH, d/16, L)
    arrays, in place: thread i holds value i % d of row i // d (the B x KVH
    K rows, then the V rows)."""
    B, KVH, _, D = kh.shape
    L = arrays[0].shape[-1]
    nr = B * KVH
    vals = torch.cat([kh.reshape(nr, D), vh.reshape(nr, D)]).reshape(-1)
    i = torch.arange(vals.numel())
    r, j = i // D, i % D
    is_v = r >= nr
    bk = torch.where(is_v, r - nr, r)
    m = vals.abs()
    for off in (8, 4, 2, 1):                 # __shfl_xor_sync
        m = torch.maximum(m, m[i ^ off])
    e = ceil_log2_exact(torch.where(m == 0, torch.ones_like(m), m))
    sign, mant, _ = mx_mantissa(vals, e, 7)
    code = (sign * mant).to(torch.int32).to(torch.int8)
    pos = positions.to(torch.int64)[bk // KVH]
    ok = (pos >= 0) & (pos < L)
    lane0 = ok & (j % 16 == 0)
    for v, (codes, exps) in enumerate((arrays[:2], arrays[2:])):
        sel = ok & (is_v == bool(v))
        codes[li].view(nr, D, L)[bk[sel], j[sel], pos[sel]] = code[sel]
        sel = lane0 & (is_v == bool(v))
        exps[li].view(nr, D // 16, L)[bk[sel], j[sel] // 16, pos[sel]] = \
            e[sel].to(torch.int8)
    return arrays


# rows of a flush thread, ``RPT`` in ``csrc/cache_write.cu``
RPT = 4


def emulate_flush_pieces(mains, rings, flushed, new_flushed):
    """Row 14's grid, in place: for each (layer, slot), thread (q, p) takes
    piece p of the rows ``q + k rq`` (k < RPT, rq = ceil(rows / RPT); the
    rows of a (layer, slot) run over the four arrays in order), the tokens
    ``lo + 16 p + 16 P j`` onwards of ``[lo, hi)``, one uint4 where the
    slot's bounds are multiples of 16 (and L and SW allow), else byte by
    byte; the threads of one (k, p) and array at once."""
    NL, B = mains[0].shape[:2]
    L, SW = mains[0].shape[-1], rings[0].shape[-1]
    P = (SW + 15) // 16
    vec = L % 16 == 0 and SW % 16 == 0
    per = [m[0, 0].numel() // L for m in mains]     # KVH x rows
    start = np.cumsum([0] + per)
    rq = -(-start[-1] // RPT)
    for lb in range(NL * B):
        b = lb % B
        lo, hi = max(int(flushed[b]), 0), min(int(new_flushed[b]), L)
        for k in range(RPT):
            rows = np.arange(rq) + k * rq            # thread q's k-th row
            for a, (main, ring) in enumerate(zip(mains, rings)):
                sel = rows[(rows >= start[a]) & (rows < start[a + 1])]
                r = torch.from_numpy(sel - start[a])
                m = main.view(NL * B, -1, L)[lb]
                g = ring.view(NL * B, -1, SW)[lb]
                for p in range(P):
                    for t0 in range(lo + 16 * p, hi, 16 * P):
                        if vec and lo % 16 == 0 and hi % 16 == 0:
                            s = t0 % SW
                            assert s + 16 <= SW and t0 + 16 <= hi
                            m[r, t0:t0 + 16] = g[r, s:s + 16]
                        else:
                            for t in range(t0, min(t0 + 16, hi)):
                                m[r, t] = g[r, t % SW]
    return mains


def _cache(rng, NL, B, KVH, D, L):
    return [rng.integers(-128, 128, (NL, B, KVH, r, L)).astype(np.int8)
            for r in (D, D // 16, D, D // 16)]


@pytest.mark.parametrize("kvh", [1, 8, 32])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_encode_columns_schedule_matches_jax(d, kvh):
    rng = np.random.default_rng(d * 100 + kvh)
    NL, B, L = 2, 3, 128
    arrays = _cache(rng, NL, B, kvh, d, L)
    kh = rng.standard_normal((B, kvh, 1, d)).astype(np.float32)
    vh = rng.standard_normal((B, kvh, 1, d)).astype(np.float32)
    kh[0, 0, 0, :16] = 0.0                          # an all-zero group
    ulp = np.nextafter(np.float32(1.0), np.float32(2.0))
    vh[1, -1, 0, 16:32] *= 0.5 / np.abs(vh[1, -1, 0, 16:32]).max()
    vh[1, -1, 0, 20] = -ulp                         # absmax 1 ulp above 2^0
    positions = np.array([0, L - 1, L], np.int32)   # L writes nothing

    # JAX states in-range positions as its precondition: run it with the
    # last slot inside the cache, then keep that slot's original bytes
    ref = jax_fused(tuple(jnp.asarray(a) for a in arrays), jnp.asarray(kh),
                    jnp.asarray(vh), LI,
                    jnp.asarray(np.minimum(positions, L - 1)),
                    interpret=True)
    ref = [np.array(a) for a in ref]
    for want, orig in zip(ref, arrays):
        want[:, 2] = orig[:, 2]

    t = lambda a: torch.from_numpy(a.copy())
    ours = emulate_encode_columns([t(a) for a in arrays], t(kh), t(vh), LI,
                                  t(positions))
    plain = kcw.encode_write_plain(tuple(t(a) for a in arrays), t(kh), t(vh),
                                   LI, t(positions))
    for got, p, want in zip(ours, plain, ref):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(p.numpy(), want)
    assert ours[3][LI, 1, -1, 1, L - 1] == 1        # ceil(log2(1 + ulp))
    assert ours[1][LI, 0, 0, 0, 0] == 0             # all-zero group
    assert (ours[0][LI, 0, 0, :16, 0] == 0).all()


# (flushed, new_flushed) per slot at L = 256, SW = 64
FLUSH_CASES = {
    # spans 32, 64 across the ring's wrap (32..96), 64 across the ring's
    # wrap and a 128-lane window (96..160), 0
    "aligned": ([0, 32, 96, 64], [32, 96, 160, 64]),
    # a span up to L, 0 at L, an unaligned slot (8..40), 64 from 0
    "to L, unaligned": ([192, 256, 8, 0], [256, 256, 40, 64]),
    # unaligned across the wrap and a window (120..150), 0, 16 tokens, a
    # span of 32 starting mid-ring
    "unaligned across": ([120, 0, 240, 48], [150, 0, 256, 80]),
}


# (kv heads, d): rows of a (layer, slot) 136 (a multiple of RPT), 102
# and 102 (not: the last thread holds fewer rows, and a thread's rows
# cross from one array into the next at other places)
@pytest.mark.parametrize("kvh,d", [(2, 32), (1, 48), (3, 16)])
@pytest.mark.parametrize("case", sorted(FLUSH_CASES))
def test_flush_pieces_schedule_matches_jax(case, kvh, d):
    fl, nf = (np.array(x, np.int32) for x in FLUSH_CASES[case])
    rng = np.random.default_rng(len(case) * 100 + d)
    NL, B, KVH, D, L, SW = 2, 4, kvh, d, 256, 64
    mains, rings = _cache(rng, NL, B, KVH, D, L), _cache(rng, NL, B, KVH, D,
                                                         SW)
    ref = jax_flush(tuple(jnp.asarray(a) for a in mains),
                    tuple(jnp.asarray(a) for a in rings), jnp.asarray(fl),
                    jnp.asarray(nf), interpret=True)
    t = lambda a: torch.from_numpy(a.copy())
    ours = emulate_flush_pieces([t(a) for a in mains],
                                [t(a) for a in rings], fl, nf)
    plain = kcw.flush_plain(tuple(t(a) for a in mains),
                            tuple(t(a) for a in rings), t(fl), t(nf))
    for got, p, want, orig in zip(ours, plain, ref, mains):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(p.numpy(), np.asarray(want))
    moved = sum(int((a.numpy() != b).sum()) for a, b in zip(ours, mains))
    assert moved > 0


def test_flush_pieces_cover_each_token_once():
    """The threads of a (layer, slot), ceil(rows / RPT) x P of them, hold
    each row once; the pieces of one row (P = ceil(SW / 16), stepping by
    16 P) visit every token of a span once, for any span and ring width."""
    for nrow in (1, 3, 272, 8704):
        rq = -(-nrow // RPT)
        held = [q + k * rq for q in range(rq) for k in range(RPT)
                if q + k * rq < nrow]
        assert sorted(held) == list(range(nrow)), nrow
    for SW in (16, 40, 64):
        P = (SW + 15) // 16
        for lo, hi in ((0, 0), (0, SW), (5, 5 + 3 * SW), (96, 160),
                       (120, 151)):
            seen = [t for p in range(P) for t0 in range(lo + 16 * p, hi,
                                                        16 * P)
                    for t in range(t0, min(t0 + 16, hi))]
            assert sorted(seen) == list(range(lo, hi)), (SW, lo, hi)
