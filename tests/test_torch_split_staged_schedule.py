"""Rows 7, 8 and 9 split over L: the host side of their launches
(``ops/kernels/split_plan.py``: the grid, the chunks each slot holds in
combine order, the ring as the last chunk, the count the last block waits
for, the scratch), and the kernels' chunked combine emulated in torch on the
CPU from that plan, held against the JAX package's Pallas entries in
interpret mode:

- row 7 (staged): per-chunk ``(m_c, l_c)`` over ``[0, flushed)`` in chunks
  of 256 tokens and over the ring, merged in chunk order, P quantized per 16
  with the final stats, the partial P·V summed in chunk order, against
  ``decode_attention_quantized_staged`` at L = 512, one slot at each of
  flushed 0, 32, 224, 256, 288 and L - 64, every ring but the first
  wrapped, code widths 8 and 4;
- row 9 (staged, row 7's kernels with blocks of ``cpb`` chunks): the same
  combine over spans of ``cpb`` chunks and the ring, against
  ``decode_attention_quantized_streaming_staged`` at L = 1024 and cpb 1, 2
  and 4, one slot at each of flushed 0 (there against the one-pass
  ``decode_attention_quantized_staged``: the JAX streaming kernel returns
  NaN, fault 9 of the reference), a span's edge, one group past it, and
  L - 64 with a full ring, code widths 8 and 4;
- row 8 (direct, blocks of ``cpb`` chunks): the same over the 16-token
  groups up to the one holding pos, from the window's first, against the
  one-pass ``decode_attention_quantized`` (the JAX streaming kernel returns
  NaN under a window once its first chunk holds no key, fault 14 of the
  reference), windowed and not, at L = 1024 and cpb 1, 2 and 4.

The emulation and JAX are held to ``testing.attention_limit``: rtol = atol
= 2e-4 for the f32 summation order, plus one 8-bit code step of p times
|v| for a rounding of p that order can flip, at most 5% of the outputs past
the rtol/atol band.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.pallas import decode_attention as jda
from lqer_tpu.parallel.collectives import mx4_encode, mx8_encode
from lqer_tpu_torch.ops.kernels import decode_attention as k3
from lqer_tpu_torch.ops.kernels import fp_decode, quantized_decode
from lqer_tpu_torch.ops.kernels import split_plan as sp
from lqer_tpu_torch.ops.kernels.attention import _quantize_sublane_groups
from lqer_tpu_torch.testing import (
    attention_limit,
    check_close,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()

NL, KVH, NREP, D = 2, 2, 2, 64
H = KVH * NREP
SCALING = D ** -0.5
L_STAGED = 512
FLUSHED = [0, 32, 224, 256, 288, L_STAGED - 64]
RESIDUE = [40, 47, 5, 0, 33, 47]     # pos = flushed + residue
L_STREAM = 1024
FLUSHED_9 = [0, 256, 272, 512, 528, L_STREAM - 64]
RESIDUE_9 = [40, 47, 5, 0, 33, 63]


def _t(a):
    return torch.from_numpy(np.array(a))


def _encoded(rng, shape, width):
    """MXINT codes and exps of seeded values (…, N, D), token axis last."""
    enc = mx8_encode if width == 8 else mx4_encode
    c, e = enc(jnp.asarray(rng.standard_normal(shape), jnp.float32), 16,
               zero_fill=1.0)
    return [np.array(jnp.swapaxes(c, -1, -2)),
            np.array(jnp.swapaxes(e, -1, -2))]


def emulate(s, v, chunks, p_width=8):
    """The kernels' combine over masked scores ``s`` (B, H, LS) and values
    ``v`` (B, H, LS, d): per slot, each span's ``m_c`` and ``l_c`` (pass
    1), ``m = max m_c`` and ``den = Σ l_c exp(m_c - m)`` in chunk order (a
    span of max -inf adds 0, a zero den becomes 1), each span's p quantized
    per 16 with them and its partial P·V, the partials summed in chunk
    order (pass 2 and its last block). (B, H, 1, d)."""
    B, Hs, _ = s.shape
    out = torch.zeros(B, Hs, 1, v.shape[-1])
    for b in range(B):
        spans = [(c.c0 + c.j0, c.c0 + c.n) for c in chunks[b]]
        stats = []
        for lo, hi in spans:
            sc = s[b, :, lo:hi]
            m_c = sc.amax(-1)
            e = torch.where(sc == -torch.inf, 0.0,
                            torch.exp(sc - m_c[:, None]))
            stats.append((m_c, torch.where(m_c == -torch.inf, 0.0,
                                           e.sum(-1))))
        m = torch.stack([m_c for m_c, _ in stats]).amax(0)
        den = torch.zeros(Hs)
        for m_c, l_c in stats:
            den = den + torch.where(m_c == -torch.inf, 0.0,
                                    l_c * torch.exp(m_c - m))
        den = torch.where(den == 0, 1.0, den)
        acc = torch.zeros(Hs, v.shape[-1])
        for lo, hi in spans:
            sc = s[b, :, lo:hi]
            p = torch.where(sc == -torch.inf, 0.0,
                            torch.exp(sc - m[:, None]) / den[:, None])
            if p_width is not None:
                p = _quantize_sublane_groups(p, p_width - 1, 16)
            acc = acc + (p[:, None, :] @ v[b, :, lo:hi])[:, 0]
        out[b, :, 0] = acc
    return out


# ---- the plan
@pytest.mark.parametrize("flushed", FLUSHED)
def test_staged_chunks(flushed):
    """Main chunks of 256 tokens over [0, flushed), then the ring: the last
    chunk, score columns [L, L + 64), index the count of main chunks."""
    chunks = sp.slot_chunks(flushed + 5, L_STAGED, flushed=flushed)
    mains = -(-flushed // sp.CHUNK)
    assert [c.zi for c in chunks] == list(range(mains + 1))
    assert [c.ring for c in chunks] == [False] * mains + [True]
    assert chunks[-1] == sp.Chunk(mains, L_STAGED, 0, sp.RING, True)
    assert sum(c.n - c.j0 for c in chunks[:-1]) == flushed
    assert sp.counter_target(flushed + 5, L_STAGED, flushed=flushed) \
        == mains + 1
    assert sp.grid_z(L_STAGED, staged=True) == L_STAGED // sp.CHUNK + 1


@pytest.mark.parametrize("edge", ["none", "group short", "span edge",
                                  "group past", "two spans", "full ring"])
@pytest.mark.parametrize("cpb", [1, 2, 4, 8])
def test_staged_span_chunks(cpb, edge):
    """Row 9's spans of cpb chunks over [0, flushed), then the ring: its
    index ceil(flushed / span), inside the grid's stats, the counter
    target one past it."""
    L, span = 8192, cpb * sp.CHUNK
    flushed = {"none": 0, "group short": span - 16, "span edge": span,
               "group past": span + 16, "two spans": 2 * span + 32,
               "full ring": L - 64}[edge]
    chunks = sp.slot_chunks(flushed + 63, L, flushed=flushed, cpb=cpb)
    mains = -(-flushed // span)
    assert [c.zi for c in chunks] == list(range(mains + 1))
    assert [(c.c0, c.j0) for c in chunks[:-1]] == [
        (z * span, 0) for z in range(mains)]
    assert sum(c.n for c in chunks[:-1]) == flushed
    assert all(c.n == span for c in chunks[:-2])
    assert chunks[-1] == sp.Chunk(mains, L, 0, sp.RING, True)
    assert mains < sp.grid_z(L, cpb, staged=True)
    assert sp.counter_target(flushed + 63, L, flushed=flushed, cpb=cpb) \
        == mains + 1


def test_counter_target_at_flushed_zero():
    """No main chunk: the ring's block is the first, the only and the last
    (it zeroes the counter and sums the one partial)."""
    for L in (512, 2048, 32768):
        assert sp.slot_chunks(40, L, flushed=0) == [
            sp.Chunk(0, L, 0, sp.RING, True)]
        assert sp.counter_target(40, L, flushed=0) == 1


@pytest.mark.parametrize("pos,window,cpb,want", [
    (0, None, 1, [(0, 0, 0, 16)]),
    (255, None, 1, [(0, 0, 0, 256)]),
    (256, None, 1, [(0, 0, 0, 256), (1, 256, 0, 16)]),
    (700, 200, 1, [(1, 256, 240, 256), (2, 512, 0, 192)]),
    (700, 200, 2, [(0, 0, 496, 512), (1, 512, 0, 192)]),
    (4000, 600, 2, [(6, 3072, 320, 512), (7, 3584, 0, 432)]),
    (1023, 40, 4, [(0, 0, 976, 1024)]),
    (-1, None, 1, [])])
def test_direct_chunks(pos, window, cpb, want):
    """The 16-token groups up to the one holding pos, from the one holding
    the window's first key, in spans of cpb chunks; spans wholly below the
    window are skipped, so the indices start past 0."""
    chunks = sp.slot_chunks(pos, 4096, window=window, cpb=cpb)
    assert [(c.zi, c.c0, c.j0, c.n) for c in chunks] == want
    assert not any(c.ring for c in chunks)
    assert sp.counter_target(pos, 4096, window=window, cpb=cpb) == len(want)


@pytest.mark.parametrize("L,d,cpb,staged", [
    (512, 64, 1, True), (2048, 128, 1, True), (32768, 64, 1, True),
    (32768, 128, 8, True), (24576, 128, 8, True), (2048, 80, 4, True),
    (2048, 128, 1, False), (32768, 128, 8, False), (32768, 80, 2, False)])
def test_scratch_floats(L, d, cpb, staged):
    """Scores (B, H, L [+ 64]), the stats m, l and the partials per block
    along z, then an int32 counter per (slot, kv head)."""
    B, Hs, KVHs = 8, 32, 8
    nz = sp.grid_z(L, cpb, staged)
    assert nz == -(-(-(-L // 256)) // cpb) + staged
    assert sp.scratch_floats(B, Hs, KVHs, L, d, cpb=cpb, staged=staged) == (
        B * Hs * (L + 64 * staged) + 2 * B * Hs * nz + B * Hs * nz * d
        + B * KVHs)
    assert fp_decode.scratch_floats is sp.scratch_floats


@pytest.mark.parametrize("B,KVH_,L,window,want", [
    (8, 32, 32768, None, 8),     # Llama-2-7B's long context
    (8, 8, 32768, 4096, 4),      # Mistral-7B under its window
    (4, 32, 32768, None, 8),
    (1, 1, 32768, None, 1),
    (8, 32, 2048, None, 4),
    (8, 32, 24576, None, 8)])    # the staged caches at max_len 24576
def test_chunks_per_block(B, KVH_, L, window, want):
    """The span of rows 8 and 9: the longest (up to 8 chunks) that keeps
    two blocks an SM where every slot holds the whole of L or of the
    window."""
    assert sp.chunks_per_block(B, KVH_, L, window) == want


# ---- the combine against the JAX package
@pytest.mark.parametrize("width", [8, 4])
def test_staged_combine_matches_jax(width):
    rng = np.random.default_rng(11 + width)
    B, li = len(FLUSHED), 1
    main = (_encoded(rng, (NL, B, KVH, L_STAGED, D), width)
            + _encoded(rng, (NL, B, KVH, L_STAGED, D), width))
    ring = (_encoded(rng, (NL, B, KVH, 64, D), width)
            + _encoded(rng, (NL, B, KVH, 64, D), width))
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    fl = np.array(FLUSHED, np.int32)
    pos = fl + np.array(RESIDUE, np.int32)
    attn, *rings_j = jda.decode_attention_quantized_staged(
        jnp.asarray(q), *(jnp.asarray(a) for a in main),
        *(jnp.asarray(a) for a in ring), jnp.asarray(kh), jnp.asarray(vh),
        jnp.asarray(pos), jnp.asarray(fl), jnp.asarray([li], jnp.int32),
        scaling=SCALING, interpret=True)
    t_main = [_t(a[li]) for a in main]
    t_ring = [_t(a[li]) for a in ring]
    k3.staged_decode_plain(_t(q), *t_main, *t_ring, _t(kh), _t(vh), _t(pos),
                           _t(fl), scaling=SCALING)   # the ring write
    for got, want in zip(t_ring, rings_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[li])
    s, vals = k3.staged_scores(_t(q), *t_main, *t_ring, _t(pos), _t(fl),
                               scaling=SCALING)
    chunks = [sp.slot_chunks(int(p), L_STAGED, flushed=int(f))
              for p, f in zip(pos, fl)]
    got = emulate(s, vals, chunks)
    want = _t(attn)
    check_close(f"row 7's combine, width {width}", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


@functools.lru_cache(maxsize=None)
def _streaming_staged_case(width):
    """Row 9's inputs at L = 1024 and the JAX reference: the streaming
    staged kernel (chunks of 256), and at flushed = 0 the one-pass one;
    the scores and values of the plain version (rings checked equal to
    JAX's)."""
    rng = np.random.default_rng(23 + width)
    B, li = len(FLUSHED_9), 0
    main = (_encoded(rng, (NL, B, KVH, L_STREAM, D), width)
            + _encoded(rng, (NL, B, KVH, L_STREAM, D), width))
    ring = (_encoded(rng, (NL, B, KVH, 64, D), width)
            + _encoded(rng, (NL, B, KVH, 64, D), width))
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kh, vh = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    fl = np.array(FLUSHED_9, np.int32)
    pos = fl + np.array(RESIDUE_9, np.int32)
    jargs = (jnp.asarray(q), *(jnp.asarray(a) for a in main + ring),
             jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(pos),
             jnp.asarray(fl), jnp.asarray([li], jnp.int32))
    stream, *rings_j = jda.decode_attention_quantized_streaming_staged(
        *jargs, scaling=SCALING, l_chunk=256, interpret=True)
    one_pass, *_ = jda.decode_attention_quantized_staged(
        *jargs, scaling=SCALING, interpret=True)
    want = np.where((fl == 0)[:, None, None, None], np.asarray(one_pass),
                    np.asarray(stream))
    t_main = [_t(a[li]) for a in main]
    t_ring = [_t(a[li]) for a in ring]
    k3.staged_decode_plain(_t(q), *t_main, *t_ring, _t(kh), _t(vh), _t(pos),
                           _t(fl), scaling=SCALING)   # the ring write
    for got, theirs in zip(t_ring, rings_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(theirs)[li])
    s, vals = k3.staged_scores(_t(q), *t_main, *t_ring, _t(pos), _t(fl),
                               scaling=SCALING)
    return s, vals, _t(want), pos, fl


@pytest.mark.parametrize("cpb", [1, 2, 4])
@pytest.mark.parametrize("width", [8, 4])
def test_streaming_staged_combine_matches_jax(width, cpb):
    """Row 9's combine over spans of cpb chunks and the ring."""
    s, vals, want, pos, fl = _streaming_staged_case(width)
    chunks = [sp.slot_chunks(int(p), L_STREAM, flushed=int(f), cpb=cpb)
              for p, f in zip(pos, fl)]
    got = emulate(s, vals, chunks)
    check_close(f"row 9's combine, width {width}, cpb {cpb}", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


@pytest.mark.parametrize("window", [None, 200])
def test_direct_combine_matches_jax(window):
    L, B, li = 1024, 3, 0
    rng = np.random.default_rng(7 if window is None else window)
    cache = (_encoded(rng, (NL, B, KVH, L, D), 8)
             + _encoded(rng, (NL, B, KVH, L, D), 8))
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    pos = np.array([300, 700, 1023], np.int32)
    want = _t(jda.decode_attention_quantized(
        jnp.asarray(q), *(jnp.asarray(a) for a in cache), jnp.asarray(pos),
        scaling=SCALING, window=window, interpret=True,
        layer_index=jnp.asarray([li], jnp.int32)))
    s, vals = quantized_decode.quantized_scores(
        _t(q), *(_t(a) for a in cache), _t(pos), li, scaling=SCALING,
        window=window)
    for cpb in (1, 2, 4):
        chunks = [sp.slot_chunks(int(p), L, window=window, cpb=cpb)
                  for p in pos]
        got = emulate(s[:, :, 0, :], vals, chunks)
        check_close(f"row 8's combine, cpb {cpb}, window {window}", got,
                    want, attention_limit(s, vals, want, p_width=8),
                    max_flipped=0.05)
