"""The host side of the decode kernels split over L (rows 5 to 10):
their grid, the chunks each slot holds in combine order, the count the last
block waits for, and the scratch.

``csrc/decode_split.cuh`` runs a block per (slot, kv head, span of ``cpb``
chunks of :data:`CHUNK` tokens); the staged cache (rows 7 and 9) has its
main columns ``[0, flushed)`` in such spans and its :data:`RING`-lane ring
as one more block, the last in every order. Pass 1 writes each span's
scores and its stats ``(m_c, l_c)``; pass 2 merges the stats in chunk
order, forms p with the final stats and a partial P·V per span, and the
last block of the (slot, kv head) sums the partials in chunk order.
:func:`slot_chunks` is the Python twin of ``chunk_of``: the CPU tests
emulate the combine with it and hold the emulation against the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

CHUNK = 256   # tokens per chunk (csrc: CH), one per thread of a block
RING = 64     # lanes of the staged cache's ring (csrc: RING)
SMS = 132     # streaming multiprocessors of an H100 SXM
MAX_CPB = 8   # chunks a block walks at most (rows 8 and 9)


class Chunk(NamedTuple):
    """One block's span: score columns ``[c0 + j0, c0 + n)`` (``c0 = L``
    for the ring); ``zi``, its index among the (slot, kv head)'s stats and
    partials."""
    zi: int
    c0: int
    j0: int
    n: int
    ring: bool


def window_start(pos: int, window: int | None) -> int:
    """The first column a kernel reads under a sliding window: the start of
    the 16-token group holding the window's first key (0 without one)."""
    return 0 if window is None else max(0, pos - window + 1) // 16 * 16


def grid_z(L: int, cpb: int = 1, staged: bool = False) -> int:
    """Blocks along z: spans of ``cpb`` chunks over L, and the ring's."""
    chunks = -(-L // CHUNK)
    return -(-chunks // cpb) + staged


def slot_chunks(pos: int, L: int, *, flushed: int | None = None,
                window: int | None = None, cpb: int = 1) -> list[Chunk]:
    """The spans of one slot in combine order (``chunk_of`` over the grid):
    direct (``flushed`` None) the 16-token groups up to the one holding
    ``pos`` from the window's first; staged ``[0, flushed)``, then the
    ring."""
    span = cpb * CHUNK
    nz = grid_z(L, cpb, flushed is not None)
    if flushed is None:
        ntok = max(0, min((pos + 16) // 16 * 16, L))
        first = min(window_start(pos, window), ntok)
    else:
        ntok, first = flushed, 0
        nz -= 1
    out = []
    for z in range(nz):
        c0 = z * span
        if c0 >= ntok or c0 + span <= first:
            continue
        out.append(Chunk(z, c0, max(0, first - c0), min(span, ntok - c0),
                         False))
    if flushed is not None:
        out.append(Chunk(-(-flushed // span), L, 0, RING, True))
    return out


def counter_target(pos: int, L: int, *, flushed: int | None = None,
                   window: int | None = None, cpb: int = 1) -> int:
    """The blocks of a (slot, kv head) that add to its counter; the one
    that finds it at this count less one sums the partials (at
    ``flushed = 0`` the ring alone)."""
    return len(slot_chunks(pos, L, flushed=flushed, window=window, cpb=cpb))


def scratch_floats(B: int, H: int, KVH: int, L: int, d: int, *,
                   cpb: int = 1, staged: bool = False) -> int:
    """f32 scratch of one call (``carve``): the scores (B, H, L, + 64 when
    staged), the chunk stats m and l (B, KVH, NZ, n_rep) each, the partial
    outputs (B, KVH, NZ, n_rep, d), NZ = :func:`grid_z`, and an int32
    counter per (slot, kv head)."""
    nz = grid_z(L, cpb, staged)
    return B * H * (L + RING * staged) + B * H * nz * (2 + d) + B * KVH


def chunks_per_block(B: int, KVH: int, L: int, window: int | None = None
                     ) -> int:
    """The span of rows 8 and 9: the most chunks a block walks (a power of
    two up to
    :data:`MAX_CPB`) that still leaves at least two blocks an SM where
    every slot holds the whole of L (or of the window). On the H100 the
    longer spans won where the route sends row 8 (``python3
    tools/bench_attention_parts.py --rows 8 --cpb 2 4 8``): 8 over 4 over
    2 at 8 slots x 32 kv heads and L = 16384 to 32768, 4 over 2 under
    Mistral's window (8, about one block an SM, lost)."""
    held = -(-min(L, L if window is None else window + 16) // CHUNK)
    cpb = 1
    while cpb < MAX_CPB and B * KVH * -(-held // (2 * cpb)) >= 2 * SMS:
        cpb *= 2
    return cpb
