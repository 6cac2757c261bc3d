"""The staged MXINT caches take the JAX package's decode route.

Row 7 (the one-pass staged kernel) splits L over blocks with nothing in
shared memory that grows with L, so ``decode.decode_route`` sends
``mxint8-staged`` and ``mxint4-staged`` down the one-pass kernel exactly
where the JAX package takes its one-pass staged kernel (``_kvh_chunk_fits``)
and down the streaming staged kernel past it, at every n_rep the kernels
take and every head dim the cache takes (MXINT4: ``head_dim % 32 == 0``).
The lengths run around JAX's one-pass limit and up to 64K tokens. Until row
7 split L, its score rows in shared memory sent the staged caches streaming
at n_rep 2, d 64 past about 28K tokens where JAX stays one-pass.
"""

import functools

import pytest

from lqer_tpu.ops.pallas.decode_attention import (
    _kvh_chunk_fits as j_kvh_chunk_fits,
)
from lqer_tpu_torch.ops.kernels.attention import HEAD_DIMS
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

ONE_PASS = ("decode_attention",)
STREAMING = ("decode_attention_streaming_staged",)


@functools.lru_cache
def _lengths(head_dim: int) -> list[int]:
    """128, 2048, 64K and the lengths around JAX's one-pass limit."""
    lengths = {128, 2048, 32768, 65536}
    for n in range(128, 65536 + 1, 16):
        if j_kvh_chunk_fits(n, head_dim) != j_kvh_chunk_fits(n + 16,
                                                              head_dim):
            lengths |= {n - 16, n, n + 16, n + 32}
    return sorted(lengths)


@pytest.mark.parametrize("n_rep", range(1, 9))
@pytest.mark.parametrize("kind,head_dim", [
    (kind, d) for kind in ("mxint8-staged", "mxint4-staged")
    for d in HEAD_DIMS if kind == "mxint8-staged" or d % 32 == 0])
def test_staged_routes_follow_the_jax_package(kind, head_dim, n_rep):
    for max_len in _lengths(head_dim):
        route = tdecode.decode_route(kind, max_len, head_dim, n_rep)
        want = ONE_PASS if j_kvh_chunk_fits(max_len, head_dim) else STREAMING
        assert route == want, (max_len, route)


def test_former_departure_is_one_pass():
    """n_rep 2, d 64 at 28672 and 32768 tokens: one-pass in both packages
    (the port streamed there while row 7 held its scores in shared
    memory)."""
    for max_len in (28672, 32768):
        assert j_kvh_chunk_fits(max_len, 64)
        for kind in ("mxint8-staged", "mxint4-staged"):
            assert tdecode.decode_route(kind, max_len, 64, 2) == ONE_PASS
