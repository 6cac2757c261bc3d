"""Kernel 3 (staged decode attention): the port's plain version against
the JAX package's ``decode_attention_quantized_staged`` (Pallas in
interpret mode) on the same layer-stacked MXINT8 cache and rings.

The attention output is allclose (rtol = atol = 2e-4; exp and the f32
summation order differ, no 8-bit rounding of p flips on these seeds); the
ring bytes the kernel writes in place are bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.pallas.decode_attention import (
    decode_attention_quantized_staged as jax_staged,
)
from lqer_tpu.parallel.collectives import mx8_encode
from lqer_tpu_torch.ops.kernels import decode_attention as k3
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

NL, B, KVH, D, L, SW = 2, 3, 2, 64, 256, 64
NREP = 2
H = KVH * NREP


def _encoded(rng, width):
    vals = jnp.asarray(rng.standard_normal((NL, B, KVH, width, D)),
                       jnp.float32)
    c, e = mx8_encode(vals, 16, zero_fill=1.0)
    return (np.array(jnp.swapaxes(c, -1, -2)), np.array(jnp.swapaxes(e, -1, -2)))


def _setup(seed):
    rng = np.random.default_rng(seed)
    main = [*_encoded(rng, L), *_encoded(rng, L)]
    ring = [*_encoded(rng, SW), *_encoded(rng, SW)]
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kh = rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
    vh = rng.standard_normal((B, KVH, 1, D)).astype(np.float32)
    return main, ring, q, kh, vh


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("positions,flushed", [
    ([70, 37, 128], [64, 32, 128]),     # residues 6, 5, 0
    ([111, 95, 200], [64, 64, 160]),    # residues 47, 31, 40
])
def test_plain_matches_jax(li, positions, flushed):
    main, ring, q, kh, vh = _setup(li * 10 + positions[0])
    pos = np.array(positions, np.int32)
    fl = np.array(flushed, np.int32)
    scaling = D ** -0.5
    attn, *rings_j = jax_staged(
        jnp.asarray(q), *(jnp.asarray(a) for a in main),
        *(jnp.asarray(a) for a in ring), jnp.asarray(kh), jnp.asarray(vh),
        jnp.asarray(pos), jnp.asarray(fl), jnp.asarray([li], jnp.int32),
        scaling=scaling, interpret=True)
    t_main = [torch.from_numpy(a) for a in main]
    t_ring = [torch.from_numpy(a.copy()) for a in ring]
    ours = k3.decode_attention_quantized_staged(
        torch.from_numpy(q), *(a[li] for a in t_main), *(a[li] for a in t_ring),
        torch.from_numpy(kh), torch.from_numpy(vh), torch.from_numpy(pos),
        torch.from_numpy(fl), scaling=scaling)
    np.testing.assert_allclose(ours.numpy(), np.asarray(attn), rtol=2e-4,
                               atol=2e-4)
    for got, want in zip(t_ring, rings_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rejects_other_ring_widths():
    main, ring, q, kh, vh = _setup(0)
    short = [torch.from_numpy(a[0][..., :32].copy()) for a in ring]
    with pytest.raises(ValueError, match="64-lane ring"):
        k3.decode_attention_quantized_staged(
            torch.from_numpy(q), *(torch.from_numpy(a[0]) for a in main),
            *short, torch.from_numpy(kh), torch.from_numpy(vh),
            torch.tensor([40, 40, 40]), torch.tensor([32, 32, 32]),
            scaling=0.125)
