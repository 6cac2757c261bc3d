"""Kernel 4 (ring flush), the cache-row encode and the staged cache
bookkeeping against the JAX package; all bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.pallas.cache_write import _encode_t as jax_encode_t
from lqer_tpu.ops.pallas.cache_write import flush_stage_to_main as jax_flush
from lqer_tpu.serving import kv_cache as jkv
from lqer_tpu_torch.ops.kernels import cache_write as k4
from lqer_tpu_torch.serving import kv_cache as tkv
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

NL, B, KVH, D, L, SW = 2, 3, 2, 32, 256, 64
ROWS = (D, D // 16, D, D // 16)


def _arrays(seed, width):
    rng = np.random.default_rng(seed)
    return [rng.integers(-128, 128, (NL, B, KVH, r, width)).astype(np.int8)
            for r in ROWS]


@pytest.mark.parametrize("fl,nf", [
    ([32, 0, 64], [64, 32, 96]),        # one 32-block per slot
    ([96, 96, 0], [160, 128, 0]),       # straddles a 128-lane window; no-op
    ([0, 1984 % 256, 160], [32, 224, 192]),
])
def test_flush_matches_jax(fl, nf):
    main, ring = _arrays(1, L), _arrays(2, SW)
    fl_a, nf_a = np.array(fl, np.int32), np.array(nf, np.int32)
    ref = jax_flush(tuple(jnp.asarray(a) for a in main),
                    tuple(jnp.asarray(a) for a in ring), jnp.asarray(fl_a),
                    jnp.asarray(nf_a), interpret=True)
    ours = [torch.from_numpy(a.copy()) for a in main]
    k4.flush_stage_to_main(tuple(ours),
                           tuple(torch.from_numpy(a) for a in ring),
                           torch.from_numpy(fl_a), torch.from_numpy(nf_a))
    for got, want in zip(ours, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encode_t_matches_jax():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((D, 7)).astype(np.float32)
    vals[:16, 2] = 0.0                              # all-zero group
    cj, ej = jax_encode_t(jnp.asarray(vals), 16)
    ct, et = k4._encode_t(torch.from_numpy(vals), 16)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj).astype(np.int8))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej).astype(np.int8))


def test_stage_boundary_sync_matches_jax():
    rng = np.random.default_rng(4)
    jcache = jkv.init_quantized_kv_cache(NL, B, KVH, D, L, staged=True)
    tcache = tkv.init_quantized_kv_cache(NL, B, KVH, D, L, staged=True,
                                         device="cpu")
    for key in tkv.MAIN_KEYS:
        a = rng.integers(-128, 128, jcache[key].shape).astype(np.int8)
        jcache[key] = jnp.asarray(a)
        tcache[key].copy_(torch.from_numpy(a))
    new_pos = np.array([63, 32, 100], np.int32)
    jout = jkv.stage_boundary_sync(jcache, jnp.asarray(new_pos))
    tkv.stage_boundary_sync(tcache, torch.from_numpy(new_pos))
    for key in tkv.STAGE_KEYS + ("flushed",):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jout[key]), err_msg=key)


def test_stage_width_other_than_64_is_rejected():
    """The decode step flushes at a ring residue of 48, which stays below
    the ring width only for 64 lanes; the JAX cache accepts other widths."""
    with pytest.raises(ValueError, match="stage_width must be 64"):
        tkv.init_quantized_kv_cache(1, 2, 2, 32, 256, staged=True,
                                    stage_width=32, device="cpu")
    cache = tkv.init_quantized_kv_cache(1, 2, 2, 32, 256, staged=True,
                                        device="cpu")
    assert cache["k_stage_codes"].shape[-1] == 64
    assert tkv.cache_group(cache) == 16 and tkv.cache_code_width(cache) == 8
    assert tkv.is_staged_cache(cache)
