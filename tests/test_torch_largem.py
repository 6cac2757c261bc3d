"""The large-M route (512 rows and more): kernel 6's plain version (the
unpack of a packed weight to dense bf16) against the JAX package's
``unpack_tiles_to_bf16(use_pallas=False)``, bit for bit, for W4, W8 and a
layer-stacked view; and the port's ``qlinear_w4_dense_largeM`` against the
JAX function of that name at M = 600 within rtol = atol = 2e-4 (the
products are exact, only the f32 summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops import storage as jstorage
from lqer_tpu.ops.pallas.dequant_gemm import prepare_w4_weights as jax_prepare
from lqer_tpu.ops.pallas.dequant_gemm import qlinear_w4_dense_largeM as jax_dense
from lqer_tpu.ops.pallas.dequant_gemm import unpack_tiles_to_bf16
from lqer_tpu.ops.quantizers import block_fp_quantizer
from lqer_tpu_torch.convert import backend_from_jax
from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
from lqer_tpu_torch.ops.storage import MXFormat
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.serving import kernel_backend as tbackend
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

K, N = 256, 384
TOL = dict(rtol=2e-4, atol=2e-4)


def _prep(width, seed, rank=0, layers=None):
    """JAX prep (layer-stacked when ``layers``) and the converted port prep."""
    rng = np.random.default_rng(seed)

    def one():
        w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
        w[:3, :16] = 0.0       # all-zero groups
        a = b = None
        if rank:
            a = jnp.asarray((rng.standard_normal((K, rank)) * 0.05).astype(
                jnp.bfloat16))
            b = jnp.asarray((rng.standard_normal((rank, N)) * 0.05).astype(
                jnp.bfloat16))
        return jax_prepare(jnp.asarray(w), a=a, b=b,
                           fmt=jstorage.MXFormat(width), tile_k=128,
                           tile_n=128)

    preps = [one() for _ in range(layers or 1)]
    arrays = {k: None if preps[0][k] is None
              else np.stack([np.asarray(p[k]) for p in preps]) if layers
              else np.asarray(preps[0][k])
              for k in ("tiles", "a", "b", "bias")}
    meta = {"fmt": preps[0]["fmt"], "tile_k": 128, "xa_width": 8,
            "out_width": 8}
    tprep = backend_from_jax({"w": arrays}, {"w": meta})["arrays"]["w"]
    return preps, tprep


@pytest.mark.parametrize("width", [4, 8])
def test_unpack_bit_equal_to_jax(width):
    (prep,), tprep = _prep(width, seed=width)
    ref = unpack_tiles_to_bf16(prep["tiles"], 128, 128,
                               jstorage.MXFormat(width), use_pallas=False)
    got = k1.unpack_packed_to_bf16(tprep["codes"], tprep["exps"],
                                   MXFormat(width))
    assert got.dtype == torch.bfloat16 and got.shape == (K, N)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert k1.unpack_packed_to_bf16.launches == 0   # CPU: the plain version


@pytest.mark.parametrize("width", [4, 8])
def test_unpack_layer_stacked_view(width):
    preps, tprep = _prep(width, seed=10 + width, layers=2)
    fmt = MXFormat(width)
    for li, prep in enumerate(preps):
        ref = unpack_tiles_to_bf16(prep["tiles"], 128, 128,
                                   jstorage.MXFormat(width), use_pallas=False)
        codes, exps = tprep["codes"][li], tprep["exps"][li]
        assert codes.is_contiguous() and codes.data_ptr() == \
            tprep["codes"].data_ptr() + li * codes.numel() * 4
        np.testing.assert_array_equal(
            k1.unpack_packed_to_bf16(codes, exps, fmt).float().numpy(),
            np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("rank", [0, 32])
@pytest.mark.parametrize("width", [4, 8])
def test_linear_large_m_matches_jax(width, rank):
    (prep,), tprep = _prep(width, seed=20 + width + rank, rank=rank)
    x = block_fp_quantizer(
        jnp.asarray(np.random.default_rng(rank).standard_normal((600, K)),
                    jnp.float32),
        width=8, exponent_width=8, block_size=[1, 16],
        skip_first_dim=True).astype(jnp.bfloat16)
    ref = np.asarray(jax_dense(x, prep))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = k1.qlinear_w4_dense_largeM(xt, tprep, MXFormat(width))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_dense_product_keeps_f32():
    """The dense product returns f32 sums of exact products, not a bf16
    rounding of them (what a bf16 ``torch.matmul`` would return)."""
    x = torch.tensor([[1.0, 2.0 ** -9]], dtype=torch.bfloat16)
    w = torch.ones(2, 1, dtype=torch.bfloat16)
    y = k1.dense_f32(x, w)
    assert y.dtype == torch.float32 and float(y) == 1.0 + 2.0 ** -9


def test_lm_head_takes_large_m_route(monkeypatch):
    """At 512 rows the packed head runs unpack + dense, below it kernel 1;
    both compute the same logits."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.05).astype(
        np.float32))
    backend = tbackend.pack_lm_head({"arrays": {}, "meta": {}},
                                    {"lm_head.weight": w}, width=8)
    h = torch.from_numpy(rng.standard_normal((2, 256, 128)).astype(
        np.float32)).to(torch.bfloat16)
    calls = []
    real = k1.unpack_packed_to_bf16
    monkeypatch.setattr(k1, "unpack_packed_to_bf16",
                        lambda *a: calls.append(1) or real(*a))
    big = tdecode._lm_head_logits(h, None, backend)
    assert calls == [1] and big.shape == (2, 256, 256)
    small = tdecode._lm_head_logits(h[:, :255], None, backend)
    assert calls == [1]
    np.testing.assert_allclose(small.float().numpy(),
                               big[:, :255].float().numpy(), **TOL)
