"""The port's quantizers, blocking and MXINT codec against the JAX package.

Same inputs (numpy, seeded) through both; every comparison is bit-exact
except the pinned exponent contract: the port takes shared exponents from
the float's bits (``ceil_log2_exact``), the JAX quantizers from a float
``ceil(log2)``, and the two may differ by one exponent step on a group whose
absmax lies one ulp above a power of two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops import blocking as jblocking
from lqer_tpu.ops import quantizers as jq
from lqer_tpu.ops.qlinear import QLinearConfig as JQLinearConfig
from lqer_tpu.ops.qlinear import qlinear as jax_qlinear
from lqer_tpu.ops.qlinear import qmatmul as jax_qmatmul
from lqer_tpu.parallel import collectives as jc
from lqer_tpu_torch.ops import blocking as tblocking
from lqer_tpu_torch.ops import quantizers as tq
from lqer_tpu_torch.ops.qlinear import QLinearConfig, qlinear
from lqer_tpu_torch.ops import registry as tregistry
from lqer_tpu_torch.parallel import collectives as tc
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()


def _x(seed=0, shape=(4, 24, 80), scale=0.3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, :2] = 0.0                    # all-zero groups
    x[1, 0, :5] = 3e-9                # |x| <= 1e-8 passthrough
    return x


def _both(fn_j, fn_t, x, **kw):
    a = np.asarray(fn_j(jnp.asarray(x), **kw))
    b = fn_t(torch.from_numpy(x), **kw).numpy()
    return a, b


@pytest.mark.parametrize("kw", [
    dict(width=8, exponent_width=8, block_size=[1, 16], skip_first_dim=True),
    dict(width=4, exponent_width=8, block_size=[1, 16], skip_first_dim=False),
    dict(width=6, exponent_width=8, block_size=[16], skip_first_dim=True),
    dict(width=8, exponent_width=5, block_size=[4, 8], skip_first_dim=False),
    dict(width=4, exponent_width=8, block_size=[-1, 32], skip_first_dim=True),
])
def test_block_fp_bit_exact(kw):
    a, b = _both(jq.block_fp_quantizer, tq.block_fp_quantizer, _x(1), **kw)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn,kw", [
    ("integer_quantizer", dict(width=8, frac_width=4)),
    ("integer_quantizer", dict(width=6, frac_width=3, is_signed=False)),
    ("minifloat_ieee_quantizer", dict(width=8, exponent_width=4)),
    ("minifloat_denorm_quantizer", dict(width=8, exponent_width=4)),
    ("minifloat_denorm_quantizer", dict(width=6, exponent_width=3,
                                        exponent_bias=2)),
])
def test_other_quantizers_bit_exact(fn, kw):
    a, b = _both(getattr(jq, fn), getattr(tq, fn), _x(2), **kw)
    np.testing.assert_array_equal(a, b)


def test_quantizer_keeps_dtype_and_passthrough():
    x = torch.from_numpy(_x(3)).to(torch.bfloat16)
    y = tq.block_fp_quantizer(x, width=8, exponent_width=8,
                              block_size=[1, 16], skip_first_dim=True)
    assert y.dtype == torch.bfloat16
    assert tq.make_quantizer({"name": "passthrough"}) is tq.passthrough_quantizer
    assert tq.make_quantizer(None)(x) is x


def test_straight_through_gradient():
    x = torch.from_numpy(_x(4)).requires_grad_()
    q = tq.make_quantizer({"name": "block_fp", "width": 4,
                           "exponent_width": 8, "block_size": [1, 16],
                           "skip_first_dim": True})
    g = torch.randn_like(x)
    (q(x) * g).sum().backward()
    assert torch.equal(x.grad, g)


def test_make_quantizer_memoized():
    cfg = {"name": "block_fp", "width": 8, "exponent_width": 8,
           "block_size": [1, 16], "skip_first_dim": True}
    assert tq.make_quantizer(cfg) is tq.make_quantizer(dict(cfg))
    with pytest.raises(ValueError):
        tq.get_quantizer("nope")


@pytest.mark.parametrize("shape,block,skip", [
    ((5, 7, 33), [1, 16], True), ((64, 48), [16], False),
    ((3, 9), [-1, 4], False), ((2, 3, 4), 8, True)])
def test_blocking_matches(shape, block, skip):
    assert tblocking.infer_block_shape(shape, block, skip) == \
        jblocking.infer_block_shape(shape, block, skip)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    vj, bj, ej = jblocking.per_block_absmax(jnp.asarray(x), block, skip)
    vt, bt, et = tblocking.per_block_absmax(torch.from_numpy(x), block, skip)
    assert ej == et
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    np.testing.assert_array_equal(
        np.asarray(jblocking.unblock(vj, x.shape, ej)),
        tblocking.unblock(vt, x.shape, et).numpy())


@pytest.mark.parametrize("zero_fill", [None, 1.0])
def test_mx_codec_bit_exact(zero_fill):
    x = _x(6, shape=(3, 5, 64))
    for enc_j, enc_t, dec_j, dec_t in (
            (jc.mx8_encode, tc.mx8_encode, jc.mx8_decode, tc.mx8_decode),
            (jc.mx4_encode, tc.mx4_encode, jc.mx4_decode, tc.mx4_decode)):
        cj, ej = enc_j(jnp.asarray(x), 16, zero_fill=zero_fill)
        ct, et = enc_t(torch.from_numpy(x), 16, zero_fill=zero_fill)
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        np.testing.assert_array_equal(np.asarray(ej), et.numpy())
        np.testing.assert_array_equal(np.asarray(dec_j(cj, ej)),
                                      dec_t(ct, et).numpy())


KS = (-15, -13, -5, 3, 13, 15)


def test_ceil_log2_exact_matches_jax_bits():
    rng = np.random.default_rng(7)
    x = np.concatenate([
        np.exp2(rng.uniform(-140, 120, 4096)).astype(np.float32),
        np.exp2(np.arange(-126, 127)).astype(np.float32),
        np.nextafter(np.exp2(np.arange(-126, 127)).astype(np.float32),
                     np.float32(np.inf)),
        np.array([1e-45, 1e-40, 1.1754942e-38], np.float32),   # subnormals
    ])
    got = tc.ceil_log2_exact(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.ceil_log2_exact(
        jnp.asarray(x))))
    normal = x >= np.float32(2.0 ** -126)
    exact = np.clip(np.ceil(np.log2(x.astype(np.float64))), -127, 128)
    np.testing.assert_array_equal(got[normal], exact[normal])
    assert (got[~normal] == -127).all()  # subnormals clamp to -127


@pytest.mark.parametrize("k", KS)
def test_exponent_contract_at_nextafter_pow2(k):
    """A 16-group whose absmax is nextafter(2^k): the port's exponent is
    exactly k + 1 (absmax → code 64); the JAX quantizer's float path picks k
    or k + 1. Each output equals the block_fp grid at the exponent it
    picked, so the two differ by at most one exponent step."""
    amax = np.nextafter(np.float32(2.0 ** k), np.float32(np.inf))
    rng = np.random.default_rng(100 + k)
    g = (rng.uniform(-1, 1, 16) * float(amax) * 0.9).astype(np.float32)
    g[3] = amax
    x = g[None, :]
    kw = dict(width=8, exponent_width=8, block_size=[1, 16],
              skip_first_dim=True)
    port = tq.block_fp_quantizer(torch.from_numpy(x), **kw).numpy()
    jax_q = np.asarray(jq.block_fp_quantizer(jnp.asarray(x), **kw))

    def grid(e):
        v = x.astype(np.float32)
        mant = np.clip(np.round((np.abs(v) + np.float32(1e-9))
                                / np.float32(2.0 ** e) * 128), 0, 127)
        return (np.sign(v + np.float32(1e-9)) * np.float32(2.0 ** e)
                * (mant / 128)).astype(np.float32)

    np.testing.assert_array_equal(port, grid(k + 1))
    assert np.array_equal(jax_q, grid(k)) or np.array_equal(jax_q, grid(k + 1))
    assert int(tc.ceil_log2_exact(torch.tensor([amax]))[0]) == k + 1


def test_subnormal_group_clamps_to_minus_127():
    """A group of subnormals encodes with exponent -127 (the clamp), from
    the bits, with the block_fp formula (f32, no flush to zero). XLA on the
    CPU flushes subnormal operands of arithmetic to zero, so the JAX encode
    itself is compared on the exponent bits only (``ceil_log2_exact``)."""
    x = np.zeros((1, 16), np.float32)
    x[0, :4] = [1e-40, -3e-41, 5e-42, 1e-45]
    ct, et = tc.mx8_encode(torch.from_numpy(x), 16, zero_fill=1.0)
    assert int(et[0, 0]) == -127
    amax = np.abs(x).max(keepdims=True)
    assert int(np.asarray(jc.ceil_log2_exact(jnp.asarray(amax)))[0, 0]) == -127
    scale = np.float32(2.0 ** -127)
    mant = np.clip(np.round((np.abs(x) + np.float32(1e-9)) / scale
                            * np.float32(128)), 0, 127)
    expect = (np.sign(x + np.float32(1e-9)) * mant).astype(np.int8)
    np.testing.assert_array_equal(ct.numpy(), expect)
    assert float(tc.exp2_int(torch.tensor([-127]))[0]) == 2.0 ** -127
    assert float(tc.exp2_int(torch.tensor([-149]))[0]) == 2.0 ** -149


Q8 = {"name": "block_fp", "width": 8, "exponent_width": 8,
      "exponent_bias": None, "block_size": [1, 16], "skip_first_dim": True}
W4 = {"name": "block_fp", "width": 4, "exponent_width": 8,
      "exponent_bias": None, "block_size": [1, 16], "skip_first_dim": False}


def test_qlinear_config_fallback_and_qlinear():
    q_config = {"name": "flexible_lqer", "is_ptq": False, "x_quantizer": Q8,
                "w_quantizer": W4, "b_quantizer": Q8}
    tcfg = QLinearConfig.from_q_config(q_config, {"rank": 16})
    jcfg = JQLinearConfig.from_q_config(q_config, {"rank": 16})
    assert tcfg.a_out_cfg == Q8 and tcfg.b_out_cfg == Q8 and tcfg.rank == 16
    assert tcfg.is_lqer and jcfg.rank == tcfg.rank
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    params = {"weight": rng.standard_normal((48, 64)).astype(np.float32) * .1,
              "bias": rng.standard_normal(48).astype(np.float32) * .1,
              "A": rng.standard_normal((64, 16)).astype(np.float32) * .1,
              "B": rng.standard_normal((16, 48)).astype(np.float32) * .1}
    yj = np.asarray(jax_qlinear(jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in params.items()}, jcfg))
    yt = qlinear(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in params.items()}, tcfg).numpy()
    # f32 matmul summation order only (plus rare 8-bit rounding flips of
    # the partial-product quantizers, none at this seed)
    np.testing.assert_allclose(yt, yj, rtol=2e-4, atol=2e-4)


def test_registry_and_qmatmul():
    build = tregistry.get_quantized_layer_cls("linear",
                                              {"name": "flexible_lqer"})
    _, cfg = build({"rank": 4})
    assert cfg.is_lqer and cfg.rank == 4
    with pytest.raises(ValueError):
        tregistry.get_quantized_layer_cls("linear", {"name": "bogus"})
    mm = tregistry.get_quantized_func("matmul", {"name": "flexible",
                                                 "x_quantizer": Q8,
                                                 "w_quantizer": Q8})
    rng = np.random.default_rng(10)
    a = rng.standard_normal((2, 8, 32)).astype(np.float32)
    b = rng.standard_normal((2, 32, 16)).astype(np.float32)
    ref = np.asarray(jax_qmatmul(jnp.asarray(a), jnp.asarray(b), {
        "x_quantizer": Q8, "w_quantizer": Q8}))
    np.testing.assert_allclose(mm(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy(), ref,
                               rtol=2e-4, atol=2e-4)
