"""The port's GPTQ and AWQ checkpoint packers and dequantizers
(``lqer_tpu_torch/models/quant_checkpoints.py``) against the JAX package's
(``lqer_tpu/models/quant_checkpoints.py``, numpy) on the same seeded
weights: packed words, zeros, scales, ``g_idx`` and decoded weights equal
to the bit. The cases of ``tests/test_quant_checkpoints.py`` (round trips
over group sizes and ``zero_offset``, act-order ``g_idx``, a mixed
checkpoint, a dequantized tiny OPT forward) run on the port, and an
all-positive group pins the GPTQ zero-of-0 wrap (stored ``z - 1 = -1`` as
the nibble 15, read back as 16) on both sides."""

import numpy as np
import pytest
import torch

from lqer_tpu.models import quant_checkpoints as jqc
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import params_from_jax
from lqer_tpu_torch.models import quant_checkpoints as tqc
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()


def _random_w(out_f=24, in_f=256, seed=0):
    return np.random.RandomState(seed).randn(out_f, in_f).astype(np.float32)


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == np.asarray(want).dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group_size", [64, 128])
@pytest.mark.parametrize("zero_offset", [True, False])
def test_gptq_roundtrip_equals_jax(group_size, zero_offset):
    w = _random_w()
    got = tqc.pack_gptq_weight(torch.from_numpy(w), group_size=group_size,
                               zero_offset=zero_offset)
    want = jqc.pack_gptq_weight(w, group_size=group_size,
                                zero_offset=zero_offset)
    for g, x in zip(got, want):
        _equal(g, x)
    qweight, qzeros, scales, g_idx = got
    assert qweight.shape == (w.shape[1] // 8, w.shape[0])
    deq = tqc.dequantize_gptq_weight(qweight, qzeros, scales, g_idx,
                                     zero_offset=zero_offset)
    _equal(deq, jqc.dequantize_gptq_weight(*want, zero_offset=zero_offset))
    assert deq.shape == w.shape
    step = (w.max() - w.min()) / 15.0
    assert float((deq - torch.from_numpy(w)).abs().max()) <= step
    qw2, qz2, sc2, _ = tqc.pack_gptq_weight(deq, group_size=group_size,
                                            zero_offset=zero_offset)
    deq2 = tqc.dequantize_gptq_weight(qw2, qz2, sc2, g_idx,
                                      zero_offset=zero_offset)
    np.testing.assert_allclose(deq2.numpy(), deq.numpy(), atol=1e-5)


def test_gptq_act_order_g_idx():
    """A permuted ``g_idx`` (act order) decodes as JAX decodes it, and
    differs from the contiguous groups."""
    w = _random_w(16, 128, seed=3)
    qweight, qzeros, scales, g_idx = jqc.pack_gptq_weight(w, group_size=64)
    perm = np.random.RandomState(1).permutation(128)
    t = [torch.from_numpy(a) for a in (qweight, qzeros, scales)]
    base = tqc.dequantize_gptq_weight(*t, torch.from_numpy(g_idx))
    permuted = tqc.dequantize_gptq_weight(*t, torch.from_numpy(g_idx[perm]))
    _equal(permuted, jqc.dequantize_gptq_weight(qweight, qzeros, scales,
                                                g_idx[perm]))
    assert not torch.allclose(base, permuted)


def test_gptq_zero_of_zero_wraps_as_in_jax():
    """Every weight >= 0: a group's min-max zero is 0, stored as ``0 - 1``
    masked to the nibble 15, which decodes as zero 16 (16 code steps off);
    the port keeps the format bit for bit."""
    w = np.abs(_random_w(8, 32, seed=11))
    got = tqc.pack_gptq_weight(torch.from_numpy(w), group_size=32)
    want = jqc.pack_gptq_weight(w, group_size=32)
    for g, x in zip(got, want):
        _equal(g, x)
    zeros = tqc._unpack_int32_nibbles(got[1], axis=1)
    assert int((zeros == 15).sum()) == zeros.numel()
    deq = tqc.dequantize_gptq_weight(*got)
    _equal(deq, jqc.dequantize_gptq_weight(*want))
    scale = got[2].to(torch.float32).max()
    err = float((deq - torch.from_numpy(w)).abs().max())
    assert err > 15 * float(scale), (err, float(scale))


def test_unpack_high_nibble_of_negative_words():
    """Nibble 7 of a word with the sign bit set reads 8..15, not a
    sign-extended value."""
    words = np.array([[-1, -2 ** 31, 0x7FFFFFFF, -0x6543210F]], np.int32)
    got = tqc._unpack_int32_nibbles(torch.from_numpy(words), axis=1)
    _equal(got, jqc._unpack_int32_nibbles(words, axis=1))
    assert got[0, 7] == 15 and got[0, 15] == 8


@pytest.mark.parametrize("group_size", [64, 128])
def test_awq_roundtrip_equals_jax(group_size):
    w = _random_w(32, 256, seed=5)
    got = tqc.pack_awq_weight(torch.from_numpy(w), group_size=group_size)
    want = jqc.pack_awq_weight(w, group_size=group_size)
    for g, x in zip(got, want):
        _equal(g, x)
    assert got[0].shape == (w.shape[1], w.shape[0] // 8)
    deq = tqc.dequantize_awq_weight(*got)
    _equal(deq, jqc.dequantize_awq_weight(*want))
    step = (w.max() - w.min()) / 15.0
    assert float((deq - torch.from_numpy(w)).abs().max()) <= step


def test_dequantize_checkpoint_mixed():
    """A whole checkpoint dict: packed modules decode to ``.weight`` as in
    JAX, everything else passes through untouched."""
    w1 = _random_w(16, 128, seed=7)
    w2 = _random_w(24, 128, seed=8)
    qw, qz, sc, gi = jqc.pack_gptq_weight(w1, group_size=64)
    emb = np.random.RandomState(9).randn(50, 16).astype(np.float32)
    bias = np.zeros(16, np.float32)
    tensors = {
        "model.layers.0.self_attn.q_proj.qweight": qw,
        "model.layers.0.self_attn.q_proj.qzeros": qz,
        "model.layers.0.self_attn.q_proj.scales": sc,
        "model.layers.0.self_attn.q_proj.g_idx": gi,
        "model.layers.0.self_attn.q_proj.bias": bias,
        "model.embed_tokens.weight": emb,
    }
    qw2, qz2, sc2 = jqc.pack_awq_weight(w2, group_size=64)
    tensors.update({
        "model.layers.0.mlp.up_proj.qweight": qw2,
        "model.layers.0.mlp.up_proj.qzeros": qz2,
        "model.layers.0.mlp.up_proj.scales": sc2,
    })
    for fmt, keep in (("gptq", lambda k: "up_proj" not in k),
                      ("awq", lambda k: "up_proj" in k)):
        part = {k: v for k, v in tensors.items() if keep(k)}
        got = tqc.dequantize_checkpoint(
            {k: torch.from_numpy(v) for k, v in part.items()}, fmt)
        want = jqc.dequantize_checkpoint(part, fmt)
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
        assert not any(k.endswith(".qweight") for k in got)
    with pytest.raises(ValueError):
        tqc.dequantize_checkpoint({}, "exl2")


def test_dequantized_forward_runs():
    """A tiny OPT's linears packed as GPTQ by the port, dequantized, and run
    through the port's fp forward: the weights equal JAX's dequantized
    ones, and the last token's argmax matches the undequantized model's."""
    import jax

    from lqer_tpu import models as jmodels
    from lqer_tpu.models import OPTConfig as JOPTConfig

    jcfg = JOPTConfig.tiny(vocab_size=128, hidden=64, layers=1, heads=4,
                           ffn=128)
    params_np = jax.tree.map(np.asarray,
                             jmodels.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = tmodels.OPTConfig.tiny(vocab_size=128, hidden=64, layers=1,
                                 heads=4, ffn=128)
    params = params_from_jax(params_np)
    tensors, tensors_np = {}, {}
    for name, a in params_np.items():
        if name.endswith(".weight") and a.ndim == 2 and (
                "self_attn" in name or ".fc" in name):
            mod = name[:-len(".weight")]
            packed = tqc.pack_gptq_weight(params[name], group_size=32)
            for s, t in zip((".qweight", ".qzeros", ".scales", ".g_idx"),
                            packed):
                tensors[mod + s] = t
                tensors_np[mod + s] = t.numpy()
        else:
            tensors[name] = params[name]
            tensors_np[name] = a
    fp = tqc.dequantize_checkpoint(tensors, "gptq")
    want = jqc.dequantize_checkpoint(tensors_np, "gptq")
    assert set(fp) == set(params)
    for k in want:
        _equal(fp[k], want[k])
    ids = torch.tensor([[3, 17, 42, 9]])
    ref = tmodels.forward(params, ids, cfg, None)
    out = tmodels.forward(fp, ids, cfg, None)
    assert int(out[0, -1].argmax()) == int(ref[0, -1].argmax())
