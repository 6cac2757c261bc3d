"""Packed MXINT storage, the converter from the JAX tile-major layout, and
the port's own packing (``prepare_serving_params`` / ``pack_lm_head``)
against the JAX package. All comparisons are bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.models import LlamaConfig as JLlamaConfig
from lqer_tpu.ops import storage as jstorage
from lqer_tpu.ops.pallas.dequant_gemm import (
    prepare_w4_weights as jax_prepare_w4_weights,
)
from lqer_tpu.ops.pallas.dequant_gemm import unpack_tiles_to_bf16
from lqer_tpu.serving import pallas_backend as jbackend
from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.convert import backend_from_jax, params_from_jax
from lqer_tpu_torch.models import LlamaConfig
from lqer_tpu_torch.ops import storage as tstorage
from lqer_tpu_torch.serving import kernel_backend as tbackend
from lqer_tpu_torch.serving.random_model import Q_CONFIG
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()


def _w(seed, shape, scale=0.1):
    w = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    w[:16, :3] = 0.0   # all-zero groups take the global min-non-zero fill
    return w


@pytest.mark.parametrize("width", [4, 8])
def test_quantize_mx_bit_exact(width):
    w = _w(0, (128, 96))
    cj, ej = jstorage.quantize_mx(jnp.asarray(w), jstorage.MXFormat(width))
    fmt = tstorage.MXFormat(width)
    ct, et = tstorage.quantize_mx(torch.from_numpy(w), fmt)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_array_equal(
        np.asarray(jstorage.dequantize_mx(cj, ej, jstorage.MXFormat(width),
                                          jnp.float32)),
        tstorage.dequantize_mx(ct, et, fmt, torch.float32).numpy())


@pytest.mark.parametrize("width", [4, 8])
def test_pack_words_roundtrip(width):
    fmt = tstorage.MXFormat(width)
    lim = 2 ** (width - 1)
    codes = torch.from_numpy(np.random.default_rng(1).integers(
        -lim + 1, lim, (64, 40)).astype(np.int8))
    words = tstorage.pack_words(codes, fmt)
    assert words.dtype == torch.int32 and words.shape == (64 * width // 32, 40)
    assert torch.equal(tstorage.unpack_words(words, fmt).to(torch.int8), codes)


@pytest.mark.parametrize("width,tile_k,tile_n", [(4, 256, 128), (4, 128, 256),
                                                 (8, 256, 128)])
def test_converter_roundtrip_vs_unpack_tiles(width, tile_k, tile_n):
    """JAX tile-major slabs → codes/exps → the port's words: the
    dequantized weight equals ``unpack_tiles_to_bf16(use_pallas=False)``."""
    w = _w(2, (256, 512))                          # (out, in)
    jfmt = jstorage.MXFormat(width)
    prep = jax_prepare_w4_weights(jnp.asarray(w), fmt=jfmt, tile_k=tile_k,
                                  tile_n=tile_n)
    ref = np.asarray(unpack_tiles_to_bf16(prep["tiles"], tile_k, tile_n, jfmt,
                                          use_pallas=False).astype(jnp.float32))
    fmt = tstorage.MXFormat(width)
    codes, exps = tstorage.codes_exps_from_jax_tiles(
        torch.from_numpy(np.array(prep["tiles"])), tile_k, fmt)
    cj, ej = jstorage.quantize_mx(jnp.asarray(w.T), jfmt)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(exps.numpy(), np.asarray(ej))
    packed = tstorage.pack_weight(codes, exps, fmt)
    np.testing.assert_array_equal(
        tstorage.dequantize_packed(packed["codes"], packed["exps"], fmt).numpy(),
        ref)


def _tiny_params(seed=0, rank=32, inter=256):
    cfg = JLlamaConfig.tiny(vocab_size=128, hidden=256, layers=2, heads=4,
                            kv_heads=2, inter=inter, max_pos=128)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for i in range(cfg.num_hidden_layers):
        for rel in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                    "mlp.down_proj"):
            o, ic = params[f"model.layers.{i}.{rel}.weight"].shape
            for name, shape in (("A", (ic, rank)), ("B", (rank, o))):
                v = (rng.standard_normal(shape) * 0.05).astype(jnp.bfloat16)
                params[f"model.layers.{i}.{rel}.{name}"] = jnp.asarray(
                    v.astype(np.float32))
    return cfg, params


@pytest.mark.parametrize("fuse_mlp,inter", [
    (False, 256),
    (True, 256),
    (True, 2432),     # the JAX packing pads it to 2560, as 7B's 11008 to 11264
])
def test_port_packing_matches_converted_jax_backend(fuse_mlp, inter):
    """The port's packing (``fuse_mlp=True`` by default) is bit-equal to
    ``backend_from_jax`` of the JAX backend packed the same way."""
    jcfg, params = _tiny_params(inter=inter)
    jq = jmodels.quantize_model(jcfg, Q_CONFIG, {"linear": {"rank": 32}})
    jb = jbackend.prepare_serving_params(params, jcfg, jq, fuse_mlp=fuse_mlp)
    jb = jbackend.pack_lm_head(jb, params, width=8)
    conv = backend_from_jax(jax.tree.map(np.asarray, jb["arrays"]), jb["meta"])

    cfg = LlamaConfig.tiny(vocab_size=128, hidden=256, layers=2, heads=4,
                           kv_heads=2, inter=inter, max_pos=128)
    tq = tmodels.quantize_model(cfg, Q_CONFIG, {"linear": {"rank": 32}})
    tparams = params_from_jax({k: np.asarray(v) for k, v in params.items()})
    own = (tbackend.prepare_serving_params(tparams, cfg, tq) if fuse_mlp
           else tbackend.prepare_serving_params(tparams, cfg, tq,
                                                fuse_mlp=False))
    own = tbackend.pack_lm_head(own, tparams, width=8)

    assert sorted(own["meta"]) == sorted(conv["meta"])
    assert "model.layers.0.self_attn.qkv_proj" in own["meta"]
    assert ("model.layers.0.mlp.gateup_proj" in own["meta"]) != fuse_mlp
    assert ("model.layers.0.mlp_fused" in own["meta"]) == fuse_mlp
    if fuse_mlp:
        i_pad = jbackend.pad_to_tile(inter)[0]
        assert own["arrays"]["model.layers.0.mlp_fused"]["codes_d"].shape \
            == (i_pad // 8, 256)
        assert own["meta"]["model.layers.0.mlp_fused"]["kind"] == "mlp"
    for key in own["meta"]:
        assert own["meta"][key] == conv["meta"][key], key
        assert sorted(own["arrays"][key]) == sorted(conv["arrays"][key]), key
        for name in own["arrays"][key]:
            a, b = own["arrays"][key][name], conv["arrays"][key][name]
            assert (a is None) == (b is None), (key, name)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (key, name)


def test_pack_lm_head_does_not_mutate_and_needs_a_head():
    w = torch.from_numpy(_w(3, (256, 128)))
    backend = {"arrays": {}, "meta": {}}
    out = tbackend.pack_lm_head(backend, {"lm_head.weight": w}, width=8)
    assert backend == {"arrays": {}, "meta": {}}
    assert out["meta"]["lm_head"]["n_real"] == 256
    tied = tbackend.pack_lm_head(backend, {"model.embed_tokens.weight": w})
    assert torch.equal(tied["arrays"]["lm_head"]["codes"],
                       out["arrays"]["lm_head"]["codes"])
    with pytest.raises(KeyError, match="lm_head.weight"):
        tbackend.pack_lm_head(backend, {"model.norm.weight": w[0]})


def test_pad_to_tile_and_tiles_match_jax():
    for n in (32000, 11008, 4096, 12288, 384):
        assert tbackend.pad_to_tile(n) == jbackend.pad_to_tile(n)
    for k in (4096, 11008, 256, 96):
        assert tbackend._pick_tile_k(k, 2048) == jbackend._pick_tile_k(k, 2048)
