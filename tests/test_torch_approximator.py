"""The port's approximators (``approximate/approximator.py``: lqer-svd and
lqer-act, each weight group stacked through one batched
``torch.linalg.svd`` in f32) against the JAX package's ``vmap``ped
``jnp.linalg.svd`` on the same weights and scales: 2 layers of a tiny
Llama (hidden 64, intermediate 128, GQA: four weight shapes), rank 8, the
W4 / A8 / B8 quantizers of the debug configs, batch size 3 so groups are
cut into slices.

A and B are fixed only up to the sign of each singular pair, so the test
holds the product ``A_q B_q`` of each weight, not A and B alone: its
relative Frobenius error against JAX's within ``PRODUCT_REL_ERR``. Two f32
SVDs (LAPACK here, XLA's there) give singular vectors a few ulps apart;
A_q and B_q round them to 8-bit codes of their 16-groups, so a value near
a rounding boundary lands one code step (2^-7 of its group's scale)
apart. Such flips move the product by well under 1% of its norm; the
worst weight here reads 0.10% (lqer-svd) and 0.14% (lqer-act).

The error rows ``l1_norm(AB-Q_error_T)/n`` match JAX's at rtol 1e-4 (the
mean over many values absorbs the flips), and the group and key names,
the rows' order and their shapes are equal, for lqer-svd and lqer-act.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu import models as jmodels
from lqer_tpu.approximate import approximator as japprox
from lqer_tpu.ops.quantizers import make_quantizer as jmake_quantizer
from lqer_tpu_torch.approximate import approximator as tapprox
from lqer_tpu_torch.ops.quantizers import make_quantizer
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

PRODUCT_REL_ERR = 1e-2
RANK = 8


def _q(width, block):
    return {"name": "block_fp", "width": width, "exponent_width": 8,
            "exponent_bias": None, "block_size": block,
            "skip_first_dim": False}


CONFIG = {
    "approximator": {
        r"model\.layers\.[0-9]+\.self_attn\.(k|q|v|o)_proj\.weight":
            "default",
        r"model\.layers\.[0-9]+\.mlp\.(gate|up|down)_proj\.weight":
            "default",
        "default": {"rank": RANK, "W_quantizer": _q(4, [1, 16]),
                    "A_quantizer": _q(8, [16, 1]),
                    "B_quantizer": _q(8, [16, 1])},
    }}


@functools.cache
def weights():
    cfg = jmodels.LlamaConfig.tiny(vocab_size=64, hidden=64, layers=2,
                                   heads=4, kv_heads=2, inter=128)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(5))
    params = {k: np.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(6)
    scales = {}
    for k, v in params.items():
        if k.endswith("_proj.weight"):
            s = rng.uniform(0.2, 3.0, v.shape[1]).astype(np.float32)
            scales[k[:-len("weight")] + "scale"] = s
    return params, scales


@functools.cache
def computed(name):
    params, scales = weights()
    j = japprox.get_model_approximator(name)(
        {k: jnp.asarray(v) for k, v in params.items()}, CONFIG)
    t = tapprox.get_model_approximator(name)(
        {k: torch.as_tensor(np.array(v)) for k, v in params.items()},
        CONFIG, device="cpu")
    if name == "lqer-act":
        j.load_scale_dict(scales)
        t.load_scale_dict(scales)
    return (j.compute(keep_error_T=True, batch_size=3),
            t.compute(keep_error_T=True, batch_size=3), len(t))


@pytest.mark.parametrize("name", ["lqer-svd", "lqer-act"])
def test_model_approximator_matches_jax(name):
    jret, tret, n = computed(name)
    assert n == 14
    assert list(tret["low_rank_dict"]) == list(jret["low_rank_dict"])
    assert list(tret["error_T_dict"]) == list(jret["error_T_dict"])
    assert [r["name"] for r in tret["df"]] == [r["name"] for r in jret["df"]]
    for jr, tr in zip(jret["df"], tret["df"]):
        assert {k: tr[k] for k in ("rank", "w_dim0", "w_dim1")} == {
            k: jr[k] for k in ("rank", "w_dim0", "w_dim1")}
        np.testing.assert_allclose(tr["l1_norm(AB-Q_error_T)/n"],
                                   jr["l1_norm(AB-Q_error_T)/n"], rtol=1e-4)
    for k, v in jret["error_T_dict"].items():
        np.testing.assert_allclose(tret["error_T_dict"][k], np.asarray(v),
                                   rtol=1e-6, atol=1e-7)
    worst = 0.0
    for k in jret["low_rank_dict"]:
        if not k.endswith(".A"):
            continue
        m = k[:-2]
        ja, jb = (np.asarray(jret["low_rank_dict"][m + s], np.float64)
                  for s in (".A", ".B"))
        ta, tb = (tret["low_rank_dict"][m + s].astype(np.float64)
                  for s in (".A", ".B"))
        assert ta.shape == ja.shape and tb.shape == jb.shape
        want = ja @ jb
        err = np.linalg.norm(ta @ tb - want) / np.linalg.norm(want)
        worst = max(worst, err)
    assert worst <= PRODUCT_REL_ERR, worst


def test_approximate_weight_one_against_stacked():
    """One weight alone and the same weight inside a stack of three give
    the same A and B: the quantizers see each matrix on its own."""
    params, scales = weights()
    name = "model.layers.1.mlp.down_proj.weight"
    d = CONFIG["approximator"]["default"]
    qs = [make_quantizer(d[k]) for k in ("W_quantizer", "A_quantizer",
                                         "B_quantizer")]
    w = torch.as_tensor(np.array(params[name]))
    s = torch.as_tensor(scales[name[:-len("weight")] + "scale"])
    a1, b1, t1 = tapprox.approximate_weight(w, RANK, *qs, scale=s)
    ws = torch.stack([w * 0.5, w, w * 2.0])
    a3, b3, t3 = tapprox.approximate_weight(ws, RANK, *qs,
                                            scale=torch.stack([s, s, s]))
    assert torch.equal(t3[1], t1)
    torch.testing.assert_close(a3[1] @ b3[1], a1 @ b1, rtol=0, atol=1e-6)
    ja, jb, jt = japprox.approximate_weight(
        jnp.asarray(params[name]), RANK,
        *[jmake_quantizer(d[k]) for k in ("W_quantizer", "A_quantizer",
                                          "B_quantizer")],
        scale=jnp.asarray(np.asarray(s)))
    np.testing.assert_allclose(t1.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-7)
    want = np.asarray(ja) @ np.asarray(jb)
    err = np.linalg.norm((a1 @ b1).numpy() - want) / np.linalg.norm(want)
    assert err <= PRODUCT_REL_ERR, err


def test_lqer_act_requires_scales():
    params, _ = weights()
    t = tapprox.get_model_approximator("lqer-act")(
        {k: torch.as_tensor(np.array(v)) for k, v in params.items()}, CONFIG,
        device="cpu")
    with pytest.raises(RuntimeError):
        t.compute()
    with pytest.raises(ValueError):
        tapprox.get_model_approximator("lqer-magic")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_needs_a_card():
    """The approximators run on ``"cuda"`` unless told otherwise: without
    a card the constructor raises."""
    params, _ = weights()
    state = {k: torch.as_tensor(np.array(v)) for k, v in params.items()}
    for name in ("lqer-svd", "lqer-act"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapprox.get_model_approximator(name)(state, CONFIG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapprox.ModelApproximator(state, CONFIG, name=name)
