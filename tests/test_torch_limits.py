"""The limits of ``lqer_tpu_torch/testing.py`` that hold each CUDA kernel
against its plain version: one flipped 8-bit rounding stays inside them, an
error of the function does not."""

import numpy as np
import pytest
import torch

from lqer_tpu_torch.ops.kernels import attention as k2
from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
from lqer_tpu_torch.ops.storage import MXINT4
from lqer_tpu_torch.testing import (
    attention_limit,
    cache_agreement,
    check_close,
    code_step,
    dequant_gemm_limit,
    logits_steps,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()


def _gemm_case(seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(256, 512, generator=g) * 0.05
    a = (torch.randn(512, 32, generator=g) * 0.05).to(torch.bfloat16)
    b = (torch.randn(32, 256, generator=g) * 0.05).to(torch.bfloat16)
    prep = k1.prepare_w4_weights(w, a=a, b=b)
    x = block_fp_quantizer(torch.randn(8, 512, generator=g), width=8,
                           exponent_width=8, block_size=[1, 16],
                           skip_first_dim=True).to(torch.bfloat16)
    return x, prep


def test_code_step():
    v = torch.tensor([[0.75] + [0.1] * 15 + [3.0] * 16])
    np.testing.assert_array_equal(code_step(v, 8).numpy(),
                                  [[2.0 ** -7] * 16 + [2.0 ** -5] * 16])
    assert float(code_step(torch.tensor([1.5]), None)) == 2.0 ** -7
    assert float(code_step(torch.ones(1, 8), 8)[0, 0]) == 2.0 ** -7


@pytest.mark.parametrize("kind", ["flip", "no_correction"])
def test_dequant_gemm_limit(kind):
    x, prep = _gemm_case(1)
    kw = dict(quant_xa_width=8, quant_out_width=8)
    want = k1.qlinear_w4_plain(x, prep, MXINT4, **kw)
    lim = dequant_gemm_limit(x, prep, want, **kw)
    corr = k1.lqer_correction(x, prep["a"], prep["b"], **kw)
    if kind == "flip":   # one correction code a step off
        got = want.clone()
        got[3, 17] += code_step(corr, 8)[3, 17]
        assert check_close("flip", got, want, lim, 0.01)["flipped"] > 0
    else:
        with pytest.raises(AssertionError, match="past"):
            check_close("no correction", want - corr, want, lim, 0.01)


def test_attention_limit_catches_unquantized_p():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(4, 64, 64, generator=g) for _ in range(3))
    s = k2.prefill_scores(q, k, scale=0.125)
    want = k2.attend_plain(s, v, 8)
    lim = attention_limit(s, v, want, p_width=8)
    assert bool((lim > 2e-4).all())
    with pytest.raises(AssertionError):
        check_close("p unquantized", k2.attend_plain(s, v, None), want, lim,
                    0.05)


def test_logits_steps_and_cache_agreement():
    ref = torch.tensor([[1.0, -3.0, 0.5]])
    got = ref + torch.tensor([[2.0 ** -5, 0.0, 0.0]])   # |ref| <= 4: 2^-5
    mx, rms = logits_steps(got, ref)
    assert mx == 1.0 and abs(rms - 3 ** -0.5) < 1e-6
    codes = torch.zeros(1, 1, 1, 16, 64, dtype=torch.int8)
    exps = torch.zeros(1, 1, 1, 1, 64, dtype=torch.int8)
    a = {"k_codes": codes, "k_exps": exps, "v_codes": codes.clone(),
         "v_exps": exps.clone(), "flushed": torch.tensor([32])}
    b = {k: v.clone() for k, v in a.items()}
    b["v_codes"][0, 0, 0, 3, 5] = 1
    b["v_codes"][0, 0, 0, 3, 40] = 9      # past flushed: not compared
    frac, worst = cache_agreement(a, b, a["flushed"])
    assert worst == 1.0 and frac == 1 - 1 / (2 * 17 * 32)


def test_cache_agreement_of_direct_caches():
    """Over the first ``lengths[s]`` tokens of each slot: bf16 values in
    8-bit steps of their 16-group along d, MXINT4 codes in 4-bit steps."""
    k = torch.zeros(1, 2, 1, 8, 16, dtype=torch.bfloat16)
    k[0, 0, 0, :, 0] = 1.0                         # group exponent 0
    a = {"k": k, "v": k.clone()}
    b = {key: v.clone() for key, v in a.items()}
    b["k"][0, 0, 0, 2, 1] = 2 ** -6                # two 8-bit steps
    b["k"][0, 1, 0, 5, 3] = 1.0                    # past slot 1's length
    frac, worst = cache_agreement(a, b, [4, 5])
    assert worst == 2.0 and frac == 1 - 1 / (2 * 16 * 9)
    codes = torch.zeros(1, 1, 1, 8, 32, dtype=torch.int8)
    exps = torch.zeros(1, 1, 1, 1, 32, dtype=torch.int8)
    a = {"k_codes": codes, "k_exps": exps, "v_codes": codes.clone(),
         "v_exps": exps.clone()}
    b = {key: v.clone() for key, v in a.items()}
    b["k_codes"][0, 0, 0, 1, 2] = 0x30              # value 9 (high nibble): 3
    frac, worst = cache_agreement(a, b, [8])
    assert worst == 3.0 and frac == 1 - 1 / (2 * 9 * 8)
