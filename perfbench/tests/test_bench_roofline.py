"""The yardstick's operations and bytes against hand counts at one
layer's shapes of each configuration."""

import pytest

from perfbench import roofline, spec

MISTRAL = spec.load_config("mistral-7b-v0.1-w4a8-r128")
OPT = spec.load_config("opt-6.7b-w4a8-r32")
A8, W4 = 1 + 1 / 16, 0.5 + 1 / 16


def test_one_linear_by_hand():
    ops, nbytes = roofline.linear(64, 4096, 4096, 128)
    assert ops == 2 * 64 * 4096 * 4096 + 2 * 64 * 128 * (4096 + 4096)
    assert nbytes == pytest.approx(4096 * 4096 * W4 + 128 * 8192 * A8
                                   + 64 * 8192 * A8)


def test_mistral_layer_linears_by_hand():
    m, h, i, kv, r = 64, 4096, 14336, 1024, 128
    shapes = [(h, h), (kv, h), (kv, h), (h, h), (i, h), (i, h), (h, i)]
    ops = sum(2 * m * k * n + 2 * m * r * (k + n) for n, k in shapes)
    weights = sum(k * n * W4 + r * (k + n) * A8 for n, k in shapes)
    attn_rows = m * ((h + h) + (h + kv) * 2 + (h + h)) * A8
    mlp_rows = 2 * m * h * A8
    got = roofline.layer_linears(MISTRAL, m)
    assert got[0] == ops
    assert got[1] == pytest.approx(weights + attn_rows + mlp_rows)
    assert sorted(MISTRAL.linear_shapes().values()) == sorted(shapes)


def test_opt_layer_counts_its_biases():
    h, f, r = 4096, 16384, 32
    shapes = [(h, h)] * 4 + [(f, h), (h, f)]
    weights = sum(k * n * W4 + r * (k + n) * A8 + n * A8 for n, k in shapes)
    rows = (4 * 2 * h + 2 * h) * A8
    assert roofline.layer_linears(OPT, 1)[1] == pytest.approx(weights + rows)


def test_heads():
    ops, nbytes = roofline.head(MISTRAL, 64)
    assert ops == 2 * 64 * 4096 * 32000
    assert nbytes == pytest.approx(4096 * 32000 * A8 + 64 * 4096 * 2
                                   + 64 * 32000 * 4)
    ops, nbytes = roofline.head(OPT, 64)
    assert nbytes == (4096 * 50272 + 64 * 4096 + 64 * 50272) * 2


def test_decode_attention_reads_each_slot_within_the_window():
    lengths = [10, 5000, 4095]
    keys = roofline.attended_keys(MISTRAL, lengths)
    assert keys == 11 + 4096 + 4096
    ops, nbytes = roofline.decode_attention(MISTRAL, keys, 3)
    assert ops == 4 * 32 * 128 * keys
    assert nbytes == pytest.approx(2 * 8 * 128 * A8 * (keys + 3)
                                   + 2 * 3 * 32 * 128 * 4)
    assert roofline.attended_keys(OPT, lengths) == 11 + 5001 + 4096


def test_prefill_attention_is_causal():
    ops, _ = roofline.prefill_attention(OPT, 2, 16)
    assert ops == 4 * 32 * 128 * (16 * 17 // 2) * 2


def test_admission_counts_each_prompt_at_its_own_length():
    even = roofline.admission(OPT, [16, 16])
    assert even == roofline.prefill(OPT, 2, 16, 2)
    ragged = roofline.admission(MISTRAL, [5, 300])
    lo, lb = roofline.layer_linears(MISTRAL, 305)
    ho, hb = roofline.head(MISTRAL, 2)
    a5, a300 = (roofline.prefill_attention(MISTRAL, 1, s) for s in (5, 300))
    assert ragged["linear"] == (32 * lo + ho, 32 * lb + hb)
    assert ragged["attn"] == (32 * (a5[0] + a300[0]), 32 * (a5[1] + a300[1]))
    padded = roofline.prefill(MISTRAL, 2, 512, 2)
    assert roofline.total(ragged)[0] < roofline.total(padded)[0] / 3


def test_bound_picks_the_larger_side():
    peaks = (3.35e12, 989e12)
    assert roofline.bound_s(989e12, 1.0, peaks) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 3.35e12, peaks) == pytest.approx(1.0)
