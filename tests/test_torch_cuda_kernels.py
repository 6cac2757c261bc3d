"""The CUDA kernels of the port against their plain PyTorch versions on
the card (the megakernel in its gated and its relu variant; kernel 1 and
the megakernel also with the in-kernel activation quantizer, equal to the
launch fed the separate quantizer's values; the staged decode kernels at
code widths 8 and 4; the row write of one layer and of every layer),
at small shapes (the unpack kernel at the 7B shapes, prefill attention
also at the 2048-token admission's, the decode kernels of the direct-write
caches also at the 7B decode shape, the long-context kernels up to
L = 32768, the streaming kernels also against the one-pass ones), and the
large-M route; OPT's biased linears and query-scaled decode kernels, and
a tiny OPT served through the kernels against the CPU, a tiny Llama on
``mxint4-staged`` against the CPU and on the in-kernel activation
quantizer route against the default route; prefill attention at head
dims 64, 80 and 128 (P unquantized and wider than bf16 too) and with
whole P groups at or below 1e-8, and the fp-cache
decode kernel over its chunks (positions at chunk edges, a window
starting mid-chunk, n_rep 1 to 8, head dims 64 to 128, L = 12288; two
launches equal to the bit), and rows 6 and 10 the same way (L up to
22528, row 10's written bytes equal to the plain version's); rows 7, 8
and 9 at head dims 80 and 96, and a tiny OPT of d = 80 served through the
kernels against the CPU; kernel 1 and the megakernel over every row count
their tiles and K splits meet (1 to 511), W4 and W8, ranks 0 to 384 and
136, with and without a bias, bf16 and raw X, a weight group at the
exponent clamp, bit-repeatable at 7B widths; rows 7 and 8 split over L:
row 7 with one slot at each flushed edge (0, a chunk's tail, a whole chunk,
one group past it, the ring one short of L; wrapped rings) at both code
widths, head dims 64 to 128, n_rep 1 to 8 and with ``scale_query``, and at
n_rep 2, d 64, L = 32768 against row 9; row 8 at L = 32768 with skewed
positions, windowed and not, at d = 80 and width 4; row 9 on row 7's
kernels with blocks of 1 to 8 chunks at each flushed edge of a span; each
twice, equal to the bit; the row write at 8 and 32 kv heads and d = 80 and
128; the fused MXINT8 encode + write at 4 and 8 slots of 32 kv heads and
at 8 kv heads, L = 32768, at d 64, 80 and 96, with positions past L, from
strided views of a q|k|v output and from bf16 rows; the flush at the 7B
shape (32 layers, 8 slots, 32 kv heads, L = 2048) with spans 0, 32 and 64
and a slot off a multiple of 16; rows 5 and 11 over the ``float32``
cache (row 5 up to its one-pass length, 6144 at d = 128) and a tiny Llama
served on it with the kernel backend against the CPU, stacked and eager;
the harness adapter's loglikelihood and rolling requests through the
kernels against the CPU. Needs an
NVIDIA GPU with nvcc; skips elsewhere. Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.

Outputs are held to the limits of ``lqer_tpu_torch/testing.py``: rtol =
atol = 2e-4 for the summation order, plus one 8-bit code step of each
quantizer whose rounding that order can flip. Ring, flush, row-write,
written-column and unpacked weight bytes are bit-exact.
"""

import numpy as np
import pytest
import torch

from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.models import LlamaConfig, OPTConfig
from lqer_tpu_torch.ops.kernels import attention as k2
from lqer_tpu_torch.ops.kernels import cache_write as k4
from lqer_tpu_torch.ops.kernels import decode_attention as k3
from lqer_tpu_torch.ops.kernels import dequant_gemm as k1
from lqer_tpu_torch.ops.kernels import fp_decode as kfp
from lqer_tpu_torch.ops.kernels import mlp_fused as k5
from lqer_tpu_torch.ops.kernels import quantized_decode as kq
from lqer_tpu_torch.ops.kernels import streaming_decode as ks
from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
from lqer_tpu_torch.ops.storage import MXFormat
from lqer_tpu_torch.parallel.collectives import (
    mx4_encode,
    mx8_decode,
    mx8_encode,
)
from lqer_tpu_torch.serving import DecodeEngine
from lqer_tpu_torch.serving.kernel_backend import pack_lm_head
from lqer_tpu_torch.serving.random_model import (
    build_random_model,
    q_config_for,
)
from lqer_tpu_torch.testing import (
    attention_limit,
    check_close,
    dequant_gemm_limit,
    logits_steps,
    mlp_limit,
    one_torch_thread_fixture,
)

_one_torch_thread = one_torch_thread_fixture()

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _act(shape, gen):
    return block_fp_quantizer(torch.randn(*shape, generator=gen, device="cuda"),
                              width=8, exponent_width=8, block_size=[1, 16],
                              skip_first_dim=True).to(torch.bfloat16)


@pytest.mark.parametrize("rank", [32, 128])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_dequant_gemm(gen, m, rank):
    """Every linear kernel 1 serves: q|k|v, o, gate|up and down (packed with
    ``fuse_mlp=False``) and the W8 head; at rank 128 q|k|v's fused rank is
    384 and gate|up's 256, three and two chunks of the kernel's rank
    tile."""
    cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=1, heads=2,
                           inter=512)
    backend, params, _ = build_random_model(cfg, rank=rank, seed=1,
                                            fuse_mlp=False)
    backend = pack_lm_head(backend, params, width=8)
    assert "model.layers.0.mlp.gateup_proj" in backend["meta"]
    for key, meta in backend["meta"].items():
        prep = backend["arrays"][key]
        x = _act((m, prep["exps"].shape[0] * 16), gen)
        kw = dict(quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        got = k1.qlinear_w4_fused(x, prep, meta["fmt"], **kw)
        want = k1.qlinear_w4_plain(x, prep, meta["fmt"], **kw)
        check_close(key, got, want, dequant_gemm_limit(x, prep, want, **kw),
                    max_flipped=0.01)


@pytest.mark.parametrize("rank", [0, 32, 128])
@pytest.mark.parametrize("m", [1, 8, 200, 511])
def test_mlp_fused(gen, m, rank):
    cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=1, heads=2,
                           inter=512)
    backend, _, _ = build_random_model(cfg, rank=rank, seed=2)
    meta = backend["meta"]["model.layers.0.mlp_fused"]
    prep = backend["arrays"]["model.layers.0.mlp_fused"]
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    x = _act((m, 256), gen)
    before = k5.mlp_w4_fused.launches
    got = k5.mlp_w4_fused(x, prep, meta["fmt"], **kw)
    assert k5.mlp_w4_fused.launches == before + 1
    want = k5.mlp_w4_plain(x, prep, meta["fmt"], **kw)
    check_close("megakernel", got, want, mlp_limit(x, prep, want, **kw),
                max_flipped=0.05)


@pytest.mark.parametrize("m", [600, 2048])
def test_large_m_route(gen, m):
    """The dequantize-once route (kernel 6, then one dense product) of a
    linear and of the whole MLP against the plain versions."""
    cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=1, heads=2,
                           inter=512)
    backend, _, _ = build_random_model(cfg, rank=32, seed=3)
    x = _act((m, 256), gen)
    key = "model.layers.0.self_attn.qkv_proj"
    prep, meta = backend["arrays"][key], backend["meta"][key]
    kw = dict(quant_xa_width=meta["xa_width"], quant_out_width=meta["out_width"])
    before = k1.unpack_packed_to_bf16.launches
    got = k1.qlinear_w4_dense_largeM(x, prep, meta["fmt"], **kw)
    want = k1.qlinear_w4_plain(x, prep, meta["fmt"], **kw)
    check_close(key, got, want, dequant_gemm_limit(x, prep, want, **kw),
                max_flipped=0.01)
    key = "model.layers.0.mlp_fused"
    prep, meta = backend["arrays"][key], backend["meta"][key]
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    got = k5.mlp_w4_dense_largeM(x, prep, meta["fmt"], **kw)
    want = k5.mlp_w4_plain(x, prep, meta["fmt"], **kw)
    assert k1.unpack_packed_to_bf16.launches == before + 4
    check_close(key, got, want, mlp_limit(x, prep, want, **kw),
                max_flipped=0.05)


@pytest.mark.parametrize("width,k,n", [
    (4, 4096, 12288), (4, 4096, 4096), (4, 4096, 11264), (4, 11264, 4096),
    (8, 4096, 32768)])
def test_unpack_7b_shapes(gen, width, k, n):
    """qkv, o, gate|up (intermediate padded to 11264), down, the W8 head:
    random words (every bit pattern is a valid code) and exponents."""
    fmt = MXFormat(width)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // fmt.codes_per_word, n),
                          generator=gen, device="cuda", dtype=torch.int32)
    exps = torch.randint(-40, 12, (k // 16, n), generator=gen, device="cuda",
                         dtype=torch.int8)
    got = k1.unpack_packed_to_bf16(words, exps, fmt)
    assert torch.equal(got, k1.unpack_plain(words, exps, fmt))


@pytest.mark.parametrize("bh,s,l,causal", [
    (6, 48, 48, True),          # one partial tile of query rows and keys
    (1, 6400, 6400, True),      # a hundred key tiles
    (2, 16, 8192, False),
    (32, 2048, 2048, True)])    # the 2048-token admission: 32 heads
def test_prefill_attention(gen, bh, s, l, causal):
    q = _act((bh, s, 128), gen)
    k, v = (mx8_decode(*mx8_encode(torch.randn(bh, l, 128, generator=gen,
                                               device="cuda"), 16, 1.0),
                       16, torch.bfloat16) for _ in range(2))
    kw = dict(scale=128 ** -0.5, causal=causal)
    got = k2.quantized_attention(q, k, v, **kw)
    want = k2.quantized_attention_plain(q, k, v, **kw)
    check_close("prefill attention", got, want,
                attention_limit(k2.prefill_scores(q, k, **kw), v, want,
                                p_width=8), max_flipped=0.05)


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s,causal,p_width", [
    (1, True, 8), (16, True, 8), (64, True, 8), (2048, True, 8),
    (100, True, 8),             # not a multiple of the 64-row tile
    (100, False, 8), (100, True, None), (100, True, 10)])
def test_prefill_attention_head_dims(gen, d, s, causal, p_width):
    """Kernel 2 at head dims it is built for, P unquantized (``None``) and
    quantized wider than bf16 (10) too. The keys are S rounded up to 16:
    past S under the causal mask, and a partial tile of keys; two launches
    equal to the bit."""
    q = _act((2, s, d), gen)
    l = -(-s // 16) * 16
    k, v = (mx8_decode(*mx8_encode(torch.randn(2, l, d, generator=gen,
                                               device="cuda"), 16, 1.0),
                       16, torch.bfloat16) for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=causal)
    before = k2.quantized_attention.launches
    got = k2.quantized_attention(q, k, v, p_width=p_width, **kw)
    assert k2.quantized_attention.launches == before + 1
    want = k2.quantized_attention_plain(q, k, v, p_width=p_width, **kw)
    check_close(f"prefill attention d={d}", got, want,
                attention_limit(k2.prefill_scores(q, k, **kw), v, want,
                                p_width=p_width), max_flipped=0.05)
    assert torch.equal(got, k2.quantized_attention(q, k, v, p_width=p_width,
                                                   **kw))


def test_prefill_attention_tiny_p(gen):
    """Scores spread so wide that whole 16-key groups of p lie at or below
    1e-8 (they pass the P quantizer unquantized)."""
    bh, s, d = 2, 256, 128
    q = _act((bh, s, d), gen) * 4
    k, v = (mx8_decode(*mx8_encode(torch.randn(bh, s, d, generator=gen,
                                               device="cuda"), 16, 1.0),
                       16, torch.bfloat16) for _ in range(2))
    q = q.to(torch.bfloat16)
    kw = dict(scale=1.0, causal=True)
    p = torch.softmax(k2.prefill_scores(q, k, **kw), -1)
    groups = p.reshape(bh, s, s // 16, 16).amax(-1)
    assert bool(((groups > 0) & (groups <= 1e-8)).any())
    got = k2.quantized_attention(q, k, v, **kw)
    want = k2.quantized_attention_plain(q, k, v, **kw)
    check_close("prefill attention, tiny p", got, want,
                attention_limit(k2.prefill_scores(q, k, **kw), v, want,
                                p_width=8), max_flipped=0.05)


def test_staged_decode_attention(gen):
    B, KVH, D, L = 3, 2, 64, 256

    def block(width):
        c, e = mx8_encode(torch.randn(B, KVH, width, D, generator=gen,
                                      device="cuda"), 16, 1.0)
        return c.transpose(-1, -2).contiguous(), e.transpose(-1, -2).contiguous()

    main = [*block(L), *block(L)]
    ring = [*block(64), *block(64)]
    q = torch.randn(B, 2 * KVH, 1, D, generator=gen, device="cuda")
    kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
              for _ in range(2))
    pos = torch.tensor([70, 37, 200], dtype=torch.int32, device="cuda")
    fl = torch.tensor([64, 32, 160], dtype=torch.int32, device="cuda")
    r_k, r_p = [t.clone() for t in ring], [t.clone() for t in ring]
    got = k3.decode_attention_quantized_staged(q, *main, *r_k, kh, vh, pos,
                                               fl, scaling=0.125)
    want = k3.staged_decode_plain(q, *main, *r_p, kh, vh, pos, fl,
                                  scaling=0.125)
    assert all(torch.equal(a, b) for a, b in zip(r_k, r_p))
    s, vals = k3.staged_scores(q, *main, *r_p, pos, fl, scaling=0.125)
    check_close("staged decode attention", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


def test_flush(gen):
    shape = (2, 3, 2)
    mains = [torch.randint(-127, 128, (*shape, r, 256), generator=gen,
                           device="cuda", dtype=torch.int8)
             for r in (64, 4, 64, 4)]
    rings = [torch.randint(-127, 128, (*shape, r, 64), generator=gen,
                           device="cuda", dtype=torch.int8)
             for r in (64, 4, 64, 4)]
    fl = torch.tensor([32, 96, 0], dtype=torch.int32, device="cuda")
    nf = torch.tensor([64, 160, 0], dtype=torch.int32, device="cuda")
    plain = [m.clone() for m in mains]
    k4.flush_stage_to_main(tuple(mains), tuple(rings), fl, nf)
    k4.flush_plain(tuple(plain), tuple(rings), fl, nf)
    assert all(torch.equal(a, b) for a, b in zip(mains, plain))


# the decode kernels of the direct-write caches: (slots, kv heads, n_rep, d,
# L, positions); the last is the 7B decode shape
DECODE_SHAPES = [
    (3, 2, 2, 64, 256, [15, 16, 255]),
    (2, 4, 1, 128, 512, [0, 47]),
    (3, 1, 4, 128, 144, [31, 100, 143]),
    (8, 32, 1, 128, 2048, [64, 303, 560, 815, 1088, 1343, 1600, 1984])]


def _positions(pos):
    return torch.tensor(pos, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("widths", [8, None])
@pytest.mark.parametrize("b,kvh,nrep,d,l,pos", DECODE_SHAPES)
def test_fp_decode_attention(gen, b, kvh, nrep, d, l, pos, widths):
    """Every cache row holds a value, past each position too; ``None``
    leaves K and V unquantized."""
    k, v = (torch.randn(2, b, kvh, l, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    kw = dict(scaling=d ** -0.5, k_width=widths, v_width=widths)
    p = _positions(pos)
    before = kfp.decode_attention_fp.launches
    got = kfp.decode_attention_fp(q, k, v, p, 1, **kw)
    assert kfp.decode_attention_fp.launches == before + 1
    want = kfp.fp_decode_plain(q, k, v, p, 1, **kw)
    s, vals = kfp.fp_scores(q, k, v, p, 1, **kw)
    check_close("fp decode attention", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


# row 5 over chunks of 256 tokens: (slots, kv heads, n_rep, d, L,
# positions, window)
FP_CHUNK_SHAPES = [
    # pos 0, a chunk's last and first token, mid-group
    (5, 2, 1, 128, 768, [0, 127, 128, 200, 255], None),
    # window starts mid-chunk (at 501 and 101), chunks wholly below it
    (3, 2, 4, 128, 1024, [300, 700, 1023], 200),
    (2, 1, 8, 128, 768, [5, 767], None),
    (2, 2, 4, 80, 512, [100, 511], 64),
    (2, 2, 2, 64, 512, [31, 400], None),
    (2, 2, 4, 96, 256, [17, 255], None),
    (2, 2, 4, 128, 12288, [12000, 6000], None)]


@pytest.mark.parametrize("b,kvh,nrep,d,l,pos,window", FP_CHUNK_SHAPES)
def test_fp_decode_chunks(gen, b, kvh, nrep, d, l, pos, window):
    """Row 5 split over L against its plain version, slots at different
    lengths in one launch; two launches equal to the bit."""
    k, v = (torch.randn(2, b, kvh, l, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    kw = dict(scaling=d ** -0.5, window=window)
    p = _positions(pos)
    before = kfp.decode_attention_fp.launches
    got = kfp.decode_attention_fp(q, k, v, p, 1, **kw)
    assert kfp.decode_attention_fp.launches == before + 1
    want = kfp.fp_decode_plain(q, k, v, p, 1, **kw)
    s, vals = kfp.fp_scores(q, k, v, p, 1, **kw)
    check_close("fp decode attention over chunks", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)
    assert torch.equal(got, kfp.decode_attention_fp(q, k, v, p, 1, **kw))


def _mx_cache(gen, width, b, kvh, d, l):
    enc = mx8_encode if width == 8 else mx4_encode
    out = []
    for _ in range(2):
        c, e = enc(torch.randn(2, b, kvh, l, d, generator=gen, device="cuda"),
                   16, zero_fill=1.0)
        out += [c.transpose(-1, -2).contiguous(),
                e.transpose(-1, -2).contiguous()]
    return out


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("b,kvh,nrep,d,l,pos", DECODE_SHAPES)
def test_quantized_decode_attention(gen, b, kvh, nrep, d, l, pos, width):
    cache = _mx_cache(gen, width, b, kvh, d, l)
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    p = _positions(pos)
    got = kq.decode_attention_quantized(q, *cache, p, 1, scaling=0.125)
    want = kq.quantized_decode_plain(q, *cache, p, 1, scaling=0.125)
    s, vals = kq.quantized_scores(q, *cache, p, 1, scaling=0.125)
    check_close(f"quantized decode attention width {width}", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


@pytest.mark.parametrize("b,kvh,nrep,d,l,pos", DECODE_SHAPES)
def test_fused_write_attend(gen, b, kvh, nrep, d, l, pos):
    cache = _mx_cache(gen, 8, b, kvh, d, l)
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
              for _ in range(2))
    kh[0, 0, 0, :16] = 0.0                      # an all-zero group
    p = _positions(pos)
    mine, theirs = [a.clone() for a in cache], [a.clone() for a in cache]
    got = kq.decode_attention_quantized_write(q, *mine, kh, vh, p, 1,
                                              scaling=0.125)
    want = kq.quantized_write_plain(q, *theirs, kh, vh, p, 1, scaling=0.125)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert not all(torch.equal(a, b) for a, b in zip(mine, cache))
    s, vals = kq.quantized_scores(q, *theirs, p, 1, scaling=0.125)
    check_close("fused write + attend", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


# rows 6 and 10 over chunks of 256 tokens: (slots, kv heads, n_rep, d, L,
# positions, window)
Q_CHUNK_SHAPES = [
    # pos 0, a chunk's last and first token, mid-group
    (5, 2, 1, 128, 768, [0, 255, 256, 200, 767], None),
    # window starts mid-chunk (at 501 and 101), chunks wholly below it
    (3, 2, 4, 128, 1024, [300, 700, 1023], 200),
    (2, 1, 8, 128, 768, [5, 767], None),
    (2, 2, 4, 80, 512, [100, 511], 64),
    (2, 2, 2, 64, 512, [31, 400], None),
    (2, 2, 4, 96, 256, [17, 255], None),
    # the one-pass length at d = 128
    (2, 2, 1, 128, 22528, [22527, 11000], None)]


@pytest.mark.parametrize("kind,b,kvh,nrep,d,l,pos,window", [
    (kind, *shape) for kind in ("width 8", "width 4", "write")
    for shape in Q_CHUNK_SHAPES
    if kind != "width 4" or shape[3] % 32 == 0])   # MXINT4: d % 32 == 0
def test_quantized_decode_chunks(gen, kind, b, kvh, nrep, d, l, pos,
                                 window):
    """Rows 6 (widths 8 and 4) and 10 split over L against their plain
    versions, slots at different lengths in one launch: one launch count a
    call, two calls equal to the bit, row 10's written cache bytes equal to
    the plain version's."""
    cache = _mx_cache(gen, 4 if kind == "width 4" else 8, b, kvh, d, l)
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    p = _positions(pos)
    kw = dict(scaling=d ** -0.5, window=window)
    if kind == "write":
        kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
                  for _ in range(2))
        kh[0, 0, 0, :16] = 0.0                  # an all-zero group
        mine, again, theirs = ([a.clone() for a in cache] for _ in range(3))
        wrapper = kq.decode_attention_quantized_write
        before = wrapper.launches
        got = wrapper(q, *mine, kh, vh, p, 1, **kw)
        assert wrapper.launches == before + 1
        want = kq.quantized_write_plain(q, *theirs, kh, vh, p, 1, **kw)
        assert all(torch.equal(a, c) for a, c in zip(mine, theirs))
        assert torch.equal(got, wrapper(q, *again, kh, vh, p, 1, **kw))
        assert wrapper.launches == before + 2
        cache = theirs
    else:
        wrapper = kq.decode_attention_quantized
        before = wrapper.launches
        got = wrapper(q, *cache, p, 1, **kw)
        assert wrapper.launches == before + 1
        want = kq.quantized_decode_plain(q, *cache, p, 1, **kw)
        assert torch.equal(got, wrapper(q, *cache, p, 1, **kw))
        assert wrapper.launches == before + 2
    s, vals = kq.quantized_scores(q, *cache, p, 1, **kw)
    check_close(f"quantized decode over chunks, {kind}", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


# rows 7, 8 and 9 at the head dims past 64 and 128: (code width, slots, kv
# heads, n_rep, d, L, positions)
HEAD_DIM_SHAPES = [
    (8, 2, 2, 4, 80, 512, [100, 511]),
    (8, 2, 2, 2, 96, 1024, [64, 1000]),
    (4, 2, 2, 2, 96, 1024, [64, 1000])]


@pytest.mark.parametrize("row", [7, 8, 9])
@pytest.mark.parametrize("width,b,kvh,nrep,d,l,pos", HEAD_DIM_SHAPES)
def test_decode_rows_head_dims(gen, row, width, b, kvh, nrep, d, l, pos):
    """The staged (7), streaming (8) and streaming staged (9) decode rows
    at d = 80 and 96 against their plain versions; rings bit-exact."""
    main = [a[1] for a in _mx_cache(gen, width, b, kvh, d, l)]
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    p = _positions(pos)
    kw = dict(scaling=d ** -0.5)
    if row == 8:
        cache = [a[None] for a in main]
        got = ks.decode_attention_quantized_streaming(q, *cache, p, 0, **kw)
        want = kq.quantized_decode_plain(q, *cache, p, 0, **kw)
        s, vals = kq.quantized_scores(q, *cache, p, 0, **kw)
    else:
        ring = [a[1].contiguous()
                for a in _mx_cache(gen, width, b, kvh, d, 64)]
        kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
                  for _ in range(2))
        fl = (p // 32) * 32
        mine, theirs = [t.clone() for t in ring], [t.clone() for t in ring]
        fn = (k3.decode_attention_quantized_staged if row == 7
              else ks.decode_attention_quantized_streaming_staged)
        got = fn(q, *main, *mine, kh, vh, p, fl, **kw)
        want = k3.staged_decode_plain(q, *main, *theirs, kh, vh, p, fl, **kw)
        assert all(torch.equal(a, c) for a, c in zip(mine, theirs))
        s, vals = k3.staged_scores(q, *main, *theirs, p, fl, **kw)
        s = s[:, :, None, :]
    check_close(f"row {row} at d = {d}, width {width}", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("pos", [[0, 17, 255], [255, 256, 3]])
def test_row_write(gen, lane, pos):
    """Both orientations, one launch for all arrays; a position past the
    cache (256) writes nothing."""
    b, kvh, d, l = 3, 2, 64, 256
    if lane:
        arrays = _mx_cache(gen, 4, b, kvh, d, l)
        news = []
        for _ in range(2):
            news += [t.transpose(-1, -2).contiguous() for t in mx4_encode(
                torch.randn(b, kvh, 1, d, generator=gen, device="cuda"), 16,
                zero_fill=1.0)]
    else:
        arrays = [torch.randn(2, b, kvh, l, d, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
        news = [torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
                for _ in range(2)]
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    p = _positions(pos)
    k4.write_kv_rows_stacked(tuple(mine), tuple(news), 1, p)
    k4.write_rows_plain(tuple(theirs), tuple(news), 1, p)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(mine, arrays))


@pytest.mark.parametrize("kvh", [8, 32])
@pytest.mark.parametrize("kind,d", [("bf16 rows", 80), ("bf16 rows", 128),
                                    ("mxint8 columns", 80),
                                    ("mxint4 columns", 128)])
def test_row_write_shapes(gen, kind, d, kvh):
    """Row 11 at the served kv head counts and head dims, bit-exact with
    its plain version; positions -1 and L write nothing."""
    nl, l = 2, 256
    pos = [-1, 0, 17, 255, 256]
    b = len(pos)
    if kind == "bf16 rows":
        arrays = [torch.randn(nl, b, kvh, l, d, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
        news = [torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
                for _ in range(2)]
    else:
        rows = [d if kind == "mxint8 columns" else d // 2, d // 16] * 2
        arrays = [torch.randint(-127, 128, (nl, b, kvh, r, l), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for r in rows]
        news = [torch.randint(-127, 128, (b, kvh, r, 1), generator=gen,
                              device="cuda", dtype=torch.int8) for r in rows]
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    p = _positions(pos)
    before = k4.write_kv_rows_stacked.launches
    k4.write_kv_rows_stacked(tuple(mine), tuple(news), 1, p)
    assert k4.write_kv_rows_stacked.launches == before + 1
    k4.write_rows_plain(tuple(theirs), tuple(news), 1, p)
    assert all(torch.equal(a, c) for a, c in zip(mine, theirs))
    assert all(torch.equal(a[0], c[0]) for a, c in zip(mine, arrays))
    for a, c in zip(mine, arrays):   # slots 0 and 4 (-1 and L) untouched
        assert torch.equal(a[:, 0], c[:, 0]) and torch.equal(a[:, 4], c[:, 4])


# the long-context kernels: (slots, kv heads, n_rep, d, L, positions), the
# last at the 7B decode shape past the one-pass length
STREAM_SHAPES = [
    (3, 2, 2, 64, 1024, [511, 512, 1023]),   # a chunk's last and first token
    (2, 1, 8, 128, 4096, [0, 4000]),
    (4, 32, 1, 128, 32768, [64, 511, 512, 32767])]


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("b,kvh,nrep,d,l,pos", STREAM_SHAPES)
def test_streaming_decode_attention(gen, b, kvh, nrep, d, l, pos, width):
    cache = _mx_cache(gen, width, b, kvh, d, l)
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    p = _positions(pos)
    before = ks.decode_attention_quantized_streaming.launches
    got = ks.decode_attention_quantized_streaming(q, *cache, p, 1,
                                                  scaling=0.125)
    assert ks.decode_attention_quantized_streaming.launches == before + 1
    want = kq.quantized_decode_plain(q, *cache, p, 1, scaling=0.125)
    s, vals = kq.quantized_scores(q, *cache, p, 1, scaling=0.125)
    check_close(f"streaming decode attention width {width}", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


def _staged_inputs(gen, b, kvh, nrep, d, l, pos):
    """A layer's main cache and rings, flushed = floor32(pos)."""
    main = _mx_cache(gen, 8, b, kvh, d, l)
    main = [a[1] for a in main]
    ring = [a[1].contiguous() for a in _mx_cache(gen, 8, b, kvh, d, 64)]
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
              for _ in range(2))
    p = _positions(pos)
    return main, ring, q, kh, vh, p, (p // 32) * 32


@pytest.mark.parametrize("b,kvh,nrep,d,l,pos", STREAM_SHAPES)
def test_streaming_staged_decode_attention(gen, b, kvh, nrep, d, l, pos):
    main, ring, q, kh, vh, p, fl = _staged_inputs(gen, b, kvh, nrep, d, l,
                                                  pos)
    mine, theirs = [t.clone() for t in ring], [t.clone() for t in ring]
    got = ks.decode_attention_quantized_streaming_staged(
        q, *main, *mine, kh, vh, p, fl, scaling=0.125)
    want = k3.staged_decode_plain(q, *main, *theirs, kh, vh, p, fl,
                                  scaling=0.125)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    s, vals = k3.staged_scores(q, *main, *theirs, p, fl, scaling=0.125)
    check_close("streaming staged decode attention", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


def test_streaming_against_one_pass(gen):
    """At L = 24576, where n_rep = 1 fits both: row 8 against row 6 and
    row 9 against row 7, the kernels on the same inputs."""
    b, kvh, d, l, pos = 4, 32, 128, 24576, [64, 511, 512, 24575]
    cache = _mx_cache(gen, 8, b, kvh, d, l)
    q = torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
    p = _positions(pos)
    got = ks.decode_attention_quantized_streaming(q, *cache, p, 1,
                                                  scaling=0.125)
    want = kq.decode_attention_quantized(q, *cache, p, 1, scaling=0.125)
    s, vals = kq.quantized_scores(q, *cache, p, 1, scaling=0.125)
    check_close("streaming vs one-pass", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)
    main, ring, q, kh, vh, p, fl = _staged_inputs(gen, b, kvh, 1, d, l, pos)
    mine, theirs = [t.clone() for t in ring], [t.clone() for t in ring]
    got = ks.decode_attention_quantized_streaming_staged(
        q, *main, *mine, kh, vh, p, fl, scaling=0.125)
    want = k3.decode_attention_quantized_staged(q, *main, *theirs, kh, vh, p,
                                                fl, scaling=0.125)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    s, vals = k3.staged_scores(q, *main, *theirs, p, fl, scaling=0.125)
    check_close("streaming staged vs one-pass staged", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


@pytest.mark.parametrize("b,kvh,d,l,pos", [
    (3, 2, 64, 256, [0, 255, 256]),          # 256 lies past the cache
    (8, 32, 128, 32768, [64, 511, 512, 4000, 16383, 16384, 30000, 32767]),
    # the long-context step's 4 slots, one past the cache
    (4, 32, 128, 32768, [32000, 32767, 32768, 0]),
    # Mistral's 8 kv heads; the head dims 64, 80 and 96
    (8, 8, 128, 32768, [32000, 32001, 32003, 32007, 32010, 32013, 32768,
                        40000]),
    (5, 8, 64, 2048, [0, 2047, 2048, 1000, 3000]),
    (5, 32, 80, 2048, [0, 2047, 2048, 1000, 3000]),
    (3, 4, 96, 1024, [1023, 1024, 17])])
def test_encode_write_tokens(gen, b, kvh, d, l, pos):
    arrays = _mx_cache(gen, 8, b, kvh, d, l)
    kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
              for _ in range(2))
    kh[0, 0, 0, :16] = 0.0                      # an all-zero group
    p = _positions(pos)
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    k4.write_kv_tokens_fused(tuple(mine), kh, vh, 1, p)
    k4.encode_write_plain(tuple(theirs), kh, vh, 1, p)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(mine, arrays))
    assert not all(torch.equal(a, b) for a, b in zip(mine, arrays))


def test_encode_write_tokens_strided_rows(gen):
    """Rows read in place from views of a fused q|k|v output (row 13 takes
    each row's slot and head strides), and bf16 rows widened to f32."""
    b, kvh, d, l = 4, 8, 128, 4096
    arrays = _mx_cache(gen, 8, b, kvh, d, l)
    qkv = torch.randn(b, 1, 3 * kvh * d, generator=gen, device="cuda")
    kh, vh = (qkv[..., i * kvh * d:(i + 1) * kvh * d]
              .reshape(b, 1, kvh, d).transpose(1, 2) for i in (1, 2))
    assert kh.stride(-1) == 1 and not kh.is_contiguous()
    p = _positions([5, 4095, 4096, 2000])
    for rows in ((kh, vh), (kh.to(torch.bfloat16), vh.to(torch.bfloat16))):
        mine, theirs = ([a.clone() for a in arrays],
                        [a.clone() for a in arrays])
        k4.write_kv_tokens_fused(tuple(mine), *rows, 1, p)
        k4.encode_write_plain(tuple(theirs), *rows, 1, p)
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
        assert not all(torch.equal(a, b) for a, b in zip(mine, arrays))


def test_flush_7b_shape(gen):
    """Row 14 at the 7B flush shape (32 layers, 8 slots, 32 kv heads,
    L = 2048): spans 0, 32 and 64 (across the ring's wrap, across a
    128-lane window, up to L) and one slot not on a multiple of 16."""
    NL, B, KVH, D, L, SW = 32, 8, 32, 128, 2048, 64
    rows = (D, D // 16, D, D // 16)
    mains = [torch.randint(-127, 128, (NL, B, KVH, r, L), generator=gen,
                           device="cuda", dtype=torch.int8) for r in rows]
    rings = [torch.randint(-127, 128, (NL, B, KVH, r, SW), generator=gen,
                           device="cuda", dtype=torch.int8) for r in rows]
    fl = _positions([0, 32, 96, 1984, 1024, 500, 2016, 64])
    nf = _positions([32, 96, 160, 2048, 1024, 530, 2048, 128])
    plain = [m.clone() for m in mains]
    k4.flush_stage_to_main(tuple(mains), tuple(rings), fl, nf)
    k4.flush_plain(tuple(plain), tuple(rings), fl, nf)
    assert all(torch.equal(a, b) for a, b in zip(mains, plain))
    del plain
    torch.cuda.empty_cache()


# ---- OPT's modes: the relu megakernel with biases, kernel 1 with a bias,
# the decode kernels with the query scaled before its quantizer, and a tiny
# OPT served through the kernels
def _opt_backend(rank=32, layers=1, seed=4):
    cfg = OPTConfig.tiny(vocab_size=200, hidden=256, layers=layers, heads=2,
                         ffn=512)
    return cfg, *build_random_model(cfg, rank=rank, seed=seed)


@pytest.mark.parametrize("rank", [0, 32])
@pytest.mark.parametrize("m", [1, 8, 200, 511])
def test_mlp_fused_relu(gen, m, rank):
    _, backend, _, _ = _opt_backend(rank=rank)
    key = "model.decoder.layers.0.mlp_fused"
    meta, prep = backend["meta"][key], backend["arrays"][key]
    assert prep["codes_u"] is None and prep["bias_d"] is not None
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    x = _act((m, 256), gen)
    before = (k5.mlp_w4_fused.launches, k5.mlp_w4_fused_relu.launches)
    got = k5.mlp_w4_fused(x, prep, meta["fmt"], **kw)
    assert (k5.mlp_w4_fused.launches,
            k5.mlp_w4_fused_relu.launches) == (before[0], before[1] + 1)
    want = k5.mlp_w4_plain(x, prep, meta["fmt"], **kw)
    check_close("relu megakernel", got, want, mlp_limit(x, prep, want, **kw),
                max_flipped=0.05)


@pytest.mark.parametrize("m", [1, 8, 40])
def test_dequant_gemm_with_bias(gen, m):
    """OPT's q|k|v (fused, with its biases) and out_proj."""
    _, backend, _, _ = _opt_backend()
    for key in ("model.decoder.layers.0.self_attn.qkv_proj",
                "model.decoder.layers.0.self_attn.out_proj"):
        prep, meta = backend["arrays"][key], backend["meta"][key]
        assert prep["bias"] is not None
        x = _act((m, 256), gen)
        kw = dict(quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        got = k1.qlinear_w4_fused(x, prep, meta["fmt"], **kw)
        want = k1.qlinear_w4_plain(x, prep, meta["fmt"], **kw)
        check_close(key, got, want, dequant_gemm_limit(x, prep, want, **kw),
                    max_flipped=0.01)


@pytest.mark.parametrize("kind", ["fp", "quantized8", "quantized4", "write",
                                  "staged", "streaming", "streaming_staged"])
def test_decode_scale_query(gen, kind):
    """Every decode kernel with ``scale_query=True`` at d = 128 (a scaling
    of 0.0884, no power of two), n_rep = 1 as OPT's, against its plain
    version."""
    b, kvh, d, l = 3, 4, 128, 1024
    pos = _positions([31, 600, 1023])
    q = torch.randn(b, kvh, 1, d, generator=gen, device="cuda") * 3
    kw = dict(scaling=d ** -0.5, scale_query=True)
    kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
              for _ in range(2))
    if kind == "fp":
        k, v = (torch.randn(2, b, kvh, l, d, generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        got = kfp.decode_attention_fp(q, k, v, pos, 1, **kw)
        want = kfp.fp_decode_plain(q, k, v, pos, 1, **kw)
        s, vals = kfp.fp_scores(q, k, v, pos, 1, **kw)
    elif kind in ("staged", "streaming_staged"):
        main = [a[1] for a in _mx_cache(gen, 8, b, kvh, d, l)]
        ring = [a[1].contiguous() for a in _mx_cache(gen, 8, b, kvh, d, 64)]
        fl = (pos // 32) * 32
        mine, theirs = [t.clone() for t in ring], [t.clone() for t in ring]
        fn = (k3.decode_attention_quantized_staged if kind == "staged"
              else ks.decode_attention_quantized_streaming_staged)
        got = fn(q, *main, *mine, kh, vh, pos, fl, **kw)
        want = k3.staged_decode_plain(q, *main, *theirs, kh, vh, pos, fl,
                                      **kw)
        assert all(torch.equal(a, c) for a, c in zip(mine, theirs))
        s, vals = k3.staged_scores(q, *main, *theirs, pos, fl, **kw)
        s = s[:, :, None, :]
    else:
        cache = _mx_cache(gen, 4 if kind == "quantized4" else 8, b, kvh, d,
                          l)
        if kind == "write":
            mine, theirs = [a.clone() for a in cache], [a.clone()
                                                        for a in cache]
            got = kq.decode_attention_quantized_write(q, *mine, kh, vh, pos,
                                                      1, **kw)
            want = kq.quantized_write_plain(q, *theirs, kh, vh, pos, 1, **kw)
            assert all(torch.equal(a, c) for a, c in zip(mine, theirs))
            cache = theirs
        else:
            fn = (ks.decode_attention_quantized_streaming
                  if kind == "streaming" else kq.decode_attention_quantized)
            got = fn(q, *cache, pos, 1, **kw)
            want = kq.quantized_decode_plain(q, *cache, pos, 1, **kw)
        s, vals = kq.quantized_scores(q, *cache, pos, 1, **kw)
    check_close(f"{kind} decode attention, scale_query", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "mxint8",
                                         "mxint8-staged", "mxint4"])
def test_opt_engine_on_card(gen, cache_dtype):
    """A 2-layer tiny OPT served through the kernels against the same engine
    through the plain versions on the CPU, teacher-forced with the card's
    greedy tokens: an admission of 63-token prompts and 20 decode steps,
    logits within 4 code steps at most and 0.4 RMS (chip_smoke.py's
    limits); the relu megakernel launched once per layer at the admission
    (256 rows, below the large-M route's 512) and at each step."""
    cfg, backend, params, qcfgs = _opt_backend(layers=2)
    if cache_dtype == "mxint4":
        qcfgs = tmodels.quantize_model(cfg, q_config_for(cfg, kv4=True),
                                       {"linear": {"rank": 32}})
    kw = dict(num_slots=4, max_len=128, cache_dtype=cache_dtype,
              pallas_backend=backend, lm_head_width=8)
    card = DecodeEngine(params, cfg, qcfgs,
                        scan_layers=True, device="cuda", **kw)
    cpu = DecodeEngine(params, cfg, qcfgs,
                       scan_layers=True, device="cpu", **kw)
    ids = torch.randint(0, 200, (4, 64), generator=gen,
                        device="cuda").cpu().numpy()
    lengths = torch.full((4,), 63, dtype=torch.int32).numpy()
    before = k5.mlp_w4_fused_relu.launches
    logits = [(card.prefill(ids, np.arange(4), lengths),
               cpu.prefill(ids, np.arange(4), lengths))]
    card.lengths[:] = cpu.lengths[:] = lengths
    for _ in range(20):
        tokens = torch.argmax(logits[-1][0], -1).cpu().numpy()
        logits.append((card.decode_logits(tokens), cpu.decode_logits(tokens)))
        card.lengths += 1
        cpu.lengths += 1
    assert k5.mlp_w4_fused_relu.launches == before + 21 * 2
    for got, want in logits:
        worst, rms = logits_steps(got.float().cpu(), want.float())
        assert worst <= 4.0 and rms <= 0.4, (worst, rms)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "mxint8",
                                         "mxint8-staged"])
def test_opt_head_dim_80_engine_on_card(gen, cache_dtype):
    """A 2-layer tiny OPT with 8 heads of d = 80 (facebook/opt-2.7b's head
    dim) served through the kernels against the same engine through the
    plain versions on the CPU, teacher-forced with the card's greedy
    tokens: an admission of 63-token prompts and 20 decode steps, logits
    within chip_smoke.py's limits, each step through the decode route's
    kernels."""
    cfg = OPTConfig.tiny(vocab_size=200, hidden=640, layers=2, heads=8,
                         ffn=512)
    assert cfg.head_dim == 80
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=7,
                                                device="cpu")
    kw = dict(num_slots=4, max_len=128, cache_dtype=cache_dtype,
              pallas_backend=backend, lm_head_width=8)
    card = DecodeEngine(params, cfg, qcfgs,
                        scan_layers=True, device="cuda", **kw)
    cpu = DecodeEngine(params, cfg, qcfgs,
                       scan_layers=True, device="cpu", **kw)
    route = {"bfloat16": kfp.decode_attention_fp,
             "mxint8": kq.decode_attention_quantized_write,
             "mxint8-staged": k3.decode_attention_quantized_staged}[
                 cache_dtype]
    ids = torch.randint(0, 200, (4, 64), generator=gen,
                        device="cuda").cpu().numpy()
    lengths = np.full(4, 63, dtype=np.int32)
    logits = [(card.prefill(ids, np.arange(4), lengths),
               cpu.prefill(ids, np.arange(4), lengths))]
    card.lengths[:] = cpu.lengths[:] = lengths
    before = route.launches
    for _ in range(20):
        tokens = torch.argmax(logits[-1][0], -1).cpu().numpy()
        logits.append((card.decode_logits(tokens), cpu.decode_logits(tokens)))
        card.lengths += 1
        cpu.lengths += 1
    assert route.launches == before + 20 * 2
    for got, want in logits:
        worst, rms = logits_steps(got.float().cpu(), want.float())
        assert worst <= 4.0 and rms <= 0.4, (worst, rms)


# the sliding window (Mistral): (slots, kv heads, n_rep, d, L, positions,
# window); windows not a multiple of 16, positions below, at and past the
# window, and the Mistral-7B shape (8 kv heads of 4 queries, window 4096)
WINDOW_SHAPES = [
    (3, 2, 4, 128, 256, [15, 39, 255], 40),
    (3, 2, 2, 64, 512, [40, 41, 500], 40),
    (2, 8, 4, 128, 8192, [4095, 6003], 4096)]


@pytest.mark.parametrize("b,kvh,nrep,d,l,pos,window", WINDOW_SHAPES)
def test_windowed_decode_attention(gen, b, kvh, nrep, d, l, pos, window):
    """Rows 5, 6 (widths 8 and 4) and 10 with a window against their plain
    versions."""
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    p = _positions(pos)
    kw = dict(scaling=d ** -0.5, window=window)
    k, v = (torch.randn(2, b, kvh, l, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    got = kfp.decode_attention_fp(q, k, v, p, 1, **kw)
    want = kfp.fp_decode_plain(q, k, v, p, 1, **kw)
    s, vals = kfp.fp_scores(q, k, v, p, 1, **kw)
    check_close("windowed fp decode attention", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)
    unwindowed = kfp.fp_decode_plain(q, k, v, p, 1, scaling=d ** -0.5)
    assert not torch.allclose(want, unwindowed)   # the window cuts keys
    for width in (8, 4):
        cache = _mx_cache(gen, width, b, kvh, d, l)
        got = kq.decode_attention_quantized(q, *cache, p, 1, **kw)
        want = kq.quantized_decode_plain(q, *cache, p, 1, **kw)
        s, vals = kq.quantized_scores(q, *cache, p, 1, **kw)
        check_close(f"windowed quantized decode width {width}", got, want,
                    attention_limit(s, vals, want, p_width=8),
                    max_flipped=0.05)
    kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
              for _ in range(2))
    cache = _mx_cache(gen, 8, b, kvh, d, l)
    mine, theirs = [a.clone() for a in cache], [a.clone() for a in cache]
    got = kq.decode_attention_quantized_write(q, *mine, kh, vh, p, 1, **kw)
    want = kq.quantized_write_plain(q, *theirs, kh, vh, p, 1, **kw)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    s, vals = kq.quantized_scores(q, *theirs, p, 1, **kw)
    check_close("windowed fused write + attend", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("b,kvh,nrep,d,l,pos,window", [
    (3, 2, 4, 64, 2048, [40, 1500, 2047], 600),    # chunks below the window
    (3, 1, 2, 128, 1024, [511, 512, 1000], 40),
    (2, 8, 4, 128, 32768, [32000, 20001], 4096)])
def test_windowed_streaming_decode_attention(gen, b, kvh, nrep, d, l, pos,
                                             window, width):
    """Row 8 with a window: whole chunks below it are skipped in every
    pass."""
    cache = _mx_cache(gen, width, b, kvh, d, l)
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    p = _positions(pos)
    kw = dict(scaling=d ** -0.5, window=window)
    got = ks.decode_attention_quantized_streaming(q, *cache, p, 1, **kw)
    want = kq.quantized_decode_plain(q, *cache, p, 1, **kw)
    s, vals = kq.quantized_scores(q, *cache, p, 1, **kw)
    check_close(f"windowed streaming decode width {width}", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "mxint8", "mxint4"])
def test_mistral_engine_on_card(gen, cache_dtype):
    """A 2-layer tiny windowed GQA model (window 40, 4 queries per kv head,
    rank 128) served through the kernels against the same engine through
    the plain versions on the CPU, teacher-forced with the card's greedy
    tokens: an eager admission of 63-token prompts, then 30 decode steps
    past the window, logits within chip_smoke.py's limits."""
    cfg = LlamaConfig.tiny(vocab_size=256, hidden=512, layers=2, heads=4,
                           kv_heads=1, inter=512, max_pos=128,
                           sliding_window=40, arch="mistral")
    backend, params, qcfgs = build_random_model(cfg, rank=128, seed=6,
                                                device="cpu")
    if cache_dtype == "mxint4":
        qcfgs = tmodels.quantize_model(cfg, q_config_for(cfg, kv4=True),
                                       {"linear": {"rank": 128}})
    params["model.embed_tokens.weight"] *= 40
    kw = dict(num_slots=4, max_len=128, cache_dtype=cache_dtype,
              pallas_backend=backend, lm_head_width=8)
    card = DecodeEngine(params, cfg, qcfgs,
                        scan_layers=True, device="cuda", **kw)
    cpu = DecodeEngine(params, cfg, qcfgs,
                       scan_layers=True, device="cpu", **kw)
    ids = torch.randint(0, 256, (4, 64), generator=gen,
                        device="cuda").cpu().numpy()
    lengths = np.full(4, 63, dtype=np.int32)
    logits = [(card.prefill(ids, np.arange(4), lengths),
               cpu.prefill(ids, np.arange(4), lengths))]
    card.lengths[:] = cpu.lengths[:] = lengths
    for _ in range(30):
        tokens = torch.argmax(logits[-1][0], -1).cpu().numpy()
        logits.append((card.decode_logits(tokens), cpu.decode_logits(tokens)))
        card.lengths += 1
        cpu.lengths += 1
    for got, want in logits:
        worst, rms = logits_steps(got.float().cpu(), want.float())
        assert worst <= 4.0 and rms <= 0.4, (worst, rms)


def test_staged_decode_attention_width4(gen):
    """Row 7 over the staged MXINT4 cache (``mxint4-staged``): the fresh
    rows MXINT4-encoded and nibble-packed into the ring in the launch."""
    b, kvh, nrep, d, l = 3, 2, 2, 64, 256
    main = [a[1] for a in _mx_cache(gen, 4, b, kvh, d, l)]
    ring = [a[1].contiguous() for a in _mx_cache(gen, 4, b, kvh, d, 64)]
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
              for _ in range(2))
    kh[0, 0, 0, :16] = 0.0                      # an all-zero group
    pos = _positions([70, 37, 200])
    fl = _positions([64, 32, 160])
    mine, theirs = [t.clone() for t in ring], [t.clone() for t in ring]
    before = k3.decode_attention_quantized_staged.launches
    got = k3.decode_attention_quantized_staged(q, *main, *mine, kh, vh, pos,
                                               fl, scaling=0.125)
    assert k3.decode_attention_quantized_staged.launches == before + 1
    want = k3.staged_decode_plain(q, *main, *theirs, kh, vh, pos, fl,
                                  scaling=0.125)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    s, vals = k3.staged_scores(q, *main, *theirs, pos, fl, scaling=0.125)
    check_close("staged decode attention width 4", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


@pytest.mark.parametrize("b,kvh,nrep,d,l,pos", STREAM_SHAPES)
def test_streaming_staged_decode_attention_width4(gen, b, kvh, nrep, d, l,
                                                  pos):
    main = [a[1] for a in _mx_cache(gen, 4, b, kvh, d, l)]
    ring = [a[1].contiguous() for a in _mx_cache(gen, 4, b, kvh, d, 64)]
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
              for _ in range(2))
    p = _positions(pos)
    fl = (p // 32) * 32
    mine, theirs = [t.clone() for t in ring], [t.clone() for t in ring]
    got = ks.decode_attention_quantized_streaming_staged(
        q, *main, *mine, kh, vh, p, fl, scaling=0.125)
    want = k3.staged_decode_plain(q, *main, *theirs, kh, vh, p, fl,
                                  scaling=0.125)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    s, vals = k3.staged_scores(q, *main, *theirs, p, fl, scaling=0.125)
    check_close("streaming staged decode attention width 4", got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)


@pytest.mark.parametrize("kind", ["mxint8 columns", "mxint4 columns",
                                  "bf16 rows"])
def test_row_write_all_layers(gen, kind):
    """Row 12: every layer's row in one launch, bit-exact with its plain
    version and with row 11 launched once per layer; a position past the
    cache (256) writes nothing."""
    nl, b, kvh, d, l = 3, 4, 2, 64, 256
    if kind == "bf16 rows":
        arrays = [torch.randn(nl, b, kvh, l, d, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
        news = [torch.randn(nl, b, kvh, 1, d, generator=gen, device="cuda")
                for _ in range(2)]
    else:
        rows = [d if kind == "mxint8 columns" else d // 2, d // 16] * 2
        arrays = [torch.randint(-127, 128, (nl, b, kvh, r, l), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for r in rows]
        news = [torch.randint(-127, 128, (nl, b, kvh, r, 1), generator=gen,
                              device="cuda", dtype=torch.int8) for r in rows]
    p = _positions([0, 17, 255, 256])
    mine, plain, per = ([a.clone() for a in arrays] for _ in range(3))
    before = k4.write_kv_rows_all_layers.launches
    k4.write_kv_rows_all_layers(tuple(mine), tuple(news), p)
    assert k4.write_kv_rows_all_layers.launches == before + 1
    k4.write_rows_all_layers_plain(tuple(plain), tuple(news), p)
    for li in range(nl):
        k4.write_kv_rows_stacked(tuple(per), tuple(n[li] for n in news), li,
                                 p)
    assert all(torch.equal(a, b) for a, b in zip(mine, plain))
    assert all(torch.equal(a, b) for a, b in zip(mine, per))
    assert not all(torch.equal(a, b) for a, b in zip(mine, arrays))


@pytest.mark.parametrize("rank", [0, 32, 128])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_dequant_gemm_xq(gen, m, rank):
    """Kernel 1 with the in-kernel activation quantizer on raw f32 X: within
    the limits of its plain version, and equal to the kernel fed the
    separate quantizer's values (one quantized X for the GEMM and the rank
    epilogue); rank 128 makes q|k|v's fused rank 384, three rank chunks."""
    cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=1, heads=2,
                           inter=512)
    backend, _, _ = build_random_model(cfg, rank=rank, seed=7)
    for key in ("model.layers.0.self_attn.qkv_proj",
                "model.layers.0.self_attn.o_proj"):
        prep, meta = backend["arrays"][key], backend["meta"][key]
        kw = dict(quant_xa_width=meta["xa_width"],
                  quant_out_width=meta["out_width"])
        x = torch.randn(m, 256, generator=gen, device="cuda") * 3
        x[0, 16:32] = 0.0
        before = k1.qlinear_w4_fused.launches
        got = k1.qlinear_w4_fused(x, prep, meta["fmt"], quant_x_width=8, **kw)
        assert k1.qlinear_w4_fused.launches == before + 1
        xq = k1.quantize_x_plain(x, 8)
        ext = k1.qlinear_w4_fused(xq.to(torch.bfloat16), prep, meta["fmt"],
                                  **kw)
        assert torch.equal(got, ext), key
        want = k1.qlinear_w4_plain(x, prep, meta["fmt"], quant_x_width=8,
                                   **kw)
        check_close(key, got, want, dequant_gemm_limit(xq, prep, want, **kw),
                    max_flipped=0.01)


@pytest.mark.parametrize("arch,rank", [("llama", 0), ("llama", 32),
                                       ("llama", 128), ("opt", 32)])
@pytest.mark.parametrize("m", [1, 8, 200])
def test_mlp_fused_xq(gen, m, arch, rank):
    """The megakernel, gated and relu, with the in-kernel activation
    quantizer on raw f32 X: within the limits of its plain version and
    equal to the launch fed the separate quantizer's values."""
    if arch == "opt":
        _, backend, _, _ = _opt_backend(rank=rank)
        key = "model.decoder.layers.0.mlp_fused"
    else:
        cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=1, heads=2,
                               inter=512)
        backend, _, _ = build_random_model(cfg, rank=rank, seed=8)
        key = "model.layers.0.mlp_fused"
    meta, prep = backend["meta"][key], backend["arrays"][key]
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    x = torch.randn(m, 256, generator=gen, device="cuda") * 3
    counter = k5.mlp_w4_fused_relu if arch == "opt" else k5.mlp_w4_fused
    before = counter.launches
    got = k5.mlp_w4_fused(x, prep, meta["fmt"], quant_x_width=8, **kw)
    assert counter.launches == before + 1
    xq = k1.quantize_x_plain(x, 8)
    ext = k5.mlp_w4_fused(xq.to(torch.bfloat16), prep, meta["fmt"], **kw)
    assert torch.equal(got, ext)
    want = k5.mlp_w4_plain(x, prep, meta["fmt"], quant_x_width=8, **kw)
    check_close(f"{arch} megakernel with quant_x_width", got, want,
                mlp_limit(xq, prep, want, **kw), max_flipped=0.05)


@pytest.mark.parametrize("route", ["mxint4-staged", "in-kernel x"])
def test_llama_engine_new_routes_on_card(gen, monkeypatch, route):
    """A 2-layer tiny Llama on the card: over ``mxint4-staged`` (crossing a
    flush) against the same engine on the CPU within chip_smoke.py's
    limits, rows 7 and 9 launched at code width 4; through the in-kernel
    activation quantizer (the route below 512 rows) against the separate
    quantizer on the card, logits equal."""
    from lqer_tpu_torch.serving import kernel_backend

    cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=2, heads=4,
                           kv_heads=2, inter=512, max_pos=128)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=9,
                                                device="cpu")
    params["model.embed_tokens.weight"] *= 40
    cache_dtype = "mxint8-staged"
    if route == "mxint4-staged":
        cache_dtype = route
        qcfgs = tmodels.quantize_model(cfg, q_config_for(cfg, kv4=True),
                                       {"linear": {"rank": 32}})
    kw = dict(num_slots=4, max_len=128, cache_dtype=cache_dtype,
              pallas_backend=backend, lm_head_width=8)
    engines = {"card": DecodeEngine(params, cfg, qcfgs,
                                    scan_layers=True, device="cuda", **kw)}
    if route == "mxint4-staged":
        engines["other"] = DecodeEngine(params, cfg, qcfgs,
                                        scan_layers=True, device="cpu", **kw)
    else:
        engines["other"] = DecodeEngine(params, cfg, qcfgs,
                                        scan_layers=True, device="cuda",
                                        **kw)
    ids = torch.randint(0, 256, (4, 64), generator=gen,
                        device="cuda").cpu().numpy()
    lengths = np.full(4, 63, dtype=np.int32)
    logits = {name: [] for name in engines}
    tokens = []
    for name, engine in engines.items():
        if name == "other" and route == "in-kernel x":
            monkeypatch.setattr(kernel_backend, "inkernel_x_width",
                                lambda *a: None)
        widths = []
        real = kernel_backend.qlinear_w4_fused
        monkeypatch.setattr(
            kernel_backend, "qlinear_w4_fused",
            lambda x, *a, **kw: widths.append(kw.get("quant_x_width"))
            or real(x, *a, **kw))
        before = k3.decode_attention_quantized_staged.launches_width4
        lg = engine.prefill(ids, np.arange(4), lengths)
        engine.lengths[:] = lengths
        logits[name].append(lg)
        for i in range(40):
            if name == "card":
                tokens.append(torch.argmax(lg, -1).cpu().numpy())
            lg = engine.decode_logits(tokens[i])
            engine.lengths += 1
            logits[name].append(lg)
        monkeypatch.setattr(kernel_backend, "qlinear_w4_fused", real)
        if route == "in-kernel x":
            assert widths == [8 if name == "card" else None] * 41 * 2 * 2
        elif name == "card":
            assert (k3.decode_attention_quantized_staged.launches_width4
                    == before + 40 * 2)
    if route == "mxint4-staged":
        assert int(engines["card"].cache["flushed"].min()) >= 64
    for got, want in zip(logits["card"], logits["other"]):
        if route == "in-kernel x":
            assert torch.equal(got, want)
        worst, rms = logits_steps(got.float().cpu(), want.float().cpu())
        assert worst <= 4.0 and rms <= 0.4, (worst, rms)


# ---- rows 1 and 3 on the tensor cores: tiles, K splits and tickets ------

W4_ROWS = [1, 8, 9, 64, 65, 256, 511]


def _w4_prep(gen, k, n, rank, bias, fmt, clamp=False):
    """Kernel 1's operands from seeded values; ``clamp`` puts one weight
    group of column 3 at the exponent clamp (-127)."""
    from lqer_tpu_torch.ops.storage import MXINT4, MXINT8

    fmt = {4: MXINT4, 8: MXINT8}[fmt]
    w = torch.randn(n, k, generator=gen, device="cuda") * 0.05
    if clamp:
        w[3, 16:32] = torch.randn(16, generator=gen, device="cuda") * 1e-39
    a = b = bb = None
    if rank:
        a = torch.randn(k, rank, generator=gen, device="cuda") * 0.1
        b = torch.randn(rank, n, generator=gen, device="cuda") * 0.05
    if bias:
        bb = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    prep = k1.prepare_w4_weights(w, a, b, bb, fmt=fmt)
    if clamp:
        assert int(prep["exps"][1, 3]) == -127
    return prep, fmt


@pytest.mark.parametrize("fmt", [4, 8])
@pytest.mark.parametrize("m", W4_ROWS)
def test_dequant_gemm_tiles(gen, m, fmt):
    """Kernel 1 over every row count its tiles and K splits meet (one
    8-row tile, the 64-row tiles, ragged ones), W4 and W8, K = 272 (17
    groups: a ragged last stage) and N = 352 (a ragged column tile), with
    one weight group at the exponent clamp: within the limits of its plain
    version, twice bit-repeatable."""
    prep, f = _w4_prep(gen, 272, 352, 32, True, fmt, clamp=True)
    x = _act((m, 272), gen)
    kw = dict(quant_xa_width=8, quant_out_width=8)
    got = k1.qlinear_w4_fused(x, prep, f, **kw)
    assert torch.equal(got, k1.qlinear_w4_fused(x, prep, f, **kw))
    want = k1.qlinear_w4_plain(x, prep, f, **kw)
    check_close(f"kernel 1 M={m} W{fmt}", got, want,
                dequant_gemm_limit(x, prep, want, **kw), max_flipped=0.01)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("rank", [0, 32, 96, 128, 136, 384])
@pytest.mark.parametrize("m", [1, 8, 65, 256])
def test_dequant_gemm_ranks(gen, m, rank, bias):
    """Kernel 1 at every rank shape: none, one rank chunk, several, a rank
    that is not a multiple of 16 and wider than 128 (one whole-row q_xa
    group over three rank chunks), with and without a bias; bf16 X and the
    in-kernel X quantizer (equal to the launch fed its values)."""
    prep, f = _w4_prep(gen, 512, 256, rank, bias, 4)
    kw = dict(quant_xa_width=8, quant_out_width=8)
    x = torch.randn(m, 512, generator=gen, device="cuda") * 3
    got = k1.qlinear_w4_fused(x, prep, f, quant_x_width=8, **kw)
    xq = k1.quantize_x_plain(x, 8)
    assert torch.equal(got, k1.qlinear_w4_fused(xq.to(torch.bfloat16), prep,
                                                f, **kw))
    want = k1.qlinear_w4_plain(x, prep, f, quant_x_width=8, **kw)
    check_close(f"kernel 1 M={m} R={rank}", got, want,
                dequant_gemm_limit(xq, prep, want, **kw), max_flipped=0.01)


@pytest.mark.parametrize("arch,rank", [("llama", 0), ("llama", 32),
                                       ("llama", 96), ("llama", 128),
                                       ("opt", 32)])
@pytest.mark.parametrize("m", W4_ROWS)
def test_mlp_fused_tiles(gen, m, arch, rank):
    """The megakernel, gated and relu with biases, over every row count its
    tiles meet, ranks 0 to 128: within the limits of its plain version,
    bf16 X and the in-kernel X quantizer (equal to the launch fed its
    values), twice bit-repeatable."""
    if arch == "opt":
        _, backend, _, _ = _opt_backend(rank=rank)
        key = "model.decoder.layers.0.mlp_fused"
    else:
        cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=1, heads=2,
                               inter=512)
        backend, _, _ = build_random_model(cfg, rank=rank, seed=12)
        key = "model.layers.0.mlp_fused"
    meta, prep = backend["meta"][key], backend["arrays"][key]
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    x = torch.randn(m, 256, generator=gen, device="cuda") * 3
    xq = k1.quantize_x_plain(x, 8).to(torch.bfloat16)
    got = k5.mlp_w4_fused(xq, prep, meta["fmt"], **kw)
    assert torch.equal(got, k5.mlp_w4_fused(xq, prep, meta["fmt"], **kw))
    assert torch.equal(got, k5.mlp_w4_fused(x, prep, meta["fmt"],
                                            quant_x_width=8, **kw))
    want = k5.mlp_w4_plain(xq, prep, meta["fmt"], **kw)
    check_close(f"{arch} megakernel M={m} R={rank}", got, want,
                mlp_limit(xq, prep, want, **kw), max_flipped=0.05)


def test_w4_split_k_repeatable_at_7b(gen):
    """Kernel 1 at Mistral's q|k|v shape (K = 4096, N = 6144, fused rank
    384) at M = 8, where the K split is widest, and the megakernel at
    Llama-2-7B's MLP (I = 11264): ten launches each bit-equal."""
    prep, f = _w4_prep(gen, 4096, 6144, 384, False, 4)
    x = _act((8, 4096), gen)
    first = k1.qlinear_w4_fused(x, prep, f)
    for _ in range(9):
        assert torch.equal(first, k1.qlinear_w4_fused(x, prep, f))
    cfg = LlamaConfig.tiny(vocab_size=256, hidden=4096, layers=1, heads=32,
                           inter=11008)
    backend, _, _ = build_random_model(cfg, rank=32, seed=13)
    key = "model.layers.0.mlp_fused"
    meta, prep = backend["meta"][key], backend["arrays"][key]
    kw = dict(act_width=meta["act_width"], quant_xa_width=meta["xa_width"],
              quant_out_width=meta["out_width"])
    first = k5.mlp_w4_fused(x, prep, meta["fmt"], **kw)
    for _ in range(9):
        assert torch.equal(first, k5.mlp_w4_fused(x, prep, meta["fmt"], **kw))


# ---- rows 7 and 8 split over L (csrc/decode_mx_split.cuh)
# row 7: one slot at each flushed value of interest (no main chunk; a
# chunk's tail; its last group; a whole chunk; one group past it; the ring
# one short of L), every ring but the first wrapped (pos >= 64)
SPLIT_FLUSHED = [0, 32, 224, 256, 288, 448]
SPLIT_RESIDUE = [40, 47, 5, 0, 33, 47]


def _staged_split_case(gen, width, d, nrep, l, fl, residue):
    b, kvh = len(fl), 2
    main = [a[1] for a in _mx_cache(gen, width, b, kvh, d, l)]
    ring = [a[1].contiguous() for a in _mx_cache(gen, width, b, kvh, d, 64)]
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    kh, vh = (torch.randn(b, kvh, 1, d, generator=gen, device="cuda")
              for _ in range(2))
    kh[0, 0, 0, :16] = 0.0                      # an all-zero group
    f = _positions(fl)
    return main, ring, q, kh, vh, f + _positions(residue), f


def _check_staged_split(name, main, ring, q, kh, vh, p, fl,
                        wrapper=k3.decode_attention_quantized_staged, **kw):
    """Row 7 (or ``wrapper``, row 9) against its plain version (rings
    bit-exact), one launch count a call, a second call on a fresh copy of
    the rings equal to the bit."""
    mine, again, theirs = ([t.clone() for t in ring] for _ in range(3))
    before = wrapper.launches
    got = wrapper(q, *main, *mine, kh, vh, p, fl, **kw)
    assert wrapper.launches == before + 1
    want = k3.staged_decode_plain(q, *main, *theirs, kh, vh, p, fl, **kw)
    assert all(torch.equal(a, c) for a, c in zip(mine, theirs))
    assert torch.equal(got, wrapper(q, *main, *again, kh, vh, p, fl, **kw))
    assert all(torch.equal(a, c) for a, c in zip(again, theirs))
    s, vals = k3.staged_scores(q, *main, *theirs, p, fl, **kw)
    check_close(name, got, want,
                attention_limit(s[:, :, None, :], vals, want, p_width=8),
                max_flipped=0.05)
    return got


@pytest.mark.parametrize("nrep", [1, 2, 4, 8])
@pytest.mark.parametrize("width,d", [(8, 64), (8, 80), (8, 96), (8, 128),
                                     (4, 64), (4, 96), (4, 128)])
def test_staged_decode_split(gen, width, d, nrep):
    """Row 7 over chunks of 256 tokens and the ring's block, L = 512."""
    case = _staged_split_case(gen, width, d, nrep, 512, SPLIT_FLUSHED,
                              SPLIT_RESIDUE)
    _check_staged_split(f"row 7 width {width} d {d} n_rep {nrep}", *case,
                        scaling=d ** -0.5)


@pytest.mark.parametrize("width,d", [(8, 80), (8, 128), (4, 128)])
def test_staged_decode_split_scale_query(gen, width, d):
    """Row 7 with OPT's query scaling (``scale_query``), n_rep 1."""
    case = _staged_split_case(gen, width, d, 1, 512, SPLIT_FLUSHED,
                              SPLIT_RESIDUE)
    case[2].mul_(3)
    _check_staged_split(f"row 7 scale_query width {width} d {d}", *case,
                        scaling=d ** -0.5, scale_query=True)


@pytest.mark.parametrize("width", [8, 4])
def test_staged_decode_split_long(gen, width):
    """Row 7 at n_rep 2, d 64, L 32768, which its shared memory refused
    before it split L, against its plain version and against row 9 on the
    same inputs."""
    fl = [0, 16352, 16384, 32704]
    case = _staged_split_case(gen, width, 64, 2, 32768, fl, [40, 31, 47, 63])
    got = _check_staged_split(f"row 7 at L 32768 width {width}", *case,
                              scaling=0.125)
    main, ring, q, kh, vh, p, f = case
    ring = [t.clone() for t in ring]
    row9 = ks.decode_attention_quantized_streaming_staged(
        q, *main, *ring, kh, vh, p, f, scaling=0.125)
    s, vals = k3.staged_scores(q, *main, *ring, p, f, scaling=0.125)
    check_close("row 7 vs row 9", got, row9,
                attention_limit(s[:, :, None, :], vals, row9, p_width=8),
                max_flipped=0.05)


@pytest.mark.parametrize("nrep", [1, 2])
@pytest.mark.parametrize("width,d", [(8, 64), (8, 80), (8, 96), (8, 128),
                                     (4, 64), (4, 128)])
@pytest.mark.parametrize("cpb", [1, 2, 4, 8])
def test_streaming_staged_split(gen, monkeypatch, cpb, width, d, nrep):
    """Row 9 on row 7's kernels with blocks of cpb chunks (span S = 256
    cpb), L = 8192: one slot at each flushed edge (none; a group short of a
    span; a span's edge; a group past it; two spans and two groups; the
    ring one short of L, full), every ring but the first wrapped."""
    span = 256 * cpb
    fl = [0, span - 16, span, span + 16, 2 * span + 32, 8192 - 64]
    monkeypatch.setattr(ks, "chunks_per_block", lambda *a: cpb)
    case = _staged_split_case(gen, width, d, nrep, 8192, fl,
                              [40, 47, 5, 0, 33, 63])
    _check_staged_split(
        f"row 9 cpb {cpb} width {width} d {d} n_rep {nrep}", *case,
        wrapper=ks.decode_attention_quantized_streaming_staged,
        scaling=d ** -0.5)


@pytest.mark.parametrize("width,d,nrep,window", [
    (8, 80, 1, None), (8, 80, 4, 4096), (4, 128, 2, None),
    (4, 128, 4, 4096), (8, 128, 1, 600), (8, 64, 8, None)])
def test_streaming_split_long(gen, width, d, nrep, window):
    """Row 8 at L 32768 with skewed positions, each block walking several
    chunks: against its plain version, one launch count a call, a second
    call equal to the bit."""
    b, kvh, l = 4, 4, 32768
    cache = _mx_cache(gen, width, b, kvh, d, l)
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    p = _positions([64, 4095, 20001, 32767])
    kw = dict(scaling=d ** -0.5, window=window)
    wrapper = ks.decode_attention_quantized_streaming
    before = wrapper.launches
    got = wrapper(q, *cache, p, 1, **kw)
    assert wrapper.launches == before + 1
    assert torch.equal(got, wrapper(q, *cache, p, 1, **kw))
    want = kq.quantized_decode_plain(q, *cache, p, 1, **kw)
    s, vals = kq.quantized_scores(q, *cache, p, 1, **kw)
    check_close(f"row 8 width {width} d {d} window {window}", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)


@pytest.mark.parametrize("cache_dtype,max_len,emulated", [
    ("mxint8-staged", 128, False), ("bfloat16", 128, False),
    ("mxint8", 128, False), ("bfloat16", 64, False), ("bfloat16", 64, True),
])
def test_eager_engine_on_card(gen, cache_dtype, max_len, emulated):
    """The eager engine (``scan_layers=False``) on a 2-layer tiny Llama
    (hidden 256, 4 heads of d = 64 over 2 kv heads, rank 32) through the
    kernels against the same engine through the plain versions on the
    CPU, teacher-forced with the card's greedy tokens: an admission of
    40-token prompts and 16 decode steps, logits within chip_smoke.py's
    limits; with the backend each step launches the eager route's decode
    kernel (max_len 64 attends eagerly); ``emulated``: no backend, every
    linear through ``qlinear`` on the prepared dense weights of the same
    seeds. The eager and stacked engines give equal logits on the card
(on ``mxint8``, where the stacked step writes and attends in one launch
of row 10, within the same limits)."""
    from lqer_tpu_torch.serving.random_model import build_random_dense_model

    cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, heads=4, kv_heads=2,
                           inter=512, max_pos=256)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=9,
                                                device="cpu")
    if emulated:
        dense, qcfgs = build_random_dense_model(cfg, rank=32, seed=9,
                                                device="cpu")
        params, backend = tmodels.prepare_ptq(dense, cfg, qcfgs), None
    kw = dict(num_slots=4, max_len=max_len, cache_dtype=cache_dtype,
              pallas_backend=backend)
    engines = {"card": DecodeEngine(params, cfg, qcfgs, device="cuda", **kw),
               "cpu": DecodeEngine(params, cfg, qcfgs, device="cpu", **kw),
               "stacked": DecodeEngine(params, cfg, qcfgs, scan_layers=True,
                                       device="cuda", **kw)}
    ids = torch.randint(0, 256, (4, 64), generator=gen,
                        device="cuda").cpu().numpy()
    lengths = np.full(4, 40, dtype=np.int32)
    logits = {k: [e.prefill(ids, np.arange(4), lengths)]
              for k, e in engines.items()}
    for e in engines.values():
        e.lengths[:] = lengths
    route = {"mxint8-staged": k3.decode_attention_quantized_staged,
             "bfloat16": kfp.decode_attention_fp,
             "mxint8": kq.decode_attention_quantized}[cache_dtype]
    launched = 0
    for _ in range(16):
        tokens = torch.argmax(logits["card"][-1], -1).cpu().numpy()
        for k, e in engines.items():
            before = route.launches
            logits[k].append(e.decode_logits(tokens))
            e.lengths += 1
            launched += (route.launches - before) * (k == "card")
    kernel = max_len >= 128 and not emulated
    assert launched == (16 * 2 if kernel else 0)
    for got, want in zip(logits["card"], logits["cpu"]):
        worst, rms = logits_steps(got.float().cpu(), want.float())
        assert worst <= 4.0 and rms <= 0.4, (worst, rms)
    for got, want in zip(logits["card"], logits["stacked"]):
        if cache_dtype == "mxint8":     # row 6 after a plain write; row 10
            worst, rms = logits_steps(got.float(), want.float())
            assert worst <= 4.0 and rms <= 0.4, (worst, rms)
        else:
            assert torch.equal(got, want)


# ---- the float32 cache: rows 5 and 11 over f32 arrays


@pytest.mark.parametrize("widths", [8, None])
@pytest.mark.parametrize("b,kvh,nrep,d,l,pos", DECODE_SHAPES + [
    (2, 2, 4, 128, 6144, [6143, 3000]),           # the f32 one-pass length
    (2, 2, 2, 80, 512, [100, 511])])
def test_fp_decode_attention_f32(gen, b, kvh, nrep, d, l, pos, widths):
    """Row 5 over an f32 cache (values off the bf16 grid, a 16-token group
    at |v| <= 1e-8 that the quantizer passes through) against its plain
    version; the f32 launch counted; two launches equal to the bit."""
    k, v = (torch.randn(2, b, kvh, l, d, generator=gen, device="cuda")
            for _ in range(2))
    k[:, 0, 0, :16] *= 1e-9
    v[:, -1, -1, :16] *= 1e-9
    q = torch.randn(b, kvh * nrep, 1, d, generator=gen, device="cuda")
    kw = dict(scaling=d ** -0.5, k_width=widths, v_width=widths)
    p = _positions(pos)
    before = kfp.decode_attention_fp.launches_f32
    got = kfp.decode_attention_fp(q, k, v, p, 1, **kw)
    assert kfp.decode_attention_fp.launches_f32 == before + 1
    want = kfp.fp_decode_plain(q, k, v, p, 1, **kw)
    s, vals = kfp.fp_scores(q, k, v, p, 1, **kw)
    check_close("fp decode attention over f32", got, want,
                attention_limit(s, vals, want, p_width=8), max_flipped=0.05)
    assert torch.equal(got, kfp.decode_attention_fp(q, k, v, p, 1, **kw))


@pytest.mark.parametrize("kvh,d", [(8, 80), (32, 128), (2, 64)])
def test_row_write_f32(gen, kvh, d):
    """Row 11's f32 rows into the f32 cache, bit-exact with its plain
    version (unrounded); positions -1 and L write nothing; a strided row
    view is copied first."""
    nl, l = 2, 256
    pos = [-1, 0, 17, 255, 256]
    b = len(pos)
    arrays = [torch.randn(nl, b, kvh, l, d, generator=gen, device="cuda")
              for _ in range(2)]
    news = [torch.randn(b, kvh, 1, 2 * d, generator=gen,
                        device="cuda")[..., ::2] for _ in range(2)]
    mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
    p = _positions(pos)
    before = k4.write_kv_rows_stacked.launches_f32
    k4.write_kv_rows_stacked(tuple(mine), tuple(news), 1, p)
    assert k4.write_kv_rows_stacked.launches_f32 == before + 1
    k4.write_rows_plain(tuple(theirs), tuple(news), 1, p)
    assert all(torch.equal(a.view(torch.int32), c.view(torch.int32))
               for a, c in zip(mine, theirs))
    assert torch.equal(mine[0][1, 1, :, 0], news[0][1, :, 0])
    for a, c in zip(mine, arrays):
        assert torch.equal(a[0], c[0])
        assert torch.equal(a[:, 0], c[:, 0]) and torch.equal(a[:, 4], c[:, 4])


@pytest.mark.parametrize("scan", [True, False])
def test_f32_engine_on_card(gen, scan):
    """A 2-layer tiny Llama with the kernel backend on the f32 cache, the
    card's engine against the CPU's, teacher-forced: logits within 4 code
    steps at most and 0.4 RMS; each decode step launches row 5 per layer
    over f32 (and the stacked step row 11 before it)."""
    cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=2, heads=4,
                           kv_heads=2, inter=512, max_pos=256)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=9)
    kw = dict(num_slots=4, max_len=128, cache_dtype="float32",
              pallas_backend=backend, lm_head_width=8, scan_layers=scan)
    card = DecodeEngine(params, cfg, qcfgs, device="cuda", **kw)
    cpu = DecodeEngine(params, cfg, qcfgs, device="cpu", **kw)
    ids = torch.randint(0, 256, (4, 64), generator=gen,
                        device="cuda").cpu().numpy()
    lengths = np.full(4, 50, dtype=np.int32)
    logits = [(card.prefill(ids, np.arange(4), lengths),
               cpu.prefill(ids, np.arange(4), lengths))]
    card.lengths[:] = cpu.lengths[:] = lengths
    fp = kfp.decode_attention_fp.launches_f32
    rw = k4.write_kv_rows_stacked.launches_f32
    for _ in range(8):
        tokens = torch.argmax(logits[-1][0], -1).cpu().numpy()
        logits.append((card.decode_logits(tokens),
                       cpu.decode_logits(tokens)))
        card.lengths += 1
        cpu.lengths += 1
    assert kfp.decode_attention_fp.launches_f32 == fp + 8 * 2
    assert k4.write_kv_rows_stacked.launches_f32 == rw + (8 * 2 if scan
                                                          else 0)
    for got, want in logits:
        worst, rms = logits_steps(got.float().cpu(), want.float())
        assert worst <= 4.0 and rms <= 0.4, (worst, rms)


class _ByteTok:
    bos_token_id = 0
    eos_token_id = None

    def encode(self, text):
        return [b % 256 for b in text.encode("utf-8")]

    def decode(self, ids):
        return "".join(chr(97 + i % 26) for i in ids)


def test_harness_loglikelihood_through_kernels(gen):
    """The harness's loglikelihood and rolling requests (the tiny
    multiple-choice, lambada and wikitext tasks) on a 2-layer tiny Llama
    with every linear packed: the forward through the kernels on the card
    (kernel 1 and the megakernel, every batch below 512 rows) against the
    same model's plain versions on the CPU, scored by the same adapter:
    equal greedy flags, loglikelihoods within 1e-3 relative (the logits
    held to phase 4's limits move a sum of log-softmaxes that little)."""
    from lqer_tpu_torch.evaluate.harness import TorchCausalLM
    from lqer_tpu_torch.evaluate.minieval import TASK_REGISTRY
    from lqer_tpu_torch.models import llama
    from lqer_tpu_torch.serving.engine import _to

    cfg = LlamaConfig.tiny(vocab_size=256, hidden=256, layers=2, heads=4,
                           kv_heads=2, inter=512, max_pos=256)
    backend, params, qcfgs = build_random_model(cfg, rank=32, seed=10)
    cpu_params, cpu_backend = _to(params, "cpu"), _to(backend, "cpu")
    requests = {}
    for name in ("tiny_arc_easy", "tiny_boolq", "tiny_lambada_openai",
                 "tiny_wikitext"):
        for inst in TASK_REGISTRY[name]().build_all_requests(0):
            requests.setdefault(inst.request_type, []).append(inst)
    out, launched = {}, 0
    for dev, p, bk in (("cuda", params, backend),
                       ("cpu", cpu_params, cpu_backend)):
        lm = TorchCausalLM(
            lambda ids, p=p, bk=bk: llama.forward(p, ids, cfg, qcfgs,
                                                  backend=bk),
            _ByteTok(), max_length=128, batch_size=4, device=dev)
        before = k1.qlinear_w4_fused.launches + k5.mlp_w4_fused.launches
        out[dev] = {t: getattr(lm, t)(r) for t, r in requests.items()}
        if dev == "cuda":
            launched = (k1.qlinear_w4_fused.launches
                        + k5.mlp_w4_fused.launches - before)
    assert launched > 0
    for (ll, g), (ll_cpu, g_cpu) in zip(out["cuda"]["loglikelihood"],
                                        out["cpu"]["loglikelihood"]):
        assert g == g_cpu
        assert abs(ll - ll_cpu) <= 1e-3 * abs(ll_cpu), (ll, ll_cpu)
    np.testing.assert_allclose(out["cuda"]["loglikelihood_rolling"],
                               out["cpu"]["loglikelihood_rolling"],
                               rtol=1e-3)
