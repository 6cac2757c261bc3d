"""How close a kernel must come to its plain PyTorch version, and the card
path to the CPU path.

A kernel and its plain version compute the same function, but their f32
sums run in different orders (and CUDA's ``expf`` is not the CPU's
``exp``), so results differ in the last bits: within rtol = atol = 2e-4,
the tolerance of the JAX package's own staged test
(``tests/test_staged_serving.py:82``). Several steps then quantize such a
sum to 8 bits: X·A and the correction in kernels 1 and 5, H in kernel 5,
P in kernels 2 and 3, and every activation and cache write of the served
path. Where a value
lies within a few ulps of a rounding boundary, the two sides round it one
code step apart. Each limit below adds the most that one such flip can
move the result, counted in code steps of the 16-group it lands in. A
flip moves one value by one step; an error of the function (a missing
quantizer, a wrong group or mask) moves most values, which the fraction
of values past the plain tolerance shows.
"""

from __future__ import annotations

import functools

import torch

from .ops.kernels import mlp_fused
from .ops.kernels.dequant_gemm import lqer_correction
from .ops.storage import MXINT4, dequantize_packed
from .parallel.collectives import (
    ceil_log2_exact,
    exp2_int,
    floor_log2_exact,
    unpack_nibbles,
)

RTOL = ATOL = 2e-4
GROUP = 16  # values per shared exponent in every 8-bit quantizer here


def code_step(v: torch.Tensor, width: int | None) -> torch.Tensor:
    """Per element of ``v``, one code step of the quantizer that rounds it:
    ``2^(e − (width − 1))`` with ``e`` the exact exponent of its group of 16
    along the last axis (the whole row when 16 does not divide it); with
    ``width`` None, one bf16 ulp of the element."""
    v = v.to(torch.float32)
    if width is None:
        return exp2_int(floor_log2_exact(v.abs()) - 7)
    n = v.shape[-1]
    g = GROUP if n % GROUP == 0 else n
    bmax = v.abs().reshape(*v.shape[:-1], n // g, g).amax(-1, keepdim=True)
    step = exp2_int(ceil_log2_exact(bmax) - (width - 1))
    return step.expand(*v.shape[:-1], n // g, g).reshape(v.shape)


def dequant_gemm_limit(x: torch.Tensor, prep: dict, ref: torch.Tensor, *,
                       quant_xa_width: int | None,
                       quant_out_width: int | None) -> torch.Tensor:
    """Per-element limit of ``|kernel − plain|`` for kernel 1 on ``x``.

    One flipped rounding of X·A (a q_xa code step, or a bf16 ulp when q_xa
    is off) moves the correction by at most that step times ``|B[r, n]|``;
    q_out then rounds the moved value at most one code step of its group
    away, and one more where the move lifts the group's exponent."""
    lim = ATOL + RTOL * ref.abs()
    if prep.get("a") is None:
        return lim
    xf = x.to(torch.float32)
    xa_step = code_step(torch.matmul(xf, prep["a"].to(torch.float32)),
                        quant_xa_width)
    shift = (xa_step[:, :, None] * prep["b"].to(torch.float32).abs()[None]
             ).amax(1)
    if quant_out_width is None:
        return lim + shift
    corr = lqer_correction(xf, prep["a"], prep["b"],
                           quant_xa_width=quant_xa_width,
                           quant_out_width=quant_out_width)
    return lim + shift + 2 * code_step(corr, quant_out_width)


def mlp_limit(x: torch.Tensor, prep: dict, ref: torch.Tensor, *,
              act_width: int, quant_xa_width: int | None,
              quant_out_width: int | None) -> torch.Tensor:
    """Per-element limit of ``|kernel − plain|`` for the MLP megakernel on
    ``x``.

    Every rounding upstream of the down projection that a summation order
    can flip (q_xa of X·[A_g|A_u], the gate and up corrections' q_out, and
    silu's ``exp``) moves gate or up by far less than one code step of H,
    so it reaches H as one flipped act code step of one value, or two where
    the move lifts the group's exponent; the down projection carries it by
    ``|W_d|``. The limit allows one such value per row (its largest step ×
    ``|W_d[i, n]|`` over the row), then the down projection's own flips of
    q_xa and q_out as kernel 1 has them (:func:`dequant_gemm_limit` on
    H)."""
    h = mlp_fused.hidden_plain(x, prep, MXINT4, act_width=act_width,
                               quant_xa_width=quant_xa_width,
                               quant_out_width=quant_out_width)
    m, i = h.shape
    # one step per 16-group of H against the group's largest |W_d| row
    step = code_step(h, act_width)[:, ::GROUP]                   # (M, I/16)
    wd = dequantize_packed(prep["codes_d"], prep["exps_d"], MXINT4).abs()
    wd = wd.reshape(i // GROUP, GROUP, -1).amax(1)               # (I/16, N)
    shift = torch.cat([(step[r:r + GROUP, :, None] * wd[None]).amax(1)
                       for r in range(0, m, GROUP)])
    return dequant_gemm_limit(h, mlp_fused.down_prep(prep), ref,
                              quant_xa_width=quant_xa_width,
                              quant_out_width=quant_out_width) + 2 * shift


def attention_limit(s: torch.Tensor, v: torch.Tensor, ref: torch.Tensor, *,
                    p_width: int | None) -> torch.Tensor:
    """Per-element limit of ``|kernel − plain|`` for an attention output
    ``ref (..., S, D)`` from masked scores ``s (..., S, L)`` and values
    ``v (..., L, D)``: one flipped rounding of a p moves the output by that
    p's code step (at most the row's largest) times ``|v|``."""
    lim = ATOL + RTOL * ref.abs()
    if p_width is None:
        return lim
    p = torch.softmax(s.to(torch.float32), dim=-1)
    step = code_step(p, p_width).amax(-1, keepdim=True)
    return lim + step * v.to(torch.float32).abs().amax(-2, keepdim=True)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                limit: torch.Tensor, max_flipped: float) -> dict:
    """Raise unless every element is within ``limit`` and at most the
    fraction ``max_flipped`` lies past the plain rtol/atol band; return
    ``{max_abs_err, flipped, of_limit}`` (``of_limit``: the largest
    ``|diff| / limit``). A NaN on either side counts as an infinite
    difference."""
    diff = (got.to(torch.float32) - want.to(torch.float32)).abs()
    diff = torch.where(diff.isnan(), float("inf"), diff)
    flipped = float((diff > ATOL + RTOL * want.abs()).float().mean())
    out = {"max_abs_err": float(diff.max()), "flipped": flipped,
           "of_limit": float((diff / limit).max())}
    if out["of_limit"] > 1 or flipped > max_flipped:
        raise AssertionError(
            f"{name}: |diff| reaches {out['of_limit']:.3g} x its limit, "
            f"{flipped:.4%} of elements past rtol=atol={RTOL} (at most "
            f"{max_flipped:.2%}), max |diff| {out['max_abs_err']:.3g}")
    return out


def logits_steps(got: torch.Tensor, want: torch.Tensor
                 ) -> tuple[float, float]:
    """(max, RMS) of ``|got − want|`` in 8-bit code steps of each row's
    scale, ``2^(ceil_log2(max |want row|) − 7)``."""
    want = want.to(torch.float32)
    step = exp2_int(ceil_log2_exact(want.abs().amax(-1, keepdim=True)) - 7)
    d = (got.to(torch.float32) - want) / step
    return float(d.abs().max()), float(d.square().mean().sqrt())


def _cache_rows(cache: dict, side: str, s: int, f: int):
    """Slot ``s``'s first ``f`` tokens of one side of the cache, d along
    dim -2: (entries to count, values in code steps at their exponents,
    exponents per value) with the code width; the bf16 cache counts values
    and reads them in 8-bit steps of their 16-group along d."""
    if f"{side}_codes" not in cache:
        x = cache[side][:, s, :, :f, :].to(torch.float32).transpose(-1, -2)
        e = ceil_log2_exact(x.abs().transpose(-1, -2).reshape(
            *x.shape[:-2], f, -1, GROUP).amax(-1).clamp(min=2 ** -126))
        e = e.transpose(-1, -2).repeat_interleave(GROUP, -2)
        return (x,), x * exp2_int(7 - e), e, 8
    codes = cache[f"{side}_codes"][:, s, ..., :f]
    exps = cache[f"{side}_exps"][:, s, ..., :f]
    width = 4 if codes.shape[-2] * 2 == exps.shape[-2] * GROUP else 8
    vals = (torch.cat(unpack_nibbles(codes), -2) if width == 4
            else codes.to(torch.int32))
    rows = vals.shape[-2] // exps.shape[-2]
    e = exps.to(torch.int32).repeat_interleave(rows, -2)
    return (codes, exps), vals.to(torch.float32), e, width


def cache_agreement(a: dict, b: dict, lengths) -> tuple[float, float]:
    """Caches ``a`` and ``b`` over the first ``lengths[s]`` tokens of each
    slot ``s`` (for a staged cache, its ``flushed``: the main part): the
    fraction of equal entries (code and exponent bytes, or bf16 values) and
    the largest difference of values in code steps of the cache's width
    (4-bit steps for MXINT4, 8-bit steps otherwise; the bf16 cache in steps
    of its 16-groups along d) at the coarser exponent of the two."""
    eq = total = 0
    worst = 0.0
    for side in ("k", "v"):
        for s, f in enumerate(int(n) for n in lengths):
            if f == 0:
                continue
            ea_, va, ya, width = _cache_rows(a, side, s, f)
            eb_, vb, yb, _ = _cache_rows(b, side, s, f)
            for xa, xb in zip(ea_, eb_):
                xa, xb = xa.cpu(), xb.cpu()
                eq += int((xa == xb).sum())
                total += xa.numel()
            va, vb, ya, yb = (t.cpu() for t in (va, vb, ya, yb))
            emax = torch.maximum(ya, yb)
            da = va * exp2_int(ya - emax)
            db = vb * exp2_int(yb - emax)
            worst = max(worst, float((da - db).abs().max()))
    return eq / max(total, 1), worst


def one_torch_thread_fixture():
    """An autouse, module-scoped pytest fixture that runs a test file's
    tests with one intra-op thread (``_one_torch_thread =
    one_torch_thread_fixture()`` in the file). The CPU tests run in several
    worker processes at once (pytest-xdist), and in each the default pool
    of one thread per core busy-waits against the others'; the tiny
    models of these tests gain little from more threads."""
    import pytest

    @pytest.fixture(autouse=True, scope="module")
    def _one_torch_thread():
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)

    return _one_torch_thread


def shared(build):
    """``build`` run once per distinct arguments (compared by ``repr``, so
    dicts count), its result returned to every later call: for the JAX
    reference models that several test cases only read."""
    results = {}

    @functools.wraps(build)
    def get(*args, **kwargs):
        key = repr((args, sorted(kwargs.items())))
        if key not in results:
            results[key] = build(*args, **kwargs)
        return results[key]

    return get
