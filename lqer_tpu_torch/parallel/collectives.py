"""MXINT codec and the collectives of the tensor-parallel paths.

Port of ``lqer_tpu/parallel/collectives.py``: ``ceil_log2_exact``,
``mx8_encode``/``mx8_decode``, ``mx4_encode``/``mx4_decode``, and the two
quantized collectives over a ``torch.distributed`` process group:
:func:`quantized_all_gather` (MXINT8 codes and int8 exponents on the
wire, decoded on arrival) and :func:`quantized_psum_scatter` (JAX's ring
reduce-scatter, step for step: each hop's partial sum crosses the group
MXINT8-encoded and is accumulated in f32 in JAX's chunk order). The exact
collectives (:func:`all_reduce`, :func:`all_gather`) carry gradients.

Every payload goes through :func:`host_staged`: on a ``gloo`` group a
CUDA tensor is copied to host memory, the collective runs there, and the
result is copied back (``gloo`` takes CUDA tensors for few operations;
two ranks on one card cannot use NCCL). :func:`wire_counts` reports the
bytes this rank put on the wire (ring algorithms: an all-reduce of N bytes
over n ranks sends ``2 (n - 1) / n · N``, an all-gather ``(n - 1) · N``)
and the bytes staged through host memory. The backend is always the
caller's: nothing here switches one for another.

Exponent contract of the whole port: every shared exponent is computed
exactly from the float's bits (:func:`ceil_log2_exact`), never from a float
``ceil(log2(x))``, in every plain version and every CUDA kernel. Powers of
two are built from bits too (:func:`exp2_int`), so no libm rounding enters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ZERO_ATOL = 1e-8  # |x| <= 1e-8 passes through every quantizer unquantized


def ceil_log2_exact(x: torch.Tensor) -> torch.Tensor:
    """``clip(ceil(log2(x)), -127, 128)`` for positive finite f32 ``x`` as
    int32, from the exponent field: a subnormal ``x`` gives -127 (the
    clamp), a power of two ``2^k`` gives ``k``, anything above it ``k+1``.
    A float ``ceil(log2(x))`` can round down to ``k`` for ``x`` an ulp
    above ``2^k``; this helper cannot."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    be = (bits >> 23) & 0xFF
    m = bits & 0x7FFFFF
    e = torch.where(be == 0, torch.full_like(be, -127),
                    be - 127 + (m != 0).to(torch.int32))
    return e.clamp(-127, 128)


def floor_log2_exact(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(x))`` for positive finite f32 ``x`` as int32, clamped
    below at -127 (every caller clips at or above that)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    be = (bits >> 23) & 0xFF
    return torch.where(be == 0, torch.full_like(be, -127), be - 127)


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2^e`` as f32 for integer ``e`` in [-149, 128] (128 gives
    inf, below -126 a subnormal), built from bits."""
    e = e.to(torch.int32)
    normal = ((e + 127).clamp(1, 255) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 22)).view(torch.float32)
    return torch.where(e >= -126, normal, sub)


def fill_zero_groups(bmax: torch.Tensor, zero_fill: float | None
                     ) -> torch.Tensor:
    """All-zero groups get ``zero_fill`` as absmax, or with ``None`` the
    smallest non-zero absmax of the whole tensor (1.0 when there is none).
    Their codes are 0 either way; only the stored exponent depends on it."""
    if zero_fill is None:
        nz_min = torch.where(bmax != 0, bmax,
                             torch.full_like(bmax, float("inf"))).amin()
        fill = torch.where(torch.isinf(nz_min), torch.ones_like(nz_min),
                           nz_min)
    else:
        fill = torch.full((), zero_fill, dtype=bmax.dtype, device=bmax.device)
    return torch.where(bmax == 0, fill, bmax)


def mx_mantissa(v: torch.Tensor, e: torch.Tensor, mb: int):
    """``(sign, mant, scale)`` of the block_fp grid: ``sign(v + 1e-9)``,
    ``clip(rint((|v| + 1e-9) / 2^e * 2^mb), 0, 2^mb - 1)`` and ``2^e``, in
    the reference's f32 operation order."""
    scale = exp2_int(e)
    shift = float(2 ** mb)
    sign = torch.sign(v + 1e-9)
    mant = torch.round((v.abs() + 1e-9) / scale * shift).clamp(0, shift - 1)
    return sign, mant, scale


def mx_values(v: torch.Tensor, bmax: torch.Tensor, mb: int,
              e_min: int = -127, e_max: int = 128) -> torch.Tensor:
    """Quantize-dequantize ``v`` against its (zero-filled, broadcastable)
    group absmax: ``sign · 2^e · mant / 2^mb`` with the ``|v| <= 1e-8``
    passthrough."""
    e = ceil_log2_exact(bmax).clamp(e_min, e_max)
    sign, mant, scale = mx_mantissa(v, e, mb)
    q = sign * scale * (mant / float(2 ** mb))
    return torch.where(v.abs() <= ZERO_ATOL, v, q)


def _group_encode(x: torch.Tensor, group: int, mb: int,
                  zero_fill: float | None):
    *lead, f = x.shape
    assert f % group == 0, (f, group)
    xf = x.to(torch.float32).reshape(*lead, f // group, group)
    bmax = fill_zero_groups(xf.abs().amax(-1, keepdim=True), zero_fill)
    e = ceil_log2_exact(bmax)
    sign, mant, _ = mx_mantissa(xf, e, mb)
    codes = (sign * mant).to(torch.int32).reshape(*lead, f)
    return codes, e.to(torch.int8).reshape(*lead, f // group)


def mx8_encode(x: torch.Tensor, group: int = 16,
               zero_fill: float | None = None):
    """(…, F) float → (codes int8 (…, F), exps int8 (…, F/group))."""
    codes, exps = _group_encode(x, group, 7, zero_fill)
    return codes.to(torch.int8), exps


def mx4_encode(x: torch.Tensor, group: int = 16,
               zero_fill: float | None = None):
    """(…, F) float → (codes int8 (…, F/2) nibble-packed F-split: element
    ``i`` holds value ``i`` low and ``i + F/2`` high; exps (…, F/group))."""
    f = x.shape[-1]
    assert f % (2 * group) == 0, (f, group)
    codes, exps = _group_encode(x, group, 3, zero_fill)
    half = f // 2
    packed = ((codes[..., half:] & 0xF) << 4) | (codes[..., :half] & 0xF)
    packed = torch.where(packed >= 128, packed - 256, packed)
    return packed.to(torch.int8), exps


def mx8_decode(codes: torch.Tensor, exps: torch.Tensor, group: int = 16,
               dtype=torch.float32) -> torch.Tensor:
    *lead, f = codes.shape
    scale = exp2_int(exps.to(torch.int32) - 7)
    v = codes.to(torch.float32).reshape(*lead, f // group, group)
    return (v * scale[..., None]).reshape(*lead, f).to(dtype)


def unpack_nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-extended (low, high) nibbles of int8-held bytes as int32."""
    c = packed.to(torch.int32)
    return (c << 28) >> 28, (c << 24) >> 28


def mx4_decode(codes: torch.Tensor, exps: torch.Tensor, group: int = 16,
               dtype=torch.float32) -> torch.Tensor:
    *lead, half = codes.shape
    f = half * 2
    low, high = unpack_nibbles(codes)
    vals = torch.cat([low, high], dim=-1).to(torch.float32)
    scale = exp2_int(exps.to(torch.int32) - 3)
    v = vals.reshape(*lead, f // group, group) * scale[..., None]
    return v.reshape(*lead, f).to(dtype)


# -- collectives ----------------------------------------------------------------
_COUNTS = {"sent_bytes": 0, "host_staged_bytes": 0}


def wire_counts() -> dict:
    """``{"sent_bytes", "host_staged_bytes"}`` since the last reset."""
    return dict(_COUNTS)


def reset_wire_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def host_staged(op, *tensors: torch.Tensor, group=None):
    """``op(*tensors)`` as ``group``'s backend takes the tensors: on a
    ``gloo`` group, CUDA tensors are copied to host memory first and the
    results (a tensor or a tuple of tensors) copied back to the device
    (the bytes both ways are counted as ``host_staged_bytes``); on any
    other backend ``op`` sees the tensors as they are."""
    device = next((t.device for t in tensors if t.is_cuda), None)
    if device is None or dist.get_backend(group) != "gloo":
        return op(*tensors)
    _COUNTS["host_staged_bytes"] += sum(_nbytes(t) for t in tensors)
    out = op(*(t.cpu() for t in tensors))
    outs = out if isinstance(out, tuple) else (out,)
    _COUNTS["host_staged_bytes"] += sum(_nbytes(t) for t in outs)
    outs = tuple(t.to(device) for t in outs)
    return outs if isinstance(out, tuple) else outs[0]


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    def op(u):
        u = u.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(u, group=group)
        return u

    return host_staged(op, t, group=group)


class _AllReduce(torch.autograd.Function):
    """Sum over the group; its gradient is the sum of the incoming
    gradients (the rule of ``torch.distributed.nn.functional.all_reduce``,
    which the installed torch marks deprecated)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Exact sum over ``group`` (a new tensor, the same on every rank),
    differentiable: the gradient is the sum of the ranks' gradients."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    _COUNTS["sent_bytes"] += 2 * (n - 1) * _nbytes(x) // n
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``axis`` in rank order. When
    ``x`` needs a gradient, each rank's part is placed in zeros of the full
    size and summed (:func:`all_reduce`: exact, as ``v + 0 == v``), so the
    gradient is each rank's slice of the summed gradients."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    axis = axis % x.ndim
    if torch.is_grad_enabled() and x.requires_grad:
        r = dist.get_rank(group)
        pad = [0, 0] * (x.ndim - 1 - axis) + [r * x.shape[axis],
                                              (n - 1 - r) * x.shape[axis]]
        return all_reduce(torch.nn.functional.pad(x, pad), group)
    _COUNTS["sent_bytes"] += (n - 1) * _nbytes(x)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    return host_staged(gather, x, group=group)


def _ring_shift(tensors: tuple, group) -> tuple:
    """Each tensor sent one hop to rank ``(i + 1) mod n`` of ``group``, the
    previous rank's received in its place."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    _COUNTS["sent_bytes"] += sum(_nbytes(t) for t in tensors)

    def shift(*ts):
        out = tuple(torch.empty_like(t) for t in ts)
        ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group)
               for t in ts]
        ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    return host_staged(shift, *tensors, group=group)


def quantized_all_gather(x: torch.Tensor, group, gather_axis: int = 0,
                         group_size: int = 16, dtype=torch.float32
                         ) -> torch.Tensor:
    """all_gather of ``x`` with MXINT8 on the wire: encode (groups of
    ``group_size`` along the last axis), gather the int8 codes and
    exponents, decode. Equal to the gather of each rank's MXINT8 round
    trip."""
    codes, exps = mx8_encode(x, group_size)
    return mx8_decode(all_gather(codes, group, gather_axis),
                      all_gather(exps, group, gather_axis), group_size,
                      dtype)


def quantized_psum_scatter(x: torch.Tensor, group, scatter_axis: int = 0,
                           group_size: int = 16) -> torch.Tensor:
    """Reduce-scatter with each hop's payload MXINT8-encoded: JAX's ring.
    ``x`` splits into n chunks along ``scatter_axis``; rank i starts from
    chunk i - 1 and at each of the n - 1 steps encodes its partial, sends it
    to rank i + 1, decodes the one from rank i - 1 and adds its own chunk
    i - 1 - step in f32. Rank i returns the reduced chunk i."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"axis {scatter_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    chunks = x.chunk(n, dim=scatter_axis)
    acc = chunks[(idx - 1) % n]
    for step in range(1, n):
        codes, exps = _ring_shift(mx8_encode(acc, group_size), group)
        acc = mx8_decode(codes, exps, group_size) + chunks[(idx - 1 - step)
                                                           % n]
    return acc
