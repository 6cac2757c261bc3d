"""The yardstick: operations and bytes of the model's work from the
configuration's shapes and the recipe's logical formats, never from the
program's arrays, so that the count reads the same whatever implements it.

Logical formats: MXINT4 weight codes (half a byte) with one 8-bit
exponent per 16 (``W4 = 1/2 + 1/16`` bytes a weight); MXINT8 activations,
low-rank factors, biases and head weights (``A8 = 1 + 1/16``); the MXINT8
cache's codes and exponents (``A8`` per value); logits in f32 (bf16 for a
dense bf16 head). Each input byte counts once and each output byte once.
A roofline bound is ``max(ops / peak ops, bytes / peak bytes)``."""

from __future__ import annotations

from .spec import ModelSpec

W4 = 0.5 + 1 / 16
A8 = 1 + 1 / 16
BF16, F32 = 2, 4


def bound_s(ops: float, nbytes: float, peaks: tuple) -> float:
    """Seconds a chip of ``peaks = (bytes/s, ops/s)`` needs at least."""
    bw, flops = peaks
    return max(ops / flops, nbytes / bw)


def linear(m: int, k: int, n: int, rank: int, bias: bool = False) -> tuple:
    """(ops, bytes) of one W4A8 linear with its rank-``rank`` correction
    over ``m`` rows: input and output rows in MXINT8."""
    ops = 2 * m * k * n + 2 * m * rank * (k + n)
    nbytes = k * n * W4 + rank * (k + n) * A8 + m * (k + n) * A8
    if bias:
        nbytes += n * A8
    return ops, nbytes


def layer_linears(spec: ModelSpec, m: int) -> tuple:
    """(ops, bytes) of one layer's linears over ``m`` rows. The MLP counts
    as one unit (its input and output rows, every weight): its
    intermediate rows need not leave the chip."""
    ops = nbytes = 0.0
    bias = spec.arch == "opt"
    mlp = ("fc1", "fc2", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
    for rel, (n, k) in spec.linear_shapes().items():
        o, b = linear(m, k, n, spec.rank, bias)
        if rel in mlp:
            b -= m * (k + n) * A8
        ops, nbytes = ops + o, nbytes + b
    nbytes += 2 * m * spec.hidden * A8       # the MLP's input and output
    return ops, nbytes


def head(spec: ModelSpec, m: int, w8: bool | None = None) -> tuple:
    """(ops, bytes) of the head over ``m`` rows: the W8 head on bf16 rows
    with f32 logits (``w8``, by default the recipe's), or a dense one
    counted in bf16."""
    h, v = spec.hidden, spec.vocab
    ops = 2 * m * h * v
    if spec.w8_head if w8 is None else w8:
        return ops, h * v * A8 + m * h * BF16 + m * v * F32
    return ops, (h * v + m * h + m * v) * BF16


def decode_attention(spec: ModelSpec, attended: int, rows: int) -> tuple:
    """(ops, bytes) of one layer's decode attention: ``attended`` keys
    summed over the step's ``rows`` slots (each slot's cached tokens plus
    its new one, under the window at most the window's), each read once as
    MXINT8 K and V, and the new rows written once; q in and out in f32."""
    d, kvh, heads = spec.head_dim, spec.kv_heads, spec.heads
    ops = 4 * heads * d * attended
    nbytes = (2 * kvh * d * A8 * (attended + rows)
              + 2 * rows * heads * d * F32)
    return ops, nbytes


def prefill_attention(spec: ModelSpec, seqs: int, s: int) -> tuple:
    """(ops, bytes) of one layer's causal attention over ``seqs`` sequences
    of ``s`` tokens (``q K^T`` and ``P V`` over the causal half; under a
    window only its keys): q, K, V in MXINT8, the output in f32."""
    d, kvh, heads = spec.head_dim, spec.kv_heads, spec.heads
    w = spec.window or s
    pairs = sum(min(i + 1, w) for i in range(s))
    ops = 4 * heads * d * pairs * seqs
    nbytes = seqs * s * d * ((heads + 2 * kvh) * A8 + heads * F32)
    return ops, nbytes


def attended_keys(spec: ModelSpec, lengths) -> int:
    """Keys a decode step reads over its slots: each slot's cached tokens
    and its new one, within the window."""
    w = spec.window
    return sum(min(n + 1, w) if w else n + 1 for n in lengths)


def decode_step(spec: ModelSpec, rows: int, lengths) -> dict:
    """{"linear": (ops, bytes), "attn": (ops, bytes)} of one decode step
    over ``rows`` slots whose caches hold ``lengths`` tokens; the head in
    the linears."""
    lo, lb = layer_linears(spec, rows)
    ho, hb = head(spec, rows)
    ao, ab = decode_attention(spec, attended_keys(spec, lengths), rows)
    n = spec.layers
    return {"linear": (n * lo + ho, n * lb + hb), "attn": (n * ao, n * ab)}


def prefill(spec: ModelSpec, seqs: int, s: int, head_rows: int,
            w8_head: bool | None = None) -> dict:
    """The same for a forward over ``seqs`` sequences of ``s`` tokens with
    the head over ``head_rows`` rows (``w8_head`` as :func:`head`)."""
    lo, lb = layer_linears(spec, seqs * s)
    ho, hb = head(spec, head_rows, w8_head)
    ao, ab = prefill_attention(spec, seqs, s)
    n = spec.layers
    return {"linear": (n * lo + ho, n * lb + hb), "attn": (n * ao, n * ab)}


def admission(spec: ModelSpec, prompts) -> dict:
    """The same for one admission of prompts of the given lengths, each at
    its own length (padding is not model work), the head over each last
    row: the weights read once for all of them."""
    lo, lb = layer_linears(spec, sum(prompts))
    ho, hb = head(spec, len(prompts))
    att = [prefill_attention(spec, 1, s) for s in prompts]
    n = spec.layers
    return {"linear": (n * lo + ho, n * lb + hb),
            "attn": (n * sum(o for o, _ in att), n * sum(b for _, b in att))}


def total(parts: dict) -> tuple:
    return (sum(o for o, _ in parts.values()),
            sum(b for _, b in parts.values()))
