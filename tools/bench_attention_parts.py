#!/usr/bin/env python3
"""Where the time of the attention rows 4 to 10 and the cache writes
(rows 11 to 14) goes, on one card.

    python3 tools/bench_attention_parts.py
        [--rows 4 5 6 7 8 9 10 11 12 13 14] [--cpb N ...]

Row 5 (fp-cache decode attention, ``ops/kernels/fp_decode.py``) at
``chip_smoke.py``'s phase-3 shapes (Llama-2-7B: 8 slots x 32 kv heads,
L = 2048, positions 64..1984; Mistral-7B: 8 slots x 8 kv heads of 4
queries, L = 8192, positions 6000..6030, window 4096): the served launch,
the same launch with K and V left unquantized (``k_width=v_width=None``),
and each of its kernels' device time (torch.profiler). Rows 6 (widths 8
and 4) and 10 (``ops/kernels/quantized_decode.py``) at those shapes and at
OPT-2.7b's (8 slots x 32 kv heads of d = 80, L = 2048): the launch, each of
its kernels' device time, the bound (the cache bytes the slots hold, the
queries and the output, over the card's memory rate) and
``scaled_dot_product_attention`` on the unquantized bf16 values (with the
window mask where there is a window). Row 4 (prefill attention,
``ops/kernels/attention.py``) at 8 prompts x 64 tokens and one prompt of
2048 tokens, 32 heads, d = 128: the launch and each of its kernels' device
time. Row 7 (staged decode, ``ops/kernels/decode_attention.py``) at the
Llama shape (flushed = pos // 32 * 32, widths 8 and 4), OPT-2.7b's and at
8 slots x 16 kv heads of 2 queries, d = 64, L = 32768 (positions up to
32767); rows 8 and 9 (``ops/kernels/streaming_decode.py``) at the
long-context shape (8 slots x 32 kv heads, L = 32768, positions 64..32767,
widths 8 and 4), row 9 also at OPT-2.7b's, row 8 also at Mistral-7B's (8
kv heads of 4 queries, L = 32768, positions 32000..32030) with and without
the window, and at L = 2048, 16384 and 24576; row 8 beside row 6 and row
7 beside row 9 on the same inputs (where the one-pass and the streaming
kernels cross). Rows 7, 8 and 9 print the launch, each kernel's device
time, the bound and SDPA; ``--cpb`` times rows 8 and 9 with each block
walking that many chunks instead of its own choice
(``split_plan.chunks_per_block``). Row 11 (``ops/kernels/cache_write.py``)
at ``chip_smoke.py``'s phase-3 shapes (the bf16 K and V rows and the four
MXINT4 columns of 8 slots x 32 kv heads, d = 128, L = 2048; Mistral's bf16
rows at 8 kv heads, L = 8192) and row 12 (32 layers, L = 2048; MXINT8 and
MXINT4 columns, bf16 rows), each beside its bound, and an empty launch
(``torch.cuda._sleep(0)``: one thread that returns at once) under the
same timer, the floor of every launch-bound row. Row 13 (the fused
MXINT8 encode + column write) at 8 slots x 32 kv heads, d = 128,
L = 32768 (and L = 2048: the same stores over a smaller cache), at the
long-context step's 4 slots (also with K and V read as
views of one q|k|v output, as the served step passes them) and at
Mistral's 8 kv heads; row 14 (the staged-ring flush) at the 7B flush shape
(32 layers x 8 slots x 32 kv heads, L = 2048) with every slot's span 32,
every span 64, and one slot's 32; each bit-exact with its plain version,
beside its bound (each input byte read once, each output byte written
once, over the card's memory rate); row 14 has beside it PyTorch's
``copy_`` of the same rows' first 32 bytes (one span for every slot: the strided pattern's
yardstick, not the same function). Rows 13 and 14 are also timed with L2
evicted by a read instead of the memset (``ms_l2_clean``), so that no
dirty line is written back during the launch. Times are medians of
CUDA events with L2 flushed before each launch (``chip_smoke.Timer``); one
JSON line per shape, the card's name and power limit first; a shape the
checkout's kernels refuse prints its reason.
Needs one CUDA device. Copied with ``chip_smoke.py`` into another checkout
(``git archive`` unpacked under ``build/``), it times that checkout's
kernels: run both in one call to compare them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (shape, slots, kv heads, n_rep, d, L, positions, window)
DECODE_SHAPES = (
    ("Llama", 8, 32, 1, 128, 2048,
     [64, 303, 560, 815, 1088, 1343, 1600, 1984], None),
    ("Mistral", 8, 8, 4, 128, 8192,
     [6000, 6001, 6003, 6007, 6010, 6013, 6021, 6030], 4096),
    ("OPT-2.7b", 8, 32, 1, 80, 2048,
     [64, 303, 560, 815, 1088, 1343, 1600, 1984], None))


def _row5(timer, launch_split, gen):
    from lqer_tpu_torch.ops.kernels import fp_decode as kfp

    for what, B, KVH, nrep, D, L, pos, win in DECODE_SHAPES[:2]:
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        q = torch.randn(B, KVH * nrep, 1, D, generator=gen, device="cuda")
        k, v = (torch.randn(2, B, KVH, L, D, generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        kw = dict(scaling=D ** -0.5, window=win)
        served = lambda: kfp.decode_attention_fp(q, k, v, p, 1, **kw)
        raw = lambda: kfp.decode_attention_fp(q, k, v, p, 1, k_width=None,
                                              v_width=None, **kw)
        print(json.dumps({
            "row": 5, "shape": what, "ms": timer(served),
            "k_v_unquantized_ms": timer(raw),
            "kernels_ms": launch_split(torch, served)}), flush=True)
        del k, v


def _rows_6_10(timer, launch_split, gen, rows):
    import torch.nn.functional as F

    from chip_smoke import peak_rates
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.ops.kernels.decode_attention import key_mask
    from lqer_tpu_torch.parallel.collectives import mx4_encode, mx8_encode

    rate = peak_rates(torch.cuda.get_device_name(0))[0]
    for what, B, KVH, nrep, D, L, pos, win in DECODE_SHAPES:
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        q = torch.randn(B, KVH * nrep, 1, D, generator=gen, device="cuda")
        lo = (p - win + 1).clamp(min=0) // 16 * 16 if win else 0
        tokens = int(((p + 16) // 16 * 16 - lo).sum())
        mask = key_mask(L, p, win)[:, None, None, :]
        kw = dict(scaling=D ** -0.5, window=win)
        cases = []
        if 6 in rows:   # width 4 needs d % 32 == 0
            cases += [(6, 8)] + [(6, 4)] * (D % 32 == 0)
        if 10 in rows:
            cases.append((10, 8))
        for row, width in cases:
            enc = mx8_encode if width == 8 else mx4_encode
            vals, cache = [], []
            for _ in range(2):
                x = torch.randn(B, KVH, L, D, generator=gen, device="cuda")
                c, e = enc(x, 16, zero_fill=1.0)
                cache += [torch.stack([t.transpose(-1, -2).contiguous()] * 2)
                          for t in (c, e)]
                vals.append(kq._decode_cache_block(cache[-2][1], cache[-1][1])
                            .transpose(-1, -2).to(torch.bfloat16)
                            .contiguous())   # SDPA's fused kernels
            nb = tokens * KVH * (cache[0].shape[-2] + D // 16) * 2 \
                + 2 * q.numel() * 4
            if row == 10:
                kh, vh = (torch.randn(B, KVH, 1, D, generator=gen,
                                      device="cuda") for _ in range(2))
                run = lambda: kq.decode_attention_quantized_write(
                    q, *cache, kh, vh, p, 1, **kw)
                nb += 2 * kh.numel() * 4 + 2 * B * KVH * (D + D // 16)
            else:
                run = lambda: kq.decode_attention_quantized(q, *cache, p, 1,
                                                            **kw)
            qb = q.to(torch.bfloat16)
            sdpa = lambda: F.scaled_dot_product_attention(
                qb, vals[0], vals[1], attn_mask=mask, enable_gqa=True)
            line = {"row": row, "width": width, "shape": what}
            try:
                line.update(ms=timer(run), bound_ms=nb / rate * 1e3,
                            sdpa_ms=timer(sdpa),
                            kernels_ms=launch_split(torch, run))
            except ValueError as e:   # a shape this checkout refuses
                line["refused"] = str(e)
            print(json.dumps(line), flush=True)
            del cache, vals


def _sdpa_ms(timer, q, cache, mask):
    """SDPA on the unquantized bf16 values of a (B, KVH, rows, L) cache."""
    import torch.nn.functional as F

    from lqer_tpu_torch.ops.kernels import quantized_decode as kq

    k, v = (kq._decode_cache_block(cache[i], cache[i + 1]).transpose(-1, -2)
            .to(torch.bfloat16).contiguous() for i in (0, 2))
    qb = q.to(torch.bfloat16)
    ms = timer(lambda: F.scaled_dot_product_attention(
        qb, k, v, attn_mask=mask[:, None, None, :], enable_gqa=True))
    del k, v
    return ms


def _encoded(gen, width, B, KVH, D, L):
    """K and V codes and exps (B, KVH, rows, L) of seeded values."""
    from lqer_tpu_torch.parallel.collectives import mx4_encode, mx8_encode

    enc = mx8_encode if width == 8 else mx4_encode
    out = []
    for _ in range(2):
        c, e = enc(torch.randn(B, KVH, L, D, generator=gen, device="cuda"),
                   16, zero_fill=1.0)
        out += [c.transpose(-1, -2).contiguous(),
                e.transpose(-1, -2).contiguous()]
    return out


LONG_POS = [64, 511, 512, 4095, 12288, 20001, 28671, 32767]
POS_16K = [min(x, 16383) for x in LONG_POS]
# (rows, shape, slots, kv heads, n_rep, d, L, positions, code widths) of
# rows 7 and 9: the one-pass and the streaming staged kernel on the same
# shapes at L = 2048, 16384 and 32768
STAGED_SHAPES = (
    ((7, 9), "Llama", 8, 32, 1, 128, 2048, DECODE_SHAPES[0][6], (8, 4)),
    ((7, 9), "OPT-2.7b", 8, 32, 1, 80, 2048, DECODE_SHAPES[0][6], (8,)),
    ((7, 9), "n_rep 2, d 64", 8, 16, 2, 64, 32768, LONG_POS, (8,)),
    ((7, 9), "L 16384", 8, 32, 1, 128, 16384, POS_16K, (8,)),
    ((7, 9), "long", 8, 32, 1, 128, 32768, LONG_POS, (8, 4)))


def _staged(timer, launch_split, gen, rows, rate, cpbs):
    """Rows 7 and 9: the main cache below flushed = pos // 32 * 32 and the
    ring's lanes from flushed to pos; row 9 also at each span of
    ``cpbs``."""
    from lqer_tpu_torch.ops.kernels import decode_attention as k3
    from lqer_tpu_torch.ops.kernels import streaming_decode as ks

    cases = [(row, *shape) for which, *shape in STAGED_SHAPES
             for row in which if row in rows]
    for row, what, B, KVH, nrep, D, L, pos, widths in cases:
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        fl = p // 32 * 32
        q = torch.randn(B, KVH * nrep, 1, D, generator=gen, device="cuda")
        kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
                  for _ in range(2))
        held = int(fl.sum()) + int((p - fl + 1).sum())
        mask = torch.arange(L, device="cuda")[None, :] <= p[:, None].long()
        fn = (k3.decode_attention_quantized_staged if row == 7
              else ks.decode_attention_quantized_streaming_staged)
        for width in widths:
            main = _encoded(gen, width, B, KVH, D, L)
            ring = [t[..., :64].contiguous() for t in
                    _encoded(gen, width, B, KVH, D, 64)]
            run = lambda: fn(q, *main, *ring, kh, vh, p, fl,
                             scaling=D ** -0.5)
            per_token = KVH * (main[0].shape[-2] + D // 16) * 2
            nb = held * per_token + 2 * q.numel() * 4 + 2 * kh.numel() * 4
            line = {"row": row, "width": width, "shape": what}
            try:
                line.update(ms=timer(run), bound_ms=nb / rate * 1e3,
                            sdpa_ms=_sdpa_ms(timer, q, main, mask),
                            kernels_ms=launch_split(torch, run))
                if row == 9:
                    line.update(_spans(timer, launch_split, run, cpbs,
                                       (B, KVH, L)))
            except ValueError as e:   # a shape this checkout refuses
                line["refused"] = str(e)
            print(json.dumps(line), flush=True)
            del main, ring


def _spans(timer, launch_split, run, cpbs, shape, window=None) -> dict:
    """A streaming row's own span and its times with each block walking
    each of ``cpbs`` chunks (``streaming_decode.chunks_per_block`` set)."""
    from lqer_tpu_torch.ops.kernels import streaming_decode as ks

    own = ks.chunks_per_block
    out = {"cpb": own(*shape, window)}
    for cpb in cpbs:
        ks.chunks_per_block = lambda *a, _c=cpb: _c
        out[f"cpb{cpb}_ms"] = timer(run)
        out[f"cpb{cpb}_kernels_ms"] = launch_split(torch, run)
    ks.chunks_per_block = own
    return out


def _row8(timer, launch_split, gen, rate, cpbs):
    """Row 8 at the long-context and Mistral shapes, and at L = 24576
    beside row 6 on the same inputs."""
    from lqer_tpu_torch.ops.kernels import quantized_decode as kq
    from lqer_tpu_torch.ops.kernels import streaming_decode as ks
    from lqer_tpu_torch.ops.kernels.decode_attention import key_mask

    mistral = [6000 + 26000 + i for i in (0, 1, 3, 7, 10, 13, 21, 30)]
    cases = [("long", 8, 32, 1, 32768, LONG_POS, 8, None),
             ("long", 8, 32, 1, 32768, LONG_POS, 4, None),
             ("Mistral", 8, 8, 4, 32768, mistral, 8, 4096),
             ("Mistral unwindowed", 8, 8, 4, 32768, mistral, 8, None),
             ("L 24576", 8, 32, 1, 24576,
              [min(x, 24575) for x in LONG_POS], 8, None),
             ("L 16384", 8, 32, 1, 16384, POS_16K, 8, None),
             ("L 2048", 8, 32, 1, 2048, DECODE_SHAPES[0][6], 8, None)]
    for what, B, KVH, nrep, L, pos, width, win in cases:
        D = 128
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        q = torch.randn(B, KVH * nrep, 1, D, generator=gen, device="cuda")
        cache = [t[None] for t in _encoded(gen, width, B, KVH, D, L)]
        lo = (p - win + 1).clamp(min=0) // 16 * 16 if win else 0
        tokens = int(((p + 16) // 16 * 16 - lo).sum())
        nb = tokens * KVH * (cache[0].shape[-2] + D // 16) * 2             + 2 * q.numel() * 4
        kw = dict(scaling=D ** -0.5, window=win)
        run = lambda: ks.decode_attention_quantized_streaming(
            q, *cache, p, 0, **kw)
        line = {"row": 8, "width": width, "shape": what, "ms": timer(run),
                "bound_ms": nb / rate * 1e3,
                "sdpa_ms": _sdpa_ms(timer, q, [t[0] for t in cache],
                                    key_mask(L, p, win)),
                "kernels_ms": launch_split(torch, run)}
        line.update(_spans(timer, launch_split, run, cpbs, (B, KVH, L),
                           win))
        line["row6_ms"] = timer(lambda: kq.decode_attention_quantized(
            q, *cache, p, 0, **kw))
        print(json.dumps(line), flush=True)
        del cache


def _row_writes(timer, launch_split, gen, rate, rows):
    """Rows 11 and 12 at ``chip_smoke.py``'s phase-3 shapes, bit-exact with
    their plain versions, and an empty launch."""
    from lqer_tpu_torch.ops.kernels import cache_write as kcw
    from lqer_tpu_torch.parallel.collectives import mx4_encode

    def cases():
        pos = torch.tensor(DECODE_SHAPES[0][6], dtype=torch.int32,
                           device="cuda")
        for what, NL, B, KVH, L, p in (
                ("Llama", 2, 8, 32, 2048, pos),
                ("Mistral", 2, 8, 8, 8192, pos + 6000 - 64)):
            for kind in (("bf16 rows", "mxint4 columns") if what == "Llama"
                         else ("bf16 rows",)):
                yield 11, what, kind, NL, B, KVH, L, p
        pos = torch.tensor([0, 17, 255, 1024, 1500, 2000, 2046, 2047],
                           dtype=torch.int32, device="cuda")
        for kind in ("mxint8 columns", "mxint4 columns", "bf16 rows"):
            yield 12, "Llama, 32 layers", kind, 32, 8, 32, 2048, pos

    D = 128
    for row, what, kind, NL, B, KVH, L, p in cases():
        if row not in rows:
            continue
        lead = (NL,) if row == 12 else ()
        if kind == "bf16 rows":
            arrays = [torch.zeros(NL, B, KVH, L, D, dtype=torch.bfloat16,
                                  device="cuda") for _ in range(2)]
            news = [torch.randn(*lead, B, KVH, 1, D, generator=gen,
                                device="cuda") for _ in range(2)]
        else:
            rws = [D if kind == "mxint8 columns" else D // 2, D // 16] * 2
            arrays = [torch.zeros(NL, B, KVH, r, L, dtype=torch.int8,
                                  device="cuda") for r in rws]
            if kind == "mxint4 columns" and row == 11:
                news = []
                for _ in range(2):
                    news += [t.transpose(-1, -2).contiguous()
                             for t in mx4_encode(torch.randn(
                                 B, KVH, 1, D, generator=gen, device="cuda"),
                                 16, zero_fill=1.0)]
            else:
                news = [torch.randint(-127, 128, (*lead, B, KVH, r, 1),
                                      generator=gen, device="cuda",
                                      dtype=torch.int8) for r in rws]
        mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
        if row == 11:
            run = lambda: kcw.write_kv_rows_stacked(tuple(mine), tuple(news),
                                                    1, p)
            kcw.write_rows_plain(tuple(theirs), tuple(news), 1, p)
        else:
            run = lambda: kcw.write_kv_rows_all_layers(tuple(mine),
                                                       tuple(news), p)
            kcw.write_rows_all_layers_plain(tuple(theirs), tuple(news), p)
        run()
        exact = all(torch.equal(a, b) for a, b in zip(mine, theirs))
        moved = sum(n.numel() * (n.element_size() + a.element_size())
                    for a, n in zip(arrays, news))
        print(json.dumps({
            "row": row, "shape": f"{what}, {kind}, B={B} KVH={KVH}",
            "bit_exact": exact, "ms": timer(run),
            "bound_ms": moved / rate * 1e3,
            "kernels_ms": launch_split(torch, run)}), flush=True)
        if not exact:
            raise AssertionError(f"row {row} {what} {kind}: bytes differ")
        del arrays, mine, theirs, news
    empty = lambda: torch.cuda._sleep(0)
    print(json.dumps({"row": "empty launch", "ms": timer(empty),
                      "kernels_ms": launch_split(torch, empty)}), flush=True)


def _rows_13_14(timer, launch_split, gen, rate, rows):
    """Rows 13 and 14, bit-exact with their plain versions."""
    from lqer_tpu_torch.ops.kernels import cache_write as kcw

    class ReadFlush:
        """Evicts L2 by reading the timer's 256 MB, so the lines it leaves
        are clean (the memset leaves them dirty, to be written back when
        the timed launch stores)."""

        def __init__(self, buf):
            self.buf = buf

        def zero_(self):
            self.buf.sum()

    def report(row, what, run, plain, arrays, moved):
        mine, theirs = [a.clone() for a in arrays], [a.clone() for a in arrays]
        run(mine)
        plain(theirs)
        exact = all(torch.equal(a, b) for a, b in zip(mine, theirs))
        del theirs
        line = {"row": row, "shape": what, "bit_exact": exact,
                "ms": timer(lambda: run(mine)),
                "bound_ms": moved / rate * 1e3,
                "kernels_ms": launch_split(torch, lambda: run(mine))}
        buf, timer.flush = timer.flush, ReadFlush(timer.flush)
        line["ms_l2_clean"] = timer(lambda: run(mine))
        timer.flush = buf
        print(json.dumps(line), flush=True)
        if not exact:
            raise AssertionError(f"row {row} {what}: bytes differ")

    D = 128
    mistral = [32000 + i for i in (0, 1, 3, 7, 10, 13, 21, 30)]
    for what, B, KVH, L, pos, view in (
            ("Llama, 8 slots", 8, 32, 32768, LONG_POS, False),
            # the same stores over a cache 16 times smaller
            ("Llama, 8 slots", 8, 32, 2048, DECODE_SHAPES[0][6], False),
            ("Llama long-context step, 4 slots", 4, 32, 32768,
             [32000, 32001, 32002, 32003], False),
            ("Llama long-context step, 4 slots, K and V views of q|k|v", 4,
             32, 32768, [32000, 32001, 32002, 32003], True),
            ("Mistral, 8 kv heads", 8, 8, 32768, mistral, False)):
        if 13 not in rows:
            break
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        arrays = [torch.zeros(2, B, KVH, r, L, dtype=torch.int8,
                              device="cuda") for r in (D, D // 16) * 2]
        if view:
            qkv = torch.randn(B, 1, 3 * KVH * D, generator=gen, device="cuda")
            kh, vh = (qkv[..., i * KVH * D:(i + 1) * KVH * D]
                      .reshape(B, 1, KVH, D).transpose(1, 2) for i in (1, 2))
        else:
            kh, vh = (torch.randn(B, KVH, 1, D, generator=gen, device="cuda")
                      for _ in range(2))
        report(13, f"{what}, B={B} KVH={KVH} L={L}",
               lambda a: kcw.write_kv_tokens_fused(tuple(a), kh, vh, 1, p),
               lambda a: kcw.encode_write_plain(tuple(a), kh, vh, 1, p),
               arrays, 2 * kh.numel() * 4 + 2 * B * KVH * (D + D // 16))
        del arrays
    if 14 not in rows:
        return
    NL, B, KVH, L, SW = 32, 8, 32, 2048, 64
    rws = (D, D // 16) * 2
    mains = [torch.randint(-127, 128, (NL, B, KVH, r, L), generator=gen,
                           device="cuda", dtype=torch.int8) for r in rws]
    rings = [torch.randint(-127, 128, (NL, B, KVH, r, SW), generator=gen,
                           device="cuda", dtype=torch.int8) for r in rws]
    fl = torch.tensor([0, 32, 64, 96, 1024, 1984, 1984, 512],
                      dtype=torch.int32, device="cuda")
    for what, nf in (("every span 32", fl + 32),
                     ("every span 64", (fl + 64).clamp(max=L)),
                     ("one slot's span 32", fl + 32 * (torch.arange(
                         B, device="cuda") == 2).to(torch.int32))):
        moved = 2 * NL * KVH * sum(rws) * int((nf - fl).sum())
        report(14, f"{what}, NL={NL} B={B} KVH={KVH} L={L}",
               lambda a: kcw.flush_stage_to_main(tuple(a), tuple(rings),
                                                 fl, nf),
               lambda a: kcw.flush_plain(tuple(a), tuple(rings), fl, nf),
               mains, moved)
        torch.cuda.empty_cache()
    # the same rows' strided bytes through PyTorch's copy: tokens 0..31 of
    # every row of the four arrays from the rings' first 32 lanes (every
    # span 32, but one span for all slots)
    dst = [m.view(-1, L)[:, :32] for m in mains]
    src = [r.view(-1, SW)[:, :32] for r in rings]

    def strided():
        for d, r in zip(dst, src):
            d.copy_(r)

    print(json.dumps({
        "row": "14 yardstick", "shape": "torch copy_ of 32 bytes of each "
        f"row, NL={NL} B={B} KVH={KVH} L={L}", "ms": timer(strided),
        "bound_ms": 2 * sum(d.numel() for d in dst) / rate * 1e3,
        "kernels_ms": launch_split(torch, strided)}), flush=True)


def _row4(timer, launch_split, gen):
    from lqer_tpu_torch.ops.kernels import attention as k2
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer
    from lqer_tpu_torch.parallel.collectives import mx8_decode, mx8_encode

    D = 128
    for BH, S in ((256, 64), (32, 2048)):
        q = block_fp_quantizer(
            torch.randn(BH, S, D, generator=gen, device="cuda"), width=8,
            exponent_width=8, block_size=[1, 16],
            skip_first_dim=True).to(torch.bfloat16)
        k, v = (mx8_decode(*mx8_encode(torch.randn(
            BH, S, D, generator=gen, device="cuda"), 16, 1.0), 16,
            torch.bfloat16) for _ in range(2))
        run = lambda: k2.quantized_attention(q, k, v, scale=D ** -0.5)
        print(json.dumps({
            "row": 4, "shape": f"{BH // 32} x {S} tokens", "ms": timer(run),
            "kernels_ms": launch_split(torch, run)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 5, 6, 10],
                    choices=range(4, 15))
    ap.add_argument("--cpb", type=int, nargs="*", default=[],
                    help="rows 8 and 9 also with each block walking this "
                    "many chunks")
    args = ap.parse_args()
    rows = set(args.rows)
    if not torch.cuda.is_available():
        print("bench_attention_parts: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import Timer, card_line, launch_split, peak_rates

    print(f"card: {card_line()}", flush=True)
    rate = peak_rates(torch.cuda.get_device_name(0))[0]
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if 5 in rows:
        _row5(timer, launch_split, gen)
    if rows & {6, 10}:
        _rows_6_10(timer, launch_split, gen, rows)
    if rows & {7, 9}:
        _staged(timer, launch_split, gen, rows, rate, args.cpb)
    if 8 in rows:
        _row8(timer, launch_split, gen, rate, args.cpb)
    if rows & {11, 12}:
        _row_writes(timer, launch_split, gen, rate, rows)
    if rows & {13, 14}:
        _rows_13_14(timer, launch_split, gen, rate, rows)
    if 4 in rows:
        _row4(timer, launch_split, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
