"""Time kernels B2 (paged decode) and B3 (paged append, bf16), or B4 (both
forms over int8 or int4 pools), over a sweep of shapes on the card, each
beside the card's bound for the same work.

    python -m paddle_tpu_torch.tools.paged_sweep [--tuning SPAN_POS:CTAS ...]
        [--quant int8|int4] [--batch 1,8,32] [--lens 512,2048,8192]
        [--groups 1,4,8] [--dims 64,128] [--out FILE]

Every shape has Hq 32 query heads (Hkv = 32 / G), block size 64 and
B sequences of the same length L (the table holds L + 1 positions). B2
takes one decode token per sequence; B3 takes two mixed steps at S 256: a
256-row chunk per sequence after its L cached positions, and one decode
row per sequence (the split across the padding tiles' CTAs). Each
``--tuning`` sets B2's span rule (``paged_attention.set_decode_tuning``:
positions a span covers at least, CTAs the grid aims at) and times B2 at
every shape again; the first is the rule the wrapper ships with unless
given. ``--quant`` quantizes the same pools with the port's rule and
times B4 in place of B2 and B3 (bounds over the stored bytes and the
scales). Each timing is the device time of 20 launches held behind a spin
kernel (:func:`cuda_timing.cuda_ms`). Prints one JSON line per timing
(ms, bound_ms, bound_by, ms / bound) and the card's name and power limit;
``--out`` also writes them to a file.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.tools.cuda_timing import cuda_ms

PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
HQ, BS, S, REPS = 32, 64, 256, 20


class Inputs:
    """Seeded inputs made on the card (pools of gigabytes would take
    minutes from numpy): unit-normal bf16 from a CUDA generator, tables
    from a numpy generator."""

    def __init__(self, seed, dev):
        self.dev = dev
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)

    def randn(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.dev) \
            .to(torch.bfloat16)


def _tables(rng, need, MB, dev):
    """Tables of shuffled physical blocks, ``need[b]`` per sequence, -1
    after; the pool has one block more (the scratch block)."""
    NB = sum(need) + 1
    it = iter(rng.permutation(NB - 1).tolist())
    t = np.full((len(need), MB), -1, np.int32)
    for b, n in enumerate(need):
        for j in range(n):
            t[b, j] = next(it)
    return torch.from_numpy(t).to(dev), NB


def decode_inputs(x, lens, Hq, Hkv, D, MB, bs=BS):
    """B2's arguments for sequences of ``lens`` cached tokens (``x``: an
    :class:`Inputs`)."""
    B, dev = len(lens), x.dev
    tables, NB = _tables(x.rng, [min(L // bs, MB - 1) + 1 for L in lens],
                         MB, dev)
    return (x.randn((B, Hq, D)), x.randn((NB, Hkv, bs, D)),
            x.randn((NB, Hkv, bs, D)), tables,
            torch.tensor(lens, dtype=torch.int32, device=dev),
            x.randn((B, Hkv, D)), x.randn((B, Hkv, D)))


def append_inputs(x, specs, Hq, Hkv, D, MB, bs=BS, S=S):
    """B3's arguments for (cached tokens, new rows) per sequence."""
    B, dev = len(specs), x.dev
    need = [0 if n == 0 else min((L + n - 1) // bs, MB - 1) + 1
            for L, n in specs]
    tables, NB = _tables(x.rng, need, MB, dev)
    i32 = torch.int32
    return (x.randn((B, S, Hq, D)), x.randn((NB, Hkv, bs, D)),
            x.randn((NB, Hkv, bs, D)), tables,
            torch.tensor([L for L, _ in specs], dtype=i32, device=dev),
            torch.tensor([n for _, n in specs], dtype=i32, device=dev),
            x.randn((B, S, Hkv, D)), x.randn((B, S, Hkv, D)))


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes)


def decode_bound(lens, Hq, Hkv, D, quant=None, bs=BS, wiped=()):
    """Every visible K/V row read once, q read, out written, the new rows
    read and written; 4 operations per (query head, key, dim). Quantized:
    the rows as stored plus each block's scales, and each rewritten last
    block's payload and scales written. A ``wiped`` sequence (an all -1
    table row) reads no history."""
    B = len(lens)
    live = [L for b, L in enumerate(lens) if b not in wiped]
    vis = sum(L + 1 for L in live)
    if quant is None:
        return bound(4 * Hq * D * vis,
                     2 * (2 * vis * Hkv * D + 2 * B * Hq * D
                          + 4 * B * Hkv * D))
    Dp = pa.kv_packed_dim(D, quant)
    blocks = sum(L // bs + 1 for L in live)
    return bound(4 * Hq * D * vis,
                 2 * vis * Hkv * Dp + 8 * blocks * Hkv + 2 * B * Hq * D
                 + 4 * B * Hkv * D + 2 * B * Hq * D
                 + 2 * (B * Hkv * bs * Dp + 4 * B * Hkv))


def append_bound(specs, Hq, Hkv, D, quant=None, bs=BS):
    """The history read once, the new K/V read and written once, q read
    and out written for the real rows; the visible pairs' products.
    Quantized: the history as stored plus its blocks' scales, the new
    rows read once, the window blocks' payload and scales written."""
    real = sum(n for _, n in specs)
    hist = sum(L for L, n in specs if n)
    pairs = sum(n * L + n * (n + 1) // 2 for L, n in specs)
    if quant is None:
        return bound(4 * Hq * D * pairs,
                     2 * (2 * hist * Hkv * D + 4 * real * Hkv * D
                          + 2 * real * Hq * D))
    Dp = pa.kv_packed_dim(D, quant)
    hist_blocks = sum(-(-L // bs) for L, n in specs if n)
    window = sum((L + n - 1) // bs - L // bs + 1 for L, n in specs if n)
    return bound(4 * Hq * D * pairs,
                 2 * hist * Hkv * Dp + 8 * hist_blocks * Hkv
                 + 4 * real * Hkv * D + 4 * real * Hq * D
                 + 2 * (window * Hkv * bs * Dp + 4 * window * Hkv))


def quantize_pools(kf, vf, quant):
    """bf16 K and V pools quantized with the port's rule: ``(k, v,
    k_scale, v_scale)``."""
    out = []
    for f in (kf.float(), vf.float()):
        sc = pa.kv_block_scale(f, quant, (2, 3))
        out.append((pa.kv_quantize(f, sc[..., None, None], quant), sc))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def quantize_args(args, k_at, quant):
    """A call's arguments with its bf16 pools (positions ``k_at``,
    ``k_at + 1``) quantized with the port's rule, and the keywords that
    name the scales."""
    if quant is None:
        return args, {}
    out = list(args)
    out[k_at], out[k_at + 1], ks, vs = quantize_pools(args[k_at],
                                                      args[k_at + 1], quant)
    return tuple(out), dict(k_scale=ks, v_scale=vs, quant=quant)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def ints(text):
    return [int(x) for x in text.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tuning", action="append",
                    help="SPAN_POS:CTAS for B2 (repeatable)")
    ap.add_argument("--quant", choices=["int8", "int4"],
                    help="time B4 over pools of this dtype")
    ap.add_argument("--batch", type=ints, default=[1, 8, 32])
    ap.add_argument("--lens", type=ints, default=[512, 2048, 8192])
    ap.add_argument("--groups", type=ints, default=[1, 4, 8])
    ap.add_argument("--dims", type=ints, default=[64, 128])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("paged_sweep: CUDA is not available")
    dev = torch.device("cuda")
    tunings = [tuple(int(x) for x in t.split(":")) for t in args.tuning or
               [f"{pa.DECODE_SPAN_POS}:{pa.DECODE_TARGET_CTAS}"]]
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    shapes = [(B, L, G, D) for D in args.dims for G in args.groups
              for L in args.lens for B in args.batch]
    for B, L, G, D in shapes:
        Hkv, MB = HQ // G, -(-(L + S) // BS)
        x = Inputs(B * 7 + L + G + D, dev)
        quant = args.quant
        dargs, kw = quantize_args(decode_inputs(x, [L] * B, HQ, Hkv, D, MB),
                                  1, quant)
        bd = decode_bound([L] * B, HQ, Hkv, D, quant)
        for span_pos, ctas in tunings:
            pa.set_decode_tuning(span_pos, ctas)
            cfg = pa.decode_launch_config(B, HQ, Hkv, D, BS, MB, quant)
            ms = cuda_ms(lambda: pa.paged_attention_decode(*dargs, **kw),
                         REPS)
            emit({"kernel": "paged_attention_decode", "quant": quant,
                  "B": B, "L": L, "G": G,
                  "D": D, "Hkv": Hkv, "MB": MB, "span_pos": span_pos,
                  "target_ctas": ctas, "span": cfg.span,
                  "splits": cfg.splits, "ms": ms, **bd,
                  "x_bound": ms / bd["bound_ms"]})
        del dargs
        pa.set_decode_tuning(*tunings[0])
        for form, n in (("chunk", S), ("decode_rows", 1)):
            specs = [(L, n)] * B
            aargs, kw = quantize_args(
                append_inputs(x, specs, HQ, Hkv, D, MB), 1, quant)
            ba = append_bound(specs, HQ, Hkv, D, quant)
            ms = cuda_ms(lambda: pa.paged_attention_append(*aargs, **kw),
                         REPS)
            emit({"kernel": "paged_attention_append", "quant": quant,
                  "form": form, "B": B,
                  "L": L, "q_len": n, "S": S, "G": G, "D": D, "Hkv": Hkv,
                  "MB": MB, "splits": pa.append_tile_splits(
                      L, n, S, G, BS, MB)[2], "ms": ms, **ba,
                  "x_bound": ms / ba["bound_ms"]})
            del aargs
        torch.cuda.empty_cache()
    emit({"card": card()})
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)


if __name__ == "__main__":
    main()
