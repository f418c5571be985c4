"""Time kernel B8 (the weight-only int4 GEMM) of two checkouts in one
process, alternating, on the card.

    python -m paddle_tpu_torch.tools.ab_int4 OTHER_ROOT [--rounds 2]
        [--rows 8 --rows 32 ...]

``OTHER_ROOT`` holds another checkout's ``paddle_tpu_torch`` (for example
``git archive <commit> paddle_tpu_torch`` unpacked into an ignored
directory); both packages load side by side
(:func:`ab_flash_fwd.load_flash`) and build their own kernels. Both sides
take the same inputs, made on the card from seeds: a packed int4 weight of
random bytes with float32 scales in [1e-3, 2e-2) at each of the four
Llama-2-7B shapes (q/k/v/o ``[4096, 4096]``, fused q/k/v ``[4096,
12288]``, gate/up ``[4096, 11264]``, down ``[11264, 4096]``), and bf16 x
of ``--rows`` rows (default 8, 32 and 128). Each launch takes another copy
of the weight, so none finds it in the 50 MB L2 (a decode step reads each
layer's weights once), as ``chip_smoke.py``'s ``time_int4_matmul`` does.
Each round times other, this, this, other (so two rounds give four
timings a side); each timing is the device time of 50 launches held
behind a spin kernel (:func:`cuda_timing.cuda_ms`), beside the host's µs
per call over 200 calls (:func:`cuda_timing.host_us`: checks, ctypes, the
launch). Prints one JSON line per timing, then per (rows, shape) each
side's medians, the largest difference between the two sides' outputs
and each side's error against the plain version (within one bf16 step of
the output's largest magnitude), then per row count one decoder layer's
seven projections summed, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch.tools.ab_flash_fwd import THIS_ROOT, load_flash
from paddle_tpu_torch.tools.cuda_timing import cuda_ms, host_us
from paddle_tpu_torch.tools.paged_sweep import card

REPS, HOST_CALLS = 50, 200
SHAPES = ((4096, 4096), (4096, 12288), (4096, 11264), (11264, 4096))
# one decoder layer's projections (q, k, v, o; gate, up; down)
LAYER = ((4096, 4096),) * 4 + ((4096, 11264),) * 2 + ((11264, 4096),)
L2_BYTES = 120_000_000      # weight copies rotated per shape: > the L2


def load_int4(root: Path, alias: str):
    """``ops.kernels.int4_matmul`` of the package under ``root``."""
    load_flash(root, alias)
    return importlib.import_module(f"{alias}.ops.kernels.int4_matmul")


def inputs(dev, n_in, n_out, rows, seed):
    """Weight copies (enough to exceed the L2), scales and bf16 x."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    packed = torch.randint(-128, 128, (n_in // 2, n_out), generator=gen,
                           device=dev, dtype=torch.int8)
    scales = torch.rand(n_out, generator=gen, device=dev) * 0.019 + 1e-3
    x = torch.randn((rows, n_in), generator=gen, device=dev) \
        .to(torch.bfloat16)
    copies = max(2, -(-L2_BYTES // packed.numel()))
    return [packed] + [packed.clone() for _ in range(copies - 1)], scales, x


def bf16_step(ref):
    return 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)


def ab(sides, rows, shape, rounds, card_name, seed):
    n_in, n_out = shape
    ws, scales, x = inputs(torch.device("cuda"), n_in, n_out, rows, seed)
    ref = sides["this"].int4_matmul_plain(x, ws[0], scales)
    outs = {s: m.int4_matmul(x, ws[0], scales) for s, m in sides.items()}
    errs = {s: (o.float() - ref.float()).abs().max().item()
            for s, o in outs.items()}
    diff = (outs["this"].float() - outs["other"].float()).abs().max().item()

    def call(mod):
        it = iter(range(1 << 30))
        return lambda: mod.int4_matmul(x, ws[next(it) % len(ws)], scales)
    times = {s: [] for s in sides}
    hosts = {s: [] for s in sides}
    for r in range(rounds):
        for side in ("other", "this", "this", "other"):
            fn = call(sides[side])
            ms, us = cuda_ms(fn, REPS), host_us(fn, HOST_CALLS)
            times[side].append(ms)
            hosts[side].append(us)
            print(json.dumps({"rows": rows, "shape": list(shape), "round": r,
                              "side": side, "ms": ms,
                              "host_us_per_call": us}), flush=True)
    med = {s: statistics.median(t) for s, t in times.items()}
    summary = {"rows": rows, "shape": list(shape), "median_ms": med,
               "median_host_us_per_call": {
                   s: statistics.median(t) for s, t in hosts.items()},
               "other_over_this": med["other"] / med["this"],
               "max_abs_out_diff": diff, "max_abs_err_vs_plain": errs,
               "tol": bf16_step(ref), "card": card_name}
    print(json.dumps(summary), flush=True)
    del ws
    torch.cuda.empty_cache()
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_root", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--rows", type=int, action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_int4: CUDA is not available")
    sides = {"other": load_int4(args.other_root.resolve(), "ptt_other"),
             "this": load_int4(THIS_ROOT, "ptt_this")}
    card_name = card()
    for rows in args.rows or (8, 32, 128):
        res = {shape: ab(sides, rows, shape, args.rounds, card_name, i)
               for i, shape in enumerate(SHAPES)}
        layer = {s: sum(res[sh]["median_ms"][s] for sh in LAYER)
                 for s in sides}
        print(json.dumps({"rows": rows, "layer_shapes": [list(s) for s in
                                                         LAYER],
                          "layer_ms": layer,
                          "other_over_this": layer["other"] / layer["this"],
                          "slower_anywhere": any(
                              r["median_ms"]["this"] > r["median_ms"]["other"]
                              for r in res.values()),
                          "card": card_name}), flush=True)


if __name__ == "__main__":
    main()
