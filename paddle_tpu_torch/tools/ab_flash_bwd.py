"""Time the flash-attention backward kernels (dK/dV and dQ, dropout 0) of
two checkouts in one process, alternating, on the card.

    python -m paddle_tpu_torch.tools.ab_flash_bwd OTHER_ROOT [--rounds 3]
        [--shape B,S,H,D ...]

``OTHER_ROOT`` holds another checkout's ``paddle_tpu_torch`` (for example
``git archive <commit> paddle_tpu_torch`` unpacked into an ignored
directory); both packages load side by side (:func:`ab_flash_fwd.load_flash`)
and build their own kernels. Both take the same bf16 q, k, v, dO and the
same ``lse`` and ``delta`` (from this checkout's forward), causal, at each
``--shape`` (default ``2,2048,32,128`` and ``4,2048,32,128``, the training
shape of ``chip_smoke.py``). Each round times other, this, this, other;
each timing is the device time of 10 launches held behind a spin kernel
(:func:`cuda_timing.cuda_ms`). Prints one JSON line per timing, then per
shape each side's medians, the largest differences between the two sides'
dq, dk and dv, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch.tools.ab_flash_fwd import (SHAPES, THIS_ROOT,
                                                 load_flash, shape_arg)
from paddle_tpu_torch.tools.cuda_timing import cuda_ms

REPS = 10
PARTS = ("dkv", "dq")


def ab(sides, shape, rounds, card):
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32))
                   .to("cuda").to(torch.bfloat16) for _ in range(4))
    this = sides["this"]
    out, lse = this.flash_attention_fwd(q, k, v, True)
    args = (q, k, v, do, lse, this.attention_delta(out, do), True)
    calls = {name: {"dkv": lambda m=mod: m.flash_attention_bwd_dkv(*args),
                    "dq": lambda m=mod: m.flash_attention_bwd_dq(*args)}
             for name, mod in sides.items()}
    grads = {name: (*c["dkv"](), c["dq"]()) for name, c in calls.items()}
    diff = {g: (a.float() - b.float()).abs().max().item()
            for g, a, b in zip(("dk", "dv", "dq"), grads["this"],
                               grads["other"])}
    times = {name: {p: [] for p in PARTS} for name in sides}
    for r in range(rounds):
        for name in ("other", "this", "this", "other"):
            for part in PARTS:
                ms = cuda_ms(calls[name][part], REPS)
                times[name][part].append(ms)
                print(json.dumps({"shape": list(shape), "round": r,
                                  "side": name, "kernel": part, "ms": ms}),
                      flush=True)
    print(json.dumps({
        "shape": list(shape), "causal": True, "dropout_p": 0.0,
        "median_ms": {n: {p: statistics.median(t[p]) for p in PARTS}
                      for n, t in times.items()},
        "max_abs_grad_diff": diff, "card": card}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_root", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--shape", type=shape_arg, action="append",
                    help="B,S,H,D (repeatable; default both of SHAPES)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash_bwd: CUDA is not available")
    sides = {"other": load_flash(args.other_root.resolve(), "ptt_other"),
             "this": load_flash(THIS_ROOT, "ptt_this")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    for shape in args.shape or SHAPES:
        ab(sides, shape, args.rounds, card)


if __name__ == "__main__":
    main()
