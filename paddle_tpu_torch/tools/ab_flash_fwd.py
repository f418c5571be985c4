"""Time the flash-attention forward kernel (dropout 0) of two checkouts in
one process, alternating, on the card.

    python -m paddle_tpu_torch.tools.ab_flash_fwd OTHER_ROOT [--rounds 3]
        [--shape B,S,H,D ...]

``OTHER_ROOT`` holds another checkout's ``paddle_tpu_torch`` (for example
``git archive <commit> paddle_tpu_torch`` unpacked into an ignored
directory). Both packages load side by side under their own module names
and build their own kernels; both run on the same bf16 inputs, causal, at
each ``--shape`` (default ``2,2048,32,128``, the forward timing shape of
``chip_smoke.py``, and ``4,2048,32,128``, the training shape). Each round
times other, this, this, other; each timing is the device time of 20
launches held behind a spin kernel (:func:`cuda_timing.cuda_ms`), so the
host's pace does not enter it. Prints one JSON line per timing, then per
shape a summary with each side's median, the largest difference between
the two outputs, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch.tools.cuda_timing import cuda_ms

THIS_ROOT = Path(__file__).resolve().parents[2]
SHAPES = ((2, 2048, 32, 128), (4, 2048, 32, 128))
REPS = 20


def load_flash(root: Path, alias: str):
    """``ops.kernels.flash_attention`` of the ``paddle_tpu_torch`` under
    ``root``, imported as package ``alias``."""
    init = root / "paddle_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.kernels.flash_attention")


def shape_arg(text):
    shape = tuple(int(x) for x in text.split(","))
    if len(shape) != 4:
        raise argparse.ArgumentTypeError(f"want B,S,H,D, got {text!r}")
    return shape


def ab(sides, shape, rounds, card):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to("cuda").to(torch.bfloat16) for _ in range(3))
    outs = {name: mod.flash_attention_fwd(q, k, v, True)[0]
            for name, mod in sides.items()}
    diff = (outs["this"].float() - outs["other"].float()).abs().max().item()
    times = {name: [] for name in sides}
    for r in range(rounds):
        for name in ("other", "this", "this", "other"):
            fwd = sides[name].flash_attention_fwd
            ms = cuda_ms(lambda: fwd(q, k, v, True), REPS)
            times[name].append(ms)
            print(json.dumps({"shape": list(shape), "round": r, "side": name,
                              "ms": ms}), flush=True)
    print(json.dumps({
        "shape": list(shape), "causal": True, "dropout_p": 0.0,
        "median_ms": {n: statistics.median(t) for n, t in times.items()},
        "max_abs_out_diff": diff, "card": card}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_root", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--shape", type=shape_arg, action="append",
                    help="B,S,H,D (repeatable; default both of SHAPES)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash_fwd: CUDA is not available")
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
