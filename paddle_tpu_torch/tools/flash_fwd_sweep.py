"""Time the flash-attention forward kernel against
``F.scaled_dot_product_attention`` over a few shapes, on the card; with
``--backward``, the backward instead.

    python -m paddle_tpu_torch.tools.flash_fwd_sweep [--backward]

Both run on the same bf16 inputs (numpy, seed 5) and are timed by
:func:`cuda_timing.cuda_ms` (20 launches held behind a spin kernel). For
each shape it prints one JSON line: both times and both rates in TFLOP/s
over the visible (query, key) pairs, ``4 * D`` operations each (two
products) forward, ``10 * D`` (the five the backward needs) backward. The
backward line times the dK/dV and dQ kernels apart, and the whole
backward (``attention_delta``, then both kernels) against the library's:
the autograd backward of ``scaled_dot_product_attention`` under its flash
backend, on the same dO. Long and short sequences, causal and not,
separate a CTA's fixed cost (its fill and drain) from the steady state of
its loop. The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.kernels.flash_attention import (
    attention_delta, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_fwd)
from paddle_tpu_torch.tools.cuda_timing import cuda_ms

#: (B, S, H, D, causal)
SHAPES = ((2, 2048, 32, 128, True), (2, 2048, 32, 128, False),
          (1, 8192, 16, 128, True), (1, 8192, 16, 128, False),
          (4, 2048, 32, 128, True), (8, 512, 32, 128, True),
          (2, 2048, 32, 64, True))


def forward_line(q, k, v, causal, pairs, D):
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal), 20)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), 20)
    ops = 4 * D * pairs
    return {"ms": ms, "sdpa_ms": sdpa_ms, "tflops": ops / ms / 1e9,
            "sdpa_tflops": ops / sdpa_ms / 1e9}


def backward_line(q, k, v, do, causal, pairs, D):
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out, lse = flash_attention_fwd(q, k, v, causal)
    args = (q, k, v, do, lse, attention_delta(out, do), causal)
    dkv_ms = cuda_ms(lambda: flash_attention_bwd_dkv(*args), 20)
    dq_ms = cuda_ms(lambda: flash_attention_bwd_dq(*args), 20)
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, causal),
                 20)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
    dot = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), 20)
    ops = 10 * D * pairs
    return {"dkv_ms": dkv_ms, "dq_ms": dq_ms, "ms": ms, "library_ms": lib_ms,
            "tflops": ops / ms / 1e9, "library_tflops": ops / lib_ms / 1e9}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backward", action="store_true",
                    help="time the backward against the library's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_sweep: CUDA is not available")
    rng = np.random.default_rng(5)
    for B, S, H, D, causal in SHAPES:
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, H, D))
                                        .astype(np.float32))
                       .to("cuda").to(torch.bfloat16) for _ in range(4))
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        line = backward_line(q, k, v, do, causal, pairs, D) \
            if args.backward else forward_line(q, k, v, causal, pairs, D)
        print(json.dumps({"shape": [B, S, H, D], "causal": causal, **line}),
              flush=True)
        del q, k, v, do
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
