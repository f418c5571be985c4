"""Time the flash-attention forward kernel against
``F.scaled_dot_product_attention`` over a few shapes, on the card.

    python -m paddle_tpu_torch.tools.flash_fwd_sweep

Both run on the same bf16 inputs (numpy, seed 5) and are timed by
:func:`cuda_timing.cuda_ms` (20 launches held behind a spin kernel). For
each shape it prints one JSON line: both times and both rates in TFLOP/s
over the visible (query, key) pairs, ``4 * D`` operations each. Long and
short sequences, causal and not, separate a CTA's fixed cost (its fill
and drain) from the steady state of its kv loop. The last line is the
card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd
from paddle_tpu_torch.tools.cuda_timing import cuda_ms

#: (B, S, H, D, causal)
SHAPES = ((2, 2048, 32, 128, True), (2, 2048, 32, 128, False),
          (1, 8192, 16, 128, True), (1, 8192, 16, 128, False),
          (4, 2048, 32, 128, True), (8, 512, 32, 128, True),
          (2, 2048, 32, 64, True))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_sweep: CUDA is not available")
    rng = np.random.default_rng(5)
    for B, S, H, D, causal in SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D))
                                    .astype(np.float32))
                   .to("cuda").to(torch.bfloat16) for _ in range(3))
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal), 20)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 20)
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        ops = 4 * D * pairs
        print(json.dumps({
            "shape": [B, S, H, D], "causal": causal, "ms": ms,
            "sdpa_ms": sdpa_ms, "tflops": ops / ms / 1e9,
            "sdpa_tflops": ops / sdpa_ms / 1e9}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
