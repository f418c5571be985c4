"""Peak device memory of a ``TrainStep`` at Llama-2-7B widths, by depth,
for each optimizer the reference's bench line offers, with and without
recompute, and the deepest model that fits on the card from those peaks.

    python -m paddle_tpu_torch.tools.train_memory [--depths 4 8]

Each cell builds ``LlamaConfig.llama2_7b(dtype="bfloat16")`` cut to each
depth, one ``[4, 2048]`` batch made as ``chip_smoke.py`` makes it, the
optimizer's slots (``TrainStep`` builds them up front), and runs two
steps; its peak is ``torch.cuda.max_memory_allocated()`` over those
steps. Once the peak falls where every grad is alive (the end of the
backward), it grows linearly with depth: every layer adds the same
parameters, grads, slots and saved activations. Two depths give the bytes
per layer and the rest, and the deepest model that fits is the largest
depth whose predicted peak stays within the memory free on the card
before the first cell. At 2 layers the peak can fall elsewhere (the loss
head's activations outweigh the layers' grads), which flattens the slope:
measure at 4 layers and more. Optimizers (``bench.py:2798-2819``):

- ``fp32_masters``: ``AdamW(multi_precision=True)``, float32 masters and
  moments (the fused AdamW kernel);
- ``bf16_moments``: the same with ``adamw_bf16_moments`` (the bench's
  default; the plain chain);
- ``sr``: ``AdamW(multi_precision=False)`` with
  ``adamw_stochastic_rounding`` and bf16 moments (``BENCH_OPT=adamw_sr``;
  the stochastic-rounding kernel).

Prints one JSON line per cell, then one with the table and the card's name
and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess

import numpy as np
import torch

from ..core.flags import set_flags
from ..jit import TrainStep
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..optimizer import AdamW

B, S = 4, 2048
OPTIMIZERS = {
    "fp32_masters": (True, {}),
    "bf16_moments": (True, {"adamw_bf16_moments": True}),
    "sr": (False, {"adamw_stochastic_rounding": True,
                   "adamw_bf16_moments": True}),
}


def _loss(m, ids, labels):
    return m(ids, labels=labels)[0]


def peak_bytes(layers, optimizer, recompute, dev):
    """Peak allocated bytes over two ``TrainStep`` calls of one cell."""
    multi_precision, flags = OPTIMIZERS[optimizer]
    set_flags(flags)
    try:
        cfg = LlamaConfig.llama2_7b(dtype="bfloat16", num_hidden_layers=layers,
                                    max_position_embeddings=S,
                                    use_recompute=recompute)
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
        model.train()
        opt = AdamW(learning_rate=3e-4, weight_decay=0.01,
                    multi_precision=multi_precision,
                    parameters=model.named_parameters())
        step = TrainStep(model, _loss, opt)
        rng = np.random.default_rng(0)
        ids, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     size=(B, S))).to(dev)
                       for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            loss = float(step(ids, labels))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        set_flags({k: False for k in flags})
    del model, opt, step, ids, labels
    gc.collect()
    torch.cuda.empty_cache()
    return peak, loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", type=int, nargs=2, default=[4, 8])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_memory: CUDA is not available")
    dev = torch.device("cuda")
    free, total = torch.cuda.mem_get_info()
    lo, hi = args.depths
    table = []
    for optimizer in OPTIMIZERS:
        for recompute in (False, True):
            peaks = {}
            for layers in (lo, hi):
                peaks[layers], loss = peak_bytes(layers, optimizer,
                                                 recompute, dev)
                print(json.dumps({"optimizer": optimizer,
                                  "recompute": recompute, "layers": layers,
                                  "peak_gb": peaks[layers] / 1e9,
                                  "loss": loss}), flush=True)
            per_layer = (peaks[hi] - peaks[lo]) / (hi - lo)
            rest = peaks[lo] - lo * per_layer
            table.append({"optimizer": optimizer, "recompute": recompute,
                          "gb_per_layer": per_layer / 1e9,
                          "gb_rest": rest / 1e9,
                          "deepest_fit": int((free - rest) // per_layer),
                          "peak_gb_at_32": (rest + 32 * per_layer) / 1e9})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"batch": [B, S], "depths": [lo, hi],
                      "free_gb": free / 1e9, "total_gb": total / 1e9,
                      "table": table, "card": card.splitlines()[0]}),
          flush=True)


if __name__ == "__main__":
    main()
