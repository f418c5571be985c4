"""Time kernels B2 and B3 (paged decode and append, bf16) and B4 (both
over int8 and int4 pools) of two checkouts in one process, alternating,
on the card.

    python -m paddle_tpu_torch.tools.ab_paged OTHER_ROOT [--rounds 3]

``OTHER_ROOT`` holds another checkout's ``paddle_tpu_torch`` (for example
``git archive <commit> paddle_tpu_torch`` unpacked into an ignored
directory); both packages load side by side (:func:`ab_flash_fwd.load_flash`)
and build their own kernels. Both sides take the same bf16 inputs, made on
the card from seeds (:class:`paged_sweep.Inputs`), and each call gets its
own copy of the pools. Shapes: ``chip_smoke.py``'s timing shapes (B2: 8
sequences of lengths 1-2000, Hkv 32 and 8; B3: its mixed step of chunks
and decode rows at S 256, Hkv 32 and 8), then two long ones (B2: 32
sequences of 8,192 at G 4; B3: 8 decode rows over 8,000 at G 1), then
B4-decode and B4-append (int8 and int4 pools) at B2's and B3's smoke
shapes, whose payload and scales must agree bit for bit (their outputs
within the smoke's tolerances when the two designs round differently).
Each round times other, this, this, other; each timing is the device time
of 20
launches held behind a spin kernel (:func:`cuda_timing.cuda_ms`), beside
the host's µs per call over 200 calls (:func:`cuda_timing.host_us`:
checks, ctypes, the launch; the host is shared, so each side's least
figure is printed beside its median). Prints one JSON line per
timing, then per shape each side's medians, the largest
difference between the two sides' outputs, whether the tensors they
update (pools, scales) agree bit for bit, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
from pathlib import Path

import torch

from paddle_tpu_torch.tools.ab_flash_fwd import THIS_ROOT, load_flash
from paddle_tpu_torch.tools.cuda_timing import cuda_ms, host_us
from paddle_tpu_torch.tools.paged_sweep import (Inputs, append_inputs, card,
                                                decode_inputs, quantize_pools)

REPS, HOST_CALLS = 20, 200
SMOKE_LENS = [1, 63, 64, 1024, 1500, 2000, 777, 500]
SMOKE_SPECS = [(0, 256), (100, 256), (512, 37), (1024, 256), (63, 1),
               (64, 1), (1999, 1), (700, 0)]


def load_paged(root: Path, alias: str):
    """``ops.kernels.paged_attention`` of the package under ``root``."""
    load_flash(root, alias)
    return importlib.import_module(f"{alias}.ops.kernels.paged_attention")


def quant_append_inputs(x, quant, specs=SMOKE_SPECS, Hkv=32, MB=32):
    """B4-append's arguments (at B3's smoke shape by default): the bf16
    pools quantized with the port's rule, their scales beside them."""
    q, kf, vf, t, ln, ql, nk, nv = append_inputs(x, specs, 32, Hkv, 128, MB)
    kp, vp, ks, vs = quantize_pools(kf, vf, quant)
    return (q, kp, vp, t, ln, ql, nk, nv, None, ks, vs, quant)


def quant_decode_inputs(x, quant, lens=SMOKE_LENS, Hkv=32, MB=32):
    """B4-decode's arguments (at B2's smoke shape by default)."""
    q, kf, vf, t, ln, nk, nv = decode_inputs(x, lens, 32, Hkv, 128, MB)
    kp, vp, ks, vs = quantize_pools(kf, vf, quant)
    return (q, kp, vp, t, ln, nk, nv, None, ks, vs, quant)


def cases(dev):
    """(name, kernel, args, positions of the tensors a call updates)."""
    pools = (1, 2)
    out = []
    for Hkv in (32, 8):
        out.append((f"decode_smoke_Hkv{Hkv}", "paged_attention_decode",
                    decode_inputs(Inputs(6, dev), SMOKE_LENS, 32, Hkv, 128,
                                  32), pools))
    for Hkv in (32, 8):
        out.append((f"append_smoke_Hkv{Hkv}", "paged_attention_append",
                    append_inputs(Inputs(8, dev), SMOKE_SPECS, 32, Hkv, 128,
                                  32), pools))
    out.append(("decode_B32_L8192_G4", "paged_attention_decode",
                decode_inputs(Inputs(9, dev), [8192] * 32, 32, 8, 128, 132),
                pools))
    out.append(("append_decode_rows_B8_L8000_G1", "paged_attention_append",
                append_inputs(Inputs(10, dev), [(8000, 1)] * 8, 32, 32, 128,
                              132), pools))
    for quant in ("int8", "int4"):
        for Hkv in (32, 8):
            out.append((f"decode_smoke_{quant}_Hkv{Hkv}",
                        "paged_attention_decode",
                        quant_decode_inputs(Inputs(12, dev), quant, Hkv=Hkv),
                        (1, 2, 8, 9)))
            out.append((f"append_smoke_{quant}_Hkv{Hkv}",
                        "paged_attention_append",
                        quant_append_inputs(Inputs(11, dev), quant, Hkv=Hkv),
                        (1, 2, 9, 10)))
        out.append((f"decode_B32_L8192_G4_{quant}", "paged_attention_decode",
                    quant_decode_inputs(Inputs(13, dev), quant, [8192] * 32,
                                        8, 132), (1, 2, 8, 9)))
    return out


def ab(sides, name, kernel, args, updated, rounds, card_name):
    """Both sides on their own copies of the tensors a call updates."""
    def call(mod):
        rest = list(args)
        for i in updated:
            rest[i] = args[i].clone()
        fn = getattr(mod, kernel)
        return lambda: fn(*rest), rest

    def first(out):
        return out[0] if isinstance(out, tuple) else out
    res = {}
    for side, mod in sides.items():
        fn, rest = call(mod)
        res[side] = (first(fn()), *(rest[i] for i in updated))
    diff = (res["this"][0].float() - res["other"][0].float()).abs().max()
    # the scratch block (a -1 target's parking place) is not compared
    pools_equal = all(torch.equal(a[:-1], b[:-1]) for a, b in
                      zip(res["this"][1:], res["other"][1:]))
    out_equal = torch.equal(res["this"][0], res["other"][0])
    times = {side: [] for side in sides}
    hosts = {side: [] for side in sides}
    for r in range(rounds):
        for side in ("other", "this", "this", "other"):
            fn, _ = call(sides[side])
            ms, us = cuda_ms(fn, REPS), host_us(fn, HOST_CALLS)
            times[side].append(ms)
            hosts[side].append(us)
            print(json.dumps({"case": name, "round": r, "side": side,
                              "ms": ms, "host_us_per_call": us}), flush=True)
    med = {s: statistics.median(t) for s, t in times.items()}
    print(json.dumps({"case": name, "kernel": kernel, "median_ms": med,
                      "median_host_us_per_call": {
                          s: statistics.median(t) for s, t in hosts.items()},
                      "min_host_us_per_call": {
                          s: min(t) for s, t in hosts.items()},
                      "other_over_this": med["other"] / med["this"],
                      "max_abs_out_diff": diff.item(),
                      "out_bit_identical": out_equal,
                      "updated_tensors_bit_identical": pools_equal,
                      "card": card_name}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_root", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_paged: CUDA is not available")
    sides = {"other": load_paged(args.other_root.resolve(), "ptt_other"),
             "this": load_paged(THIS_ROOT, "ptt_this")}
    card_name = card()
    for name, kernel, kargs, updated in cases(torch.device("cuda")):
        ab(sides, name, kernel, kargs, updated, args.rounds, card_name)


if __name__ == "__main__":
    main()
