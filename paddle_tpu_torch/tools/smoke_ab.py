"""Run ``chip_smoke.py`` from several checkouts in turn, in one call on the
card, so that their whole runs and their phases are timed on one host.

    python -m paddle_tpu_torch.tools.smoke_ab ROOT [ROOT ...] [--out DIR]

Each ``ROOT`` holds a checkout (for example ``git archive <commit>``
unpacked into an ignored directory), and its smoke runs from there as
``python3 chip_smoke.py``, the next one only after it has ended. Its
standard output and errors go to ``DIR/<name>.log`` and
``DIR/<name>.err`` (``<name>`` is the root's last component; ``DIR`` is
``build/smoke_ab`` by default). Prints one JSON line a run: its exit code,
its wall seconds, its last line, and for each phase the seconds from the
start at which the phase printed its last line. Exits with 0 only if
every run did.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def phase_of(line):
    """The ``phase`` of a JSON line the smoke printed, else None."""
    if not line.startswith("{"):
        return None
    try:
        obj = json.loads(line)
    except ValueError:
        return None
    return obj.get("phase") if isinstance(obj, dict) else None


def run(root, out):
    """One smoke from ``root``; returns its JSON line as a dict."""
    name = Path(root).resolve().name
    phases, last = {}, ""
    t0 = time.perf_counter()
    with open(out / f"{name}.log", "w") as log, \
            open(out / f"{name}.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                                cwd=root, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        for line in proc.stdout:
            log.write(line)
            line = line.rstrip("\n")
            phase = phase_of(line)
            if phase is not None:
                phases[phase] = round(time.perf_counter() - t0, 1)
            if line:
                last = line
        rc = proc.wait()
    return {"root": str(root), "rc": rc,
            "seconds": time.perf_counter() - t0,
            "phase_done_s": phases, "last_line": last[:200]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts, run in this order")
    ap.add_argument("--out", default="build/smoke_ab",
                    help="directory for each run's output")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failed = False
    for root in args.roots:
        res = run(root, out)
        print(json.dumps(res), flush=True)
        failed |= res["rc"] != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
