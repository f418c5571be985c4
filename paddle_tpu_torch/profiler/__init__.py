"""paddle_tpu_torch.profiler (counterpart: ``paddle_tpu/profiler``): the
step timer, the serving telemetry, the engine flight recorder, the
metrics store and ``merge_profile`` (JSON chrome traces). The SLOs and
pathology detectors (``slo.py``) and the black box are ROADMAP A11."""
from __future__ import annotations

import json
import os

from .flight_recorder import (COUNTER_TRACKS, FLOW_EVENT_NAME,
                              REQUEST_EVENT_KINDS, TAIL_CAUSES,
                              FlightRecorder, StepRecord)
from .metrics_store import ALERT_KINDS, Alert, MetricsStore, Series
from .serving_telemetry import (GAUGES, STAGES, LatencyHistogram,
                                ServingTelemetry)
from .timer import Benchmark, benchmark

__all__ = ["Benchmark", "benchmark", "LatencyHistogram", "ServingTelemetry",
           "STAGES", "GAUGES", "merge_profile",
           "FlightRecorder", "StepRecord", "TAIL_CAUSES",
           "REQUEST_EVENT_KINDS", "COUNTER_TRACKS", "FLOW_EVENT_NAME",
           "MetricsStore", "Series", "Alert", "ALERT_KINDS"]


def merge_profile(rank_dirs_or_files, output_path, align_start=True):
    """Merge per-rank chrome traces into one cluster-wide timeline
    (reference ``paddle_tpu/profiler/__init__.py:357-410``). Each rank's
    events land in their own process lane (pid = rank index, with a
    process_name metadata row); with ``align_start``, per-rank clocks
    are shifted so every rank's first event starts at t=0, compensating
    unsynced host clocks. Directories contribute their ``*.json`` files
    in natural order (rank10 after rank9)."""
    import glob
    import re

    def _natural(s):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", os.path.basename(s))]

    files = []
    for entry in rank_dirs_or_files:
        if os.path.isdir(entry):
            files.extend(sorted(glob.glob(os.path.join(entry, "*.json")),
                                key=_natural))
        else:
            files.append(entry)
    if not files:
        raise ValueError("no trace files to merge")

    merged = []
    for rank, path in enumerate(files):
        with open(path) as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        t0 = min((e["ts"] for e in events
                  if e.get("ph") != "M" and "ts" in e), default=0)
        shift = -t0 if align_start else 0
        label = os.path.splitext(os.path.basename(path))[0]
        merged.append({"ph": "M", "pid": rank, "name": "process_name",
                       "args": {"name": f"rank{rank}:{label}"}})
        for e in events:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                continue  # replaced by the rank lane name
            e = dict(e)
            e["pid"] = rank
            if "ts" in e:
                e["ts"] = e["ts"] + shift
            merged.append(e)

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump({"traceEvents": merged}, f)
    return output_path
