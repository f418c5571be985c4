"""paddle_tpu_torch.profiler (counterpart: ``paddle_tpu/profiler``): the
step timer and the serving telemetry. The flight recorder, metrics store,
SLOs and black box are ROADMAP A11."""
from .serving_telemetry import (GAUGES, STAGES, LatencyHistogram,
                                ServingTelemetry)
from .timer import Benchmark, benchmark

__all__ = ["Benchmark", "benchmark", "LatencyHistogram", "ServingTelemetry",
           "STAGES", "GAUGES"]
