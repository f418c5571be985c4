"""Throughput/step timer (counterpart: ``paddle_tpu/profiler/timer.py``,
ported verbatim; reference: python/paddle/profiler/timer.py — benchmark()
singleton with ips/step-time summaries, used by hapi and fleet)."""
from __future__ import annotations

import time


class _Stat:
    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.total = 0.0
        self.minimum = float("inf")
        self.maximum = 0.0

    def update(self, v):
        self.count += 1
        self.total += v
        self.minimum = min(self.minimum, v)
        self.maximum = max(self.maximum, v)

    @property
    def avg(self):
        return self.total / self.count if self.count else 0.0


class Benchmark:
    def __init__(self):
        self.reset()

    def reset(self):
        self._last = None
        self.step_time = _Stat()
        self.ips = _Stat()
        self._samples = 0

    def begin(self):
        self._last = time.perf_counter()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time.update(dt)
            if num_samples:
                self.ips.update(num_samples / dt)
        self._last = now

    def end(self):
        self._last = None

    def step_info(self, unit=None):
        msg = (f"avg_step_time: {self.step_time.avg * 1e3:.2f} ms "
               f"(min {self.step_time.minimum * 1e3:.2f}, "
               f"max {self.step_time.maximum * 1e3:.2f})")
        if self.ips.count:
            u = unit or "samples"
            msg += f", ips: {self.ips.avg:.2f} {u}/s"
        return msg


_BENCH = Benchmark()


def benchmark() -> Benchmark:
    return _BENCH
