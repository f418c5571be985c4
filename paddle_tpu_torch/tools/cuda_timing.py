"""Device timing on the card with CUDA events, the host held off the
critical path.

A call whose host side (argument checks, ctypes, a launch) outlasts its
device time would, launched back to back between two events, be timed at
the host's pace. :func:`cuda_ms` first enqueues a spin kernel long enough
to cover the host's enqueueing of every launch, so the events time the
device alone. :func:`host_us` is the other half: the host's own cost per
call while the spin keeps the card busy, so the host never waits on it.
"""
from __future__ import annotations

import time

import torch

_SPIN = {}


def spin_cycles_per_ms():
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    if not _SPIN:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SPIN["per_ms"] = 10_000_000 / start.elapsed_time(end)
    return _SPIN["per_ms"]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events). A
    spin kernel holds the card (up to 100 ms) while the host enqueues the
    launches, so a call whose host side outlasts its device time is timed
    on the device and not at the host's pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(min(1.2 * call_ms * reps, 100.0)
                          * spin_cycles_per_ms()))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls=50):
    """Mean host µs per call of ``fn`` (checks, ctypes, the launch) while a
    100 ms spin kernel holds the card, so no call waits on the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(100.0 * spin_cycles_per_ms()))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us
