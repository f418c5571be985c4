"""Admission scheduling for ``paddle_tpu_torch.serving`` — a bounded FIFO
with blocking backpressure (counterpart: ``paddle_tpu/serving/scheduler.py``,
ported verbatim).

Reference analog: the reference serving stack's request queue in front of
AnalysisPredictor instances; here one queue feeds one engine thread, and
the bound IS the backpressure contract: a full queue either blocks the
submitter (`block=True`, optional timeout) or raises
:class:`~paddle_tpu_torch.serving.types.ServerQueueFull` immediately — the
server never buffers unboundedly ahead of the engine.
"""
from __future__ import annotations

import collections
import threading
import time

from .types import ServerQueueFull

__all__ = ["AdmissionQueue"]


class AdmissionQueue:
    """Bounded thread-safe FIFO of :class:`RequestHandle`.

    Producers (submitters) block in :meth:`put` when full; the engine
    thread drains via :meth:`pop` and every pop wakes one blocked
    producer. :meth:`remove` supports cancellation/deadline expiry of a
    still-queued request in O(n) — n is bounded by ``max_size``."""

    def __init__(self, max_size=64):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        self.max_size = int(max_size)
        self._dq = collections.deque()
        self._cond = threading.Condition()

    def __len__(self):
        with self._cond:
            return len(self._dq)

    def put(self, handle, block=True, timeout=None, front=False):
        """Enqueue, applying backpressure. Raises ServerQueueFull when the
        queue stays at capacity (immediately if ``block=False``, after
        ``timeout`` seconds otherwise).

        ``front=True`` is the RE-ADMISSION grant: the handle joins the
        HEAD of the queue, ahead of fresh arrivals — used for failover
        resumes (streams a consumer is already reading, whose service
        was paid once on the lost replica). Backpressure still applies:
        a full queue blocks or rejects a front put like any other, so
        re-admissions cannot grow the queue past its bound."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._dq) >= self.max_size:
                if not block:
                    raise ServerQueueFull(
                        f"admission queue full ({self.max_size})")
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise ServerQueueFull(
                        f"admission queue full ({self.max_size}) after "
                        f"waiting {timeout}s")
                self._cond.wait(remaining)
            if front:
                self._dq.appendleft(handle)
            else:
                self._dq.append(handle)
            self._cond.notify_all()

    def pop(self):
        """Dequeue the oldest handle, or None when empty (never blocks —
        the engine thread must keep stepping)."""
        with self._cond:
            if not self._dq:
                return None
            h = self._dq.popleft()
            self._cond.notify_all()  # space freed: wake blocked producers
            return h

    def remove(self, handle):
        """Remove a specific queued handle (cancel/deadline). True when it
        was found and removed."""
        with self._cond:
            try:
                self._dq.remove(handle)
            except ValueError:
                return False
            self._cond.notify_all()
            return True

    def drain(self):
        """Remove and return every queued handle (server shutdown)."""
        with self._cond:
            out = list(self._dq)
            self._dq.clear()
            self._cond.notify_all()
            return out
