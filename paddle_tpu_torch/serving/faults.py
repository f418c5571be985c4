"""Deterministic fault injection + restart policy for
``paddle_tpu_torch.serving`` (counterpart: ``paddle_tpu/serving/faults.py``,
ported verbatim).

Reference analog: the reference treats failure handling as a first-class
subsystem — watchdog heartbeats with hang detection (PAPER.md §2.3 row
15, ``distributed/watchdog.py``) and failure-detection/elastic recovery
(§5.3). The serving-side mirror of that layer needs one thing the
training-side watchdog never did: **reproducible chaos**. A failover test
that monkeypatches ``step_begin`` or murders a thread exercises whatever
interleaving the scheduler felt like that run; a SCRIPTED fault schedule
("raise at engine step 4", "hang 2s at step 7", "next 3 submissions see a
full queue") produces the same crash at the same engine state every run,
so tier-1 can assert token-exact recovery instead of eyeballing a soak.

Two pieces:

* :class:`FaultInjector` — the scripted schedule. It threads through
  exactly three narrow hooks: ``LLMEngine.step_begin`` /
  ``LLMEngine.step_finish`` entry (one attribute check when detached,
  like the flight recorder) and ``AsyncLLMServer.submit``'s enqueue
  (queue-full bursts). Steps are counted ONLY while the engine has work
  (idle poll passes don't advance the schedule) AND a schedule is
  pending (the detached/no-actions fast path is one attribute check and
  doesn't count), so "step N" means the N-th working step after the
  first action was scripted. Hangs sleep on an Event so the
  server watchdog can :meth:`interrupt` them — the injectable stand-in
  for "cancel the stuck device call where the runtime allows it".
* :class:`RestartPolicy` — bounds for ``AsyncLLMServer(supervise=...)``:
  how many times the serving loop may be restarted after a crash, and the
  capped exponential backoff between attempts.

Every fired fault lands in :attr:`FaultInjector.fired` (the test-side
record) and on the ``faults_injected`` telemetry counter when a server
armed the injector.
"""
from __future__ import annotations

import threading
import time

from .types import ServerQueueFull

__all__ = ["FaultInjector", "InjectedFault", "RestartPolicy"]


class InjectedFault(RuntimeError):
    """An exception raised by a scripted FaultInjector schedule — the
    chaos tests' stand-in for a device/compile/runtime failure. A plain
    RuntimeError subclass so every layer treats it exactly like a real
    crash (it must NOT be special-cased anywhere outside tests)."""


class RestartPolicy:
    """Bounds for supervised serving-loop recovery.

    ``max_restarts``: total restarts one server lifetime may consume
    before a crash becomes terminal (fails every waiter with
    ``finish_reason="server_error"``, exactly like the unsupervised
    crash path). ``backoff_s * backoff_factor**(attempt-1)``, capped at
    ``max_backoff_s``, is slept between the crash and the re-arm — a
    crash LOOP must not spin the engine thread."""

    def __init__(self, max_restarts=3, backoff_s=0.05, backoff_factor=2.0,
                 max_backoff_s=2.0):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff_s = float(max_backoff_s)

    def delay(self, attempt):
        """Backoff before restart ``attempt`` (1-based)."""
        return min(self.backoff_s * self.backoff_factor ** (attempt - 1),
                   self.max_backoff_s)

    def __repr__(self):
        return (f"RestartPolicy(max_restarts={self.max_restarts}, "
                f"backoff_s={self.backoff_s}, "
                f"backoff_factor={self.backoff_factor}, "
                f"max_backoff_s={self.max_backoff_s})")


class _Action:
    __slots__ = ("kind", "step", "phase", "seconds", "interruptible",
                 "request_id", "message")

    def __init__(self, kind, step=None, phase="begin", seconds=0.0,
                 interruptible=True, request_id=None,
                 message="injected fault"):
        self.kind = kind              # "raise" | "hang" | "fail_request"
        self.step = step              # None = fire at the NEXT hook
        self.phase = phase            # "begin" | "finish"
        self.seconds = seconds
        self.interruptible = interruptible
        self.request_id = request_id
        self.message = message


class FaultInjector:
    """One scripted fault schedule (attach via
    ``AsyncLLMServer(fault_injector=...)`` or ``engine.fault_injector``).

    Schedule entries fire at most once and are consumed when they fire.
    Thread-safe: tests script from their thread, the engine thread fires,
    the watchdog interrupts, submitters hit bursts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._actions: list[_Action] = []
        self._burst = 0               # pending queue-full submissions
        self._interrupt = threading.Event()
        self._telemetry = None        # armed by AsyncLLMServer.start()
        self._step = 0
        #: every fault that fired, as (kind, step, detail) — the
        #: test-side assertion record
        self.fired: list[tuple] = []
        #: True while a hang action is sleeping — the watchdog's "is the
        #: stall ours to interrupt?" check
        self.hanging = False

    # -- scripting (any thread) -----------------------------------------
    def crash_at_step(self, step, message="injected fault", phase="begin"):
        """Raise :class:`InjectedFault` at engine step ``step`` (1-based,
        counting only steps with work; ``phase="finish"`` raises at the
        readout side instead of the dispatch side)."""
        with self._lock:
            self._actions.append(_Action("raise", int(step), phase,
                                         message=message))
        return self

    def hang_at_step(self, step, seconds, phase="begin",
                     interruptible=True):
        """Block the engine thread ``seconds`` at step ``step`` — the
        stuck-compile / wedged-device simulation. ``interruptible=True``
        sleeps on an Event so :meth:`interrupt` (the server watchdog)
        can end the hang early; False sleeps hard, modeling a stall
        nothing can cancel."""
        with self._lock:
            self._actions.append(_Action(
                "hang", int(step), phase, seconds=float(seconds),
                interruptible=bool(interruptible)))
        return self

    def fail_request(self, request_id, message=None):
        """Raise when request ``request_id`` occupies an engine slot at a
        dispatch — a per-request poison pill (the whole loop crashes;
        supervision decides what survives)."""
        with self._lock:
            self._actions.append(_Action(
                "fail_request", None, "begin", request_id=request_id,
                message=message or f"injected dispatch failure for "
                                   f"request {request_id}"))
        return self

    def queue_full_burst(self, n=1):
        """The next ``n`` ``submit()`` calls see a full admission queue
        (raise :class:`ServerQueueFull`) regardless of real queue depth."""
        with self._lock:
            self._burst += int(n)
        return self

    def kill(self, message="injected replica death"):
        """Crash at the very next engine hook (begin or finish,
        whichever comes first) — the "kill replica K" form the cluster
        chaos tests use instead of ad-hoc thread murder."""
        with self._lock:
            self._actions.append(_Action("raise", None, "any",
                                         message=message))
        return self

    def interrupt(self):
        """End a currently-sleeping interruptible hang (the server
        watchdog calls this when the heartbeat goes stale)."""
        self._interrupt.set()

    @property
    def step(self):
        """Engine steps counted so far (hooks on steps with work)."""
        with self._lock:
            return self._step

    def snapshot(self):
        """JSON-ready schedule state — what fired (with its step) and
        what's still pending. Rides the black-box debug bundle so a
        chaos run's postmortem is self-describing."""
        with self._lock:
            return {"step": self._step,
                    "fired": [list(f) for f in self.fired],
                    "pending": [a.kind for a in self._actions],
                    "burst_pending": self._burst,
                    "hanging": self.hanging}

    # -- hook side -------------------------------------------------------
    def _record(self, kind, step, detail):
        self.fired.append((kind, step, detail))
        tel = self._telemetry
        if tel is not None:
            try:
                tel.inc("faults_injected")
            except KeyError:
                pass

    def _take(self, phase, step, engine):
        """Pop every action due at (phase, step) — under the lock."""
        due, keep = [], []
        for a in self._actions:
            phase_ok = a.phase in (phase, "any")
            if a.kind == "fail_request":
                hit = phase == "begin" and any(
                    s is not None and s.req.request_id == a.request_id
                    for s in engine.slots)
                (due if hit else keep).append(a)
            elif phase_ok and (a.step is None or a.step == step):
                due.append(a)
            else:
                keep.append(a)
        self._actions = keep
        return due

    def _fire(self, phase, engine, count):
        with self._lock:
            if count:
                self._step += 1
            step = self._step
            due = self._take(phase, step, engine)
        for a in due:
            if a.kind == "hang":
                self._record("hang", step, a.seconds)
                self.hanging = True
                try:
                    if a.interruptible:
                        self._interrupt.clear()
                        self._interrupt.wait(a.seconds)
                    else:
                        time.sleep(a.seconds)
                finally:
                    self.hanging = False
            else:
                detail = a.message
                self._record(a.kind, step, detail)
                raise InjectedFault(detail)

    def on_step_begin(self, engine):
        """Engine hook: entry of ``LLMEngine.step_begin`` (before the
        model dispatch lock, so a hang here never blocks OTHER replicas
        sharing the model object)."""
        if not self._actions:
            return
        self._fire("begin", engine, count=engine.has_unfinished())

    def on_step_finish(self, engine):
        """Engine hook: entry of ``LLMEngine.step_finish`` (the readout
        side — after the dispatch landed, before the host sync)."""
        if not self._actions:
            return
        self._fire("finish", engine, count=False)

    def on_submit(self, server):
        """Server hook: inside ``submit()``'s enqueue try-block, so an
        injected queue-full rides the SAME bookkeeping (rejection
        counter, timeline finish, handle cleanup) as a real full queue."""
        with self._lock:
            if self._burst <= 0:
                return
            self._burst -= 1
            step = self._step
        self._record("queue_full", step, None)
        raise ServerQueueFull("injected queue_full burst")
