"""Runtime lock-order watchdog (counterpart:
``paddle_tpu/analysis/lock_watchdog.py``, with ``find_cycle`` from
``paddle_tpu/analysis/locks.py:97-125``; this package has no static
lock-order pass, so :func:`assert_consistent` takes the static edges from
the caller).

The static pass sees only LEXICAL nesting of ``with <lock>:`` blocks; a
lock acquired inside a function *called* under another lock is
invisible to it. This watchdog records the acquisition edges that
actually happen: armed by ``PADDLE_TPU_LOCK_CHECKS=1`` (the test
conftest's debug posture, like ``PADDLE_TPU_POOL_CHECKS``), the serving
stack's documented locks are wrapped in :class:`TrackedLock` via
:func:`tracked`, each thread keeps a stack of held lock labels, and
every acquisition while holding another lock records a ``held ->
acquired`` edge.

Two assertions:

* **acyclic online** — an acquisition whose edge closes a cycle in the
  observed graph raises immediately, with the cycle in the message
  (catching the deadlock the one time the interleaving happens in a
  test, instead of hanging CI).
* **static consistency** — :func:`assert_consistent` checks the
  observed edges against PTL004's static graph: an observed edge A→B
  conflicts if the static graph can reach A from B (the two sides
  disagree about the global order).

Disarmed (the default), :func:`tracked` returns the lock unchanged —
zero overhead in production.
"""
from __future__ import annotations

import os
import threading

__all__ = ["enabled", "tracked", "TrackedLock", "observed_edges",
           "reset_edges", "assert_consistent", "LockOrderError",
           "find_cycle"]


def enabled():
    return os.environ.get("PADDLE_TPU_LOCK_CHECKS", "0") not in ("", "0")


class LockOrderError(AssertionError):
    """An acquisition that closes a cycle in the observed lock graph."""


_STATE_GUARD = threading.Lock()
#: (held_label, acquired_label) -> count
_EDGES = {}
_TLS = threading.local()


def _held_stack():
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def observed_edges():
    """Copy of the observed acquisition-edge multiset."""
    with _STATE_GUARD:
        return dict(_EDGES)


def reset_edges():
    with _STATE_GUARD:
        _EDGES.clear()


def find_cycle(edges):
    """One cycle in a directed edge set as a node list, or None."""
    graph = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack = []

    def dfs(n):
        color[n] = GRAY
        stack.append(n)
        for nxt in sorted(graph.get(n, ())):
            if color.get(nxt, WHITE) == GRAY:
                return stack[stack.index(nxt):] + [nxt]
            if color.get(nxt, WHITE) == WHITE:
                cyc = dfs(nxt)
                if cyc:
                    return cyc
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(graph):
        if color[n] == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


def _record(held, acquired):
    with _STATE_GUARD:
        key = (held, acquired)
        fresh = key not in _EDGES
        _EDGES[key] = _EDGES.get(key, 0) + 1
        if fresh:
            cycle = find_cycle(set(_EDGES))
            if cycle:
                del _EDGES[key]
                raise LockOrderError(
                    f"acquiring {acquired!r} while holding {held!r} "
                    f"closes a lock-order cycle: {' -> '.join(cycle)}")


class TrackedLock:
    """A lock proxy that reports acquisition edges to the watchdog.

    Wraps Lock and RLock alike; re-entrant re-acquisition of the SAME
    label records no self-edge (RLock semantics are not an ordering
    hazard)."""

    def __init__(self, lock, name):
        self._lock = lock
        self.name = name

    def acquire(self, *a, **k):
        got = self._lock.acquire(*a, **k)
        if got:
            stack = _held_stack()
            if stack and stack[-1] != self.name:
                try:
                    _record(stack[-1], self.name)
                except LockOrderError:
                    # don't leak the just-acquired inner lock through
                    # the cycle error — the caller never saw it held
                    self._lock.release()
                    raise
            stack.append(self.name)
        return got

    def release(self):
        stack = _held_stack()
        # remove the most recent entry for this label (locks may be
        # released out of LIFO order; the stack is best-effort there)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()


def tracked(lock, name):
    """Wrap ``lock`` for edge recording when the watchdog is armed;
    return it unchanged otherwise."""
    if not enabled():
        return lock
    return TrackedLock(lock, name)


def assert_consistent(static_edges, observed=None):
    """Assert the observed runtime edges don't contradict the static
    lock-order graph: for every observed A→B, the static graph must not
    order B before A (reach A from B). Returns the list of observed
    edges that are NEW (absent from the static graph but consistent
    with it) — informational, since call-through acquisitions are
    invisible to the lexical scan."""
    static = set(static_edges)
    reach = {}

    def reachable(src, dst):
        if src not in reach:
            seen, frontier = set(), [src]
            while frontier:
                n = frontier.pop()
                for a, b in static:
                    if a == n and b not in seen:
                        seen.add(b)
                        frontier.append(b)
            reach[src] = seen
        return dst in reach[src]

    novel = []
    for a, b in (observed if observed is not None else observed_edges()):
        if (a, b) in static:
            continue
        if reachable(b, a):
            raise LockOrderError(
                f"runtime acquisition edge {a!r} -> {b!r} contradicts "
                f"the static lock-order graph (which orders {b!r} "
                f"before {a!r})")
        novel.append((a, b))
    return novel
