"""Seeded generators and seed scopes (counterpart:
``paddle_tpu/core/random.py``).

The reference advances one global threefry key; the port gives every
model init its own ``torch.Generator`` made from an explicit seed, so two
models built from one seed on one device hold the same weights. The two
packages draw different numbers from the same seed: tests that hold the
port against the reference copy weights across instead (``bridge.py``).

:func:`provide_seed` is the counterpart of the reference's
``provide_key`` (:113-133): inside it, :func:`draw_seed` derives each
draw from the scope's base seed and a per-draw counter, on the host. A
recompute segment enters a scope with a seed drawn before the segment, so
its replay draws the same seeds again, as the reference's segment folds
the same key (``distributed/fleet/recompute.py:84-86``); ``TrainStep``
enters one per step.

:class:`Generator` and ``default_generator`` are the reference's host-side
(seed, counter) pair (``:36-121``): ``next_seed`` counts a draw and
returns the pair, which ``LlamaForCausalLM.generate`` and an
``LLMEngine`` without ``sampling_seed`` fold into their threefry base key
(:mod:`paddle_tpu_torch.core.prng`). :func:`seed` reseeds it, as
``paddle.seed`` does; tests hold the two packages in step by setting
both generators' states alike.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_M32 = 0xFFFFFFFF
_local = threading.local()     # each thread's stack of seed scopes


def _scopes() -> list:
    if not hasattr(_local, "scopes"):
        _local.scopes = []
    return _local.scopes


class Generator:
    """A seed and a count of draws, on the host (reference
    ``core/random.py:36-90``): every ``next_seed`` advances the count."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._counter = 0
        return self

    def initial_seed(self) -> int:
        return self._seed

    def next_seed(self):
        """Count a draw; returns the fresh ``(seed, counter)`` pair."""
        with self._lock:
            self._counter += 1
            return (self._seed, self._counter)

    def get_state(self):
        with self._lock:
            return (self._seed, self._counter)

    def set_state(self, state):
        seed, counter = state
        with self._lock:
            self._seed = int(seed)
            self._counter = int(counter)


default_generator = Generator(0)


def seed(value: int):
    """Reseed the global generator (``paddle.seed``); returns it."""
    default_generator.manual_seed(value)
    return default_generator


def make_generator(seed: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def _mix32(x):
    """The murmur3 finalizer on 32 bits."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


class _SeedScope:
    __slots__ = ("base", "counter")

    def __init__(self, base):
        self.base = int(base) & _M32
        self.counter = 0


@contextlib.contextmanager
def provide_seed(base):
    """Within this scope, :func:`draw_seed` on this thread returns seeds
    derived from ``base`` and a counter that starts afresh on every
    entry."""
    _scopes().append(_SeedScope(base))
    try:
        yield
    finally:
        _scopes().pop()


def draw_seed(generator=None) -> int:
    """An int32 seed for a random kernel. Inside :func:`provide_seed`: the
    next seed of the innermost scope, from the host. Outside: a draw from
    ``generator`` (default: torch's CPU generator), which blocks on the
    card when the generator lives there."""
    if _scopes():
        scope = _scopes()[-1]
        scope.counter += 1
        return _mix32(scope.base ^ _mix32(scope.counter * 0x9E3779B9)) \
            & 0x7FFFFFFF
    dev = generator.device if generator is not None else "cpu"
    return int(torch.randint(-2 ** 31, 2 ** 31, (1,), device=dev,
                             generator=generator))


def in_seed_scope() -> bool:
    """Whether a :func:`provide_seed` scope is active."""
    return bool(_scopes())
