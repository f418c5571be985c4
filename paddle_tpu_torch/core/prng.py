"""Threefry2x32 keys and the draws the sampler makes from them, on torch
tensors (counterpart: the ``jax.random`` functions the reference calls,
``jax/_src/prng.py`` and ``jax/_src/random.py``, in the
``jax_threefry_partitionable`` mode that is JAX's default).

A key is a ``[..., 2]`` int64 tensor holding two uint32 words; every add,
shift and rotate is masked back to 32 bits, so the same code runs bit for
bit on the CPU and on the card. Every function here is batched over the
key's leading dimensions: ``fold_in(keys [B, 2], rids [B])`` folds one rid
into each row's key, as the reference's ``vmap`` over ``fold_in`` does.

- :func:`threefry_2x32`: the 20-round hash (rotations 13, 15, 26, 6 / 17,
  29, 16, 24, a key injection every four rounds);
- :func:`PRNGKey`: the two words of an int64 seed, what
  ``jax.random.PRNGKey`` makes of an int under x64 (which the reference
  turns on);
- :func:`fold_in`: ``threefry(key, (0, data))``;
- :func:`split`: ``threefry(key, (0, i))`` for ``i < n``;
- :func:`random_bits`: ``b1 ^ b2`` of ``threefry(key, (hi, lo))`` over the
  flat 64-bit index of each element of ``shape``;
- :func:`uniform`, :func:`gumbel` (the ``"low"`` mode) and
  :func:`categorical` (the Gumbel-max trick, first maximum on ties).
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32's smallest normal, the Gumbel uniform's lower bound
_F32_TINY = 1.1754943508222875e-38


def threefry_2x32(k1, k2, x1, x2):
    """Threefry2x32 (20 rounds) of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)``: int64 tensors (or ints) of uint32 values that
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = (((x2 << r) & M32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def _words(key):
    return key[..., 0], key[..., 1]


def PRNGKey(seed, device="cpu"):
    """The raw key of an int64 seed: its high and low 32-bit words (the
    reference runs JAX with x64 on, where ``PRNGKey`` bit-casts the int64
    seed; a seed below 2**32 gives ``[0, seed]``)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """``key [..., 2]`` with ``data`` (an int or an integer tensor that
    broadcasts against the key's leading dimensions) folded in: a new key
    per element, ``threefry(key, (0, data mod 2**32))``."""
    k1, k2 = _words(key)
    data = data.to(torch.int64) & M32 if isinstance(data, torch.Tensor) \
        else int(data) & M32
    y1, y2 = threefry_2x32(k1, k2, 0, data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key, num=2):
    """``num`` new keys from each key: ``[..., num, 2]``."""
    k1, k2 = _words(key)
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry_2x32(k1[..., None], k2[..., None], 0, idx)
    return torch.stack((y1, y2), dim=-1)


def random_bits(key, shape):
    """32 random bits for every element of ``shape`` under each key:
    ``[*key.shape[:-1], *shape]`` int64 values below 2**32."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    k1, k2 = _words(key)
    lead = k1.shape
    k1 = k1.reshape(*lead, *([1] * len(shape)))
    k2 = k2.reshape(*lead, *([1] * len(shape)))
    flat = torch.arange(n, dtype=torch.int64, device=key.device) \
        .reshape(shape)
    hi = flat >> 32 if n > M32 else 0
    b1, b2 = threefry_2x32(k1, k2, hi, flat & M32)
    return b1 ^ b2


def uniform(key, shape, minval=0.0, maxval=1.0):
    """float32 uniforms in ``[minval, maxval)``: 23 random mantissa bits
    under exponent 0 (``bits >> 9 | 0x3f800000``, a float in [1, 2)),
    minus 1, scaled and shifted, then clamped below at ``minval``."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span rounded to float32 on the host: scalars
    # exact in float32, so no tensor is made (and copied) on the card
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    return (floats * span + lo).clamp(min=lo)


def gumbel(key, shape):
    """float32 standard Gumbel noise, ``-log(-log(u))`` of a uniform in
    ``[tiny, 1)`` (JAX's ``"low"`` mode). Each log runs in float64 and
    rounds to float32, as JAX's float32 intermediate does: torch's float32
    ``log`` on the CPU can miss by hundreds of ulps just below 1, where
    XLA's stays within one."""
    u = uniform(key, shape, _F32_TINY, 1.0)
    inner = (-torch.log(u.double())).float()
    return (-torch.log(inner.double())).float()


def categorical(key, logits):
    """One draw per distribution: ``argmax(gumbel + logits)`` along the
    last axis (the first maximum wins). ``key [*K, 2]`` and ``logits [*K,
    *S, V]``: each key's noise covers its whole ``[*S, V]`` block, as a
    single ``jax.random.categorical`` call over that block draws it."""
    lead = key.dim() - 1
    noise = gumbel(key, logits.shape[lead:])
    return torch.argmax(noise + logits, dim=-1)
