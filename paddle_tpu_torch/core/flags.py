"""Global flags (counterpart: ``paddle_tpu/core/flags.py``).

A process-global registry with Paddle's surface: ``define_flag``,
``set_flags``/``get_flags`` (names may carry the ``FLAGS_`` prefix) and
``flag_value``. Each flag has a type, a default and a doc; the environment
variable ``FLAGS_<name>`` overrides the default at first read. Only the
flags of the port's slices are defined here.
"""
from __future__ import annotations

import os
import threading
from typing import Any

_lock = threading.Lock()
_REGISTRY: dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "type", "default", "doc", "_value", "_resolved")

    def __init__(self, name, type_, default, doc):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc
        self._value = default
        self._resolved = False

    def _parse(self, s: str):
        if self.type is bool:
            return s.lower() in ("1", "true", "yes", "on")
        return self.type(s)

    def get(self):
        if not self._resolved:
            with _lock:
                if not self._resolved:
                    env = os.environ.get(f"FLAGS_{self.name}")
                    if env is not None:
                        self._value = self._parse(env)
                    self._resolved = True
        return self._value

    def set(self, value):
        with _lock:
            self._value = self.type(value) if not isinstance(value, self.type) \
                else value
            self._resolved = True


def define_flag(name: str, default: Any, doc: str = "",
                type_: type | None = None):
    if type_ is None:
        type_ = type(default)
    flag = _Flag(name, type_, default, doc)
    _REGISTRY[name] = flag
    return flag


def _key(name):
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise ValueError(f"unknown flag {name!r}")
    return key


def get_flags(flags):
    """paddle.get_flags: a name or a list of names -> ``{name: value}``."""
    if isinstance(flags, str):
        flags = [flags]
    return {name: _REGISTRY[_key(name)].get() for name in flags}


def set_flags(flags: dict):
    """paddle.set_flags: ``{name: value}``; every name is checked before any
    flag is set."""
    resolved = [(_key(name), value) for name, value in flags.items()]
    for key, value in resolved:
        _REGISTRY[key].set(value)


def flag_value(name: str):
    return _REGISTRY[name].get()


define_flag("use_pallas_flash_attention", True,
            "route scaled_dot_product_attention to the flash-attention "
            "kernels where the reference's rule admits the call (no mask, "
            "dropout_p < 1, equal lengths when causal) and, on a CUDA "
            "tensor, the kernels take it (bf16, head_dim 64 or 128); every "
            "other call takes the plain attention math (the reference's "
            "name and default)")
define_flag("use_paged_attention", True,
            "route block_multihead_attention to the paged-attention kernels "
            "where they take the call (bf16 rows, a bf16 or int8 pool, "
            "head_dim 64 or 128, 1, 2, 4 or 8 query heads per kv head, "
            "block_size <= 128); otherwise, or with the flag off, the plain "
            "paged versions run (the reference's dense-gather fallback). "
            "CPU tensors always take the plain versions. Set "
            "FLAGS_use_paged_attention=0 to A/B against them (the "
            "reference's name and default)")
define_flag("use_fused_adamw", True,
            "accepted for Paddle's surface and read nowhere in the port: "
            "multi-precision Adam/AdamW updates (fp32 master and moments, "
            "decoupled decay) always take the fused single-pass kernel")
define_flag("adamw_bf16_moments", False,
            "store Adam/AdamW moment1/moment2 of float32 params in bfloat16 "
            "(the update math stays float32); such params take the plain "
            "update chain")
define_flag("adamw_stochastic_rounding", False,
            "master-weight-free AdamW for bf16 params with a stochastically "
            "rounded param write (the stochastic-rounding kernel where the "
            "reference's kernel tiles the shape, else the plain chain)")
define_flag("use_pallas_int4", True,
            "route tileable weight-only int4 GEMMs of at most 128 rows on a "
            "CUDA tensor to the hand-written int4 GEMM kernel (the "
            "reference's name; CPU tensors always take the split-nibble "
            "path)")
