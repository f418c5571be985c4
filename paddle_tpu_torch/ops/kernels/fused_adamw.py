"""Fused multi-precision AdamW update (counterpart:
``paddle_tpu/ops/kernels/fused_adamw.py``).

Replaces the Pallas kernel ``_adamw_kernel`` (``fused_adamw.py:40``,
launched through ``fused_adamw_update`` ``:142``) with the hand-written
CUDA kernel ``paddle_tpu_torch/csrc/fused_adamw.cu``; the source note there
gives the design and its bound on the H100.

One pass per parameter: read the bf16 grad and the float32 moments and
master weight, write the moments and master IN PLACE and the bf16 param in
place (the reference aliases the same buffers and its train step donates
them). The three step scalars ``alpha = lr/bc1``, ``c2 = 1/sqrt(bc2)`` and
``lrwd = lr*wd`` are computed here on the host in numpy float32 from the
host ``lr`` and ``step``, so an update reads nothing back from the card.

The reference refuses shapes whose tiles overflow the TPU's VMEM budget
(``_tile_plan``, ``:104-139``) and updates those with the optimizer's
generic chain; this kernel is a flat elementwise pass and takes every
shape.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

KERNEL = "fused_adamw"


def adamw_scalars(lr, step, beta1, beta2, eps, weight_decay, apply_decay):
    """The kernel's float32 scalars, computed as the reference computes them
    (``fused_adamw.py:160-166``): ``(b1, 1-b1, b2, 1-b2, eps, alpha, c2,
    lrwd)`` as Python floats holding float32 values."""
    f32 = np.float32
    stepf = f32(step)
    bc1 = f32(1.0) - np.power(f32(beta1), stepf)
    bc2 = f32(1.0) - np.power(f32(beta2), stepf)
    lr32 = f32(lr)
    lrwd = lr32 * f32(weight_decay) if (weight_decay and apply_decay) \
        else f32(0.0)
    vals = (f32(beta1), f32(1.0 - beta1), f32(beta2), f32(1.0 - beta2),
            f32(eps), lr32 / bc1, f32(1.0) / np.sqrt(bc2), lrwd)
    return tuple(float(f32(x)) for x in vals)


@torch.no_grad()
def fused_adamw_update_plain(p, g, m, v, master, lr, step, *, beta1=0.9,
                             beta2=0.999, eps=1e-8, weight_decay=0.0,
                             apply_decay=True):
    """The plain PyTorch version of the kernel: the same float32 operations
    in the same order, one rounding each, then the same in-place writes."""
    b1, omb1, b2, omb2, eps32, alpha, c2, lrwd = adamw_scalars(
        lr, step, beta1, beta2, eps, weight_decay, apply_decay)
    g32 = g.float()
    m_new = b1 * m + omb1 * g32
    v_new = b2 * v + omb2 * (g32 * g32)
    denom = torch.sqrt(v_new) * c2 + eps32
    mw_new = (master - alpha * (m_new / denom)) - lrwd * master
    m.copy_(m_new)
    v.copy_(v_new)
    master.copy_(mw_new)
    p.copy_(mw_new.to(p.dtype))


def _check(p, g, m, v, master):
    if not (p.shape == g.shape == m.shape == v.shape == master.shape):
        raise ValueError("fused_adamw_update: p, g, m, v, master differ in "
                         "shape")
    if len({t.device for t in (p, g, m, v, master)}) != 1:
        raise ValueError("fused_adamw_update: tensors on different devices")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or \
            master.dtype != torch.float32:
        raise TypeError("fused_adamw_update takes float32 moments and master")


def fused_adamw_update(p, g, m, v, master, lr, step, *, beta1=0.9,
                       beta2=0.999, eps=1e-8, weight_decay=0.0,
                       apply_decay=True):
    """One AdamW step for a low-precision param ``p`` with float32 moments
    ``m``, ``v`` and master weight; every tensor but ``g`` is updated in
    place. ``lr`` and ``step`` are host numbers.

    CPU tensors take :func:`fused_adamw_update_plain`. CUDA tensors launch
    the kernel (bf16 ``p`` and ``g``, contiguous, 16-byte aligned) or
    raise."""
    _check(p, g, m, v, master)
    if p.device.type == "cpu":
        return fused_adamw_update_plain(
            p, g, m, v, master, lr, step, beta1=beta1, beta2=beta2, eps=eps,
            weight_decay=weight_decay, apply_decay=apply_decay)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_update: unsupported device {p.device}")
    if p.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"fused_adamw_update kernel takes a bfloat16 param "
                        f"and grad, got {p.dtype} and {g.dtype}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v),
                    ("master", master)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_adamw_update: {name} must be contiguous "
                             f"and 16-byte aligned")
    scal = adamw_scalars(lr, step, beta1, beta2, eps, weight_decay,
                         apply_decay)
    lib = _build.load(KERNEL)
    fn = lib.pt_fused_adamw_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_long] + \
        [ctypes.c_float] * 8 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_sm = torch.cuda.get_device_properties(p.device).multi_processor_count
    code = fn(g.data_ptr(), m.data_ptr(), v.data_ptr(), master.data_ptr(),
              p.data_ptr(), p.numel(), *scal, n_sm, _build.stream_of(p))
    _build.check(lib, code, "fused_adamw_update")
    fused_adamw_update.launches += 1


fused_adamw_update.launches = 0
