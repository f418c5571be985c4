"""Fused AdamW updates (counterpart: ``paddle_tpu/ops/kernels/fused_adamw.py``).

Two kernels, each a hand-written CUDA kernel whose source note gives the
design and its bound on the H100:

- ``fused_adamw_update`` replaces the Pallas kernel ``_adamw_kernel``
  (``fused_adamw.py:40``, launched through ``fused_adamw_update`` ``:142``)
  with ``paddle_tpu_torch/csrc/fused_adamw.cu``: multi-precision AdamW, a
  low-precision param with float32 moments and master weight;
- ``fused_adamw_sr_update`` replaces ``_adamw_sr_kernel`` (``:244``,
  launched through ``fused_adamw_sr_update`` ``:268``) with
  ``paddle_tpu_torch/csrc/fused_adamw_sr.cu``: master-free AdamW on bf16
  param and moments, the param written with stochastic rounding.

Both take a bf16 or a float32 grad: gradient accumulation hands the update
the float32 mean, which the reference's kernels upcast like any other.

One pass per parameter, every state tensor updated IN PLACE (the
reference aliases the same buffers and its train step donates them). The
three step scalars ``alpha = lr/bc1``, ``c2 = 1/sqrt(bc2)`` and ``lrwd =
lr*wd`` are computed here on the host in numpy float32 from the host
``lr`` and ``step``, so an update reads nothing back from the card.

The reference refuses shapes whose tiles overflow the TPU's VMEM budget
(``_tile_plan``, ``:104-139``) and updates those with the optimizer's
generic chain. Both kernels here are flat elementwise passes that take
every shape; :func:`tile_plan` keeps the reference's rule because the
optimizer's routing follows it under stochastic rounding (``optimizer.py``
``Adam._apply_fused``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .flash_attention import position_hash

KERNEL = "fused_adamw"
SR_KERNEL = "fused_adamw_sr"
_M32 = 0xFFFFFFFF


def _pick_block(rows, cols):
    """The reference's rows per block (``fused_adamw.py:72-82``): 9 live
    fp32-sized buffers of ``(block_r, cols)`` within 4 MB, a multiple of
    8."""
    target = 4 * 1024 * 1024 // (9 * 4 * max(cols, 1))
    br = max(8, min(rows, (target // 8) * 8))
    while rows % br:
        br -= 8
        if br <= 0:
            return rows
    return br


def tile_plan(shape):
    """The reference's ``_tile_plan`` (``fused_adamw.py:104-139``), a pure
    shape function: the kernel's ``(rows, cols)`` factorization, or None
    where the reference's kernel refuses the shape (at Llama-2-7B widths,
    ``lm_head [4096, 32000]`` and a fused ``gate_up [4096, 22016]``)."""
    n = int(np.prod(shape)) if shape else 1
    if len(shape) >= 2:
        rows = int(shape[0])
        cols = n // rows
    else:
        cols = min(n, 131072)
        while n % cols:
            cols //= 2
        cols = max(cols, 1)
        rows = n // cols
    if rows * cols != n or (rows % 8 != 0 and rows != 1):
        cols = 1
        for c in (131072, 65536, 32768, 16384, 8192, 4096, 2048, 1024, 512,
                  256, 128):
            if n % c == 0 and (n // c) % 8 == 0:
                cols = c
                break
        if cols > 1:
            rows = n // cols
        else:
            rows, cols = 1, n
    br = _pick_block(rows, cols)
    if br * cols > (4 * 1024 * 1024) // (9 * 4):
        return None
    return rows, cols


def sr_seed(step, param_id):
    """The reference's per-(step, param) rounding seed
    (``optimizer.py:345-354``): ``((step + (param_id * 2654435761 &
    0x7FFFFFFF)) * -1640531527) ^ 0x5BD1E995`` in int32 with wraparound,
    returned as its 32 bits in ``[0, 2**32)``."""
    h = (int(step) + ((int(param_id) * 2654435761) & 0x7FFFFFFF)) & _M32
    return ((h * 0x9E3779B9) & _M32) ^ 0x5BD1E995


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


def _check_aligned(what, **tensors):
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             f"aligned")


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
    place. ``g`` is bf16 or float32. ``lr`` and ``step`` are host numbers.

    CPU tensors take :func:`fused_adamw_update_plain`. CUDA tensors launch
    the kernel (bf16 ``p``, contiguous, 16-byte aligned) or raise."""
    _check(p, g, m, v, master)
    if p.device.type == "cpu":
        return fused_adamw_update_plain(
            p, g, m, v, master, lr, step, beta1=beta1, beta2=beta2, eps=eps,
            weight_decay=weight_decay, apply_decay=apply_decay)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_update: unsupported device {p.device}")
    if p.dtype != torch.bfloat16 or \
            g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_adamw_update kernel takes a bfloat16 param "
                        f"and a bfloat16 or float32 grad, got {p.dtype} and "
                        f"{g.dtype}")
    _check_aligned("fused_adamw_update", p=p, g=g, m=m, v=v, master=master)
    scal = adamw_scalars(lr, step, beta1, beta2, eps, weight_decay,
                         apply_decay)
    lib = _build.load(KERNEL)
    fn = lib.pt_fused_adamw_bf16 if g.dtype == torch.bfloat16 \
        else lib.pt_fused_adamw_bf16_gf32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_long] + \
        [ctypes.c_float] * 8 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_sm = torch.cuda.get_device_properties(p.device).multi_processor_count
    code = fn(g.data_ptr(), m.data_ptr(), v.data_ptr(), master.data_ptr(),
              p.data_ptr(), p.numel(), *scal, n_sm, _build.stream_of(p))
    _build.check(lib, code, "fused_adamw_update")
    fused_adamw_update.launches += 1


fused_adamw_update.launches = 0


# ---------------------------------------------------------------------------
# master-free AdamW with stochastic rounding (B7)
# ---------------------------------------------------------------------------

def sr_round_bf16(x, seed):
    """The reference's ``_sr_round_bf16`` (``fused_adamw.py:226-241``) on
    a float32 tensor: to each element's bits add the low 16 bits of
    :func:`position_hash` of its flat index (the hash does not depend on
    how the tensor is factored into rows and columns) and ``seed``, modulo
    ``2**32``, and keep the top 16 bits as the bf16 value. Unbiased:
    ``E[round(x)] == x``."""
    bits = x.contiguous().view(torch.int32).reshape(-1).long() & _M32
    idx = torch.arange(bits.numel(), device=x.device, dtype=torch.int64)
    r16 = position_hash(idx, seed) & 0xFFFF
    hi = ((bits + r16) & _M32) >> 16
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi).to(torch.int16)
    return hi.view(torch.bfloat16).view(x.shape)


@torch.no_grad()
def fused_adamw_sr_update_plain(p, g, m, v, lr, step, seed, *, beta1=0.9,
                                beta2=0.999, eps=1e-8, weight_decay=0.0,
                                apply_decay=True):
    """The plain PyTorch version of the stochastic-rounding kernel: float32
    math on the bf16 state in the reference's order, one rounding each,
    moments written back in bf16 (round to nearest even), the param through
    :func:`sr_round_bf16`."""
    b1, omb1, b2, omb2, eps32, alpha, c2, lrwd = adamw_scalars(
        lr, step, beta1, beta2, eps, weight_decay, apply_decay)
    g32, p32 = g.float(), p.float()
    m_new = b1 * m.float() + omb1 * g32
    v_new = b2 * v.float() + omb2 * (g32 * g32)
    denom = torch.sqrt(v_new) * c2 + eps32
    p_new = (p32 - alpha * (m_new / denom)) - lrwd * p32
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(sr_round_bf16(p_new, seed))


def fused_adamw_sr_update(p, g, m, v, lr, step, seed, *, beta1=0.9,
                          beta2=0.999, eps=1e-8, weight_decay=0.0,
                          apply_decay=True):
    """One master-free AdamW step: bf16 ``p``, ``m`` and ``v`` updated in
    place from a bf16 or float32 ``g``, ``p`` written with stochastic
    rounding keyed by ``seed`` (see :func:`sr_seed`). ``lr`` and ``step``
    are host numbers.

    CPU tensors take :func:`fused_adamw_sr_update_plain`. CUDA tensors
    launch the kernel (contiguous, 16-byte aligned) or raise."""
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError("fused_adamw_sr_update: p, g, m, v differ in shape")
    if len({t.device for t in (p, g, m, v)}) != 1:
        raise ValueError("fused_adamw_sr_update: tensors on different "
                         "devices")
    if not (p.dtype == m.dtype == v.dtype == torch.bfloat16):
        raise TypeError("fused_adamw_sr_update takes a bfloat16 param and "
                        "moments")
    if p.device.type == "cpu":
        return fused_adamw_sr_update_plain(
            p, g, m, v, lr, step, seed, beta1=beta1, beta2=beta2, eps=eps,
            weight_decay=weight_decay, apply_decay=apply_decay)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_sr_update: unsupported device "
                         f"{p.device}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_adamw_sr_update kernel takes a bfloat16 or "
                        f"float32 grad, got {g.dtype}")
    _check_aligned("fused_adamw_sr_update", p=p, g=g, m=m, v=v)
    scal = adamw_scalars(lr, step, beta1, beta2, eps, weight_decay,
                         apply_decay)
    lib = _build.load(SR_KERNEL)
    fn = lib.pt_fused_adamw_sr_bf16 if g.dtype == torch.bfloat16 \
        else lib.pt_fused_adamw_sr_bf16_gf32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long] + \
        [ctypes.c_float] * 8 + [ctypes.c_uint32, ctypes.c_int,
                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_sm = torch.cuda.get_device_properties(p.device).multi_processor_count
    code = fn(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
              p.numel(), *scal, int(seed) & _M32, n_sm, _build.stream_of(p))
    _build.check(lib, code, "fused_adamw_sr_update")
    fused_adamw_sr_update.launches += 1


fused_adamw_sr_update.launches = 0
