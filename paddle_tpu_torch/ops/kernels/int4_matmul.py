"""Weight-only int4 GEMM (counterpart: ``paddle_tpu/ops/kernels/int4_matmul.py``).

Replaces the Pallas kernel ``_int4_mm_kernel`` (``int4_matmul.py:43``,
launched at ``:96`` through ``int4_matmul`` ``:72``) with the hand-written
CUDA kernel ``paddle_tpu_torch/csrc/int4_matmul.cu`` (B8); the source note
there gives its design and its bound on the H100.

``y = (x[:, 0::2] @ lo + x[:, 1::2] @ hi) * scales`` for ``x [rows, n_in]``
(bf16 or float32, at most 128 rows), ``packed`` int8 ``[n_in / 2, n_out]``
holding weight row 2i in the low nibble of byte i and row 2i+1 in its high
nibble (both sign-extended, the layout of ``nn.quant.weight_quantize``) and
float32 ``scales [n_out]``: the sum accumulates in float32, is scaled once
and is cast to ``out_dtype`` (default ``x.dtype``). Shapes must tile as the
reference's: ``n_in % 1024 == 0`` and ``n_out % 512 == 0``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "int4_matmul"

#: output columns one CTA of the kernel owns (``CTA_COLS`` in the source)
CTA_COLS = 256
#: fewest packed rows a K split keeps, so each of a CTA's 4 warps walks >= 32
MIN_SPLIT_ROWS = 128


def int4_matmul_tileable(n_in, n_out):
    """Shapes the kernel serves (the reference's rule, ``:67-69``)."""
    return n_in % 1024 == 0 and n_out % 512 == 0


def nibbles(p):
    """Sign-extended ``(low, high)`` int4 nibbles of packed int8 ``p``, as
    int8: the unpacking convention (row 2i low, row 2i+1 high) that the
    reference's ``nn/quant._nibbles`` defines and its kernel repeats."""
    return (p << 4) >> 4, p >> 4


def int4_matmul_plain(x, packed, scales, out_dtype=None):
    """The plain PyTorch version: both nibble products in float32, summed,
    scaled once in float32, cast to ``out_dtype`` (default ``x.dtype``)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    low, high = nibbles(packed)
    acc = (torch.matmul(x[:, 0::2].float(), low.float())
           + torch.matmul(x[:, 1::2].float(), high.float()))
    return (acc * scales.float()).to(out_dtype)


def split_count(n_in, n_out, n_sm):
    """K splits for the kernel's grid: doubled while the CTAs number fewer
    than two per SM and each split keeps >= ``MIN_SPLIT_ROWS`` packed
    rows (a power of two that divides ``n_in / 2``)."""
    k2, col_blocks, s = n_in // 2, n_out // CTA_COLS, 1
    while (col_blocks * s < 2 * n_sm and k2 % (2 * s) == 0
           and k2 // (2 * s) >= MIN_SPLIT_ROWS):
        s *= 2
    return s


_N_SM: dict[int, int] = {}


def _n_sm(device):
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _N_SM[idx]


def _entry():
    lib = _build.load(KERNEL)
    fn = lib.pt_int4_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def int4_matmul(x, packed, scales, out_dtype=None):
    """``x [rows, n_in] @ dequant(packed [n_in / 2, n_out]) * scales``.

    Raises unless ``n_in == 2 * packed.shape[0]``, the shape tiles
    (:func:`int4_matmul_tileable`) and ``rows <= 128`` (the reference's
    contract, ``:83-84``). CPU tensors take :func:`int4_matmul_plain`;
    CUDA tensors launch B8 (bf16 or float32 ``x`` and output, contiguous
    int8 ``packed``, contiguous float32 ``scales [n_out]``) or raise."""
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError("int4_matmul takes 2-D x and packed")
    rows, n_in = x.shape
    kt2_rows, n_out = packed.shape
    if not (n_in == 2 * kt2_rows and int4_matmul_tileable(n_in, n_out)
            and rows <= 128):
        raise ValueError(
            f"int4_matmul takes n_in == 2 * packed rows, n_in % 1024 == 0, "
            f"n_out % 512 == 0 and at most 128 rows; got rows {rows}, "
            f"n_in {n_in}, packed {tuple(packed.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"int4_matmul kernel takes bf16 or float32 x and "
                        f"output, got {x.dtype} -> {out_dtype}")
    if packed.dtype != torch.int8 or not packed.is_contiguous() or \
            packed.data_ptr() % 16:
        raise TypeError("int4_matmul: packed must be contiguous, 16-byte "
                        "aligned int8")
    if scales.dtype != torch.float32 or not scales.is_contiguous() or \
            tuple(scales.shape) != (n_out,):
        raise TypeError(f"int4_matmul: scales must be contiguous float32 "
                        f"[{n_out}]")
    if packed.device != x.device or scales.device != x.device:
        raise ValueError(f"int4_matmul: tensors on {x.device}, "
                         f"{packed.device}, {scales.device}")
    x = x.contiguous()
    n_sm = _n_sm(x.device)
    splits = split_count(n_in, n_out, n_sm)
    partial = torch.empty((splits, rows, n_out), device=x.device,
                          dtype=torch.float32)
    out = torch.empty((rows, n_out), device=x.device, dtype=out_dtype)
    lib, fn = _entry()
    code = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
              scales.data_ptr(), partial.data_ptr(), out.data_ptr(),
              int(out_dtype == torch.bfloat16), rows, n_in, n_out, splits,
              n_sm, _build.stream_of(x))
    _build.check(lib, code, "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0          # B8
