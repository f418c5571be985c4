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

The kernel runs ``mma.sync`` on nibbles unpacked in registers, fed by a TMA
ring, one launch a call: CTAs own 128 output columns and a K split
(:func:`launch_config`); the last CTA of a column block adds the float32
partials in split order. The wrapper passes a float32 scratch and an int32
counter per column block, kept per device and stream and shared with the
paged kernels (``paged_attention._split_buffers``), and allocates only
the output.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .paged_attention import _split_buffers

KERNEL = "int4_matmul"

#: output columns one CTA owns (``I4_COLS`` in the source): one 128-byte
#: TMA box row of the packed weight
CTA_COLS = 128
#: packed rows of a ring stage (``I4_KS``): 128 k
STAGE_ROWS = 64
#: the deepest ring (``I4_MAX_STAGES``)
MAX_STAGES = 16
#: stages each K split walks at least (``I4_MIN_SPLIT_STAGES``)
MIN_SPLIT_STAGES = 2
#: dynamic shared memory of a CTA when two share an SM (an SM holds 228
#: KB, each CTA reserves 1 KB) and when one has it alone (227 KB), and the
#: shallowest ring two CTAs keep (``I4_SMEM_TWO``, ``I4_SMEM_ONE``,
#: ``I4_MIN_STAGES_TWO``)
SM_SMEM = 233472
SMEM_TWO = SM_SMEM // 2 - 1024
SMEM_ONE = 232448
MIN_STAGES_TWO = 4
#: threads of a CTA: four consumer warps and one producer warp
THREADS = 160


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


def row_tiles(rows):
    """n8 tiles of x rows the kernel's template takes: the smallest power
    of two with ``8 * nt >= rows`` (1, 2, 4, 8 or 16)."""
    nt = 1
    while 8 * nt < rows:
        nt *= 2
    return nt


def stage_bytes(nt, x_bytes):
    """One ring stage: the 8 KB weight tile (64 packed rows x 128 columns)
    and the x tile (``8 * nt`` rows x 128 k of ``x_bytes``-byte elements)."""
    return STAGE_ROWS * CTA_COLS + 8 * nt * 2 * STAGE_ROWS * x_bytes


def _stages_in(budget, sb):
    """Stages of ``sb`` bytes that fit ``budget`` beside 1024 bytes of
    alignment slack, a full and an empty mbarrier each and the last-CTA
    flag (16 bytes), at most ``MAX_STAGES``."""
    return min(MAX_STAGES, (budget - 1040) // (sb + 16))


def ctas_per_sm(nt, x_bytes):
    """2 when two CTAs sharing an SM each still keep a ring of
    ``MIN_STAGES_TWO`` stages, else 1."""
    two = _stages_in(SMEM_TWO, stage_bytes(nt, x_bytes)) >= MIN_STAGES_TWO
    return 2 if two else 1


def ring_stages(nt, x_bytes):
    """Stages of the ring: as deep as the CTA's share of the SM holds."""
    budget = SMEM_TWO if ctas_per_sm(nt, x_bytes) == 2 else SMEM_ONE
    return _stages_in(budget, stage_bytes(nt, x_bytes))


def smem_bytes(nt, x_bytes):
    """Dynamic shared memory of a CTA: 1024 bytes of alignment slack, the
    ring, a full and an empty mbarrier per stage, the last-CTA flag."""
    return 1040 + ring_stages(nt, x_bytes) * (stage_bytes(nt, x_bytes) + 16)


def split_count(n_in, n_out, n_sm, per_sm):
    """K splits: as many as one wave of ``per_sm * n_sm`` CTAs holds over
    the ``n_out / 128`` column blocks, each split walking at least
    ``MIN_SPLIT_STAGES`` stages of 64 packed rows (split s takes stages
    ``[S * s // k, S * (s + 1) // k)`` of the ``S = n_in / 128``)."""
    blocks, stages = n_out // CTA_COLS, n_in // 2 // STAGE_ROWS
    return max(1, min(per_sm * n_sm // blocks, stages // MIN_SPLIT_STAGES))


@dataclasses.dataclass(frozen=True)
class Int4Launch:
    nt: int                 # n8 tiles of x rows (the template)
    grid: tuple             # (column blocks, K splits)
    splits: int
    stages: int
    smem_bytes: int
    ctas_per_sm: int
    threads: int
    scratch_floats: int     # float32 partials: splits * rows * n_out
    counters: int           # int32 counters: one per column block


@functools.lru_cache(maxsize=1024)
def launch_config(rows, n_in, n_out, x_bf16, n_sm):
    """B8's launch geometry for ``rows`` of ``x`` (bf16 if ``x_bf16``, else
    float32) against a ``[n_in / 2, n_out]`` packed weight on a card of
    ``n_sm`` SMs."""
    nt, xb = row_tiles(rows), 2 if x_bf16 else 4
    per_sm = ctas_per_sm(nt, xb)
    k = split_count(n_in, n_out, n_sm, per_sm)
    return Int4Launch(nt, (n_out // CTA_COLS, k), k, ring_stages(nt, xb),
                      smem_bytes(nt, xb), per_sm, THREADS,
                      k * rows * n_out if k > 1 else 0, n_out // CTA_COLS)


_N_SM: dict[int, int] = {}


def _n_sm(device):
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _N_SM[idx]


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "pt_int4_matmul": [_P, _I, _P, _P, _P, _I] + [_I] * 4 + [_P] * 3,
    "pt_int4_matmul_check_launch": [_I] * 12 + [_LL, _I],
}
_FNS: dict = {}


def _entry(name="pt_int4_matmul"):
    """``(library, C function)``, its argument types set once."""
    hit = _FNS.get(name)
    if hit is None:
        lib = _build.load(KERNEL)
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        hit = _FNS[name] = (lib, fn)
    return hit


@functools.lru_cache(maxsize=1024)
def _check_launch(rows, n_in, n_out, x_bf16, n_sm):
    """Hold :func:`launch_config` against the kernel's constants, once per
    geometry; raises on a mismatch."""
    c = launch_config(rows, n_in, n_out, x_bf16, n_sm)
    lib, chk = _entry("pt_int4_matmul_check_launch")
    code = chk(rows, n_in, n_out, int(x_bf16), n_sm, c.nt, *c.grid,
               c.smem_bytes, c.stages, c.threads, c.ctas_per_sm,
               c.scratch_floats, c.counters)
    _build.check(lib, code, "int4_matmul launch geometry")


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def int4_matmul(x, packed, scales, out_dtype=None):
    """``x [rows, n_in] @ dequant(packed [n_in / 2, n_out]) * scales``.

    Raises unless ``n_in == 2 * packed.shape[0]``, the shape tiles
    (:func:`int4_matmul_tileable`) and ``rows <= 128`` (the reference's
    contract, ``:83-84``). CPU tensors take :func:`int4_matmul_plain`;
    CUDA tensors launch B8 once (bf16 or float32 ``x`` and output,
    contiguous 16-byte aligned int8 ``packed``, contiguous float32
    ``scales [n_out]``; an ``x`` that is strided or not 16-byte aligned is
    copied first, and bf16 ``x`` with a float32 output is passed as
    float32) or raise."""
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
    dev = x.device
    if packed.device != dev or scales.device != dev:
        raise ValueError(f"int4_matmul: tensors on {dev}, "
                         f"{packed.device}, {scales.device}")
    if x.dtype == torch.bfloat16 and out_dtype == torch.float32:
        # the float32-x kernel: bf16 x splits into (x, 0, 0) there, and a
        # float32 output takes its rounded accumulation
        x = x.float()
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    if scales.data_ptr() % 16:
        scales = scales.clone()
    n_sm = _n_sm(dev)
    x_bf16 = x.dtype == torch.bfloat16
    _check_launch(rows, n_in, n_out, x_bf16, n_sm)
    cfg = launch_config(rows, n_in, n_out, x_bf16, n_sm)
    stream = _build.stream_of(x)
    scratch, counters = _split_buffers(dev, stream, cfg)
    out = torch.empty((rows, n_out), device=dev, dtype=out_dtype)
    lib, fn = _entry()
    code = fn(x.data_ptr(), int(x_bf16), packed.data_ptr(),
              scales.data_ptr(), out.data_ptr(),
              int(out_dtype == torch.bfloat16), rows, n_in, n_out, n_sm,
              scratch.data_ptr(), counters.data_ptr(), stream)
    _build.check(lib, code, "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0          # B8
