"""Paged attention, decode and append forms (counterpart:
``paddle_tpu/ops/kernels/paged_attention.py``, unquantized).

Replaces two Pallas kernels with hand-written CUDA kernels:

- ``_decode_kernel`` (``paged_attention.py:370``, launched at ``:566``
  through ``paged_attention_decode`` ``:481``) with
  ``paddle_tpu_torch/csrc/paged_attention_decode.cu``;
- ``_append_kernel`` (``paged_attention.py:662``, launched at ``:868``
  through ``paged_attention_append`` ``:784``) with
  ``paddle_tpu_torch/csrc/paged_attention_append.cu``.

The source notes there give each design and its bound on the H100.

Decode: one query token per sequence, straight off the physical
block pools ``[NB, Hkv, bs, D]`` through ``block_tables [B, MB]`` (-1 =
unallocated) and ``seq_lens [B]`` (tokens already cached):

- the new token's K/V is written at position ``seq_lens[b]``, into block
  ``tables[b, seq_lens[b] // bs]`` (the block index clamped into the
  table). A ``-1`` target is written to the pool's LAST block, the
  engine's scratch block, never to a real block: freed slots keep stale
  lens with wiped tables (``paged_attention.py:36-43``);
- attention covers positions ``<= seq_lens[b]`` of blocks
  ``0 .. seq_lens[b] // bs``; the dead tail past it and any ``-1`` entry
  are never visited (a ``-1`` write target therefore leaves the new token
  unattended, exactly as the reference kernel does);
- float32 online softmax, ``out = acc / max(l, 1e-30)``.

Append (the fused scheduler's mixed step): ``q [B, S, Hq, D]`` holds up to
S new positions per sequence, ``q_lens [B]`` of them real:

- row ``i < q_lens[b]`` writes position ``lens[b] + i`` into block
  ``tables[b, (lens[b] + i) // bs]``; a ``-1`` entry writes into the
  scratch block, a logical block ``>= MB`` drops; padding rows and
  ``q_lens == 0`` slots write nothing;
- attention walks blocks ``0 .. (lens + max(q_lens - 1, 0)) // bs``,
  skips ``-1`` entries and ``q_lens == 0`` slots, and row i sees
  positions ``<= lens + i`` (pooled history plus its own chunk prefix).
  Rows past ``q_lens`` are padding whose outputs the caller ignores.

The pools are updated IN PLACE (the reference returns new pools from a
functional call whose buffers it donates).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

KERNEL = "paged_attention_decode"
APPEND_KERNEL = "paged_attention_append"


def paged_attention_decode_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                 new_k, new_v, scale=None):
    """The plain PyTorch version of the kernel (same writes, same visible
    set, float32 softmax, P rounded to the pool dtype before P@V). Updates
    the pools in place and returns ``out [B, Hq, D]``."""
    B, Hq, D = q.shape
    NB, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    dev = q.device
    lens = seq_lens.to(device=dev, dtype=torch.long)
    tables = block_tables.to(device=dev, dtype=torch.long)
    j_last = torch.clamp(lens // bs, max=MB - 1)
    phys = tables.gather(1, j_last[:, None])[:, 0]
    slot = lens - j_last * bs
    tgt = torch.where(phys < 0, torch.full_like(phys, NB - 1), phys)
    rows = torch.nonzero(slot < bs)[:, 0]
    k_pool[tgt[rows], :, slot[rows]] = new_k[rows].to(k_pool.dtype)
    v_pool[tgt[rows], :, slot[rows]] = new_v[rows].to(v_pool.dtype)

    safe = tables.clamp(min=0)
    kseq = k_pool[safe].permute(0, 2, 1, 3, 4).reshape(B, Hkv, MB * bs, D)
    vseq = v_pool[safe].permute(0, 2, 1, 3, 4).reshape(B, Hkv, MB * bs, D)
    pos = torch.arange(MB * bs, device=dev)
    blk = pos // bs
    visible = (pos[None, :] <= lens[:, None]) & \
        (blk[None, :] <= j_last[:, None]) & \
        (tables.gather(1, blk[None, :].expand(B, -1)) >= 0)   # [B, T]
    qg = q.reshape(B, Hkv, G, D).float() * scale
    s = torch.matmul(qg, kseq.float().transpose(-1, -2))      # [B, Hkv, G, T]
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)   # nothing visible
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v_pool.dtype).float(), vseq.float()) / l
    return o.reshape(B, Hq, D).to(q.dtype)


def _check(q, k_pool, v_pool, block_tables, seq_lens, new_k, new_v):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError("paged_attention_decode takes q [B, Hq, D] and "
                         "pools [NB, Hkv, bs, D]")
    B, Hq, D = q.shape
    NB, Hkv, bs, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} vs q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            seq_lens.shape != (B,):
        raise ValueError("block_tables [B, MB] and seq_lens [B] expected")
    if new_k.shape != (B, Hkv, D) or new_v.shape != (B, Hkv, D):
        raise ValueError("new_k/new_v [B, Hkv, D] expected")
    devs = {t.device for t in (q, k_pool, v_pool, block_tables, seq_lens,
                               new_k, new_v)}
    if len(devs) != 1:
        raise ValueError(f"paged_attention_decode: tensors on {devs}")


def _rows_ok(t):
    """Inner ``[H, D]`` contiguous and 16-byte aligned; the outer strides
    may be anything that keeps rows aligned (q and the new K/V arrive as
    views of one fused qkv row)."""
    return t.stride(-1) == 1 and t.stride(-2) == t.shape[-1] and \
        all(st % 8 == 0 for st in t.stride()[:-2]) and \
        t.data_ptr() % 16 == 0


def _check_kernel_args(what, rows, pools, ints, D, G, bs):
    """What both paged kernels take, raising on anything else: bf16
    ``rows`` (q, new K/V) and contiguous bf16 ``pools``, contiguous int32
    ``ints`` (tables, lens), head dim 64 or 128, 1/2/4/8 query heads per kv
    head, block size <= 128."""
    for name, t in {**rows, **pools}.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel takes bfloat16 {name}, got "
                            f"{t.dtype}")
    for name, t in ints.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{what}: {name} must be contiguous int32")
    if D not in (64, 128):
        raise ValueError(f"{what} kernel takes head_dim 64 or 128, got {D}")
    if G not in (1, 2, 4, 8):
        raise ValueError(f"{what} kernel takes 1, 2, 4 or 8 query heads "
                         f"per kv head")
    if bs > 128:
        raise ValueError(f"{what} kernel takes block_size <= 128")
    if not all(t.is_contiguous() for t in pools.values()):
        raise ValueError(f"{what}: pools must be contiguous")
    for name, t in rows.items():
        if not _rows_ok(t):
            raise ValueError(f"{what}: {name} rows must be contiguous "
                             f"[H, D] and 16-byte aligned")


def paged_attention_decode(q, k_pool, v_pool, block_tables, seq_lens, new_k,
                           new_v, scale=None):
    """One paged decode step: writes the new K/V into the pools (in place)
    and returns ``out [B, Hq, D]`` in q's dtype.

    CPU tensors take :func:`paged_attention_decode_plain`. CUDA tensors
    launch the kernel (bf16, head dim 64 or 128, int32 tables and lens,
    contiguous pools; q and new K/V may be strided views of one qkv row)
    or raise."""
    _check(q, k_pool, v_pool, block_tables, seq_lens, new_k, new_v)
    B, Hq, D = q.shape
    NB, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pool, v_pool, block_tables,
                                            seq_lens, new_k, new_v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device "
                         f"{q.device}")
    _check_kernel_args(
        "paged_attention_decode", dict(q=q, new_k=new_k, new_v=new_v),
        dict(k_pool=k_pool, v_pool=v_pool),
        dict(block_tables=block_tables, seq_lens=seq_lens), D, Hq // Hkv, bs)
    out = torch.empty((B, Hq, D), device=q.device, dtype=q.dtype)
    lib = _build.load(KERNEL)
    fn = lib.pt_paged_attention_decode_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + \
        [ctypes.c_void_p] * 4 + \
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), q.stride(0), k_pool.data_ptr(), v_pool.data_ptr(),
              block_tables.data_ptr(), seq_lens.data_ptr(),
              new_k.data_ptr(), new_k.stride(0), new_v.data_ptr(),
              new_v.stride(0), out.data_ptr(), B, Hq, Hkv, D, bs, MB, NB,
              scale, _build.stream_of(q))
    _build.check(lib, code, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


# ---------------------------------------------------------------------------
# append attention: q_len = chunk (the fused prefill+decode mixed step)
# ---------------------------------------------------------------------------

def paged_attention_append_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                 q_lens, new_k, new_v, scale=None):
    """The plain PyTorch version of the append kernel: the reference Pallas
    kernel's writes (``-1`` targets park in the scratch block, blocks past
    the table drop), its visible set and its arithmetic (float32 softmax,
    P rounded to the pool dtype before P@V, ``acc / max(l, 1e-30)``).
    Updates the pools in place and returns ``out [B, S, Hq, D]``; rows
    past ``q_lens`` and ``q_lens == 0`` slots are zeros."""
    B, S, Hq, D = q.shape
    NB, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    dev = q.device
    lens = seq_lens.to(device=dev, dtype=torch.long)
    qlens = q_lens.to(device=dev, dtype=torch.long)
    tables = block_tables.to(device=dev, dtype=torch.long)
    i_idx = torch.arange(S, device=dev)
    pos = lens[:, None] + i_idx[None, :]                       # [B, S]
    blk = pos // bs
    phys = tables.gather(1, blk.clamp(max=MB - 1))
    tgt = torch.where(phys < 0, torch.full_like(phys, NB - 1), phys)
    bi, ii = torch.nonzero((i_idx[None, :] < qlens[:, None]) & (blk < MB),
                           as_tuple=True)
    slot = pos % bs
    k_pool[tgt[bi, ii], :, slot[bi, ii]] = new_k[bi, ii].to(k_pool.dtype)
    v_pool[tgt[bi, ii], :, slot[bi, ii]] = new_v[bi, ii].to(v_pool.dtype)

    j_last = torch.clamp((lens + (qlens - 1).clamp(min=0)) // bs, max=MB - 1)
    safe = tables.clamp(min=0)
    kseq = k_pool[safe].permute(0, 2, 1, 3, 4).reshape(B, Hkv, MB * bs, D)
    vseq = v_pool[safe].permute(0, 2, 1, 3, 4).reshape(B, Hkv, MB * bs, D)
    t = torch.arange(MB * bs, device=dev)
    tb = t // bs
    live = (tb[None, :] <= j_last[:, None]) & \
        (tables.gather(1, tb[None, :].expand(B, -1)) >= 0) & \
        (qlens[:, None] > 0)                                     # [B, T]
    visible = live[:, None, :] & \
        (t[None, None, :] <= pos[:, :, None])                    # [B, S, T]
    # [B, S, Hkv, G, D] -> [B, Hkv, S*G, D]: row r = i*G + g
    qg = q.reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, S * G, D).float() * scale
    s = torch.matmul(qg, kseq.float().transpose(-1, -2))       # [B, Hkv, SG, T]
    vis = visible[:, None, :, None, :].expand(B, Hkv, S, G, MB * bs) \
        .reshape(B, Hkv, S * G, MB * bs)
    s = s.masked_fill(~vis, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)     # nothing visible
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v_pool.dtype).float(), vseq.float()) / l
    o = o.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)
    real = (i_idx[None, :] < qlens[:, None])[:, :, None, None]
    return torch.where(real, o, torch.zeros_like(o)).to(q.dtype)


def _check_append(q, k_pool, v_pool, block_tables, seq_lens, q_lens, new_k,
                  new_v):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("paged_attention_append takes q [B, S, Hq, D] and "
                         "pools [NB, Hkv, bs, D]")
    B, S, Hq, D = q.shape
    NB, Hkv, bs, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} vs q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            seq_lens.shape != (B,) or q_lens.shape != (B,):
        raise ValueError("block_tables [B, MB], seq_lens [B] and q_lens [B] "
                         "expected")
    if new_k.shape != (B, S, Hkv, D) or new_v.shape != (B, S, Hkv, D):
        raise ValueError("new_k/new_v [B, S, Hkv, D] expected")
    devs = {t.device for t in (q, k_pool, v_pool, block_tables, seq_lens,
                               q_lens, new_k, new_v)}
    if len(devs) != 1:
        raise ValueError(f"paged_attention_append: tensors on {devs}")


def paged_attention_append(q, k_pool, v_pool, block_tables, seq_lens, q_lens,
                           new_k, new_v, scale=None):
    """One fused prefill+decode attention step off the block pools: writes
    each sequence's ``q_lens[b]`` new K/V rows into its blocks (in place)
    and returns ``out [B, S, Hq, D]`` in q's dtype (padding rows zero).

    CPU tensors take :func:`paged_attention_append_plain`. CUDA tensors
    launch the kernel (bf16, head dim 64 or 128, 1/2/4/8 query heads per
    kv head, block size <= 128, int32 contiguous tables, lens and q_lens,
    contiguous pools; q and new K/V may be strided views of one qkv row)
    or raise."""
    _check_append(q, k_pool, v_pool, block_tables, seq_lens, q_lens, new_k,
                  new_v)
    B, S, Hq, D = q.shape
    NB, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attention_append_plain(q, k_pool, v_pool, block_tables,
                                            seq_lens, q_lens, new_k, new_v,
                                            scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_append: unsupported device "
                         f"{q.device}")
    _check_kernel_args(
        "paged_attention_append", dict(q=q, new_k=new_k, new_v=new_v),
        dict(k_pool=k_pool, v_pool=v_pool),
        dict(block_tables=block_tables, seq_lens=seq_lens, q_lens=q_lens),
        D, Hq // Hkv, bs)
    out = torch.empty((B, S, Hq, D), device=q.device, dtype=q.dtype)
    lib = _build.load(APPEND_KERNEL)
    fn = lib.pt_paged_attention_append_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + \
        [ctypes.c_void_p] * 5 + \
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 2 + \
        [ctypes.c_void_p] + [ctypes.c_int] * 8 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), q.stride(0), q.stride(1), k_pool.data_ptr(),
              v_pool.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
              q_lens.data_ptr(), new_k.data_ptr(), new_k.stride(0),
              new_k.stride(1), new_v.data_ptr(), new_v.stride(0),
              new_v.stride(1), out.data_ptr(), B, S, Hq, Hkv, D, bs, MB, NB,
              scale, _build.stream_of(q))
    _build.check(lib, code, "paged_attention_append")
    paged_attention_append.launches += 1
    return out


paged_attention_append.launches = 0
