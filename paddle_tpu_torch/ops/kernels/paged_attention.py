"""Paged attention, decode and append forms (counterpart:
``paddle_tpu/ops/kernels/paged_attention.py``, unquantized).

Replaces two Pallas kernels with hand-written CUDA kernels:

- ``_decode_kernel`` (``paged_attention.py:370``, launched at ``:566``
  through ``paged_attention_decode`` ``:481``) with
  ``paddle_tpu_torch/csrc/paged_attention_decode.cu``;
- ``_append_kernel`` (``paged_attention.py:662``, launched at ``:868``
  through ``paged_attention_append`` ``:784``) with
  ``paddle_tpu_torch/csrc/paged_attention_append.cu``.

The source notes there give each design and its bound on the H100. B2,
B3 and both forms of B4 share one walk (``csrc/paged_split.cuh``): a
sequence's kv walk is split across CTAs whose float32 partials merge in a
fixed order (B2: spans of whole blocks, :func:`decode_launch_config`; B3:
the last real tile of a sequence when it holds few rows,
:func:`append_tile_splits`), with the pool blocks fed by TMA through an
mbarrier ring (B4: payload bytes, each tile row's scales beside its
position; B4-decode's last block j_last has a split of its own, whose CTA
requantizes it, :func:`decode_walks`). The wrapper passes each a float32
scratch and an int32 counter per (sequence, kv head), kept per device and
stream (:func:`_split_buffers`).

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

Quantized pools (``quant="int8"|"int4"``, the engine's
``kv_cache_dtype``; reference ``paged_attention.py:95-162``, ``:401-447``,
``:689-750``): int8 payload ``[NB, Hkv, bs, kv_packed_dim(D)]`` (int4
packs two head-dim elements per byte in the split-half layout of
:func:`kv_unpack`) with one float32 absmax scale per (physical block, kv
head) in ``k_scale``/``v_scale [NB, Hkv]``. Blocks dequantize on read
(``int * scale``). Every block a step writes is merged in float32, its
rows past the written end are ZEROED (stale content of a reused block
must not inflate the scale), its scale recomputed (absmax / qmax) and the
block requantized; attention reads the ROUND-TRIPPED values of the blocks
it wrote. Decode rewrites the last live block; append rewrites every
window block ``w0 <= j <= j_last`` and leaves a ``q_lens == 0`` slot's
blocks unchanged. A ``-1`` target parks payload and scale in the scratch
block. The plain versions' attention math is float32 throughout (P is not
rounded); B4-append rounds P times each key's V scale to bf16 for its
tensor-core product, as B3 rounds P over bf16 pools, and B4-decode keeps
that product to float32 precision as three exact bf16 terms. These forms are
kernel B4 (the int8/int4 instantiations of
``csrc/paged_attention_decode.cu`` and ``csrc/paged_attention_append.cu``;
rules shared in ``csrc/kv_quant.cuh``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading

import numpy as np
import torch

from . import _build

KERNEL = "paged_attention_decode"
APPEND_KERNEL = "paged_attention_append"

#: symmetric integer grid per KV quantization mode; int4 is [-7, 7] (not
#: -8), stored offset by +8 in a nibble
KV_QMAX = {"int8": 127.0, "int4": 7.0}


# ---------------------------------------------------------------------------
# KV quantization rules (reference paged_attention.py:95-162, op for op)
# ---------------------------------------------------------------------------

def kv_packed_dim(D, quant):
    """Last dim of the pool storage: D for int8 (and unquantized pools),
    ceil(D/2) bytes for int4 (odd D pads one nibble)."""
    if quant is None or quant == "int8":
        return D
    if quant == "int4":
        return (D + 1) // 2
    raise ValueError(f"unknown kv quant dtype {quant!r}")


def kv_unpack(vals, quant, D):
    """Quantized storage -> UNSCALED float32 grid values, last dim
    packed -> D. int4 is split-half: byte j holds element j in its low
    nibble and element ``Dp + j`` (Dp = ceil(D/2)) in its high nibble, each
    stored +8; odd D drops the final high nibble."""
    if quant == "int8":
        return vals.to(torch.float32)
    b = vals.to(torch.int32) & 0xFF
    lo = (b & 0xF) - 8
    hi = ((b >> 4) & 0xF) - 8
    return torch.cat([lo, hi], dim=-1)[..., :D].to(torch.float32)


def kv_pack(q, quant):
    """Grid values (already clipped) -> int8 storage; int4 packs nibble
    pairs in the split-half layout of :func:`kv_unpack`."""
    q = q.to(torch.int32)
    if quant == "int8":
        return q.to(torch.int8)
    D = q.shape[-1]
    Dp = (D + 1) // 2
    if 2 * Dp != D:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    lo = q[..., :Dp] + 8
    hi = q[..., Dp:] + 8
    return (lo | (hi << 4)).to(torch.int8)


def kv_quantize(x, scale, quant):
    """float32 values + (broadcastable) scale -> packed storage:
    ``x / max(scale, 1e-20)``, rounded half to even, clipped to +-qmax."""
    qmax = KV_QMAX[quant]
    q = torch.clamp(torch.round(x / torch.clamp(scale, min=1e-20)),
                    -qmax, qmax)
    return kv_pack(q, quant)


#: float32 ``1 / qmax``. The reference writes ``absmax / qmax``, and XLA
#: compiles a division by a constant into a product with its float32
#: reciprocal, which is what its compiled paths (the dense fallback, the
#: engine's prefill scatter) store; the port stores the same bits.
KV_INV_QMAX = {"int8": float(np.float32(1.0) / np.float32(127.0)),
               "int4": float(np.float32(1.0) / np.float32(7.0))}


def kv_block_scale(x, quant, dims):
    """Absmax scale of float32 block(s) over ``dims``: ``absmax *
    float32(1 / qmax)``. THE one scale rule: the kernels' in-CTA reduction
    (``csrc/kv_quant.cuh``) and the engine's prefill scatter compute it
    the same way."""
    inv = x.new_full((), KV_INV_QMAX[quant], dtype=torch.float32)
    return torch.amax(torch.abs(x), dim=dims) * inv


def kv_dequantize(vals, scale, quant, D):
    """Packed storage [..., bs, Dp] under scales [...] -> float32
    [..., bs, D]."""
    return kv_unpack(vals, quant, D) * scale[..., None, None]


def _attend_plain(q_rows, kseq, vseq, visible, scale, p_dtype):
    """The plain versions' attention: ``q_rows [B, Hkv, R, D]`` against
    ``kseq``/``vseq [B, Hkv, T, D]`` under ``visible [B, Hkv|1, R, T]``;
    float32 softmax, P rounded to ``p_dtype`` before P@V,
    ``acc / max(l, 1e-30)``."""
    s = torch.matmul(q_rows.float() * scale, kseq.float().transpose(-1, -2))
    s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)   # nothing visible
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p.to(p_dtype).float(), vseq.float()) / l


def _gather_seq(pool, tables, scales=None, quant=None, D=None):
    """Each sequence's logical K or V ``[B, Hkv, MB*bs, D]`` (float32 when
    quantized): blocks gathered through ``tables`` (-1 reads block 0, and
    the caller masks it)."""
    B, MB = tables.shape
    safe = tables.clamp(min=0)
    blks = pool[safe]                                 # [B, MB, Hkv, bs, Dp]
    if quant:
        blks = kv_dequantize(blks, scales[safe], quant, D)
    Hkv, bs = blks.shape[2], blks.shape[3]
    return blks.permute(0, 2, 1, 3, 4).reshape(B, Hkv, MB * bs, blks.shape[-1])


def _requant_blocks(pool, scales, src, tgt, rows_new, new_mask, live_end,
                    quant, D):
    """The quantized write rule on a batch of P blocks: dequantize blocks
    ``src [P]``, put ``rows_new [P, Hkv, bs, D]`` where ``new_mask [P, bs]``,
    zero rows at or past ``live_end [P]``, recompute the per-head absmax
    scale, requantize, and store payload and scale at ``tgt [P]`` (in
    place)."""
    bs = pool.shape[2]
    blk = kv_dequantize(pool[src], scales[src], quant, D)    # [P, Hkv, bs, D]
    blk = torch.where(new_mask[:, None, :, None], rows_new.float(), blk)
    dead = torch.arange(bs, device=pool.device)[None, :] >= live_end[:, None]
    blk = torch.where(dead[:, None, :, None], torch.zeros_like(blk), blk)
    s_new = kv_block_scale(blk, quant, (2, 3))               # [P, Hkv]
    pool[tgt] = kv_quantize(blk, s_new[..., None, None], quant)
    scales[tgt] = s_new


def paged_attention_decode_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                 new_k, new_v, scale=None, k_scale=None,
                                 v_scale=None, quant=None):
    """The plain PyTorch version of the decode kernels (same writes, same
    visible set, float32 softmax; unquantized pools round P to their dtype
    before P@V). Updates the pools in place and returns ``out [B, Hq, D]``;
    with ``quant`` it also rewrites the last live block of every slot under
    the quantized write rule and returns ``(out, k_pool, v_pool, k_scale,
    v_scale)``."""
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
    if quant:
        # the last live block of every slot (block 0's content for a -1
        # entry, parked in scratch): the new row at `slot`, rows past it
        # zeroed, rescaled and requantized
        new_mask = torch.arange(bs, device=dev)[None, :] == slot[:, None]
        src = phys.clamp(min=0)
        for pool, scales, new in ((k_pool, k_scale, new_k),
                                  (v_pool, v_scale, new_v)):
            _requant_blocks(pool, scales, src, tgt,
                            new[:, :, None, :].expand(B, Hkv, bs, D),
                            new_mask, slot + 1, quant, D)
    else:
        rows = torch.nonzero(slot < bs)[:, 0]
        k_pool[tgt[rows], :, slot[rows]] = new_k[rows].to(k_pool.dtype)
        v_pool[tgt[rows], :, slot[rows]] = new_v[rows].to(v_pool.dtype)

    kseq = _gather_seq(k_pool, tables, k_scale, quant, D)
    vseq = _gather_seq(v_pool, tables, v_scale, quant, D)
    pos = torch.arange(MB * bs, device=dev)
    blk = pos // bs
    visible = (pos[None, :] <= lens[:, None]) & \
        (blk[None, :] <= j_last[:, None]) & \
        (tables.gather(1, blk[None, :].expand(B, -1)) >= 0)   # [B, T]
    o = _attend_plain(q.reshape(B, Hkv, G, D), kseq, vseq,
                      visible[:, None, None, :], scale,
                      torch.float32 if quant else v_pool.dtype)
    out = o.reshape(B, Hq, D).to(q.dtype)
    if quant:
        return out, k_pool, v_pool, k_scale, v_scale
    return out


def _check_pools(what, D, Hq, k_pool, v_pool, k_scale, v_scale, quant):
    """Pool shapes against q's head dim, the scale arrays of a quantized
    pool, and the GQA ratio."""
    NB, Hkv, _, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != kv_packed_dim(D, quant):
        raise ValueError(f"{what}: pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} vs head dim {D} "
                         f"(quant={quant!r})")
    if quant:
        if k_scale is None or v_scale is None or \
                k_scale.shape != (NB, Hkv) or v_scale.shape != (NB, Hkv):
            raise ValueError(f"{what}: quant={quant!r} needs k_scale and "
                             f"v_scale [num_blocks, Hkv] = [{NB}, {Hkv}]")
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"{what}: scale arrays given without quant")
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")


def _check(q, k_pool, v_pool, block_tables, seq_lens, new_k, new_v,
           k_scale=None, v_scale=None, quant=None):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError("paged_attention_decode takes q [B, Hq, D] and "
                         "pools [NB, Hkv, bs, D]")
    B, Hq, D = q.shape
    Hkv = k_pool.shape[1]
    _check_pools("paged_attention_decode", D, Hq, k_pool, v_pool, k_scale,
                 v_scale, quant)
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            seq_lens.shape != (B,):
        raise ValueError("block_tables [B, MB] and seq_lens [B] expected")
    if new_k.shape != (B, Hkv, D) or new_v.shape != (B, Hkv, D):
        raise ValueError("new_k/new_v [B, Hkv, D] expected")
    devs = {t.device for t in (q, k_pool, v_pool, block_tables, seq_lens,
                               new_k, new_v, k_scale, v_scale)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"paged_attention_decode: tensors on {devs}")


def _rows_ok(t):
    """Inner ``[H, D]`` contiguous and 16-byte aligned; the outer strides
    may be anything that keeps rows aligned (q and the new K/V arrive as
    views of one fused qkv row)."""
    return t.stride(-1) == 1 and t.stride(-2) == t.shape[-1] and \
        all(st % 8 == 0 for st in t.stride()[:-2]) and \
        t.data_ptr() % 16 == 0


#: the head dims, query heads per kv head and largest block size the paged
#: kernels take
KERNEL_HEAD_DIMS, KERNEL_GROUPS = (64, 128), (1, 2, 4, 8)
KERNEL_MAX_BLOCK = 128


def kernel_takes(row_dtype, pool_dtype, D, G, bs, quant=None):
    """Whether the paged kernels (B2/B3, or B4 on a quantized pool) take a
    call: bf16 rows, a bf16 pool (int8 payload when quantized), head dim 64
    or 128, 1, 2, 4 or 8 query heads per kv head, block size <= 128 (the
    routing rule of ``block_multihead_attention`` on a CUDA tensor; the
    wrappers raise on anything else)."""
    pool_want = torch.int8 if quant else torch.bfloat16
    return row_dtype == torch.bfloat16 and pool_dtype == pool_want and \
        D in KERNEL_HEAD_DIMS and G in KERNEL_GROUPS and \
        bs <= KERNEL_MAX_BLOCK


def _check_kernel_args(what, rows, pools, ints, D, G, bs, quant=None,
                       scales=None):
    """What the paged kernels take, raising on anything else: bf16
    ``rows`` (q, new K/V), contiguous bf16 ``pools`` (int8 payload and
    contiguous float32 ``scales`` when quantized), contiguous int32
    ``ints`` (tables, lens), head dim 64 or 128, 1/2/4/8 query heads per kv
    head, block size <= 128."""
    pool_dtype = torch.int8 if quant else torch.bfloat16
    for name, t in rows.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel takes bfloat16 {name}, got "
                            f"{t.dtype}")
    for name, t in pools.items():
        if t.dtype != pool_dtype:
            raise TypeError(f"{what} kernel takes {pool_dtype} {name}, got "
                            f"{t.dtype}")
    for name, t in (scales or {}).items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{what}: {name} must be contiguous float32")
    for name, t in ints.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{what}: {name} must be contiguous int32")
    if D not in KERNEL_HEAD_DIMS:
        # odd head dims (int4 nibble padding) stay with the plain version
        raise ValueError(f"{what} kernel takes head_dim 64 or 128, got {D}")
    if G not in KERNEL_GROUPS:
        raise ValueError(f"{what} kernel takes 1, 2, 4 or 8 query heads "
                         f"per kv head")
    if bs > KERNEL_MAX_BLOCK:
        raise ValueError(f"{what} kernel takes block_size <= 128")
    if not all(t.is_contiguous() for t in pools.values()):
        raise ValueError(f"{what}: pools must be contiguous")
    for name, t in rows.items():
        if not _rows_ok(t):
            raise ValueError(f"{what}: {name} rows must be contiguous "
                             f"[H, D] and 16-byte aligned")


# ---------------------------------------------------------------------------
# B2/B3/B4 launch geometry (csrc/paged_split.cuh states the same constants)
# ---------------------------------------------------------------------------

#: q rows of a tile and kv rows of a ring stage; threads of a CTA (four
#: consumer warps and a producer warp)
SPLIT_ROWS, SPLIT_THREADS = 64, 160
#: B2's span rule: a span covers at least this many positions, and grows
#: until the grid holds about this many CTAs (8 per SM); picked from
#: ``tools/paged_sweep.py``, set for a sweep by :func:`set_decode_tuning`
DECODE_SPAN_POS, DECODE_TARGET_CTAS = 512, 1056
#: B3's split rule: the last real tile of a sequence splits only with at
#: most APPEND_SPLIT_MAX_ROWS real rows, into at most APPEND_MAX_SPLITS
#: walks of at least APPEND_SPLIT_MIN_POS positions
APPEND_MAX_SPLITS, APPEND_SPLIT_MAX_ROWS, APPEND_SPLIT_MIN_POS = 8, 32, 256


#: bits of a pool element per ``quant``
POOL_BITS = {None: 16, "int8": 8, "int4": 4}


def split_stages(D, quant=None):
    """Stages of the kv ring: bf16 3 at head dim 128, 4 at 64 (96 and 64
    KB, so two CTAs fit on an SM); a byte pool as many stages as those
    bytes hold, at most 8 (int8: 6 and 8, int4: 8 and 8)."""
    bits = POOL_BITS[quant]
    if bits == 16:
        return 3 if D == 128 else 4
    ring = 98304 if D == 128 else 65536
    return min(8, ring // (2 * SPLIT_ROWS * D * bits // 8))


def split_smem_bytes(D, quant=None):
    """Dynamic shared memory of a B2/B3/B4 CTA: 1024 bytes of alignment
    slack, the ring (K and V tiles of 64 pool rows per stage), each
    stage's 64 tile-row positions (a byte pool: and their K factors and V
    scales), a full and an empty mbarrier per stage, two ints (a byte
    pool: and the block requantization's reduction, 8 words, and byte
    table, 256 bytes)."""
    bits = POOL_BITS[quant]
    st = split_stages(D, quant)
    scales = st * 2 * SPLIT_ROWS * 4 if bits < 16 else 0
    return 1024 + st * 2 * SPLIT_ROWS * D * bits // 8 \
        + st * SPLIT_ROWS * 4 + scales + st * 16 + (304 if bits < 16 else 16)


@dataclasses.dataclass(frozen=True)
class PagedLaunch:
    grid: tuple             # (x, kv heads, sequences)
    span: int               # B2: pool blocks per split (B3: 0, on the device)
    splits: int             # B2: splits per sequence; B3: the most per tile
    smem_bytes: int
    stages: int
    threads: int
    scratch_rows: int       # partial rows per (sequence, kv head)
    scratch_floats: int     # float32 scratch: rows * (D + 2) per pair
    counters: int           # int32 counters: one per (sequence, kv head)


@functools.lru_cache(maxsize=256)
def decode_launch_config(B, Hq, Hkv, D, bs, MB, quant=None):
    """B2's (and B4-decode's) launch geometry, from what the host knows (no
    read of lens): a span of ``max(ceil(DECODE_SPAN_POS / bs), ceil(MB * B
    * Hkv / DECODE_TARGET_CTAS))`` blocks (at most MB), ``ceil(MB / span)``
    splits per sequence (B4: ``ceil((MB - 1) / span)`` spans of the
    history and one split that owns the last block); grid (splits, Hkv,
    B). A CTA whose split lies past its sequence's walks exits at once
    (:func:`decode_walks`)."""
    span = min(MB, max(-(-DECODE_SPAN_POS // bs),
                       -(-(MB * B * Hkv) // DECODE_TARGET_CTAS)))
    splits = -(-MB // span) if quant is None else -(-(MB - 1) // span) + 1
    rows = splits * (Hq // Hkv)
    return PagedLaunch((splits, Hkv, B), span, splits,
                       split_smem_bytes(D, quant), split_stages(D, quant),
                       SPLIT_THREADS, rows, B * Hkv * rows * (D + 2), B * Hkv)


@functools.lru_cache(maxsize=256)
def append_launch_config(B, S, Hq, Hkv, D, quant=None):
    """B3's (and B4-append's) launch geometry, from S, G, Hkv and B alone:
    one CTA per 64-row tile of the S*G rows of a head group; the split of a
    sequence's last tile is decided on the device
    (:func:`append_tile_splits`) and runs on the padding tiles' CTAs, so
    the grid does not grow with it."""
    G = Hq // Hkv
    return PagedLaunch((-(-S * G // SPLIT_ROWS), Hkv, B), 0,
                       APPEND_MAX_SPLITS, split_smem_bytes(D, quant),
                       split_stages(D, quant), SPLIT_THREADS, SPLIT_ROWS,
                       B * Hkv * SPLIT_ROWS * (D + 2), B * Hkv)


def decode_walks(L, bs, MB, span, quant=None):
    """B2's walks of a sequence with ``L`` cached tokens: ``(jb, je)``
    block ranges of splits 0, 1, ... (every block 0 .. j_last once); a
    split index past the list exits at once. B4 (``quant``): spans of
    blocks 0 .. j_last - 1, then ``(j_last, j_last + 1)``, the split whose
    CTA requantizes the last block."""
    j_last = min(L // bs, MB - 1)
    if quant is None:
        return [(jb, min(jb + span, j_last + 1))
                for jb in range(0, j_last + 1, span)]
    return [(jb, min(jb + span, j_last))
            for jb in range(0, j_last, span)] + [(j_last, j_last + 1)]


def append_tile_splits(L, QL, S, G, bs, MB):
    """B3's split rule for one sequence (the kernel's ``append_splits``):
    ``(t_last, rows, k)``, the last real tile, its real rows and the CTAs
    that walk it (1: not split; ``t_last = -1`` for an idle slot). Split s
    of k walks blocks ``[J*s // k, J*(s+1) // k)`` of the tile's ``J``."""
    n_tiles = -(-S * G // SPLIT_ROWS)
    real = min(QL, S) * G
    if real <= 0:
        return -1, 0, 1
    t_last = (real - 1) // SPLIT_ROWS
    R = real - t_last * SPLIT_ROWS
    if R > APPEND_SPLIT_MAX_ROWS:
        return t_last, R, 1
    max_lim = L + min(QL, S) - 1
    J = min(max_lim // bs, MB - 1) + 1
    npos = min(max_lim + 1, MB * bs)
    k = min(n_tiles - t_last, APPEND_MAX_SPLITS, SPLIT_ROWS // R,
            npos // APPEND_SPLIT_MIN_POS, J)
    return t_last, R, max(k, 1)


def append_tile_walks(L, QL, S, G, bs, MB):
    """Every walk of one (sequence, kv head) as B3 runs it: ``(row0,
    rows, split, k, jb, je)`` per CTA that walks (its tile's real rows
    ``[row0, row0 + rows)``, its blocks ``[jb, je)``)."""
    t_last, R_last, k_last = append_tile_splits(L, QL, S, G, bs, MB)
    walks = []
    for t in range(t_last + 1):
        r0 = t * SPLIT_ROWS
        R = R_last if t == t_last else SPLIT_ROWS
        k = k_last if t == t_last else 1
        J = min((L + (r0 + R - 1) // G) // bs, MB - 1) + 1
        walks += [(r0, R, s, k, J * s // k, J * (s + 1) // k)
                  for s in range(k)]
    return walks


def set_decode_tuning(span_pos, target_ctas):
    """Set B2's and B4-decode's span rule in the wrapper and in the
    kernel's library (for ``tools/paged_sweep.py``; needs the card)."""
    global DECODE_SPAN_POS, DECODE_TARGET_CTAS
    DECODE_SPAN_POS, DECODE_TARGET_CTAS = int(span_pos), int(target_ctas)
    lib = _build.load(KERNEL)
    lib.pt_paged_attention_decode_set_tuning.argtypes = [ctypes.c_int] * 2
    lib.pt_paged_attention_decode_set_tuning.restype = None
    lib.pt_paged_attention_decode_set_tuning(span_pos, target_ctas)
    decode_launch_config.cache_clear()
    _check_decode_launch.cache_clear()


_SPLIT_BUFS: dict = {}
_SPLIT_LOCK = threading.Lock()


def _split_buffers(dev, stream, cfg):
    """The float32 scratch and int32 counters of B2/B3/B4 and of B8
    (``int4_matmul``) on ``dev`` for launches on ``stream``: allocated once
    (the counters zeroed; every launch leaves them 0) and grown when a
    launch needs more. Launches on one stream run in order, so they share
    them; a buffer replaced while a launch on that stream still uses it is
    reused only after it."""
    key = (dev.index, stream.value)

    def fits(bufs):
        return bufs is not None and bufs[0].numel() >= cfg.scratch_floats \
            and bufs[1].numel() >= cfg.counters
    bufs = _SPLIT_BUFS.get(key)
    if not fits(bufs):
        with _SPLIT_LOCK:
            bufs = _SPLIT_BUFS.get(key)
            if not fits(bufs):
                n_f = max(cfg.scratch_floats, bufs[0].numel() if bufs else 0)
                n_c = max(cfg.counters, bufs[1].numel() if bufs else 0)
                bufs = (torch.empty(n_f, dtype=torch.float32, device=dev),
                        torch.zeros(n_c, dtype=torch.int32, device=dev))
                _SPLIT_BUFS[key] = bufs
    return bufs


_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
#: each C entry point's arguments (set once, when its library loads)
_ARGTYPES = {
    "pt_paged_attention_decode_bf16":
        [_P, _LL] + [_P] * 4 + [_P, _LL, _P, _LL, _P] + [_I] * 7 +
        [_F, _P, _P, _P],
    "pt_paged_attention_decode_int8":
        [_P, _LL] + [_P] * 6 + [_P, _LL, _P, _LL, _P] + [_I] * 7 +
        [_F, _P, _P, _P],
    "pt_paged_attention_append_bf16":
        [_P, _LL, _LL] + [_P] * 5 + [_P, _LL, _LL] * 2 + [_P] + [_I] * 8 +
        [_F, _P, _P, _P],
    "pt_paged_attention_append_int8":
        [_P, _LL, _LL] + [_P] * 7 + [_P, _LL, _LL] * 2 + [_P] + [_I] * 8 +
        [_F, _P, _P, _P],
    "pt_paged_attention_decode_check_launch": [_I] * 16,
    "pt_paged_attention_append_check_launch": [_I] * 18,
    "pt_paged_attention_append_splits": [_I] * 6,
}
_ARGTYPES["pt_paged_attention_decode_int4"] = \
    _ARGTYPES["pt_paged_attention_decode_int8"]
_ARGTYPES["pt_paged_attention_append_int4"] = \
    _ARGTYPES["pt_paged_attention_append_int8"]
_FNS: dict = {}


def _entry(kernel, name):
    """``(library, C function)`` of ``name`` in ``kernel``'s library, its
    argument types set once."""
    hit = _FNS.get(name)
    if hit is None:
        lib = _build.load(kernel)
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        hit = _FNS[name] = (lib, fn)
    return hit


@functools.lru_cache(maxsize=256)
def _check_decode_launch(B, Hq, Hkv, D, bs, MB, quant=None):
    """Hold B2's (B4-decode's) rule and constants against
    :func:`decode_launch_config` for this geometry, once per geometry;
    raises on a mismatch."""
    c = decode_launch_config(B, Hq, Hkv, D, bs, MB, quant)
    lib, chk = _entry(KERNEL, "pt_paged_attention_decode_check_launch")
    code = chk(B, Hq, Hkv, D, bs, MB, POOL_BITS[quant], *c.grid, c.span,
               c.splits, c.smem_bytes, c.stages, c.threads, c.scratch_rows)
    _build.check(lib, code, "paged_attention_decode launch geometry")


@functools.lru_cache(maxsize=256)
def _check_append_launch(B, S, Hq, Hkv, D, bs, MB, quant=None):
    """Hold B3's (B4-append's) constants and split rule's numbers against
    :func:`append_launch_config`, once per geometry; raises on a
    mismatch."""
    c = append_launch_config(B, S, Hq, Hkv, D, quant)
    lib, chk = _entry(APPEND_KERNEL, "pt_paged_attention_append_check_launch")
    code = chk(B, S, Hq, Hkv, D, bs, MB, POOL_BITS[quant], *c.grid,
               c.smem_bytes, c.stages, c.threads, c.scratch_rows,
               APPEND_MAX_SPLITS, APPEND_SPLIT_MAX_ROWS,
               APPEND_SPLIT_MIN_POS)
    _build.check(lib, code, "paged_attention_append launch geometry")


def paged_attention_decode(q, k_pool, v_pool, block_tables, seq_lens, new_k,
                           new_v, scale=None, k_scale=None, v_scale=None,
                           quant=None):
    """One paged decode step: writes the new K/V into the pools (in place)
    and returns ``out [B, Hq, D]`` in q's dtype; with ``quant`` ("int8" or
    "int4", int8 pools and float32 ``k_scale``/``v_scale [NB, Hkv]``) the
    last live block of each slot is requantized in place and the return
    is ``(out, k_pool, v_pool, k_scale, v_scale)``.

    CPU tensors take :func:`paged_attention_decode_plain`. CUDA tensors
    launch the kernel (bf16 q and new K/V, head dim 64 or 128, int32 tables
    and lens, contiguous pools; q and new K/V may be strided views of one
    qkv row; quantized pools launch B4-decode) or raise."""
    _check(q, k_pool, v_pool, block_tables, seq_lens, new_k, new_v, k_scale,
           v_scale, quant)
    B, Hq, D = q.shape
    NB, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pool, v_pool, block_tables,
                                            seq_lens, new_k, new_v, scale,
                                            k_scale, v_scale, quant)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device "
                         f"{q.device}")
    _check_kernel_args(
        "paged_attention_decode", dict(q=q, new_k=new_k, new_v=new_v),
        dict(k_pool=k_pool, v_pool=v_pool),
        dict(block_tables=block_tables, seq_lens=seq_lens), D, Hq // Hkv, bs,
        quant, dict(k_scale=k_scale, v_scale=v_scale) if quant else None)
    out = torch.empty((B, Hq, D), device=q.device, dtype=q.dtype)
    stream = _build.stream_of(q)
    _check_decode_launch(B, Hq, Hkv, D, bs, MB, quant)
    scratch, counters = _split_buffers(
        q.device, stream, decode_launch_config(B, Hq, Hkv, D, bs, MB, quant))
    if quant:
        lib, fn = _entry(KERNEL, f"pt_paged_attention_decode_{quant}")
        code = fn(q.data_ptr(), q.stride(0), k_pool.data_ptr(),
                  v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                  block_tables.data_ptr(), seq_lens.data_ptr(),
                  new_k.data_ptr(), new_k.stride(0), new_v.data_ptr(),
                  new_v.stride(0), out.data_ptr(), B, Hq, Hkv, D, bs, MB, NB,
                  scale, scratch.data_ptr(), counters.data_ptr(), stream)
        _build.check(lib, code, f"paged_attention_decode ({quant})")
        paged_attention_decode.quant_launches[quant] += 1
        return out, k_pool, v_pool, k_scale, v_scale
    lib, fn = _entry(KERNEL, "pt_paged_attention_decode_bf16")
    code = fn(q.data_ptr(), q.stride(0), k_pool.data_ptr(), v_pool.data_ptr(),
              block_tables.data_ptr(), seq_lens.data_ptr(), new_k.data_ptr(),
              new_k.stride(0), new_v.data_ptr(), new_v.stride(0),
              out.data_ptr(), B, Hq, Hkv, D, bs, MB, NB, scale,
              scratch.data_ptr(), counters.data_ptr(), stream)
    _build.check(lib, code, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0          # B2
paged_attention_decode.quant_launches = {"int8": 0, "int4": 0}   # B4


# ---------------------------------------------------------------------------
# append attention: q_len = chunk (the fused prefill+decode mixed step)
# ---------------------------------------------------------------------------

def paged_attention_append_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                 q_lens, new_k, new_v, scale=None,
                                 k_scale=None, v_scale=None, quant=None):
    """The plain PyTorch version of the append kernels: the reference
    Pallas kernel's writes (``-1`` targets park in the scratch block, blocks
    past the table drop), its visible set and its arithmetic (float32
    softmax, unquantized pools round P to their dtype before P@V,
    ``acc / max(l, 1e-30)``). Updates the pools in place and returns
    ``out [B, S, Hq, D]``; rows past ``q_lens`` and ``q_lens == 0`` slots
    are zeros. With ``quant`` every window block of a slot with
    ``q_lens > 0`` is rewritten under the quantized write rule (a
    ``q_lens == 0`` slot's blocks stay as they are) and the return is
    ``(out, k_pool, v_pool, k_scale, v_scale)``."""
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
    j_last = torch.clamp((lens + (qlens - 1).clamp(min=0)) // bs, max=MB - 1)
    if quant:
        # window blocks w0 .. j_last of each slot with rows to write
        w0 = torch.clamp(lens // bs, max=MB - 1)
        jj = w0[:, None] + torch.arange((S + bs - 1) // bs + 1, device=dev)
        bi, wi = torch.nonzero((jj <= j_last[:, None]) & (qlens[:, None] > 0),
                               as_tuple=True)
        j = jj[bi, wi]
        phys = tables[bi, j]
        src = phys.clamp(min=0)
        tgt = torch.where(phys < 0, torch.full_like(phys, NB - 1), phys)
        ci = j[:, None] * bs + torch.arange(bs, device=dev)[None, :] - \
            lens[bi][:, None]                                  # [P, bs]
        new_mask = (ci >= 0) & (ci < qlens[bi][:, None])
        cic = ci.clamp(0, S - 1)
        live_end = (lens + qlens)[bi] - j * bs
        for pool, scales, new in ((k_pool, k_scale, new_k),
                                  (v_pool, v_scale, new_v)):
            rows = new[bi[:, None], cic].permute(0, 2, 1, 3)   # [P, Hkv, bs, D]
            _requant_blocks(pool, scales, src, tgt, rows, new_mask,
                            live_end, quant, D)
    else:
        blk = pos // bs
        phys = tables.gather(1, blk.clamp(max=MB - 1))
        tgt = torch.where(phys < 0, torch.full_like(phys, NB - 1), phys)
        bi, ii = torch.nonzero((i_idx[None, :] < qlens[:, None]) & (blk < MB),
                               as_tuple=True)
        slot = pos % bs
        k_pool[tgt[bi, ii], :, slot[bi, ii]] = new_k[bi, ii].to(k_pool.dtype)
        v_pool[tgt[bi, ii], :, slot[bi, ii]] = new_v[bi, ii].to(v_pool.dtype)

    kseq = _gather_seq(k_pool, tables, k_scale, quant, D)
    vseq = _gather_seq(v_pool, tables, v_scale, quant, D)
    t = torch.arange(MB * bs, device=dev)
    tb = t // bs
    live = (tb[None, :] <= j_last[:, None]) & \
        (tables.gather(1, tb[None, :].expand(B, -1)) >= 0) & \
        (qlens[:, None] > 0)                                     # [B, T]
    visible = live[:, None, :] & \
        (t[None, None, :] <= pos[:, :, None])                    # [B, S, T]
    # [B, S, Hkv, G, D] -> [B, Hkv, S*G, D]: row r = i*G + g
    qg = q.reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, S * G, D)
    vis = visible[:, None, :, None, :].expand(B, Hkv, S, G, MB * bs) \
        .reshape(B, Hkv, S * G, MB * bs)
    o = _attend_plain(qg, kseq, vseq, vis, scale,
                      torch.float32 if quant else v_pool.dtype)
    o = o.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)
    real = (i_idx[None, :] < qlens[:, None])[:, :, None, None]
    out = torch.where(real, o, torch.zeros_like(o)).to(q.dtype)
    if quant:
        return out, k_pool, v_pool, k_scale, v_scale
    return out


def _check_append(q, k_pool, v_pool, block_tables, seq_lens, q_lens, new_k,
                  new_v, k_scale=None, v_scale=None, quant=None):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("paged_attention_append takes q [B, S, Hq, D] and "
                         "pools [NB, Hkv, bs, D]")
    B, S, Hq, D = q.shape
    Hkv = k_pool.shape[1]
    _check_pools("paged_attention_append", D, Hq, k_pool, v_pool, k_scale,
                 v_scale, quant)
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            seq_lens.shape != (B,) or q_lens.shape != (B,):
        raise ValueError("block_tables [B, MB], seq_lens [B] and q_lens [B] "
                         "expected")
    if new_k.shape != (B, S, Hkv, D) or new_v.shape != (B, S, Hkv, D):
        raise ValueError("new_k/new_v [B, S, Hkv, D] expected")
    devs = {t.device for t in (q, k_pool, v_pool, block_tables, seq_lens,
                               q_lens, new_k, new_v, k_scale, v_scale)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"paged_attention_append: tensors on {devs}")


def paged_attention_append(q, k_pool, v_pool, block_tables, seq_lens, q_lens,
                           new_k, new_v, scale=None, k_scale=None,
                           v_scale=None, quant=None):
    """One fused prefill+decode attention step off the block pools: writes
    each sequence's ``q_lens[b]`` new K/V rows into its blocks (in place)
    and returns ``out [B, S, Hq, D]`` in q's dtype (padding rows zero);
    with ``quant`` every window block is requantized in place and the
    return is ``(out, k_pool, v_pool, k_scale, v_scale)``.

    CPU tensors take :func:`paged_attention_append_plain`. CUDA tensors
    launch the kernel (bf16 q and new K/V, head dim 64 or 128, 1/2/4/8
    query heads per kv head, block size <= 128, int32 contiguous tables,
    lens and q_lens, contiguous pools; q and new K/V may be strided views
    of one qkv row; quantized pools launch B4-append) or raise."""
    _check_append(q, k_pool, v_pool, block_tables, seq_lens, q_lens, new_k,
                  new_v, k_scale, v_scale, quant)
    B, S, Hq, D = q.shape
    NB, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attention_append_plain(q, k_pool, v_pool, block_tables,
                                            seq_lens, q_lens, new_k, new_v,
                                            scale, k_scale, v_scale, quant)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_append: unsupported device "
                         f"{q.device}")
    _check_kernel_args(
        "paged_attention_append", dict(q=q, new_k=new_k, new_v=new_v),
        dict(k_pool=k_pool, v_pool=v_pool),
        dict(block_tables=block_tables, seq_lens=seq_lens, q_lens=q_lens),
        D, Hq // Hkv, bs, quant,
        dict(k_scale=k_scale, v_scale=v_scale) if quant else None)
    out = torch.empty((B, S, Hq, D), device=q.device, dtype=q.dtype)
    stream = _build.stream_of(q)
    head = [q.data_ptr(), q.stride(0), q.stride(1), k_pool.data_ptr(),
            v_pool.data_ptr()]
    rows = [block_tables.data_ptr(), seq_lens.data_ptr(), q_lens.data_ptr(),
            new_k.data_ptr(), new_k.stride(0), new_k.stride(1),
            new_v.data_ptr(), new_v.stride(0), new_v.stride(1),
            out.data_ptr(), B, S, Hq, Hkv, D, bs, MB, NB, scale]
    _check_append_launch(B, S, Hq, Hkv, D, bs, MB, quant)
    scratch, counters = _split_buffers(
        q.device, stream, append_launch_config(B, S, Hq, Hkv, D, quant))
    bufs = [scratch.data_ptr(), counters.data_ptr(), stream]
    if quant:
        lib, fn = _entry(APPEND_KERNEL, f"pt_paged_attention_append_{quant}")
        code = fn(*head, k_scale.data_ptr(), v_scale.data_ptr(), *rows, *bufs)
        _build.check(lib, code, f"paged_attention_append ({quant})")
        paged_attention_append.quant_launches[quant] += 1
        return out, k_pool, v_pool, k_scale, v_scale
    lib, fn = _entry(APPEND_KERNEL, "pt_paged_attention_append_bf16")
    code = fn(*head, *rows, *bufs)
    _build.check(lib, code, "paged_attention_append")
    paged_attention_append.launches += 1
    return out


paged_attention_append.launches = 0          # B3
paged_attention_append.quant_launches = {"int8": 0, "int4": 0}   # B4
