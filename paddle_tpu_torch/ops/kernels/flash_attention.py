"""Flash attention, forward and backward (counterpart:
``paddle_tpu/ops/kernels/flash_attention.py``).

Replaces the Pallas kernels ``_fwd_kernel`` (``flash_attention.py:87``),
``_bwd_dkv_kernel`` (``:174``) and ``_bwd_dq_kernel`` (``:229``) with the
hand-written CUDA kernels ``paddle_tpu_torch/csrc/flash_attention_fwd.cu``
and ``flash_attention_bwd.cu``; the source notes there give the designs
and their bounds on the H100. :class:`FlashAttention` is the counterpart of
the reference's ``_flash_core`` custom VJP (``:370-426``).

Layout contract, as in the reference: Paddle's ``[B, S, H, D]`` at the
public functions, GQA by mapping q head ``h`` onto kv head ``h // (Hq /
Hkv)``, causal masking TOP-LEFT (row >= col) — which equals Paddle's
bottom-right causal only when ``Sq == Sk``, so causal calls with unequal
lengths are refused. The forward returns ``out`` in q's dtype and the
dropout-free ``lse = m + log(max(l, 1e-30))`` in float32, ``[B, Hq, Sq]``.
Dropout runs inside the kernels with the reference's position hash
(:func:`keep_mask`) and an int32 seed, the bits the reference carries in
its float32 ``seed_f``; forward and backward rebuild the same mask.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build

KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
_M32 = 0xFFFFFFFF


def _mul32(a, c):
    """``a * c mod 2**32`` for an int64 tensor ``a`` in ``[0, 2**32)`` and
    an int ``c`` in the same range, without leaving int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def keep_mask(seed, bh, rows, cols, sq, sk, dropout_p):
    """The reference's ``_keep_mask`` (``flash_attention.py:48-64``), bit
    for bit: a murmur3-style hash of the absolute position ``idx = (bh *
    sq + row) * sk + col`` (``bh`` the flat q-head index ``b * Hq + h``),
    int32 wraparound, compared on 31 bits with ``int(p * 2**31)``.
    ``bh``, ``rows`` and ``cols`` are broadcastable integer tensors; the
    arithmetic runs in int64 masked to 32 bits, with logical shifts."""
    idx = _mul32(bh.long() & _M32, sq & _M32)
    idx = _mul32((idx + rows.long()) & _M32, sk & _M32)
    idx = (idx + cols.long()) & _M32
    h = position_hash(idx, seed)
    return (h & 0x7FFFFFFF) >= int(dropout_p * 2147483648.0)


def position_hash(idx, seed):
    """The reference's murmur3-style position hash, shared by the dropout
    mask and the stochastic rounding of ``fused_adamw.py``: ``h = idx *
    0x9E3779B9 + seed``, then the murmur3 finalizer, all mod ``2**32``.
    ``idx`` is an int64 tensor in ``[0, 2**32)``; returns the same, with
    logical shifts."""
    h = (_mul32(idx, 0x9E3779B9) + (int(seed) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _dropout_consts(dropout_p):
    """(threshold, float32 1/(1-p)) as the reference computes them."""
    p = float(dropout_p)
    return int(p * 2147483648.0), float(torch.tensor(1.0 / (1.0 - p),
                                                     dtype=torch.float32))


def _positions(B, Hq, Sq, Sk, device):
    """``bh [B, Hq, 1, 1]``, ``rows [Sq, 1]``, ``cols [1, Sk]``."""
    bh = torch.arange(B * Hq, device=device).view(B, Hq, 1, 1)
    rows = torch.arange(Sq, device=device)[:, None]
    cols = torch.arange(Sk, device=device)[None, :]
    return bh, rows, cols


def _heads_first(q, k, v, G):
    """float32 ``[B, H, S, D]`` views, kv heads repeated over the group."""
    return (q.transpose(1, 2).float(),
            k.transpose(1, 2).float().repeat_interleave(G, dim=1),
            v.transpose(1, 2).float().repeat_interleave(G, dim=1))


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None,
                              dropout_p=0.0, seed=0):
    """The plain PyTorch version of the forward kernel: the same function
    in full float32 (scores, softmax statistics and the P@V accumulation),
    with P rounded to v's dtype before the P@V product as the kernel rounds
    it. Returns ``(out, lse)``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    qf, kf, vf = _heads_first(q, k, v, Hq // Hkv)
    s = torch.matmul(qf * scale, kf.transpose(-1, -2))      # [B, Hq, Sq, Sk]
    bh, rows, cols = _positions(B, Hq, Sq, Sk, q.device)
    if causal:
        s = s.masked_fill(cols > rows, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)       # unmasked p
    if dropout_p > 0.0:
        _, inv = _dropout_consts(dropout_p)
        keep = keep_mask(seed, bh, rows, cols, Sq, Sk, dropout_p)
        p = torch.where(keep, p, torch.zeros_like(p)) * inv
    o = torch.matmul(p.to(v.dtype).float(), vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype).transpose(1, 2).contiguous(), lse


def _bwd_plain(q, k, v, do, lse, delta, causal, scale, dropout_p, seed):
    """dq, dk, dv in float32, ``[B, H, S, D]``: the reference's ``_bwd``
    math (``flash_attention.py:174-330``) with P, Z and dS rounded to q's
    dtype before their products, as the kernels round them."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf, kf, vf = _heads_first(q, k, v, G)
    qs = qf * scale
    dof = do.transpose(1, 2).float()
    s = torch.matmul(qs, kf.transpose(-1, -2))
    bh, rows, cols = _positions(B, Hq, Sq, Sk, q.device)
    if causal:
        s = s.masked_fill(cols > rows, float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    z = p
    if dropout_p > 0.0:
        _, inv = _dropout_consts(dropout_p)
        keep = keep_mask(seed, bh, rows, cols, Sq, Sk, dropout_p)
        zero = torch.zeros_like(p)
        z = torch.where(keep, p, zero) * inv
        dp = torch.where(keep, dp, zero) * inv
    low = q.dtype
    dv = torch.matmul(z.to(low).float().transpose(-1, -2), dof)
    ds = (p * (dp - delta[..., None])).to(low).float()
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dq = torch.matmul(ds, kf) * scale
    if G > 1:
        dk = dk.view(B, Hkv, G, Sk, D).sum(dim=2)
        dv = dv.view(B, Hkv, G, Sk, D).sum(dim=2)
    return dq, dk, dv


def _out(x, dtype):
    return x.transpose(1, 2).to(dtype).contiguous()


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                                  scale=None, dropout_p=0.0, seed=0):
    """The plain version of the dK/dV kernel: ``(dk, dv)`` in k's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    _, dk, dv = _bwd_plain(q, k, v, do, lse, delta, causal, scale, dropout_p,
                           seed)
    return _out(dk, k.dtype), _out(dv, v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                                 scale=None, dropout_p=0.0, seed=0):
    """The plain version of the dQ kernel: ``dq`` in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    dq, _, _ = _bwd_plain(q, k, v, do, lse, delta, causal, scale, dropout_p,
                          seed)
    return _out(dq, q.dtype)


def attention_delta(out, do):
    """``delta = rowsum(dO * O)`` in float32, ``[B, Hq, Sq]`` (the reference
    computes it outside its kernels too, ``flash_attention.py:276``). Only
    ``out`` is copied to float32: the product casts ``do``'s elements as it
    reads them, the same values without a second copy."""
    return (out.float() * do).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              scale=None, dropout_p=0.0, seed=0):
    """The plain backward: ``(dq, dk, dv)``, dq in q's dtype, dk/dv in
    k's."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    dq, dk, dv = _bwd_plain(q, k, v, do, lse, attention_delta(out, do),
                            causal, scale, dropout_p, seed)
    return _out(dq, q.dtype), _out(dk, k.dtype), _out(dv, v.dtype)


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] q, k, v")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {k.shape[2]}")
    if causal and Sq != k.shape[1]:
        raise ValueError("causal flash attention masks top-left and needs "
                         "Sq == Sk (unequal lengths take the plain path)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v of different dtypes")


def _check_bwd(q, k, v, do, lse, delta, causal):
    _check(q, k, v, causal)
    B, Sq, Hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dout {tuple(do.shape)} {do.dtype} must match q")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, Hq, Sq) or t.dtype != torch.float32 or \
                t.device != q.device:
            raise ValueError(f"{name} must be float32 [B, Hq, Sq] on q's "
                             f"device, got {tuple(t.shape)} {t.dtype}")


#: the dtype and head dims the flash kernels take
KERNEL_DTYPE, KERNEL_HEAD_DIMS = torch.bfloat16, (64, 128)


def kernel_takes(dtype, head_dim):
    """Whether the flash kernels take a call of this dtype and head dim (the
    routing rule of ``scaled_dot_product_attention`` on a CUDA tensor; the
    wrappers raise on anything else)."""
    return dtype == KERNEL_DTYPE and head_dim in KERNEL_HEAD_DIMS


def _check_kernel(what, dtype, D, tensors):
    if dtype != KERNEL_DTYPE:
        raise TypeError(f"{what} kernel takes bfloat16, got {dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim 64 or 128, got {D}")
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             f"aligned")


def _device(q, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    return q.device.type


#: the forward kernel's geometry (``csrc/flash_attention_fwd.cu``): q rows
#: per CTA, kv rows per ring stage, ring stages, threads (a producer and two
#: consumer warpgroups), heads per launch group, and the shared memory a CTA
#: may take on the H100
FWD_BLOCK_Q, FWD_BLOCK_K, FWD_STAGES, FWD_THREADS = 128, 128, 2, 384
FWD_HEAD_GROUP = 16
SMEM_PER_BLOCK = 232_448


def _group_tile(rank, n_t, n_h, head_group, heavy_last):
    """The ``(head, tile)`` of the CTA launched ``rank``-th: heads in groups
    of ``head_group``, inside a group the tiles heaviest first across its
    heads (the heaviest is the last tile if ``heavy_last``, else the
    first)."""
    group, r = divmod(rank, head_group * n_t)
    heads = min(head_group, n_h - group * head_group)
    t = r // heads
    return group * head_group + r % heads, (n_t - 1 - t if heavy_last else t)


@dataclasses.dataclass(frozen=True)
class FwdLaunch:
    """One launch of the forward kernel: the tile sizes, the ring's stages,
    threads per CTA, the grid ``(q tiles, B * Hq)``, the dynamic shared
    memory in bytes, the heads per launch group, and for each q tile the
    kv tiles it walks (the causal limit)."""
    block_q: int
    block_k: int
    stages: int
    threads: int
    grid: tuple
    smem_bytes: int
    head_group: int
    kv_tiles: tuple

    def tile(self, rank):
        """The ``(bh, q tile)`` of the CTA launched ``rank``-th (blocks
        launch x fastest): heads in groups of ``head_group``, and inside a
        group the q tiles heaviest first across its heads."""
        n_qt, n_bh = self.grid
        return _group_tile(rank, n_qt, n_bh, self.head_group, True)


@functools.lru_cache(maxsize=256)
def fwd_launch_config(B, Sq, Sk, Hq, Hkv, D, causal):
    """The forward kernel's launch geometry for these shapes (the kernel
    states the same constants and checks them against these numbers).
    Shared memory: Q, then ``stages`` pairs of K and V tiles, 8-byte
    mbarriers (Q full; K full, V full, K empty, V empty per stage), and
    1024 bytes of slack to align the 128-byte-swizzled tiles to 1024
    bytes."""
    del Hkv     # GQA maps heads inside the CTA; the geometry ignores it
    bq, bk = FWD_BLOCK_Q, FWD_BLOCK_K
    n_qt, n_kt = -(-Sq // bq), -(-Sk // bk)
    tiles = tuple(min(n_kt, -(-(qt * bq + bq) // bk)) if causal else n_kt
                  for qt in range(n_qt))
    smem = 1024 + bq * D * 2 + FWD_STAGES * 2 * bk * D * 2 \
        + 8 * (1 + 4 * FWD_STAGES)
    return FwdLaunch(bq, bk, FWD_STAGES, FWD_THREADS, (n_qt, B * Hq), smem,
                     FWD_HEAD_GROUP, tiles)


@functools.lru_cache(maxsize=256)
def _check_fwd_launch(B, Sq, Sk, Hq, Hkv, D, causal):
    """Hold the kernel's constants against :func:`fwd_launch_config` for
    these shapes, once per distinct geometry; raises on a mismatch."""
    cfg = fwd_launch_config(B, Sq, Sk, Hq, Hkv, D, causal)
    lib = _build.load(KERNEL)
    chk = lib.pt_flash_attention_fwd_check_launch
    chk.argtypes = [ctypes.c_int] * 15
    chk.restype = ctypes.c_int
    code = chk(B, Sq, Sk, Hq, D, int(causal), cfg.block_q, cfg.block_k,
               cfg.stages, cfg.threads, cfg.smem_bytes, cfg.grid[0],
               cfg.grid[1], cfg.head_group, cfg.kv_tiles[-1])
    _build.check(lib, code, "flash_attention_fwd launch geometry")


def flash_attention_fwd(q, k, v, causal=False, scale=None, dropout_p=0.0,
                        seed=0):
    """Flash attention forward over ``[B, S, H, D]`` tensors; returns
    ``(out [B, Sq, Hq, D], lse [B, Hq, Sq] float32)``. ``0 <= dropout_p <
    1`` drops attention weights in the kernel with the position hash and
    the int32 ``seed``. No autograd: :class:`FlashAttention` is the
    differentiable form.

    CPU tensors take :func:`flash_attention_fwd_plain`. CUDA tensors launch
    the kernel (bf16, head dim 64 or 128, contiguous, 16-byte aligned) or
    raise."""
    _check(q, k, v, causal)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"flash attention dropout_p must be in [0, 1), got "
                         f"{dropout_p}")
    if _device(q, "flash_attention_fwd") == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale, dropout_p,
                                         seed)
    _check_kernel("flash_attention_fwd", q.dtype, D,
                  (("q", q), ("k", k), ("v", v)))
    thr, inv = _dropout_consts(dropout_p)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), device=q.device, dtype=torch.float32)
    _check_fwd_launch(B, Sq, Sk, Hq, Hkv, D, bool(causal))
    lib = _build.load(KERNEL)
    fn = lib.pt_flash_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
         ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), B, Sq, Sk, Hq, Hkv, D, scale, int(bool(causal)),
              int(dropout_p > 0.0), thr, inv, _seed32(seed),
              _build.stream_of(q))
    _build.check(lib, code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


#: the backward kernels' geometry (``csrc/flash_attention_bwd.cu``): the
#: dK/dV kernel's kv rows per CTA, q rows per ring stage and stages, the dQ
#: kernel's q rows per CTA, kv rows per ring stage and stages; both run
#: ``FWD_THREADS`` threads and heads in groups of ``FWD_HEAD_GROUP``
DKV_BLOCK_KV, DKV_BLOCK_Q, DKV_STAGES = 128, 64, 2
DQ_BLOCK_Q, DQ_BLOCK_K, DQ_STAGES = 128, 128, 2


@dataclasses.dataclass(frozen=True)
class BwdLaunch:
    """The launches of the backward kernels. dK/dV: a CTA per ``(b * Hkv +
    hk, kv tile)`` over ``dkv_grid = (kv tiles, B * Hkv)``, two consumers
    of 64 kv rows each, walking ``dkv_block_q``-row q tiles of every q head
    of the group from ``dkv_q_start[kv tile]``. dQ: a CTA per ``(b * Hq + h,
    q tile)`` over ``dq_grid``, walking ``dq_kv_tiles[q tile]`` kv tiles.
    Both: ``threads`` per CTA, rings of ``*_stages``, heads in groups of
    ``head_group``, dynamic shared memory ``*_smem`` bytes."""
    threads: int
    dkv_stages: int
    dq_stages: int
    head_group: int
    dkv_block_kv: int
    dkv_block_q: int
    dkv_grid: tuple
    dkv_smem: int
    dkv_q_start: tuple
    dq_block_q: int
    dq_block_k: int
    dq_grid: tuple
    dq_smem: int
    dq_kv_tiles: tuple
    causal: bool

    def dkv_tile(self, rank):
        """``(b * Hkv + hk, kv tile)`` of the dK/dV CTA launched
        ``rank``-th; the first kv tile walks the most q tiles."""
        n, n_h = self.dkv_grid
        return _group_tile(rank, n, n_h, self.head_group, False)

    def dq_tile(self, rank):
        """``(b * Hq + h, q tile)`` of the dQ CTA launched ``rank``-th."""
        n, n_h = self.dq_grid
        return _group_tile(rank, n, n_h, self.head_group, True)

    def dkv_q_tiles(self, kv_tile, consumer, n_q_tiles):
        """The q tiles that consumer ``consumer`` (0 or 1) of a dK/dV CTA
        multiplies, per q head: the CTA's walk without the tiles wholly
        above the diagonal of its 64 kv rows."""
        kvc0 = kv_tile * self.dkv_block_kv + 64 * consumer
        return [qt for qt in range(self.dkv_q_start[kv_tile], n_q_tiles)
                if not (self.causal and
                        qt * self.dkv_block_q + self.dkv_block_q - 1 < kvc0)]


@functools.lru_cache(maxsize=256)
def bwd_launch_config(B, Sq, Sk, Hq, Hkv, D, causal):
    """The backward kernels' launch geometry for these shapes (the kernels
    state the same constants and check them against these numbers). Shared
    memory, after 1024 bytes of slack to align the 128-byte-swizzled tiles:
    dK/dV K and V, then ``dkv_stages`` pairs of Q and dO tiles, each
    stage's lse and delta (float32), and 8-byte mbarriers (K/V full; full
    and empty per stage); dQ Q and dO, then ``dq_stages`` pairs of K and V
    tiles, and mbarriers (Q/dO full; K full, V full, K empty, V empty per
    stage)."""
    st, st_q = DKV_STAGES, DQ_STAGES
    n_kvt = -(-Sk // DKV_BLOCK_KV)
    q_start = tuple(kvt * DKV_BLOCK_KV // DKV_BLOCK_Q if causal else 0
                    for kvt in range(n_kvt))
    dkv_smem = 1024 + 2 * DKV_BLOCK_KV * D * 2 + st * 2 * DKV_BLOCK_Q * D * 2 \
        + st * 2 * DKV_BLOCK_Q * 4 + 8 * (1 + 2 * st)
    n_qt, n_kt = -(-Sq // DQ_BLOCK_Q), -(-Sk // DQ_BLOCK_K)
    kv_tiles = tuple(min(n_kt, -(-(qt * DQ_BLOCK_Q + DQ_BLOCK_Q)
                                 // DQ_BLOCK_K)) if causal else n_kt
                     for qt in range(n_qt))
    dq_smem = 1024 + 2 * DQ_BLOCK_Q * D * 2 + st_q * 2 * DQ_BLOCK_K * D * 2 \
        + 8 * (1 + 4 * st_q)
    return BwdLaunch(FWD_THREADS, st, st_q, FWD_HEAD_GROUP, DKV_BLOCK_KV,
                     DKV_BLOCK_Q, (n_kvt, B * Hkv), dkv_smem, q_start,
                     DQ_BLOCK_Q, DQ_BLOCK_K, (n_qt, B * Hq), dq_smem,
                     kv_tiles, bool(causal))


def bwd_check_args(B, Sq, Sk, Hq, Hkv, D, causal):
    """The arguments of ``pt_flash_attention_bwd_check_launch`` for these
    shapes, from :func:`bwd_launch_config`."""
    c = bwd_launch_config(B, Sq, Sk, Hq, Hkv, D, causal)
    return [B, Sq, Sk, Hq, Hkv, D, int(causal), c.threads, c.dkv_stages,
            c.dq_stages, c.head_group, c.dkv_block_kv, c.dkv_block_q,
            c.dkv_smem, c.dkv_grid[0], c.dkv_grid[1], c.dkv_q_start[-1],
            c.dq_block_q, c.dq_block_k, c.dq_smem, c.dq_grid[0],
            c.dq_grid[1], c.dq_kv_tiles[-1]]


@functools.lru_cache(maxsize=256)
def _check_bwd_launch(B, Sq, Sk, Hq, Hkv, D, causal):
    """Hold the kernels' constants against :func:`bwd_launch_config` for
    these shapes, once per distinct geometry; raises on a mismatch."""
    lib = _build.load(BWD_KERNEL)
    chk = lib.pt_flash_attention_bwd_check_launch
    chk.argtypes = [ctypes.c_int] * 23
    chk.restype = ctypes.c_int
    code = chk(*bwd_check_args(B, Sq, Sk, Hq, Hkv, D, causal))
    _build.check(lib, code, "flash_attention_bwd launch geometry")


def _seed32(seed):
    """The seed's low 32 bits as a C int."""
    s = int(seed) & _M32
    return s - (1 << 32) if s >= (1 << 31) else s


def _bwd_launch(entry, q, k, v, do, lse, delta, outs, causal, scale,
                dropout_p, seed):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check_kernel(entry, q.dtype, D, (("q", q), ("k", k), ("v", v),
                                      ("dout", do), ("lse", lse),
                                      ("delta", delta)))
    thr, inv = _dropout_consts(dropout_p)
    _check_bwd_launch(B, Sq, Sk, Hq, Hkv, D, bool(causal))
    lib = _build.load(BWD_KERNEL)
    fn = getattr(lib, f"pt_{entry}_bf16")
    fn.argtypes = [ctypes.c_void_p] * (6 + len(outs)) + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), *[o.data_ptr() for o in outs],
              B, Sq, Sk, Hq, Hkv, D, scale, int(bool(causal)),
              int(dropout_p > 0.0), thr, inv, _seed32(seed),
              _build.stream_of(q))
    _build.check(lib, code, entry)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None, dropout_p=0.0, seed=0):
    """dK and dV of flash attention from the forward's ``lse`` and
    ``delta`` (:func:`attention_delta`): ``(dk, dv)`` in k's dtype,
    ``[B, Sk, Hkv, D]``, GQA summed over each kv head's q heads.

    CPU tensors take :func:`flash_attention_bwd_dkv_plain`; CUDA tensors
    launch the kernel or raise."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if _device(q, "flash_attention_bwd_dkv") == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             scale, dropout_p, seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv", q, k, v, do, lse, delta, (dk, dv),
                causal, scale, dropout_p, seed)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False, scale=None,
                           dropout_p=0.0, seed=0):
    """dQ of flash attention: ``dq`` in q's dtype, ``[B, Sq, Hq, D]``.

    CPU tensors take :func:`flash_attention_bwd_dq_plain`; CUDA tensors
    launch the kernel or raise."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if _device(q, "flash_attention_bwd_dq") == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            scale, dropout_p, seed)
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, do, lse, delta, (dq,),
                causal, scale, dropout_p, seed)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None,
                        dropout_p=0.0, seed=0):
    """The backward of :func:`flash_attention_fwd` (the reference's
    ``_flash_vjp_bwd``, ``:411-423``): ``(dq, dk, dv)``, dq in q's dtype,
    dk and dv in k's. ``delta`` is computed here with torch ops.

    CPU tensors take :func:`flash_attention_bwd_plain`; CUDA tensors launch
    the dK/dV kernel and then the dQ kernel, or raise."""
    _check(q, k, v, causal)
    if _device(q, "flash_attention_bwd") == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale,
                                         dropout_p, seed)
    delta = attention_delta(out, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                     dropout_p, seed)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                                dropout_p, seed)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``_flash_core`` with
    ``defvjp``, ``flash_attention.py:370-426``): the forward kernel, then
    the backward kernels, on the card; the plain versions on the CPU.
    Saves ``q, k, v, out, lse`` and the dropout seed."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=None, dropout_p=0.0,
                seed=0):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, dropout_p,
                                       seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, dropout_p=0.0,
                    seed=0):
    """Differentiable flash attention over ``[B, S, H, D]``; returns
    ``out``."""
    return FlashAttention.apply(q, k, v, causal, scale, dropout_p, seed)
