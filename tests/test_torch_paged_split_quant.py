"""Kernel B4's split walks (``paddle_tpu_torch/csrc/paged_split.cuh`` over
int8 and int4 pools) on the CPU: their launch geometry, the fragment
permutations the consumers take straight from the byte tiles, and a
float32 model of the quantized split-and-merge held against the plain
versions and the JAX package's Pallas kernels in interpret mode.

The fragment model works on bits: byte tiles laid out as TMA's 128-, 64-
and 32-byte swizzles write them, ``ldmatrix`` (plain and ``.trans``) as
the PTX manual defines its lanes, the kernel's byte-to-bf16 conversions,
q's permuted A fragments and ``mma.m16n8k16``'s fragment layout; S and
P V computed through them must equal the grid products exactly.

The walk model splits each (sequence, kv head) as the kernels do: B4-decode
walks spans of blocks 0 .. j_last - 1 (``decode_walks(..., quant)``) and
gives j_last a split of its own, whose CTA requantizes the block (the new
row at its slot, rows past it zeroed, the absmax scale, the rounding) and
attends it under the new scale; B4-append runs the write pass and then
B3's tiles and splits. Each tile row carries its block's K factor
(k_scale * scale * log2 e) and V scale; S's columns take the factor before
the mask, P's columns the V scale after l has summed P. Inputs are float32
from numpy seeds; the plain versions keep P in float32 too, so both sides
do the same math in another order: atol 2e-5, rtol 1e-4 (the tolerance of
``tests/test_torch_kv_quant.py``). Payload and scales are bit for bit
outside the scratch block."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.kernels.paged_attention import (
    paged_attention_append as jax_paged_append,
    paged_attention_decode as jax_paged_decode)

from paddle_tpu_torch.ops.kernels import paged_attention as pa

torch.set_num_threads(1)
QUANTS = ("int8", "int4")
TOL = dict(atol=2e-5, rtol=1e-4)
SMEM_LIMIT = 232448          # 227 KB: the most one CTA may use on an H100
SM_SMEM = 233472             # 228 KB an SM holds; each CTA reserves 1 KB
LOG2E = np.float32(1.4426950408889634)

BLOCK_SIZES = (16, 32, 48, 64, 100, 128)
GEOMETRIES = [(D, G, bs, MB) for D in (64, 128) for G in (1, 2, 4, 8)
              for bs in BLOCK_SIZES for MB in (1, 32, 128)]


@pytest.fixture
def pallas_kernels(monkeypatch):
    """The reference decode and append kernels, in interpret mode on the
    CPU. This jax renamed ``pltpu.TPUCompilerParams`` to
    ``CompilerParams``; the old name is aliased for the duration of the
    test only (the JAX package is not touched)."""
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    return jax_paged_decode, jax_paged_append


def _lens_for(bs, MB):
    cap = MB * bs
    return sorted({0, 1, bs - 1, bs, bs + 1, cap // 2, cap - 1, cap,
                   cap + 7, 5 * bs + 3})


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("D,G,bs,MB", GEOMETRIES)
def test_quant_decode_launch_walks_every_live_block_once(D, G, bs, MB,
                                                         quant):
    """B4-decode: B2's spans over blocks 0 .. j_last - 1, then j_last alone
    on split k - 1; the grid holds every sequence's splits; the ring is
    deeper than bf16's and two CTAs still fit an SM."""
    B, Hkv = 3, 2
    cfg = pa.decode_launch_config(B, G * Hkv, Hkv, D, bs, MB, quant)
    bf = pa.decode_launch_config(B, G * Hkv, Hkv, D, bs, MB)
    assert cfg.span == bf.span
    assert cfg.smem_bytes <= SMEM_LIMIT
    assert 2 * (cfg.smem_bytes + 1024) <= SM_SMEM
    assert cfg.stages > bf.stages and cfg.stages <= 8
    assert cfg.grid == (cfg.splits, Hkv, B) and cfg.threads == 160
    assert cfg.splits == -(-(MB - 1) // cfg.span) + 1
    assert cfg.scratch_floats == B * G * Hkv * cfg.splits * (D + 2)
    rng = np.random.default_rng(D + G + bs + MB)
    for L in _lens_for(bs, MB):
        j_last = min(L // bs, MB - 1)
        walks = pa.decode_walks(L, bs, MB, cfg.span, quant)
        assert 1 <= len(walks) <= cfg.splits
        assert walks[-1] == (j_last, j_last + 1)
        assert all(je > jb for jb, je in walks)
        assert [j for jb, je in walks for j in range(jb, je)] == \
            list(range(j_last + 1))
        assert all(jb == s * cfg.span for s, (jb, _) in
                   enumerate(walks[:-1]))
        row = rng.integers(-1, 50, size=MB)
        seen = [j for jb, je in walks[:-1] for j in range(jb, je)
                if row[j] >= 0]
        assert seen == [j for j in range(j_last) if row[j] >= 0]


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("D,G,bs,MB", GEOMETRIES)
def test_quant_append_launch_matches_b3(D, G, bs, MB, quant):
    """B4-append: B3's grid, tiles, splits and scratch over byte stages; a
    deeper ring within 227 KB, two CTAs an SM."""
    B, Hkv, S = 2, 2, 48
    cfg = pa.append_launch_config(B, S, G * Hkv, Hkv, D, quant)
    bf = pa.append_launch_config(B, S, G * Hkv, Hkv, D)
    assert cfg.grid == bf.grid and cfg.scratch_floats == bf.scratch_floats
    assert cfg.smem_bytes <= SMEM_LIMIT
    assert 2 * (cfg.smem_bytes + 1024) <= SM_SMEM
    assert cfg.stages == pa.split_stages(D, quant) > bf.stages
    # the epilogue's 64 rows of (acc, m, l) reuse the ring
    ring = cfg.stages * 2 * 64 * pa.kv_packed_dim(D, quant)
    assert 64 * (D + 2) * 4 <= ring


# ---------------------------------------------------------------------------
# the fragment permutations, on bits
# ---------------------------------------------------------------------------

def _bf16_bits(x):
    """float32 values (exactly representable in bf16) -> their bf16 bits."""
    b = np.asarray(x, np.float32).view(np.uint32)
    assert not (b & 0xFFFF).any()
    return (b >> 16).astype(np.uint32)


def _bf16_val(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _byte_perm(x, y, s):
    """CUDA's __byte_perm (selector nibbles 0-7)."""
    src = [(int(x) >> (8 * i)) & 0xFF for i in range(4)] + \
          [(int(y) >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _i8x4_bf16(w):
    """The kernel's ``i8x4_bf16``: bytes (0, 2) and (1, 3) as bf16x2."""
    u = int(w) ^ 0x80808080
    f = [np.float32(np.array(_byte_perm(u, 0x4B000000, 0x7650 + i),
                             np.uint32).view(np.float32))
         - np.float32(8388736.0) for i in range(4)]
    fb = [int(np.array(v, np.float32).view(np.uint32)) for v in f]
    return _byte_perm(fb[0], fb[2], 0x7632), _byte_perm(fb[1], fb[3], 0x7632)


def _i4x2_bf16(w, shift):
    """The kernel's ``i4x2_bf16``: nibbles at ``shift`` of bytes 0 and 2
    minus 8, as bf16x2 (128 + n in bf16, minus 136: exact)."""
    x = ((int(w) >> shift) & 0x000F000F) | 0x43004300
    lo, hi = _bf16_val([x & 0xFFFF, x >> 16]) - np.float32(136.0)
    return int(_bf16_bits(lo)) | (int(_bf16_bits(hi)) << 16)


def _swzb(row, chunk, RB):
    """The kernel's ``swzb``: TMA's swizzle at the row's width."""
    return row * RB + ((chunk ^ ((row * RB >> 7) & (RB // 16 - 1))) << 4)


def _tile(rows, RB):
    """A byte tile of 64 rows as TMA lands it: row r's 16-byte chunk c at
    ``_swzb(r, c)``."""
    sm = np.zeros(64 * RB, np.uint8)
    for r in range(rows.shape[0]):
        for c in range(RB // 16):
            o = _swzb(r, c, RB)
            sm[o:o + 16] = rows[r, 16 * c:16 * c + 16]
    return sm


def _ldsm_x4(sm, addrs, trans):
    """ldmatrix.x4 (b16): lane l gives the row address of row l % 8 of
    matrix l // 8; each thread gets one 32-bit register per matrix."""
    regs = np.zeros((32, 4), np.uint32)
    for m in range(4):
        rows = [sm[addrs[8 * m + i]:addrs[8 * m + i] + 16].view(np.uint16)
                for i in range(8)]
        # a bank-conflict-free phase: the eight rows in eight 16-byte
        # bank groups
        assert len({(addrs[8 * m + i] >> 4) & 7 for i in range(8)}) == 8
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            if trans:
                lo, hi = rows[2 * t][g], rows[2 * t + 1][g]
            else:
                lo, hi = rows[g][2 * t], rows[g][2 * t + 1]
            regs[lane, m] = int(lo) | (int(hi) << 16)
    return regs


def _mma(a, b):
    """mma.m16n8k16 with bf16 fragments a [32, 4] and b [32, 2]: the
    [16, 8] product, in float64 (exact for these values)."""
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i, (r, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            A[r, k:k + 2] = _bf16_val([a[lane, i] & 0xFFFF, a[lane, i] >> 16])
        for i, k in enumerate((2 * t, 2 * t + 8)):
            Bm[k:k + 2, g] = _bf16_val([b[lane, i] & 0xFFFF, b[lane, i] >> 16])
    return A @ Bm


def _c_frag(C):
    """The accumulator fragment of a [16, 8] product: lane (g, t) holds
    (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)."""
    return np.array([[C[l >> 2, 2 * (l & 3)], C[l >> 2, 2 * (l & 3) + 1],
                      C[(l >> 2) + 8, 2 * (l & 3)],
                      C[(l >> 2) + 8, 2 * (l & 3) + 1]] for l in range(32)])


def _quant_dim(n, e, t, quant, Dp):
    """The kernel's ``quant_dim``: head dim of accumulator e of n8 tile n."""
    if quant == "int8":
        return 16 * (n >> 1) + 4 * t + 2 * e + (n & 1)
    return ((n >> 1) & 1) * Dp + 16 * (n >> 2) + 4 * t + 2 * e + (n & 1)


def _grid_bytes(rng, quant, rows, D):
    """Random stored rows and their grid values [rows, D]."""
    if quant == "int8":
        g = rng.integers(-127, 128, size=(rows, D))
        return g.astype(np.int8).view(np.uint8), g.astype(np.float64)
    g = rng.integers(-7, 8, size=(rows, D))
    st = pa.kv_pack(torch.from_numpy(g), "int4").numpy().view(np.uint8)
    return st, g.astype(np.float64)


def _lane_rows(tr0, lane):
    return tr0 + (((lane >> 3) & 1) << 3) + (lane & 7)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("D", [64, 128])
def test_score_fragments_from_byte_tiles(quant, D):
    """S = q K^T through the kernel's fragments: K's bytes by ldmatrix from
    the swizzled tile (16 positions of a 64-row stage), converted in
    registers, against q's A fragments in the permuted order (k-step kk:
    dims 16kk + 4t + {0, 2}, {1, 3}; int4's high nibbles are k-steps
    Dp / 16 on). Equal to the grid product exactly."""
    rng = np.random.default_rng(D + len(quant))
    Dp = pa.kv_packed_dim(D, quant)
    NC = Dp // 16
    tr0 = 16
    stored, grid = _grid_bytes(rng, quant, 64, D)
    sm = _tile(stored, Dp)
    qf = (rng.standard_normal((16, D)).astype(np.float32).view(np.uint32)
          & 0xFFFF0000).view(np.float32)                  # bf16 values
    qbits = _bf16_bits(qf)
    qa = np.zeros((D // 16, 32, 4), np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for kk in range(D // 16):
            for hr in range(2):
                r = g + 8 * hr
                c = kk * 16 + t * 4
                x0 = int(qbits[r, c]) | (int(qbits[r, c + 1]) << 16)
                x1 = int(qbits[r, c + 2]) | (int(qbits[r, c + 3]) << 16)
                qa[kk, lane, hr] = _byte_perm(x0, x1, 0x5410)
                qa[kk, lane, hr + 2] = _byte_perm(x0, x1, 0x7632)
    sc = np.zeros((2, 32, 4))
    for c in range(0, NC, 2):
        addrs = [_swzb(_lane_rows(tr0, l), c + (l >> 4), Dp)
                 for l in range(32)]
        kf = _ldsm_x4(sm, addrs, trans=False)
        for h in range(2):
            for n in range(2):
                x = kf[:, 2 * h + n]
                if quant == "int8":
                    bb = np.array([_i8x4_bf16(w) for w in x], np.uint32)
                    sc[n] += _c_frag(_mma(qa[c + h], bb))
                else:
                    bb = np.array([[_i4x2_bf16(w, 0), _i4x2_bf16(w, 8)]
                                   for w in x], np.uint32)
                    sc[n] += _c_frag(_mma(qa[c + h], bb))
                    bb = np.array([[_i4x2_bf16(w, 4), _i4x2_bf16(w, 12)]
                                   for w in x], np.uint32)
                    sc[n] += _c_frag(_mma(qa[c + h + NC], bb))
    want = qf.astype(np.float64) @ grid[tr0:tr0 + 16].T      # [16, 16]
    for n in range(2):
        np.testing.assert_array_equal(sc[n], _c_frag(want[:, 8 * n:8 * n + 8]))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("D", [64, 128])
def test_value_fragments_from_byte_tiles(quant, D):
    """O = P V through the kernel's fragments: V's bytes by ldmatrix.trans
    (two positions' bytes 2g, 2g + 1 a thread), converted in registers, P
    as the score accumulators' A fragment; the epilogue's ``quant_dim``
    puts each accumulator at its head dim. Equal to the grid product
    exactly."""
    rng = np.random.default_rng(2 * D + len(quant))
    Dp = pa.kv_packed_dim(D, quant)
    NC = Dp // 16
    tr0 = 32
    stored, grid = _grid_bytes(rng, quant, 64, D)
    sm = _tile(stored, Dp)
    P = (rng.random((16, 16)).astype(np.float32).view(np.uint32)
         & 0xFFFF0000).view(np.float32)                   # bf16 values
    pb = _bf16_bits(P)
    pa_ = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i, (r, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            pa_[lane, i] = int(pb[r, k]) | (int(pb[r, k + 1]) << 16)
    o = np.zeros((D // 8, 32, 4))
    for c in range(0, NC, 2):
        addrs = [_swzb(_lane_rows(tr0, l), c + (l >> 4), Dp)
                 for l in range(32)]
        vf = _ldsm_x4(sm, addrs, trans=True)
        for h in range(2):
            cc = c + h
            x0, x1 = vf[:, 2 * h], vf[:, 2 * h + 1]
            if quant == "int8":
                ev = [_i8x4_bf16(w) for w in x0]
                ev1 = [_i8x4_bf16(w) for w in x1]
                for s in range(2):
                    bb = np.array([[a[s], b[s]] for a, b in zip(ev, ev1)],
                                  np.uint32)
                    o[2 * cc + s] += _c_frag(_mma(pa_, bb))
            else:
                for hs in range(4):
                    sh = 4 * (hs >> 1) + 8 * (hs & 1)
                    bb = np.array([[_i4x2_bf16(a, sh), _i4x2_bf16(b, sh)]
                                   for a, b in zip(x0, x1)], np.uint32)
                    o[4 * cc + hs] += _c_frag(_mma(pa_, bb))
    got = np.full((16, D), np.nan)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for n in range(D // 8):
            for hr in range(2):
                for e in range(2):
                    got[g + 8 * hr, _quant_dim(n, e, t, quant, Dp)] = \
                        o[n, lane, 2 * hr + e]
    want = P.astype(np.float64) @ grid[tr0:tr0 + 16]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Dp", [128, 64, 32])
def test_byte_swizzle_is_a_bijection(Dp):
    """Every 16-byte chunk of a 64-row tile lands once, inside the tile,
    and the eight rows an ldmatrix phase reads fall in eight bank
    groups."""
    offs = sorted(_swzb(r, c, Dp) for r in range(64) for c in range(Dp // 16))
    assert offs == list(range(0, 64 * Dp, 16))
    for r0 in range(0, 64, 8):
        for c in range(Dp // 16):
            assert len({(_swzb(r0 + i, c, Dp) >> 4) & 7
                        for i in range(8)}) == 8


def _pool_boxes(bs):
    """The kernel's ``pool_boxes``: rows of a TMA box, boxes of a block
    (two above 64 rows), tile rows of a box slot (rounded up to 8), box
    slots of a stage."""
    nbb = 1 if bs <= 64 else 2
    br = -(-bs // nbb)
    brs = (br + 7) & ~7
    return br, nbb, brs, 64 // brs


def _tma_swizzle(addr, RB):
    """Where TMA's RB-byte swizzle (RB = 128, 64, 32) puts the byte at
    shared-memory address ``addr`` of its box laid out row after row:
    address bits 7 and up XORed into the 16-byte chunk bits."""
    return addr ^ (((addr >> 7) & (RB // 16 - 1)) << 4)


def _producer(walk, tables_row, kvh, Hkv, bs, max_lim, owner=False):
    """The producer warp's stages for a walk over blocks ``walk``: per
    stage, the (block, box, first position, rows) of each box slot, in
    the kernel's order (-1 entries skipped, or block 0's content for
    B4-decode's owner; a block's second box only if its first position
    is visible)."""
    br, nbb, brs, bps = _pool_boxes(bs)
    boxes = []
    for j in walk:
        if tables_row[j] < 0 and not owner:
            continue
        for bi in range(nbb):
            if bi and j * bs + bi * br > max_lim:
                break
            nr = 0 if tables_row[j] < 0 else min(br, bs - bi * br)
            src = (max(int(tables_row[j]), 0) * Hkv + kvh) * bs + bi * br
            boxes.append((j, bi, j * bs + bi * br, nr, src))
    return [boxes[i:i + bps] for i in range(0, len(boxes), bps)]


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_box_slots_land_where_the_consumers_read(bs, D, quant):
    """A walk's stages as the producer fills them: each box of ``br`` rows
    lands by TMA at its slot (kb * brs tile rows in, brs = br rounded up
    to 8: at bs 100 two 50-row boxes, each in a 56-row slot of its own
    stage), swizzled by address. The consumers' ``swzb`` of every tile row
    with a position then reads that position's stored bytes, every
    position of the walk's boxes is there once, slot rows past a box and
    rows past the last slot have position -1; and B4-decode's owner, whose
    walk is j_last alone, finds block row r at ``at(r, c)`` (box r // br
    in stage r // br)."""
    rng = np.random.default_rng(bs + D + len(quant))
    RB = pa.kv_packed_dim(D, quant)
    br, nbb, brs, bps = _pool_boxes(bs)
    assert bps * brs <= 64 and brs % 8 == 0
    Hkv, kvh, MB = 2, 1, 9
    NB = MB + 2
    pool = rng.integers(0, 256, size=(NB * Hkv * bs, RB), dtype=np.uint8)
    row = rng.permutation(NB - 1)[:MB].astype(np.int64)
    row[[2, 5]] = -1
    kt = 64 * RB                                     # one K or V tile
    base = 4096                                      # the ring, aligned

    def land(stages):
        sm = np.full(len(stages) * 2 * kt, 0xEE, np.uint8)   # stale bytes
        pos = np.full((len(stages), 64), -1)
        for s, st in enumerate(stages):
            for kb, (_, _, p0, nr, src) in enumerate(st):
                pos[s, kb * brs:kb * brs + nr] = p0 + np.arange(nr)
                dst = base + s * 2 * kt + kb * brs * RB
                assert dst % 128 == 0
                for i in range(br):
                    r = src + i
                    data = pool[r] if r < pool.shape[0] else np.zeros(RB)
                    for b in range(RB):
                        sm[_tma_swizzle(dst + i * RB + b, RB) - base] = \
                            data[b]
        return sm, pos

    def stored(p):
        j, r = divmod(int(p), bs)
        return pool[(int(row[j]) * Hkv + kvh) * bs + r]

    max_lim = (MB - 1) * bs + br // 2      # the last block's box 1 unread
    sm, pos = land(_producer(range(MB), row, kvh, Hkv, bs, max_lim))
    want = sorted(j * bs + bi * br + r for j in range(MB) if row[j] >= 0
                  for bi in range(nbb) if not bi or j * bs + br <= max_lim
                  for r in range(min(br, bs - bi * br)))
    assert sorted(pos[pos >= 0].tolist()) == want
    for s in range(pos.shape[0]):
        for tr in range(64):
            if pos[s, tr] < 0:
                continue
            got = np.concatenate([
                sm[s * 2 * kt + _swzb(tr, c, RB):][:16]
                for c in range(RB // 16)])
            np.testing.assert_array_equal(got, stored(pos[s, tr]))
    # the owner: j_last = 7 alone, every row visible; then a -1 entry,
    # whose block 0 content is landed and requantized, not attended
    for j_last in (7, 2):
        stages = _producer([j_last], row, kvh, Hkv, bs, MB * bs, owner=True)
        assert len(stages) == nbb and all(len(st) == 1 for st in stages)
        sm, pos = land(stages)
        src = (max(int(row[j_last]), 0) * Hkv + kvh) * bs
        for r in range(bs):
            bi = r // br
            got = np.concatenate([
                sm[bi * 2 * kt + _swzb(r - bi * br, c, RB):][:16]
                for c in range(RB // 16)])
            np.testing.assert_array_equal(got, pool[src + r])
        assert (pos >= 0).any() == (row[j_last] >= 0)


def test_byte_conversions_cover_every_stored_value():
    """The two conversions over every byte value: int8 bytes to their
    signed value, int4 nibbles to nibble - 8, as exact bf16."""
    for v in range(256):
        w = v | (((v + 37) & 0xFF) << 8) | (((v + 101) & 0xFF) << 16) | \
            (((v + 200) & 0xFF) << 24)
        by = [(w >> (8 * i)) & 0xFF for i in range(4)]
        sv = [b - 256 if b > 127 else b for b in by]
        even, odd = _i8x4_bf16(w)
        assert list(_bf16_val([even & 0xFFFF, even >> 16])) == [sv[0], sv[2]]
        assert list(_bf16_val([odd & 0xFFFF, odd >> 16])) == [sv[1], sv[3]]
        for shift, (i, j, hi) in ((0, (0, 2, 0)), (8, (1, 3, 0)),
                                  (4, (0, 2, 1)), (12, (1, 3, 1))):
            x = _i4x2_bf16(w, shift)
            nib = [((by[k] >> (4 * hi)) & 0xF) - 8 for k in (i, j)]
            assert list(_bf16_val([x & 0xFFFF, x >> 16])) == nib


# ---------------------------------------------------------------------------
# the float32 model of the quantized split walk
# ---------------------------------------------------------------------------

def _requant(pool, scales, src, tgt, rows, live_end, quant, D):
    """The write rule on one block, all kv heads: block ``src``
    dequantized, ``rows`` ({row: [Hkv, D]}) merged, rows >= live_end
    zeroed, rescaled and requantized into ``tgt``."""
    blk = pa.kv_dequantize(pool[src], scales[src], quant, D)   # [Hkv, bs, D]
    for r, v in rows.items():
        blk[:, r] = v.float()
    blk[:, live_end:] = 0.0
    sn = pa.kv_block_scale(blk, quant, (1, 2))
    pool[tgt] = pa.kv_quantize(blk, sn[:, None, None], quant)
    scales[tgt] = sn


def _partial_q(qr, lims, trow, blocks, pools, kvh, bs, sl2, quant, D):
    """(m, l, acc) in log2 units of rows ``qr`` over ``blocks``: S on grid
    values times each row's K factor, masked, P's columns times each row's
    V scale after l has summed P."""
    kp, vp, ks, vs = pools
    R = qr.shape[0]
    blocks = [j for j in blocks if trow[j] >= 0]
    if not blocks:
        return (torch.full((R,), float("-inf")), torch.zeros(R),
                torch.zeros(R, D))
    K = torch.cat([pa.kv_unpack(kp[trow[j], kvh], quant, D) for j in blocks])
    V = torch.cat([pa.kv_unpack(vp[trow[j], kvh], quant, D) for j in blocks])
    kf = torch.cat([(ks[trow[j], kvh] * sl2).expand(bs) for j in blocks])
    vsc = torch.cat([vs[trow[j], kvh].expand(bs) for j in blocks])
    pos = torch.cat([torch.arange(j * bs, j * bs + bs) for j in blocks])
    s = (qr @ K.T) * kf[None, :]
    s = s.masked_fill(pos[None, :] > lims[:, None], float("-inf"))
    m = s.amax(-1)
    p = torch.exp2(s - torch.where(torch.isinf(m), 0.0, m)[:, None])
    return m, p.sum(-1), (p * vsc[None, :]) @ V


def _merge(parts):
    """Partials merged in split order (log2 units): acc / max(l, 1e-30),
    zeros where every split saw nothing."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    Ms = torch.where(torch.isinf(M), 0.0, M)
    acc, lsum = torch.zeros_like(parts[0][2]), torch.zeros_like(parts[0][1])
    for m, l, a in parts:
        w = torch.exp2(m - Ms)
        acc = acc + w[:, None] * a
        lsum = lsum + w * l
    return acc / lsum.clamp_min(1e-30)[:, None]


def _model_decode(c, scale, span, quant):
    """B4-decode as the kernel splits it: the owner of j_last requantizes
    the block (block 0's content into scratch for a -1 entry), then each
    (sequence, kv head) walks its history spans and the owner's block."""
    q, nk, nv, tables, lens = c["q"], c["nk"], c["nv"], c["tables"], c["lens"]
    pools = [c[k].clone() for k in ("kp", "vp", "ks", "vs")]
    kp, vp, ks, vs = pools
    B, Hq, D = q.shape
    NB, Hkv, bs, _ = kp.shape
    MB, G = tables.shape[1], Hq // Hkv
    sl2 = torch.tensor(np.float32(scale) * LOG2E)
    # every owner reads its block before any owner writes (the plain
    # version's order; only the scratch block could tell them apart)
    src_blocks = {}
    for b in range(B):
        L = int(lens[b])
        jl = min(L // bs, MB - 1)
        phys = int(tables[b, jl])
        src_blocks[b] = [x[max(phys, 0)].clone() for x in pools]
    for b in range(B):
        L = int(lens[b])
        jl = min(L // bs, MB - 1)
        slot, phys = L - jl * bs, int(tables[b, jl])
        tgt = NB - 1 if phys < 0 else phys
        for (pool, scales), new, (sp, ss) in zip(
                ((kp, ks), (vp, vs)), (nk, nv),
                ((src_blocks[b][0], src_blocks[b][2]),
                 (src_blocks[b][1], src_blocks[b][3]))):
            tmp_p, tmp_s = sp[None].clone(), ss[None].clone()
            _requant(tmp_p, tmp_s, 0, 0, {slot: new[b]} if slot < bs else {},
                     slot + 1, quant, D)
            pool[tgt], scales[tgt] = tmp_p[0], tmp_s[0]
    out = torch.zeros_like(q)
    for b in range(B):
        L = int(lens[b])
        trow = [int(x) for x in tables[b]]
        for kvh in range(Hkv):
            heads = slice(kvh * G, kvh * G + G)
            lims = torch.full((G,), L)
            out[b, heads] = _merge([
                _partial_q(q[b, heads], lims, trow, range(jb, je), pools,
                           kvh, bs, sl2, quant, D)
                for jb, je in pa.decode_walks(L, bs, MB, span, quant)])
    return out, pools


def _model_append(c, scale, quant, force_k=None):
    """B4-append: the write pass over every window block, then B3's tiles
    and splits (``force_k``: every tile split that many ways) with each
    row's scales, merged in split order; padding rows zero."""
    q, nk, nv = c["q"], c["nk"], c["nv"]
    tables, lens, qlens = c["tables"], c["lens"], c["qlens"]
    pools = [c[k].clone() for k in ("kp", "vp", "ks", "vs")]
    kp, vp, ks, vs = pools
    B, S, Hq, D = q.shape
    NB, Hkv, bs, _ = kp.shape
    MB, G = tables.shape[1], Hq // Hkv
    sl2 = torch.tensor(np.float32(scale) * LOG2E)
    writes = []
    for b in range(B):
        L, QL = int(lens[b]), int(qlens[b])
        if QL <= 0:
            continue
        for j in range(min(L // bs, MB - 1),
                       min((L + QL - 1) // bs, MB - 1) + 1):
            phys = int(tables[b, j])
            rows = {r: j * bs + r - L for r in range(bs)
                    if 0 <= j * bs + r - L < QL}
            writes.append((b, phys, rows, L + QL - j * bs,
                           [x[max(phys, 0)].clone() for x in pools]))
    for b, phys, rows, live_end, src in writes:
        tgt = NB - 1 if phys < 0 else phys
        for (pool, scales), new, (sp, ss) in zip(
                ((kp, ks), (vp, vs)), (nk, nv),
                ((src[0], src[2]), (src[1], src[3]))):
            tmp_p, tmp_s = sp[None].clone(), ss[None].clone()
            _requant(tmp_p, tmp_s, 0, 0,
                     {r: new[b, ci] for r, ci in rows.items()}, live_end,
                     quant, D)
            pool[tgt], scales[tgt] = tmp_p[0], tmp_s[0]
    out = torch.zeros_like(q)
    for b in range(B):
        L, QL = int(lens[b]), int(qlens[b])
        walks = pa.append_tile_walks(L, QL, S, G, bs, MB)
        trow = [int(x) for x in tables[b]]
        for r0, R in sorted({(w[0], w[1]) for w in walks}):
            J = min((L + (r0 + R - 1) // G) // bs, MB - 1) + 1
            if force_k is None:
                spans = [(w[4], w[5]) for w in walks if w[0] == r0]
            else:
                k = min(force_k, J)
                spans = [(J * s // k, J * (s + 1) // k) for s in range(k)]
            rows = range(r0, r0 + R)
            lims = torch.tensor([L + r // G for r in rows])
            for kvh in range(Hkv):
                qr = torch.stack([q[b, r // G, kvh * G + r % G] for r in rows])
                o = _merge([_partial_q(qr, lims, trow, range(jb, je), pools,
                                       kvh, bs, sl2, quant, D)
                            for jb, je in spans])
                for n, r in enumerate(rows):
                    out[b, r // G, kvh * G + r % G] = o[n]
    return out, pools


def _quant_pool(rng, shape, quant, dirty=()):
    """Quantized unit-normal blocks; ``dirty`` (block, row) pairs: that
    block's rows from ``row`` on are 100x larger (stale content of a
    reused block)."""
    f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    for blk, row in dirty:
        f[blk, :, row:] *= 100.0
    sc = pa.kv_block_scale(f, quant, (2, 3))
    return pa.kv_quantize(f, sc[..., None, None], quant), sc


def _tables(rng, need, MB, NB):
    it = iter(rng.permutation(NB - 1))
    tables = np.full((len(need), MB), -1, np.int32)
    for b, n in enumerate(need):
        for j in range(n):
            tables[b, j] = next(it)
    return tables


def _decode_case(rng, quant, lens, Hq, Hkv, D, bs, MB, wiped=(), holes=()):
    need = [min(int(L) // bs, MB - 1) + 1 for L in lens]
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    for b in wiped:
        tables[b] = -1
    for b, j0, j1 in holes:
        tables[b, j0:j1] = -1
    B = len(lens)
    # the last live block of slot 0 holds stale rows 100x larger past its
    # slot: the requantization must zero them before the absmax
    slot0 = int(lens[0]) - (need[0] - 1) * bs
    dirty = ((int(tables[0, need[0] - 1]), slot0 + 1),) \
        if tables[0, need[0] - 1] >= 0 and slot0 + 1 < bs else ()
    kp, ks = _quant_pool(rng, (NB, Hkv, bs, D), quant, dirty)
    vp, vs = _quant_pool(rng, (NB, Hkv, bs, D), quant, dirty)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return dict(q=randn(B, Hq, D), nk=randn(B, Hkv, D), nv=randn(B, Hkv, D),
                tables=torch.from_numpy(tables),
                lens=torch.from_numpy(np.asarray(lens, np.int32)),
                kp=kp, vp=vp, ks=ks, vs=vs, dirty=dirty)


DECODE_CASES = [
    # Hq, Hkv, D, bs, MB, lens, wiped slots, -1 holes (one at a j_last)
    (4, 4, 16, 16, 48, [0, 15, 16, 300, 700, 767, 5], (5,), ((3, 18, 19),)),
    (8, 2, 32, 16, 48, [257, 600, 766, 40], (), ((1, 16, 32),)),
    (8, 1, 16, 32, 20, [639, 640, 100, 0], (3,), ((0, 2, 4),)),
    (2, 2, 16, 64, 12, [700, 64, 63, 300], (), ((0, 4, 8), (3, 4, 5))),
    (16, 2, 16, 128, 6, [767, 129, 128, 1], (), ()),
    (8, 2, 16, 48, 40, [1900, 48, 47, 600], (), ((0, 20, 22), (2, 0, 1))),
    (4, 2, 16, 100, 10, [999, 100, 49, 50, 51, 450], (4,), ((0, 3, 5),)),
]


def _assert_pools(got, want):
    nb = got[0].shape[0]
    for g, w in zip(got, want):
        assert torch.equal(g[:nb - 1], w[:nb - 1])


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("Hq,Hkv,D,bs,MB,lens,wiped,holes", DECODE_CASES)
def test_quant_decode_split_model_matches_plain(Hq, Hkv, D, bs, MB, lens,
                                                wiped, holes, quant):
    """B4-decode's spans, owner and merge against
    ``paged_attention_decode_plain(quant=...)``: long walks split several
    ways, a span of -1 entries, a -1 entry at j_last (block 0's content
    requantized into scratch, not attended), a wiped slot, lengths past
    the table (the block rewritten, no row written), a dirty last block,
    block sizes 16-128 (100 and 128: the block is two TMA boxes in two
    stages).
    Payload and scales bit for bit outside the scratch block."""
    rng = np.random.default_rng(Hq * 7 + bs + len(quant))
    c = _decode_case(rng, quant, lens, Hq, Hkv, D, bs, MB, wiped, holes)
    scale = D ** -0.5
    span = pa.decode_launch_config(len(lens), Hq, Hkv, D, bs, MB, quant).span
    assert any(len(pa.decode_walks(int(L), bs, MB, span, quant)) > 2
               for L in lens)
    out, pools = _model_decode(c, scale, span, quant)
    want = [c[k].clone() for k in ("kp", "vp", "ks", "vs")]
    ref, *_ = pa.paged_attention_decode_plain(
        c["q"], want[0], want[1], c["tables"], c["lens"], c["nk"], c["nv"],
        scale, want[2], want[3], quant)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    _assert_pools(pools, want)
    for b in wiped:
        assert not out[b].any()
    if c["dirty"]:
        db = c["dirty"][0][0]
        assert (pools[2][db] < 10 * c["ks"].median()).all()


def _append_case(rng, quant, specs, Hq, Hkv, D, bs, S, MB, minus_one=()):
    need = [0 if n == 0 else min((L + n - 1) // bs, MB - 1) + 1
            for L, n in specs]
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    for b, j0, j1 in minus_one:
        tables[b, j0:j1] = -1
    kp, ks = _quant_pool(rng, (NB, Hkv, bs, D), quant)
    vp, vs = _quant_pool(rng, (NB, Hkv, bs, D), quant)
    B, f = len(specs), np.float32
    return dict(
        q=torch.from_numpy(rng.standard_normal((B, S, Hq, D)).astype(f)),
        nk=torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(f)),
        nv=torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(f)),
        tables=torch.from_numpy(tables),
        lens=torch.tensor([L for L, _ in specs], dtype=torch.int32),
        qlens=torch.tensor([n for _, n in specs], dtype=torch.int32),
        kp=kp, vp=vp, ks=ks, vs=vs)


APPEND_CASES = [
    # Hq, Hkv, D, bs, S, MB, (lens, q_lens) per slot, -1 ranges, force_k
    (2, 2, 16, 16, 96, 64, [(0, 96), (600, 1), (700, 20), (40, 0),
                            (300, 33)], ((1, 8, 24),), None),
    (8, 2, 16, 32, 40, 40, [(900, 1), (500, 8), (0, 40), (1000, 3)],
     ((0, 10, 20),), None),
    (4, 4, 32, 64, 128, 20, [(1100, 1), (63, 1), (64, 1), (200, 64)], (),
     None),
    (4, 2, 16, 128, 40, 8, [(900, 5), (0, 40), (129, 1)], ((0, 2, 4),), 3),
    (4, 2, 16, 48, 40, 40, [(900, 1), (300, 30), (0, 40)], ((0, 5, 8),),
     None),
    (4, 2, 16, 100, 40, 12, [(1100, 1), (99, 2), (0, 40)], (), None),
]


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("Hq,Hkv,D,bs,S,MB,specs,minus_one,force_k",
                         APPEND_CASES)
def test_quant_append_split_model_matches_plain(Hq, Hkv, D, bs, S, MB, specs,
                                                minus_one, force_k, quant):
    """B4-append's write pass, tiles, splits and merge against
    ``paged_attention_append_plain(quant=...)``: decode rows and short
    tails split several ways, -1 ranges, an idle slot, forced splits.
    Real rows within the tolerance, padding rows zero, payload and scales
    bit for bit outside scratch."""
    rng = np.random.default_rng(Hq + 3 * bs + S + len(quant))
    c = _append_case(rng, quant, specs, Hq, Hkv, D, bs, S, MB, minus_one)
    scale = D ** -0.5
    G = Hq // Hkv
    assert force_k or any(pa.append_tile_splits(L, n, S, G, bs, MB)[2] > 1
                          for L, n in specs)
    out, pools = _model_append(c, scale, quant, force_k)
    want = [c[k].clone() for k in ("kp", "vp", "ks", "vs")]
    ref, *_ = pa.paged_attention_append_plain(
        c["q"], want[0], want[1], c["tables"], c["lens"], c["qlens"],
        c["nk"], c["nv"], scale, want[2], want[3], quant)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    _assert_pools(pools, want)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("form", ["decode", "append"])
def test_quant_split_model_matches_pallas_reference(form, quant,
                                                    pallas_kernels):
    """One case each against the reference's quantized Pallas kernels in
    interpret mode: a decode step whose long sequence splits into two
    history spans and the owner, around -1 entries, beside a wiped slot;
    an append step whose decode row splits 2 ways."""
    jax_decode, jax_append = pallas_kernels
    rng = np.random.default_rng(31 + len(quant))
    if form == "decode":
        lens = [700, 40, 9]
        c = _decode_case(rng, quant, lens, 4, 2, 16, 16, 48, wiped=(2,),
                         holes=((0, 8, 16),))
        span = pa.decode_launch_config(3, 4, 2, 16, 16, 48, quant).span
        assert len(pa.decode_walks(700, 16, 48, span, quant)) == 3
        out, pools = _model_decode(c, 0.25, span, quant)
        r_out, *r_pools = jax_decode(
            *(jnp.asarray(c[k].numpy()) for k in
              ("q", "kp", "vp", "tables", "lens")),
            new_k=jnp.asarray(c["nk"].numpy()),
            new_v=jnp.asarray(c["nv"].numpy()),
            k_scale=jnp.asarray(c["ks"].numpy()),
            v_scale=jnp.asarray(c["vs"].numpy()), quant=quant)
        np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **TOL)
    else:
        specs = [(520, 1), (0, 40), (30, 0)]
        c = _append_case(rng, quant, specs, 4, 2, 16, 8, 40, 80)
        assert pa.append_tile_splits(520, 1, 40, 2, 8, 80)[2] == 2
        out, pools = _model_append(c, 0.25, quant)
        r_out, *r_pools = jax_append(
            *(jnp.asarray(c[k].numpy()) for k in
              ("q", "kp", "vp", "tables", "lens", "qlens", "nk", "nv")),
            k_scale=jnp.asarray(c["ks"].numpy()),
            v_scale=jnp.asarray(c["vs"].numpy()), quant=quant)
        r_out = np.asarray(r_out)
        for b, (_, n) in enumerate(specs):
            np.testing.assert_allclose(out[b, :n].numpy(), r_out[b, :n],
                                       **TOL)
    _assert_pools(pools, [torch.from_numpy(np.array(x)) for x in r_pools])
