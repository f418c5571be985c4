"""Kernel B8's design (``paddle_tpu_torch/csrc/int4_matmul.cu``) on the CPU:
its launch geometry, and a bit-level model of what each lane does, held
against the plain version and the JAX package's Pallas kernel.

The model works on bits: the packed weight and x land in shared memory as
TMA's 128-byte swizzle writes them (x rows past ``rows`` zero-filled, as
TMA fills out-of-bounds rows); each lane loads the 32-bit words its
column permutation names (chunk ``4 (g & 1) + warp``, word ``g >> 1``),
unpacks them with the kernel's byte_perm / lop3 / bf16-subtraction, and
``ldmatrix`` hands it x's B fragments; the A and B fragments are put back
into the m16n8k16 tiles that ``mma.sync`` multiplies, and the C fragments
are read back to the output columns the epilogue writes. K splits walk
their stages, write float32 partials and the last CTA adds them in split
order. On integer-valued x every sum is exact, so the model must equal
``int4_matmul_plain`` bit for bit; on normal x it is held against the
reference's Pallas ``int4_matmul`` in interpret mode within the tolerances
of ``tests/test_torch_weight_quant.py`` (float32: 1e-5 of the largest
magnitude, two float32 sums in other orders; bf16: one bf16 step)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.kernels.int4_matmul import int4_matmul as j_int4_matmul

from paddle_tpu_torch.ops.kernels import int4_matmul as i4

torch.set_num_threads(1)
SMEM_LIMIT = 232448          # 227 KB: the most one CTA may use on an H100
N_SM = 132
# [n_in, n_out]: a small tile, q/k/v/o, fused q/k/v, gate/up and down at
# hidden 4096, ff 11264 (chip_smoke.py's INT4_SHAPES)
INT4_SHAPES = ((2048, 512), (4096, 4096), (4096, 12288), (4096, 11264),
               (11264, 4096))
LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_bf16", [True, False])
@pytest.mark.parametrize("n_in,n_out", INT4_SHAPES)
def test_launch_config_at_every_row_count(n_in, n_out, x_bf16):
    """Every shape x rows 1-128: the row tile holds the rows, the ring fits
    a CTA (two an SM where the split rule counts two), the splits are one
    wave of CTAs and each walks >= 2 stages of 64 packed rows, and scratch
    and counters are sized for the launch."""
    xb = 2 if x_bf16 else 4
    for rows in range(1, 129):
        c = i4.launch_config(rows, n_in, n_out, x_bf16, N_SM)
        assert c.nt in (1, 2, 4, 8, 16) and 8 * c.nt >= rows
        assert c.nt == 1 or rows > 4 * c.nt
        assert c.smem_bytes == 1040 + c.stages * (
            i4.stage_bytes(c.nt, xb) + 16) <= SMEM_LIMIT
        assert 3 <= c.stages <= 16
        assert c.ctas_per_sm * (c.smem_bytes + 1024) <= i4.SM_SMEM
        # a deeper ring would not fit the CTA's share of the SM
        assert c.ctas_per_sm * (
            c.smem_bytes + i4.stage_bytes(c.nt, xb) + 16 + 1024) \
            > i4.SM_SMEM or c.stages == 16
        # K splits of a decode-sized walk land in the ring at once
        if c.nt == 1 and x_bf16 and n_out >= 4096 and c.splits > 2:
            assert -(-(n_in // 128) // c.splits) <= c.stages
        assert c.grid == (n_out // 128, c.splits) and c.threads == 160
        assert c.grid[0] * c.splits <= c.ctas_per_sm * N_SM
        stages = n_in // 2 // 64
        walks = [(stages * s // c.splits, stages * (s + 1) // c.splits)
                 for s in range(c.splits)]
        assert [st for a, b in walks for st in range(a, b)] == \
            list(range(stages))
        assert min(b - a for a, b in walks) >= i4.MIN_SPLIT_STAGES
        assert c.scratch_floats == (c.splits * rows * n_out
                                    if c.splits > 1 else 0)
        assert c.counters == n_out // 128


def test_decode_shapes_fill_the_card():
    """At decode's 8 rows [4096, 4096] fills the 132 SMs with two CTAs
    each (256 of 264), [4096, 11264] exactly, and each SM keeps >= 32 KB
    of the weight in flight."""
    for (n_in, n_out), ctas in (((4096, 4096), 256), ((4096, 11264), 264),
                                ((11264, 4096), 256), ((4096, 12288), 192)):
        c = i4.launch_config(8, n_in, n_out, True, N_SM)
        assert c.nt == 1 and c.ctas_per_sm == 2
        assert c.grid[0] * c.splits == ctas, (n_in, n_out)
        walk = n_in // 2 // 64 // c.splits
        assert c.ctas_per_sm * min(c.stages, walk) * 64 * 128 >= 32 * 1024
        assert c.stages == 11
    c = i4.launch_config(128, 4096, 4096, True, N_SM)
    assert c.nt == 16 and c.grid == (32, 4)


# ---------------------------------------------------------------------------
# the bit-level model
# ---------------------------------------------------------------------------

def bf16_bits(x):
    """float32 array -> bf16 bits (round to nearest even), as uint16."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)) \
        .to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_value(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def swz128(row, chunk):
    """Byte offset of 16-byte chunk ``chunk`` of row ``row`` in a tile of
    128-byte rows as TMA's 128-byte swizzle writes it (1024-byte aligned)."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def weight_tile(packed, k0, col0):
    """The stage's weight box: packed rows k0 .. k0 + 63, columns col0 ..
    col0 + 127, as 8192 bytes of shared memory."""
    box = packed[k0:k0 + 64, col0:col0 + 128].view(np.uint8)
    smem = np.zeros(64 * 128, np.uint8)
    r, c = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    smem[swz128(r, c >> 4) + (c & 15)] = box
    return smem


def x_tile(xbits, k0, nt, xs):
    """The stage's x boxes: k0 .. k0 + 127 of rows 0 .. 8 nt - 1 (rows past
    x's zero), boxes of 128 bytes a row one after another, as bytes."""
    rows = xbits.shape[0]
    per_box = 128 // xs
    R8 = 8 * nt
    smem = np.zeros(128 // per_box * R8 * 128, np.uint8)
    for b in range(128 // per_box):
        box = np.zeros((R8, per_box), xbits.dtype)
        box[:rows] = xbits[:, k0 + b * per_box:k0 + (b + 1) * per_box]
        raw = box.view(np.uint8).reshape(R8, 128)
        r, c = np.meshgrid(np.arange(R8), np.arange(128), indexing="ij")
        smem[b * R8 * 128 + swz128(r, c >> 4) + (c & 15)] = raw
    return smem


def word(smem, off):
    """Little-endian 32-bit words at byte offsets ``off`` (an array)."""
    off = np.asarray(off)
    b = [smem[off + i].astype(np.uint32) for i in range(4)]
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


def byte_perm(x, y, sel):
    """PTX prmt (default mode): result byte i is byte ``(sel >> 4i) & 7`` of
    the eight bytes {y:x}."""
    both = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= both[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def nib_bf16x2(w, byte):
    """The kernel's unpack of byte ``byte`` of words ``w``: (low, high)
    nibble values as float32 arrays, through the bf16 bits it builds."""
    y = byte_perm(w, w >> 4, byte | ((4 + byte) << 8))
    y = (y & 0x000F000F) ^ 0x43084308
    lo = bf16_value((y & 0xFFFF).astype(np.uint16))
    hi = bf16_value((y >> 16).astype(np.uint16))
    # 128 + (v + 8) minus 136 in bf16: exact, the result is v
    return lo - np.float32(136), hi - np.float32(136)


def lane_offsets(warp):
    """Byte offsets of each lane's words in packed rows t and t + 4 of a
    k-step, and its first output column in the CTA's 128."""
    chunk, wd = 4 * (G & 1) + warp, G >> 1
    off0 = T * 128 + ((chunk ^ T) << 4) + 4 * wd
    off1 = (T + 4) * 128 + ((chunk ^ T ^ 4) << 4) + 4 * wd
    return off0, off1, 16 * chunk + 4 * wd


def a_tiles(wsmem, warp, ks):
    """The two m16 x k16 A tiles (float32) warp ``warp``'s lanes hold for
    k-step ``ks`` of a stage, put back from their fragments: a0 (row g, k
    2t, 2t + 1), a1 (g + 8), a2 (g, 2t + 8, + 9), a3 (g + 8, ...)."""
    off0, off1, _ = lane_offsets(warp)
    w0 = word(wsmem, ks * 1024 + off0)
    w1 = word(wsmem, ks * 1024 + off1)
    tiles = np.full((2, 16, 16), np.nan, np.float32)
    for j in range(2):
        for reg, (w, byte, dm, dk) in enumerate(
                ((w0, 2 * j, 0, 0), (w0, 2 * j + 1, 8, 0),
                 (w1, 2 * j, 0, 8), (w1, 2 * j + 1, 8, 8))):
            lo, hi = nib_bf16x2(w, byte)
            tiles[j, G + dm, 2 * T + dk] = lo
            tiles[j, G + dm, 2 * T + dk + 1] = hi
    assert not np.isnan(tiles).any()   # every element held by one lane
    return tiles


def ldmatrix_x4(smem, addr):
    """ldmatrix.x4 (b16): lane l gives the row address of row l & 7 of
    matrix l >> 3; lane (g, t) receives bytes 4t .. 4t + 3 of row g of
    each matrix. Returns regs [4 matrices][32 lanes]."""
    return np.stack([word(smem, addr[8 * i + G] + 4 * T) for i in range(4)])


def b_tiles_bf16(xsmem, nt, n, pp):
    """The k16 x n8 B tiles of k-steps 2pp and 2pp + 1 for row tile n, from
    the kernel's ldmatrix addresses: b0 (k 2t, 2t + 1; n g), b1 (k 2t + 8,
    + 9)."""
    R8 = 8 * nt
    row = 8 * n + (LANES & 7)
    c = 4 * (pp & 1) + (LANES >> 3)
    regs = ldmatrix_x4(xsmem, (pp >> 1) * R8 * 128 + swz128(row, c))
    tiles = np.zeros((2, 16, 8), np.float32)
    for h in range(2):
        for dk, r in ((0, regs[2 * h]), (8, regs[2 * h + 1])):
            tiles[h, 2 * T + dk, G] = bf16_value((r & 0xFFFF).astype(
                np.uint16))
            tiles[h, 2 * T + dk + 1, G] = bf16_value((r >> 16).astype(
                np.uint16))
    return tiles


def b_tiles_bf16_pair(xsmem, nt, n0, ks):
    """From 8 row tiles on the kernel takes one k-step at a time: one
    ldmatrix.x4 gives the B tiles of k-step ``ks`` for row tiles n0 (lanes
    0-15 address it) and n0 + 1 (lanes 16-31)."""
    R8 = 8 * nt
    row = 8 * (n0 + (LANES >> 4)) + (LANES & 7)
    c = 2 * (ks & 3) + ((LANES >> 3) & 1)
    regs = ldmatrix_x4(xsmem, (ks >> 2) * R8 * 128 + swz128(row, c))
    tiles = np.zeros((2, 16, 8), np.float32)
    for m in range(2):
        for dk, r in ((0, regs[2 * m]), (8, regs[2 * m + 1])):
            tiles[m, 2 * T + dk, G] = bf16_value((r & 0xFFFF).astype(
                np.uint16))
            tiles[m, 2 * T + dk + 1, G] = bf16_value((r >> 16).astype(
                np.uint16))
    return tiles


def split3(a):
    """split3_bf16: three bf16 terms, each the rounding of what the terms
    before it left, as float32 values."""
    terms = []
    a = np.asarray(a, np.float32)
    for _ in range(3):
        h = bf16_value(bf16_bits(a))
        terms.append(h)
        a = (a - h).astype(np.float32)
    return terms


def b_tiles_f32(xsmem, nt, n, ks):
    """float32 x's B tile of k-step ``ks`` as three bf16 term tiles: lane
    (g, t) reads x[8n + g][16 ks + 2t, + 1] and [+ 8, + 9] (two 8-byte
    loads) and splits each value in three."""
    R8 = 8 * nt
    c = 4 * (ks & 1) + (T >> 1)
    base = (ks >> 1) * R8 * 128 + (8 * n + G) * 128 + 8 * (T & 1)
    vals = {}
    for dk, cc in ((0, c), (8, c + 2)):
        off = base + ((cc ^ G) << 4)
        lo = word(xsmem, off).view(np.float32)
        hi = word(xsmem, off + 4).view(np.float32)
        vals[dk] = (split3(lo), split3(hi))
    tiles = np.zeros((3, 16, 8), np.float32)
    for e in range(3):
        for dk in (0, 8):
            tiles[e, 2 * T + dk, G] = vals[dk][0][e]
            tiles[e, 2 * T + dk + 1, G] = vals[dk][1][e]
    return tiles


def c_fragments(d):
    """m16n8 C fragments of each lane: c0 (row g, col 2t), c1 (g, 2t + 1),
    c2 (g + 8, 2t), c3 (g + 8, 2t + 1); returns [32 lanes][4]."""
    return np.stack([d[G, 2 * T], d[G, 2 * T + 1], d[G + 8, 2 * T],
                     d[G + 8, 2 * T + 1]], axis=1)


def model_int4_matmul(x, packed, scales, n_sm=N_SM, out_dtype=None):
    """B8 as the kernel runs it, one CTA (column block, split) at a time:
    per k-step the four warps' A tiles times each row tile's B tile (three
    bf16 term tiles for float32 x, summed into one tile), read back as C
    fragments and added to each lane's float32 accumulators. bf16 x with a
    float32 output takes the float32-x path, as the wrapper routes it."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.dtype == torch.bfloat16 and out_dtype == torch.float32:
        x = x.float()
    rows, n_in = x.shape
    n_out = packed.shape[1]
    x_bf16 = x.dtype == torch.bfloat16
    c = i4.launch_config(rows, n_in, n_out, x_bf16, n_sm)
    nt, k = c.nt, c.splits
    if x_bf16:
        xbits, xs = x.view(torch.int16).numpy().view(np.uint16), 2
    else:
        xbits, xs = x.numpy().view(np.uint32), 4
    pk = packed.numpy()
    S = n_in // 2 // 64
    partial = np.zeros((k, rows, n_out), np.float32)
    for cb in range(n_out // 128):
        col0 = cb * 128
        for split in range(k):
            acc = np.zeros((4, 32, nt, 2, 4), np.float32)
            for st in range(S * split // k, S * (split + 1) // k):
                wsm = weight_tile(pk, st * 64, col0)
                xsm = x_tile(xbits, st * 128, nt, xs)
                for ks in range(8):
                    a = np.stack([a_tiles(wsm, w, ks) for w in range(4)])
                    if x_bf16 and nt >= 8:
                        bs = [np.concatenate([b_tiles_bf16_pair(xsm, nt, n,
                                                                ks)
                                              for n in range(0, nt, 2)])]
                    elif x_bf16:
                        bs = [np.stack([b_tiles_bf16(xsm, nt, n, ks >> 1)
                                        [ks & 1] for n in range(nt)])]
                    else:
                        bf = np.stack([b_tiles_f32(xsm, nt, n, ks)
                                       for n in range(nt)])
                        bs = [bf[:, e] for e in range(3)]
                    d = sum(np.einsum("wjmk,nkc->wjnmc", a.astype(np.float64),
                                      b.astype(np.float64))
                            for b in bs).astype(np.float32)
                    frag = np.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1],
                                     d[..., G + 8, 2 * T],
                                     d[..., G + 8, 2 * T + 1]], axis=-1)
                    acc = (acc + frag.transpose(0, 3, 2, 1, 4)).astype(
                        np.float32)
            # the epilogue's columns: row 8n + 2t + e, columns c .. c + 3
            for w in range(4):
                _, _, c0 = lane_offsets(w)
                for n in range(nt):
                    for e in range(2):
                        r = 8 * n + 2 * T + e
                        v = np.stack([acc[w, :, n, 0, e],
                                      acc[w, :, n, 0, 2 + e],
                                      acc[w, :, n, 1, e],
                                      acc[w, :, n, 1, 2 + e]], axis=1)
                        keep = r < rows
                        for i in range(4):
                            partial[split, r[keep], col0 + c0[keep] + i] = \
                                v[keep, i]
    total = partial[0]
    for s in range(1, k):     # the last CTA's merge, split 0 first
        total = (total + partial[s]).astype(np.float32)
    y = torch.from_numpy(total) * scales.float()
    return y.to(out_dtype)


def _case(n_in, n_out, seed):
    rng = np.random.default_rng(seed)
    packed = torch.from_numpy(rng.integers(-128, 128, (n_in // 2, n_out),
                                           dtype=np.int8))
    scales = torch.from_numpy(rng.uniform(1e-3, 2e-2, n_out)
                              .astype(np.float32))
    return rng, packed, scales


def test_unpack_gives_every_byte_its_two_nibbles():
    """All 256 bytes in every byte position of a word: the kernel's unpack
    gives the sign-extended (low, high) nibbles of ``nibbles``."""
    b = np.arange(256, dtype=np.uint32)
    want_lo, want_hi = (t.numpy().astype(np.float32) for t in
                        i4.nibbles(torch.arange(-128, 128, dtype=torch.int8)
                                   .roll(-128)))
    for pos in range(4):
        w = (b << (8 * pos)) | (np.uint32(0x5A) << (8 * ((pos + 1) % 4)))
        lo, hi = nib_bf16x2(w, pos)
        np.testing.assert_array_equal(lo, want_lo)
        np.testing.assert_array_equal(hi, want_hi)


def test_lanes_cover_the_tile_without_bank_conflicts():
    """Each warp's 32 lanes load 32 distinct banks in packed rows t and
    t + 4, and the four warps' words cover every byte of a packed row once;
    the epilogue's columns are the 128 columns of the block."""
    seen = np.zeros((8, 128), int)
    cols = []
    for w in range(4):
        off0, off1, c0 = lane_offsets(w)
        for off in (off0, off1):
            assert len(set((off // 4) % 32)) == 32
            for i in range(4):
                seen[(off + i) // 128, (off + i) % 128] += 1
        cols += [c0[T == 0] + i for i in range(4)]   # one lane per g
    assert (seen == 1).all()
    assert sorted(np.concatenate(cols)) == list(range(128))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 5, 8, 9, 16, 33, 128])
def test_model_bit_for_bit_on_integer_x(rows, x_dtype):
    """Integer-valued x: every product and sum is exact, so the model of the
    lanes (permutations, unpack, ldmatrix, row-tile padding, splits) equals
    the plain version bit for bit, with and without K splits."""
    rng, packed, scales = _case(1024, 512, rows)
    x = torch.from_numpy(rng.integers(-8, 9, (rows, 1024)).astype(
        np.float32)).to(x_dtype)
    want = i4.int4_matmul_plain(x, packed, scales)
    for n_sm in (N_SM, 1):
        got = model_int4_matmul(x, packed, scales, n_sm)
        assert got.dtype == x_dtype
        assert torch.equal(got, want), (rows, n_sm)
    if x_dtype == torch.bfloat16:
        got = model_int4_matmul(x, packed, scales, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert torch.equal(got, i4.int4_matmul_plain(x, packed, scales,
                                                     torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 5, 8, 16, 128])
def test_model_matches_reference_kernel(rows, dtype):
    """Normal x through the model against the reference's Pallas kernel in
    interpret mode at [2048, 512]: float32 within 1e-5 of the largest
    magnitude (the three-term split keeps float32's precision), bf16
    within one bf16 step."""
    w = np.random.default_rng(3).standard_normal((2048, 512)) \
        .astype(np.float32)
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), algo="weight_only_int4")
    jq, js = np.asarray(jq.numpy()), np.asarray(js.numpy())
    x = np.random.default_rng(4).standard_normal((rows, 2048)) \
        .astype(np.float32)
    want = np.asarray(j_int4_matmul(jnp.asarray(x).astype(dtype),
                                    jnp.asarray(jq), jnp.asarray(js))
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = model_int4_matmul(tx, torch.from_numpy(jq), torch.from_numpy(js))
    err = np.abs(got.float().numpy() - want).max()
    top = np.abs(want).max()
    tol = 1e-5 * top if dtype == "float32" else \
        2.0 ** (np.floor(np.log2(top)) - 7)
    assert err <= tol, (rows, dtype, err, tol)


def test_three_term_split_is_exact():
    """hi + mid + lo == x exactly for float32 x whose magnitude is in
    [2^-110, bf16's largest finite): random values over the whole exponent
    range and the edges. Below 2^-110 the last term falls under bf16's
    subnormal step (an error under 2^-133); zeros stay zeros."""
    rng = np.random.default_rng(7)
    mant = rng.uniform(1, 2, 200_000)
    expo = rng.integers(-110, 127, 200_000)
    x = (rng.choice([-1.0, 1.0], 200_000) * mant * 2.0 ** expo) \
        .astype(np.float32)
    edges = np.array([2.0 ** -110, -(2.0 ** -110) * 1.9999999, 1.0,
                      1 + 2.0 ** -23, -(1 - 2.0 ** -24), 3.3895e38,
                      -3.3895e38, 1.17549435e-38 * 2 ** 16,
                      np.nextafter(np.float32(1), np.float32(2)),
                      16777215.0, -16777217.0, 0.0, -0.0],
                     dtype=np.float32)
    for v in (x, edges):
        hi, mid, lo = split3(v)
        assert np.isfinite(hi).all()
        total = hi.astype(np.float64) + mid + lo
        np.testing.assert_array_equal(total, v.astype(np.float64))
        assert (np.abs(mid) <= np.abs(hi) * 2.0 ** -8).all()
        assert (np.abs(lo) <= np.abs(mid) * 2.0 ** -8).all()
    tiny = np.float32(2.0 ** -120) * np.float32(1.2345678)
    hi, mid, lo = split3(np.array([tiny]))
    assert abs(float(hi[0]) + float(mid[0]) + float(lo[0]) - float(tiny)) \
        < 2.0 ** -133


def test_split_of_bf16_values_is_one_term():
    """bf16 x with a float32 output runs the float32-x kernel: the split of
    a bf16-valued float32 is (x, 0, 0), so each k-step adds the one
    product of that x, zeros and signs included."""
    rng = np.random.default_rng(8)
    v = (rng.standard_normal(100_000)
         * 2.0 ** rng.integers(-100, 100, 100_000)).astype(np.float32)
    # and 0, -0, 1, the largest finite negative, the least subnormals
    edges = np.array([0x0000, 0x8000, 0x3F80, 0xFF7F, 0x0001, 0x8001],
                     np.uint16)
    v = bf16_value(np.concatenate([bf16_bits(v), edges]))
    hi, mid, lo = split3(v)
    np.testing.assert_array_equal(hi.view(np.uint32), v.view(np.uint32))
    assert not mid.any() and not lo.any()
