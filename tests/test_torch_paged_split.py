"""Kernels B2 and B3's split walks (``paddle_tpu_torch/csrc/paged_split.cuh``)
on the CPU: their launch geometry, and a float32 model of the
split-and-merge held against the plain versions and the JAX package's
Pallas kernels in interpret mode.

The model walks each (sequence, kv head) the way the kernels do: the spans
of ``decode_walks`` (B2) and the tiles and splits of ``append_tile_walks``
(B3) give float32 partials (m, l, acc) that merge in split order. Inputs
are float32 from numpy seeds; the plain versions round P to the pool's
dtype, so with float32 pools both sides do the same math in another
summation order: atol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.kernels.paged_attention import (
    paged_attention_append as jax_paged_append,
    paged_attention_decode as jax_paged_decode)

from paddle_tpu_torch.ops.kernels import paged_attention as pa

torch.set_num_threads(1)
ATOL = 1e-5
SMEM_LIMIT = 232448          # 227 KB: the most one CTA may use on an H100

GEOMETRIES = [(D, G, bs, MB) for D in (64, 128) for G in (1, 2, 4, 8)
              for bs in (16, 32, 64, 128) for MB in (1, 32, 128)]


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
    """Lengths on and around block and span edges, and past the table."""
    cap = MB * bs
    return sorted({0, 1, bs - 1, bs, bs + 1, cap // 2, cap - 1, cap,
                   cap + 7, 5 * bs + 3})


@pytest.mark.parametrize("D,G,bs,MB", GEOMETRIES)
def test_decode_launch_config_covers_every_live_block_once(D, G, bs, MB):
    """The spans of B2's splits cover blocks 0 .. j_last once, in order; a
    split index past them starts past j_last (its CTA exits at once); the
    grid, shared memory and scratch follow from B, Hkv and MB alone."""
    B, Hkv = 3, 2
    cfg = pa.decode_launch_config(B, G * Hkv, Hkv, D, bs, MB)
    assert cfg.smem_bytes <= SMEM_LIMIT
    assert cfg.grid == (cfg.splits, Hkv, B) and cfg.threads == 160
    assert (cfg.splits - 1) * cfg.span < MB <= cfg.splits * cfg.span
    assert cfg.span * bs >= min(pa.DECODE_SPAN_POS, MB * bs)
    assert cfg.scratch_floats == B * G * Hkv * cfg.splits * (D + 2)
    assert cfg.counters == B * Hkv
    rng = np.random.default_rng(D + G + bs + MB)
    for L in _lens_for(bs, MB):
        j_last = min(L // bs, MB - 1)
        walks = pa.decode_walks(L, bs, MB, cfg.span)
        assert 1 <= len(walks) <= cfg.splits
        assert [j for jb, je in walks for j in range(jb, je)] == \
            list(range(j_last + 1))
        assert all(jb == s * cfg.span for s, (jb, _) in enumerate(walks))
        for s in range(len(walks), cfg.splits):
            assert s * cfg.span > j_last
        # with -1 entries, the live blocks are visited once each
        row = rng.integers(-1, 50, size=MB)
        seen = [j for jb, je in walks for j in range(jb, je) if row[j] >= 0]
        assert seen == [j for j in range(j_last + 1) if row[j] >= 0]


@pytest.mark.parametrize("D,G,bs,MB", GEOMETRIES)
def test_append_launch_config_covers_every_live_block_once(D, G, bs, MB):
    """B3: every real row is in exactly one tile; each tile's splits cover
    its blocks 0 .. J-1 once, in order; a split tile has at most 32 real
    rows, k * rows fits the 64 scratch rows, and its extra CTAs are the
    padding tiles after it, so the host's grid holds them."""
    B, Hkv, S = 2, 2, 48
    cfg = pa.append_launch_config(B, S, G * Hkv, Hkv, D)
    n_tiles = -(-S * G // 64)
    assert cfg.smem_bytes <= SMEM_LIMIT
    assert cfg.grid == (n_tiles, Hkv, B) and cfg.scratch_rows == 64
    assert cfg.scratch_floats == B * Hkv * 64 * (D + 2)
    cap = MB * bs
    for L in _lens_for(bs, MB):
        for QL in (0, 1, 5, S):
            t_last, R, k = pa.append_tile_splits(L, QL, S, G, bs, MB)
            walks = pa.append_tile_walks(L, QL, S, G, bs, MB)
            real = min(QL, S) * G
            if real == 0:
                assert walks == [] and t_last == -1
                continue
            rows = sorted({(r0, n) for r0, n, *_ in walks})
            assert [r for r0, n in rows for r in range(r0, r0 + n)] == \
                list(range(real))
            assert t_last + k <= n_tiles and k <= pa.APPEND_MAX_SPLITS
            assert k == 1 or (R <= pa.APPEND_SPLIT_MAX_ROWS and k * R <= 64)
            for r0, n in rows:
                tile = [w for w in walks if w[0] == r0]
                J = min((L + (r0 + n - 1) // G) // bs, MB - 1) + 1
                assert [w[2] for w in tile] == list(range(len(tile)))
                assert [j for w in tile for j in range(w[4], w[5])] == \
                    list(range(J))
                assert all(w[5] > w[4] for w in tile)   # no split is empty
                if len(tile) > 1:
                    span_pos = min(L + QL, cap) // len(tile)
                    assert span_pos >= pa.APPEND_SPLIT_MIN_POS // 2


# ---------------------------------------------------------------------------
# the float32 model of the split-and-merge
# ---------------------------------------------------------------------------

def _partial(qr, lims, trow, jb, je, kp, vp, kvh, bs, scale):
    """(m, l, acc) of rows ``qr [R, D]`` (row r sees positions <=
    ``lims[r]``) over the live blocks of ``[jb, je)``: m = -inf and
    l = 0 where a row sees nothing there."""
    R, D = qr.shape
    blocks = [j for j in range(jb, je) if trow[j] >= 0]
    if not blocks:
        return (torch.full((R,), float("-inf")), torch.zeros(R),
                torch.zeros(R, D))
    K = torch.cat([kp[trow[j], kvh] for j in blocks])
    V = torch.cat([vp[trow[j], kvh] for j in blocks])
    pos = torch.cat([torch.arange(j * bs, j * bs + bs) for j in blocks])
    s = (qr @ K.T) * scale
    s = s.masked_fill(pos[None, :] > lims[:, None], float("-inf"))
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[:, None])
    return m, p.sum(-1), p @ V


def _merge(parts):
    """Partials merged in split order: acc / max(l, 1e-30), zeros where
    every split saw nothing."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    Ms = torch.where(torch.isinf(M), 0.0, M)
    acc, lsum = torch.zeros_like(parts[0][2]), torch.zeros_like(parts[0][1])
    for m, l, a in parts:
        w = torch.exp(m - Ms)
        acc = acc + w[:, None] * a
        lsum = lsum + w * l
    return acc / lsum.clamp_min(1e-30)[:, None]


def _model_decode(q, kp, vp, tables, lens, nk, nv, scale, span):
    """B2 as the kernel splits it: the new row written at ``slot`` of block
    j_last (a -1 entry: the scratch block; past the table: dropped), then
    each (sequence, kv head) walked in spans of ``span`` blocks."""
    B, Hq, D = q.shape
    NB, Hkv, bs, _ = kp.shape
    MB = tables.shape[1]
    G = Hq // Hkv
    kp, vp = kp.clone(), vp.clone()
    out = torch.zeros_like(q)
    for b in range(B):
        L = int(lens[b])
        j_last = min(L // bs, MB - 1)
        slot = L - j_last * bs
        if slot < bs:
            phys = int(tables[b, j_last])
            tgt = NB - 1 if phys < 0 else phys
            kp[tgt, :, slot], vp[tgt, :, slot] = nk[b], nv[b]
        trow = [int(x) for x in tables[b]]
        for kvh in range(Hkv):
            heads = slice(kvh * G, kvh * G + G)
            lims = torch.full((G,), L)
            out[b, heads] = _merge([
                _partial(q[b, heads], lims, trow, jb, je, kp, vp, kvh, bs,
                         scale)
                for jb, je in pa.decode_walks(L, bs, MB, span)])
    return out, kp, vp


def _model_append(q, kp, vp, tables, lens, qlens, nk, nv, scale,
                  force_k=None):
    """B3 as the kernel splits it (``force_k``: every tile split that many
    ways instead, so causal rows meet spans they see none of): the write
    pass, then each tile's splits merged in order; padding rows zero."""
    B, S, Hq, D = q.shape
    NB, Hkv, bs, _ = kp.shape
    MB = tables.shape[1]
    G = Hq // Hkv
    kp, vp = kp.clone(), vp.clone()
    out = torch.zeros_like(q)
    for b in range(B):
        L, QL = int(lens[b]), int(qlens[b])
        for i in range(min(QL, S)):
            blk = (L + i) // bs
            if blk < MB:
                phys = int(tables[b, blk])
                tgt = NB - 1 if phys < 0 else phys
                kp[tgt, :, (L + i) % bs] = nk[b, i]
                vp[tgt, :, (L + i) % bs] = nv[b, i]
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
                o = _merge([_partial(qr, lims, trow, jb, je, kp, vp, kvh, bs,
                                     scale) for jb, je in spans])
                for n, r in enumerate(rows):
                    out[b, r // G, kvh * G + r % G] = o[n]
    return out, kp, vp


def _tables(rng, need, MB, NB):
    it = iter(rng.permutation(NB - 1))
    tables = np.full((len(need), MB), -1, np.int32)
    for b, n in enumerate(need):
        for j in range(n):
            tables[b, j] = next(it)
    return tables


def _decode_case(rng, lens, Hq, Hkv, D, bs, MB, wiped=(), holes=()):
    """Pools and tables covering ``lens`` (+1 position each); ``wiped``
    slots have all -1 rows (stale lens), ``holes`` are (b, j0, j1) ranges
    of -1 entries inside a live sequence."""
    need = [min(int(L) // bs, MB - 1) + 1 for L in lens]
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    for b in wiped:
        tables[b] = -1
    for b, j0, j1 in holes:
        tables[b, j0:j1] = -1
    f = np.float32
    B = len(lens)
    return dict(q=rng.standard_normal((B, Hq, D)).astype(f),
                kp=rng.standard_normal((NB, Hkv, bs, D)).astype(f),
                vp=rng.standard_normal((NB, Hkv, bs, D)).astype(f),
                tables=tables, lens=np.asarray(lens, np.int32),
                nk=rng.standard_normal((B, Hkv, D)).astype(f),
                nv=rng.standard_normal((B, Hkv, D)).astype(f))


DECODE_CASES = [
    # Hq, Hkv, D, bs, MB, lens, wiped slots, -1 holes
    (4, 4, 16, 16, 48, [0, 15, 16, 300, 700, 767, 5], (5,), ()),
    (8, 2, 32, 16, 48, [257, 600, 766, 40], (), ((1, 16, 32),)),
    (8, 1, 16, 32, 20, [639, 640, 100, 0], (3,), ((0, 2, 4),)),
    (2, 2, 16, 64, 12, [700, 64, 63, 300], (), ((0, 4, 8),)),
    (16, 2, 16, 128, 6, [767, 129, 128, 1], (), ()),
]


@pytest.mark.parametrize("Hq,Hkv,D,bs,MB,lens,wiped,holes", DECODE_CASES)
def test_decode_split_model_matches_plain(Hq, Hkv, D, bs, MB, lens, wiped,
                                          holes):
    """B2's spans and merge, in float32, against
    ``paged_attention_decode_plain``: long sequences split several ways, a
    span of -1 entries (an empty split), a wiped slot (its write parks in
    the scratch block, nothing visible), a length past the table (the
    write drops), lengths on block edges. Pools bit-identical outside the
    scratch block."""
    rng = np.random.default_rng(Hq * 7 + bs)
    c = {k: torch.from_numpy(np.array(v)) for k, v in
         _decode_case(rng, lens, Hq, Hkv, D, bs, MB, wiped, holes).items()}
    scale = D ** -0.5
    span = pa.decode_launch_config(len(lens), Hq, Hkv, D, bs, MB).span
    assert any(len(pa.decode_walks(int(L), bs, MB, span)) > 1 for L in lens)
    out, kp, vp = _model_decode(c["q"], c["kp"], c["vp"], c["tables"],
                                c["lens"], c["nk"], c["nv"], scale, span)
    kr, vr = c["kp"].clone(), c["vp"].clone()
    ref = pa.paged_attention_decode_plain(c["q"], kr, vr, c["tables"],
                                          c["lens"], c["nk"], c["nv"], scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    NB = kp.shape[0]
    assert torch.equal(kp[:NB - 1], kr[:NB - 1])
    assert torch.equal(vp[:NB - 1], vr[:NB - 1])
    for b in wiped:
        assert not out[b].any()


def _append_case(rng, specs, Hq, Hkv, D, bs, S, MB, minus_one=()):
    """Pools and tables covering each window ``[lens, lens + q_lens)``;
    idle slots (q_lens 0) have an all -1 row; ``minus_one`` lists (b, j0,
    j1) ranges of -1 entries."""
    need = [0 if q == 0 else min((L + q - 1) // bs, MB - 1) + 1
            for L, q in specs]
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    for b, j0, j1 in minus_one:
        tables[b, j0:j1] = -1
    f = np.float32
    B = len(specs)
    return dict(q=rng.standard_normal((B, S, Hq, D)).astype(f),
                kp=rng.standard_normal((NB, Hkv, bs, D)).astype(f),
                vp=rng.standard_normal((NB, Hkv, bs, D)).astype(f),
                tables=tables,
                lens=np.array([L for L, _ in specs], np.int32),
                qlens=np.array([q for _, q in specs], np.int32),
                nk=rng.standard_normal((B, S, Hkv, D)).astype(f),
                nv=rng.standard_normal((B, S, Hkv, D)).astype(f))


APPEND_CASES = [
    # Hq, Hkv, D, bs, S, MB, (lens, q_lens) per slot, -1 ranges, force_k
    (2, 2, 16, 16, 96, 64, [(0, 96), (600, 1), (700, 20), (40, 0),
                            (300, 33)], ((1, 8, 24),), None),
    (8, 2, 16, 32, 40, 40, [(900, 1), (500, 8), (0, 40), (1000, 3)],
     ((0, 10, 20),), None),
    (4, 4, 32, 64, 128, 20, [(1100, 1), (63, 1), (64, 1), (200, 64)], (),
     None),
    (2, 1, 16, 16, 48, 24, [(0, 48), (100, 30), (370, 2)], (), 5),
    (4, 2, 16, 128, 40, 8, [(900, 5), (0, 40), (129, 1)], ((0, 2, 4),), 3),
]


@pytest.mark.parametrize("Hq,Hkv,D,bs,S,MB,specs,minus_one,force_k",
                         APPEND_CASES)
def test_append_split_model_matches_plain(Hq, Hkv, D, bs, S, MB, specs,
                                          minus_one, force_k):
    """B3's tiles, splits and merge, in float32, against
    ``paged_attention_append_plain``: decode rows over long histories and
    short chunk tails split several ways, -1 ranges (empty splits), an
    idle slot; with ``force_k`` every tile splits, so causal rows meet
    spans they see none of. Real rows within atol 1e-5; padding rows zero;
    pools bit-identical outside the scratch block."""
    rng = np.random.default_rng(Hq + 3 * bs + S)
    c = {k: torch.from_numpy(np.array(v)) for k, v in
         _append_case(rng, specs, Hq, Hkv, D, bs, S, MB, minus_one).items()}
    scale = D ** -0.5
    G = Hq // Hkv
    assert force_k or any(pa.append_tile_splits(L, q, S, G, bs, MB)[2] > 1
                          for L, q in specs)
    out, kp, vp = _model_append(c["q"], c["kp"], c["vp"], c["tables"],
                                c["lens"], c["qlens"], c["nk"], c["nv"],
                                scale, force_k)
    kr, vr = c["kp"].clone(), c["vp"].clone()
    ref = pa.paged_attention_append_plain(c["q"], kr, vr, c["tables"],
                                          c["lens"], c["qlens"], c["nk"],
                                          c["nv"], scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    NB = kp.shape[0]
    assert torch.equal(kp[:NB - 1], kr[:NB - 1])
    assert torch.equal(vp[:NB - 1], vr[:NB - 1])


@pytest.mark.parametrize("form", ["decode", "append"])
def test_split_model_matches_pallas_reference(form, pallas_kernels):
    """One case each against the reference's Pallas kernels in interpret
    mode: a decode step whose long sequence splits 2 ways around -1
    entries, beside a wiped slot; an append step whose decode row splits 2
    ways."""
    jax_decode, jax_append = pallas_kernels
    rng = np.random.default_rng(31)
    if form == "decode":
        lens = [700, 40, 9]
        c = _decode_case(rng, lens, 4, 2, 16, 16, 48, wiped=(2,),
                         holes=((0, 8, 16),))
        span = pa.decode_launch_config(3, 4, 2, 16, 16, 48).span
        assert len(pa.decode_walks(700, 16, 48, span)) == 2
        t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
        out, kp, vp = _model_decode(t["q"], t["kp"], t["vp"], t["tables"],
                                    t["lens"], t["nk"], t["nv"], 0.25, span)
        r_out, r_kp, r_vp = jax_decode(
            jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
            jnp.asarray(c["tables"]), jnp.asarray(c["lens"]),
            new_k=jnp.asarray(c["nk"]), new_v=jnp.asarray(c["nv"]))
        np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=ATOL,
                                   rtol=0)
    else:
        specs = [(520, 1), (0, 40), (30, 0)]
        c = _append_case(rng, specs, 4, 2, 16, 8, 40, 80)
        assert pa.append_tile_splits(520, 1, 40, 2, 8, 80)[2] == 2
        t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
        out, kp, vp = _model_append(t["q"], t["kp"], t["vp"], t["tables"],
                                    t["lens"], t["qlens"], t["nk"], t["nv"],
                                    0.25)
        r_out, r_kp, r_vp = jax_append(*(jnp.asarray(c[k]) for k in (
            "q", "kp", "vp", "tables", "lens", "qlens", "nk", "nv")))
        r_out = np.asarray(r_out)
        for b, (_, n) in enumerate(specs):
            np.testing.assert_allclose(out[b, :n].numpy(), r_out[b, :n],
                                       atol=ATOL, rtol=0)
    NB = kp.shape[0]
    np.testing.assert_array_equal(kp.numpy()[:NB - 1], np.asarray(r_kp)[:NB - 1])
    np.testing.assert_array_equal(vp.numpy()[:NB - 1], np.asarray(r_vp)[:NB - 1])
