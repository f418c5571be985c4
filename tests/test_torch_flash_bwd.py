"""The flash-attention backward's launch geometry and its plain version on
the CPU.

``bwd_launch_config`` is the geometry the CUDA kernels
(``paddle_tpu_torch/csrc/flash_attention_bwd.cu``) launch with and check
against their constants; these tests hold it to the card's shared-memory
limit, show that the dK/dV walk (kv tiles of 128 rows, two consumers of
64, q tiles of 64 over every q head of the GQA group) and the dQ walk (q
tiles of 128, kv tiles of 128 up to the causal limit) each cover every
visible (query, key) pair exactly once, and that both launch every tile
once, heaviest first within each group of heads. The plain backward, the
kernels' CPU path, is held against ``jax.vjp`` of the reference's Pallas
flash attention in interpret mode at ragged lengths and with one kv head,
at both head dims the kernels take. Inputs are float32 from numpy with a
fixed seed; tolerance atol 1e-4 (both sides float32, different summation
orders over up to 200 keys)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.kernels.flash_attention import (
    flash_attention_fwd as jax_flash)

from paddle_tpu_torch.ops.kernels.flash_attention import (
    SMEM_PER_BLOCK, attention_delta, bwd_check_args, bwd_launch_config,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)

torch.set_num_threads(1)
ATOL = 1e-4
LENGTHS = (1, 17, 64, 127, 128, 129, 1000, 2048)
SEED = 20261017


@pytest.mark.parametrize("D", [64, 128])
def test_bwd_launch_fits_shared_memory(D):
    cfg = bwd_launch_config(4, 2048, 2048, 32, 8, D, True)
    dkv_tiles = 2 * cfg.dkv_block_kv * D * 2 + \
        cfg.dkv_stages * 2 * cfg.dkv_block_q * D * 2
    dq_tiles = 2 * cfg.dq_block_q * D * 2 + \
        cfg.dq_stages * 2 * cfg.dq_block_k * D * 2
    assert dkv_tiles < cfg.dkv_smem <= SMEM_PER_BLOCK
    assert dq_tiles < cfg.dq_smem <= SMEM_PER_BLOCK
    assert cfg.threads == 384 and cfg.dq_stages == 2
    assert cfg.dkv_grid == (16, 32) and cfg.dq_grid == (16, 128)
    # the check entry point's arguments carry every number above
    args = bwd_check_args(4, 2048, 2048, 32, 8, D, True)
    assert len(args) == 23 and cfg.dkv_smem in args and cfg.dq_smem in args


def _dkv_coverage(cfg, Sq, Sk, G):
    """How often the dK/dV launch multiplies each (q head of one group,
    row, col): whole tiles; the kernel masks the rest."""
    count = np.zeros((G, Sq, Sk), np.uint8)
    n_q_tiles = -(-Sq // cfg.dkv_block_q)
    for kvt in range(cfg.dkv_grid[0]):
        for c in (0, 1):
            c0 = kvt * cfg.dkv_block_kv + 64 * c
            for qt in cfg.dkv_q_tiles(kvt, c, n_q_tiles):
                r0 = qt * cfg.dkv_block_q
                count[:, r0:r0 + cfg.dkv_block_q, c0:c0 + 64] += 1
    return count


def _dq_coverage(cfg, Sq, Sk):
    count = np.zeros((Sq, Sk), np.uint8)
    for qt in range(cfg.dq_grid[0]):
        r0 = qt * cfg.dq_block_q
        for kt in range(cfg.dq_kv_tiles[qt]):
            c0 = kt * cfg.dq_block_k
            count[r0:r0 + cfg.dq_block_q, c0:c0 + cfg.dq_block_k] += 1
    return count


def _visible(Sq, Sk, causal):
    return np.tril(np.ones((Sq, Sk), bool)) if causal else \
        np.ones((Sq, Sk), bool)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", LENGTHS)
def test_bwd_walks_cover_each_visible_pair_once(S, causal):
    cfg = bwd_launch_config(1, S, S, 4, 1, 128, causal)
    visible = _visible(S, S, causal)
    dkv = _dkv_coverage(cfg, S, S, 4)
    assert (dkv[:, visible] == 1).all()
    dq = _dq_coverage(cfg, S, S)
    assert (dq[visible] == 1).all()
    if causal:
        # no consumer walks a q tile wholly above its 64 kv rows' diagonal,
        # no dQ tile a kv tile wholly above its rows
        n_q_tiles = -(-S // cfg.dkv_block_q)
        for kvt in range(cfg.dkv_grid[0]):
            for c in (0, 1):
                c0 = kvt * cfg.dkv_block_kv + 64 * c
                for qt in cfg.dkv_q_tiles(kvt, c, n_q_tiles):
                    assert (qt + 1) * cfg.dkv_block_q - 1 >= c0
        for qt in range(cfg.dq_grid[0]):
            r_last = min(S, (qt + 1) * cfg.dq_block_q) - 1
            assert (cfg.dq_kv_tiles[qt] - 1) * cfg.dq_block_k <= r_last


@pytest.mark.parametrize("Sq,Sk", [(129, 1000), (1000, 17), (1, 2048)])
def test_bwd_walks_cover_unequal_lengths(Sq, Sk):
    cfg = bwd_launch_config(2, Sq, Sk, 8, 2, 64, False)
    assert cfg.dkv_grid == (-(-Sk // cfg.dkv_block_kv), 4)
    assert cfg.dq_grid == (-(-Sq // cfg.dq_block_q), 16)
    assert (_dkv_coverage(cfg, Sq, Sk, 4)[:, :Sq, :Sk] == 1).all()
    assert (_dq_coverage(cfg, Sq, Sk)[:Sq, :Sk] == 1).all()


@pytest.mark.parametrize("G", [1, 4, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_walks_cover_gqa_groups(G, causal):
    """Each dK/dV CTA sums every q head of its kv head's group: over the
    launch, every (q head, row, col) is visited once, and each q head by
    the CTAs of its own kv head only."""
    B, Hkv, S = 2, 2, 200
    Hq = G * Hkv
    cfg = bwd_launch_config(B, S, S, Hq, Hkv, 64, causal)
    count = np.zeros((B * Hq, S, S), np.uint8)
    n_q_tiles = -(-S // cfg.dkv_block_q)
    for rank in range(cfg.dkv_grid[0] * cfg.dkv_grid[1]):
        bhk, kvt = cfg.dkv_tile(rank)
        b, hk = divmod(bhk, Hkv)
        heads = [b * Hq + hk * G + gi for gi in range(G)]
        for c in (0, 1):
            c0 = kvt * cfg.dkv_block_kv + 64 * c
            for qt in cfg.dkv_q_tiles(kvt, c, n_q_tiles):
                r0 = qt * cfg.dkv_block_q
                count[heads, r0:r0 + cfg.dkv_block_q, c0:c0 + 64] += 1
    assert (count[:, _visible(S, S, causal)] == 1).all()


@pytest.mark.parametrize("B,Hq", [(2, 32), (1, 40), (3, 5)])
def test_bwd_launches_heaviest_first_in_head_groups(B, Hq):
    """Both kernels launch every (head, tile) once, heads in groups of
    ``head_group``, the causal tiles heaviest first across a group: dK/dV
    from the first kv tile (the longest q walk), dQ from the last q
    tile."""
    S, Hkv = 1000, 1
    cfg = bwd_launch_config(B, S, S, Hq, Hkv, 128, True)
    n_q_tiles = -(-S // cfg.dkv_block_q)
    for grid, tile, walk in (
            (cfg.dkv_grid, cfg.dkv_tile,
             lambda t: len(cfg.dkv_q_tiles(t, 0, n_q_tiles))),
            (cfg.dq_grid, cfg.dq_tile, lambda t: cfg.dq_kv_tiles[t])):
        n_t, n_h = grid
        order = [tile(r) for r in range(n_t * n_h)]
        assert sorted(order) == [(h, t) for h in range(n_h)
                                 for t in range(n_t)]
        per_group = cfg.head_group * n_t
        for g0 in range(0, len(order), per_group):
            group = order[g0:g0 + per_group]
            assert {h // cfg.head_group for h, _ in group} == \
                {g0 // per_group}
            walks = [walk(t) for _, t in group]
            assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,p", [
    (1, 77, 2, 1, 64, True, 0.0), (1, 130, 4, 1, 128, False, 0.0),
    (1, 200, 4, 2, 128, True, 0.0), (2, 17, 2, 1, 64, False, 0.0),
    (1, 77, 4, 1, 64, True, 0.1), (1, 130, 2, 1, 128, False, 0.2)])
def test_bwd_plain_matches_pallas_vjp_ragged_mqa(B, S, Hq, Hkv, D, causal, p):
    """The dK/dV and dQ wrappers on the CPU (their plain versions, no
    launch) from the forward's ``lse`` and ``delta``, against ``jax.vjp``
    of the reference's flash attention (its Pallas kernels in interpret
    mode) at lengths that are not multiples of the kernels' tiles, with
    one kv head, at D 64 and 128; with dropout both rebuild the same
    position-hashed mask."""
    rng = np.random.default_rng(S + D)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    seed_f = jnp.asarray(np.array([[SEED]], np.int32).view(np.float32))
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal, None, p, seed_f),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_dq, ref_dk, ref_dv = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_fwd(tq, tk, tv, causal, None, p, SEED)
    delta = attention_delta(out, tdo)
    n0 = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    dk, dv = flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal,
                                     None, p, SEED)
    dq = flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta, causal, None, p,
                                SEED)
    assert n0 == (flash_attention_bwd_dkv.launches,
                  flash_attention_bwd_dq.launches)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
