"""The flash-attention forward's launch geometry and its plain version on
the CPU.

``fwd_launch_config`` is the geometry the CUDA kernel
(``paddle_tpu_torch/csrc/flash_attention_fwd.cu``) launches with and checks
against its constants; these tests hold it to the card's shared-memory
limit and show that its tiles cover every visible (query, key) pair
exactly once, causal q tiles heaviest first within each group of heads.
The plain version, the
kernel's CPU path, is held against the reference's Pallas forward in
interpret mode at lengths that are not multiples of the kernel's
128-row tiles, with one kv head and at both head dims. Inputs are
float32 from numpy with a fixed seed; tolerance atol 1e-5 (both sides in
float32, different summation orders)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.kernels.flash_attention import (
    _flash_fwd_res, flash_attention_fwd as jax_flash)

from paddle_tpu_torch.ops.kernels.flash_attention import (
    SMEM_PER_BLOCK, flash_attention_fwd, fwd_launch_config)

torch.set_num_threads(1)
ATOL = 1e-5
LENGTHS = (1, 17, 127, 128, 129, 1000, 2048)


@pytest.mark.parametrize("D", [64, 128])
def test_fwd_launch_fits_shared_memory(D):
    cfg = fwd_launch_config(2, 2048, 2048, 32, 8, D, True)
    tiles = cfg.block_q * D * 2 + cfg.stages * 2 * cfg.block_k * D * 2
    assert tiles < cfg.smem_bytes <= SMEM_PER_BLOCK
    assert cfg.threads == 384 and cfg.grid == (16, 64)


def _launched(cfg):
    """Every CTA's ``(bh, q tile)``, in launch order."""
    return [cfg.tile(r) for r in range(cfg.grid[0] * cfg.grid[1])]


def _coverage(cfg, Sq, Sk):
    """How many (q tile, kv tile) pairs of the launch cover each (bh, row,
    col); a launch covers whole tiles and the kernel masks the rest."""
    count = np.zeros((cfg.grid[1], Sq, Sk), np.int32)
    for bh, qt in _launched(cfg):
        r0 = qt * cfg.block_q
        for kt in range(cfg.kv_tiles[qt]):
            c0 = kt * cfg.block_k
            count[bh, r0:r0 + cfg.block_q, c0:c0 + cfg.block_k] += 1
    return count


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", LENGTHS)
def test_fwd_launch_covers_each_visible_pair_once(S, causal):
    cfg = fwd_launch_config(1, S, S, 4, 2, 128, causal)
    count = _coverage(cfg, S, S)
    visible = np.tril(np.ones((S, S), bool)) if causal else \
        np.ones((S, S), bool)
    assert (count[:, visible] == 1).all()
    # a causal launch skips every kv tile wholly above the diagonal
    if causal:
        for qt in range(cfg.grid[0]):
            r_last = min(S, (qt + 1) * cfg.block_q) - 1
            assert (cfg.kv_tiles[qt] - 1) * cfg.block_k <= r_last


@pytest.mark.parametrize("Sq,Sk", [(129, 1000), (1000, 17), (1, 2048)])
def test_fwd_launch_covers_unequal_lengths(Sq, Sk):
    cfg = fwd_launch_config(2, Sq, Sk, 8, 8, 64, False)
    assert cfg.grid == (-(-Sq // cfg.block_q), 16)
    assert (_coverage(cfg, Sq, Sk) == 1).all()


@pytest.mark.parametrize("B,Hq", [(2, 32), (1, 40), (3, 5)])
def test_fwd_launch_heaviest_first_in_head_groups(B, Hq):
    """Every (bh, q tile) launches once; heads launch in groups of
    ``head_group`` consecutive heads, and inside a group the causal q tiles
    go heaviest first across its heads."""
    cfg = fwd_launch_config(B, 1000, 1000, Hq, 1, 128, True)
    order = _launched(cfg)
    n_qt = cfg.grid[0]
    assert sorted(order) == [(bh, qt) for bh in range(B * Hq)
                             for qt in range(n_qt)]
    per_group = cfg.head_group * n_qt
    for g0 in range(0, len(order), per_group):
        group = order[g0:g0 + per_group]
        assert {bh // cfg.head_group for bh, _ in group} == \
            {g0 // per_group}
        walks = [cfg.kv_tiles[qt] for _, qt in group]
        assert walks == sorted(walks, reverse=True)
    assert cfg.kv_tiles[-1] == n_qt and cfg.kv_tiles[0] == 1


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,D", [(200, 64), (200, 128), (1000, 64),
                                 (1000, 128)])
def test_flash_plain_matches_pallas_ragged_mqa(S, D, causal):
    rng = np.random.default_rng(3)
    B, Hq, Hkv = 1, 2, 1
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal))
    _, res = _flash_fwd_res(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, None)
    ref_lse = np.asarray(res[4]).reshape(B, Hq, S)
    n0 = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal)
    assert flash_attention_fwd.launches == n0   # CPU: plain version, no launch
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=0)
