"""paddle_tpu_torch's sampler against the reference's, on the CPU:
``core/prng.py`` against ``jax.random`` (threefry2x32 in the
``jax_threefry_partitionable`` mode), ``models/llama.py``'s
``_filter_logits`` and ``_sample_logits_device`` against
``paddle_tpu.models.llama``'s, and ``core/random.py``'s
``default_generator`` against ``paddle_tpu.core.random``'s.

Keys, split and folded keys, random bits and uniforms are bit for bit.
Gumbel noise is within one ulp a log: each of the two logs is within one
ulp of XLA's on the same input, so the composed noise differs by at most
the inner log's ulp carried through the outer one plus one ulp of the
result a side. The
categorical draw and the filtered sampler are token for token over 1,000+
keys; a differing token (none at these seeds) must be a near-tie, a top-2
gap of the perturbed logits below 1e-5, and is reported. The nucleus keep
masks are compared whole: a flip (the two cumulative sums rounding to
either side of ``top_p``) is reported with its distance from ``top_p``
and must lie within 1e-6 of it. XLA's CPU cumsum associates otherwise than
torch's (which accumulates in float64), so at ``top_p`` 1 the full-sort
nucleus flips far out in the tail, where the cumulative mass reaches 1 in
one and not the other: tokens of mass ~1e-7 and below, kept by the port
and cut by the reference; the rows they touch are left out of the
filtered-logit comparison, not of the sampled-token one. Argmax ties go to the first index in
both. Inputs come from numpy seeds, and hypothesis draws the key seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax._src import prng as jprng

from paddle_tpu.core import random as jrandom
from paddle_tpu.models import llama as jllama

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.inference import llm_engine as tle
from paddle_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

#: seeds the engines and tests of both packages use, and int64 edges (the
#: reference runs JAX with x64 on: a seed's high word is kept)
SEEDS = [0, 1, 2 ** 31 - 1, 5, 7, 11, 123, 321, 2 ** 32 + 5, -1]
SHAPES = [(32000,), (8, 32000), (8, 6, 32000)]
NEAR_TIE = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(a):
    return np.asarray(a).astype(np.int64)


def _ulps(a, b):
    """Distance in float32 ulps (same-sign values)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_partitionable_mode_is_jax_default():
    """The port implements only the partitionable threefry mode: if JAX's
    default changes, this fails instead of the streams diverging."""
    assert jax.config.jax_threefry_partitionable is True


@given(st.integers(0, 2 ** 32 - 1), st.integers(0, 2 ** 32 - 1))
@settings(max_examples=20, deadline=None)
def test_threefry_2x32_bit_exact(k1, k2):
    rng = np.random.default_rng(k1 ^ k2)
    x = rng.integers(0, 2 ** 32, (2, 1000), dtype=np.uint64) \
        .astype(np.uint32)
    want = jprng.threefry2x32_p.bind(jnp.uint32(k1), jnp.uint32(k2),
                                     jnp.asarray(x[0]), jnp.asarray(x[1]))
    got = prng.threefry_2x32(k1, k2, _t(x[0]), _t(x[1]))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_seeds(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


def test_x64_is_on_in_the_reference():
    """The reference package turns x64 on, so ``PRNGKey`` keeps an int64
    seed's high word and ``bits``/``uniform`` default to 64 bits: the
    draws below ask for uint32/float32, as the sampler's float32 logits
    make ``categorical`` do."""
    assert jax.config.jax_enable_x64 is True


@given(st.integers(-2 ** 63, 2 ** 63 - 1))
@settings(max_examples=25, deadline=None)
def test_prng_key_any_seed(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


@given(st.integers(0, 2 ** 31 - 1), st.integers(0, 2 ** 20))
@settings(max_examples=15, deadline=None)
def test_fold_in_chains_batched(seed, salt):
    """``fold_in(fold_in(key, rids), positions)`` over a ``[B]`` batch and
    over ``[B, R]`` positions, as the engine folds them, against the
    reference's vmapped scalar folds."""
    rng = np.random.default_rng(salt)
    rids = rng.integers(0, 2 ** 31, (8,))
    pos = rng.integers(0, 4096, (8,))
    win = pos[:, None] + 1 + np.arange(5)[None]
    key = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed)
    want = jax.vmap(lambda r, p: jax.random.fold_in(
        jax.random.fold_in(key, r), p))(rids, pos)
    got = prng.fold_in(prng.fold_in(tkey, _t(rids)), _t(pos))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    k_rids = jax.vmap(lambda r: jax.random.fold_in(key, r))(rids)
    want_w = jax.vmap(lambda k, ps: jax.vmap(
        lambda p: jax.random.fold_in(k, p))(ps))(k_rids, win)
    got_w = prng.fold_in(prng.fold_in(tkey, _t(rids))[:, None], _t(win))
    np.testing.assert_array_equal(got_w.numpy(), _np(want_w))
    # a scalar fold, and a chain of them, as generate folds its counter
    chain_j, chain_t = key, tkey
    for d in (salt, 3, 0):
        chain_j, chain_t = jax.random.fold_in(chain_j, d), \
            prng.fold_in(chain_t, d)
    np.testing.assert_array_equal(chain_t.numpy(), _np(chain_j))


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split(num):
    key = jax.random.fold_in(jax.random.PRNGKey(42), 9)
    tkey = prng.fold_in(prng.PRNGKey(42), 9)
    np.testing.assert_array_equal(prng.split(tkey, num).numpy(),
                                  _np(jax.random.split(key, num)))
    # generate's chain: rkey, sub = split(rkey), step after step
    for _ in range(5):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        np.testing.assert_array_equal(tsub.numpy(), _np(sub))
    np.testing.assert_array_equal(tkey.numpy(), _np(key))
    # batched over keys
    keys = jax.random.split(key, 4)
    np.testing.assert_array_equal(
        prng.split(_t(keys), num).numpy(),
        _np(jax.vmap(lambda k: jax.random.split(k, num))(keys)))


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_and_uniform_bit_exact(shape):
    key = jax.random.PRNGKey(321)
    tkey = prng.PRNGKey(321)
    np.testing.assert_array_equal(
        prng.random_bits(tkey, shape).numpy(),
        _np(jax.random.bits(key, shape, dtype=jnp.uint32)))
    want = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    got = prng.uniform(tkey, shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32,
                                         minval=tiny))
    got = prng.uniform(tkey, shape, float(tiny), 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_per_row_keys_bit_exact():
    """One key a row over ``[V]`` (the engine's vmap) equals the
    reference's vmapped draws, bits and uniforms."""
    keys = jax.random.split(jax.random.PRNGKey(5), 8)
    want_b = jax.vmap(lambda k: jax.random.bits(
        k, (32000,), dtype=jnp.uint32))(keys)
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (32000,), dtype=jnp.float32))(keys))
    np.testing.assert_array_equal(
        prng.random_bits(_t(keys), (32000,)).numpy(), _np(want_b))
    np.testing.assert_array_equal(
        prng.uniform(_t(keys), (32000,)).numpy().view(np.int32),
        want_u.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_one_ulp(shape):
    key = jax.random.PRNGKey(7)
    tkey = prng.PRNGKey(7)
    u = prng.uniform(tkey, shape, prng._F32_TINY, 1.0)
    # each log within one ulp of XLA's on the same input
    inner_j = np.asarray(-jnp.log(jnp.asarray(u.numpy())))
    inner_t = (-torch.log(u.double())).float().numpy()
    assert _ulps(inner_t, inner_j).max() <= 1
    outer_j = np.asarray(-jnp.log(jnp.asarray(inner_j)))
    outer_t = (-torch.log(torch.tensor(inner_j).double())).float() \
        .numpy()
    assert _ulps(outer_t, outer_j).max() <= 1
    # composed: the result's ulp plus the inner ulp carried through -log
    want = np.asarray(jax.random.gumbel(key, shape, dtype=jnp.float32))
    got = prng.gumbel(tkey, shape).numpy()
    assert np.isfinite(got).all()
    carried = np.spacing(inner_j).astype(np.float64) / inner_j
    ulps = (np.abs(got.astype(np.float64) - want) - carried) \
        / np.spacing(np.abs(want))
    assert ulps.max() <= 2, ulps.max()


def _top2_gap(x):
    top = np.sort(x, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def test_categorical_token_exact_over_keys():
    """1,024 keys, one ``[4096]`` row each (the engine's per-row draw),
    and one key over a ``[8, 4096]`` batch (generate's draw)."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((1024, 4096)) * 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), 1024)
    want = np.asarray(jax.vmap(jax.random.categorical)(
        keys, jnp.asarray(logits)))
    got = prng.categorical(_t(keys), torch.from_numpy(logits)).numpy()
    diff = np.nonzero(got != want)[0]
    if len(diff):
        noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
            k, (4096,), dtype=jnp.float32))(keys[diff]))
        gaps = _top2_gap(noise + logits[diff])
        print(f"categorical: {len(diff)} of 1024 differ, top-2 gaps "
              f"{gaps.tolist()}")
        assert (gaps < NEAR_TIE).all(), gaps
    batch = logits[:8]
    key = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        prng.categorical(prng.PRNGKey(3), torch.from_numpy(batch)).numpy(),
        np.asarray(jax.random.categorical(key, jnp.asarray(batch))))


def _keep_masks(logits, temp, top_k, top_p):
    """Both packages' nucleus keep masks over the sorted slice (the k-slice
    with top-k, else the full sort) and the reference's mass before each
    position."""
    x = logits / np.float32(temp)
    if top_k:
        vals_j = jax.lax.top_k(jnp.asarray(x), top_k)[0]
        vals_t = torch.topk(torch.from_numpy(x), top_k, dim=-1).values
    else:
        vals_j = -jnp.sort(-jnp.asarray(x), axis=-1)
        vals_t = torch.sort(torch.from_numpy(x), dim=-1,
                            descending=True).values
    probs_j = jax.nn.softmax(vals_j, axis=-1)
    before_j = np.asarray(jnp.cumsum(probs_j, axis=-1) - probs_j)
    probs_t = tllama._softmax(vals_t)
    before_t = (torch.cumsum(probs_t, dim=-1) - probs_t).numpy()
    return before_j < np.float32(top_p), before_t < np.float32(top_p), \
        before_j


@pytest.mark.parametrize("temp", [0.5, 0.8, 1.3])
@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("top_k", [0, 50])
def test_filter_and_sampler_match_reference(top_k, top_p, temp):
    """The filter over ``[8, 32000]`` rows: the keep masks (flips
    reported, each within 1e-6 of ``top_p``), the filtered logits where
    no flip reaches, and the sampler's tokens over 128 draws a case (8
    rows x 8 keys, as ``generate`` calls it: one key, ``use_top_p`` off
    at ``top_p`` 1; and 8 rows x 8 positions as the engine does: a key a
    row, the nucleus always on), 1,536 draws over the 12 cases."""
    rng = np.random.default_rng(top_k + int(10 * top_p) + int(10 * temp))
    logits = (rng.standard_normal((8, 32000)) * 2).astype(np.float32)
    keep_j, keep_t, before = _keep_masks(logits, temp, top_k, top_p)
    flips = np.argwhere(keep_j != keep_t)
    if len(flips):
        dist = np.abs(before[tuple(flips.T)] - np.float32(top_p))
        print(f"top_k {top_k} top_p {top_p} temp {temp}: {len(flips)} "
              f"keep-mask flips in rows {sorted(set(flips[:, 0].tolist()))}, at "
              f"sorted positions {flips[:, 1].min()}-{flips[:, 1].max()},"
              f" at most {dist.max():.3g} from top_p")
        assert (dist <= 1e-6).all(), dist
    flipped_rows = set(flips[:, 0].tolist()) if len(flips) else set()
    use_top_p = top_p < 1.0
    t_j, p_j = jnp.float32(temp), jnp.float32(top_p)
    t_t, p_t = torch.tensor(temp, dtype=torch.float32), \
        torch.tensor(top_p, dtype=torch.float32)
    want = np.asarray(jllama._filter_logits(jnp.asarray(logits), t_j, top_k,
                                            p_j, use_top_p))
    got = tllama._filter_logits(torch.from_numpy(logits), t_t, top_k, p_t,
                                use_top_p).numpy()
    for r in range(8):
        if r not in flipped_rows:
            np.testing.assert_array_equal(got[r], want[r])
    # generate's form: one key over the batch, split as its loop splits
    key, tkey = jax.random.PRNGKey(9), prng.PRNGKey(9)
    diff = 0
    for _ in range(8):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        w = np.asarray(_J_SAMPLE(jnp.asarray(logits), sub, t_j, top_k, p_j,
                                 False, use_top_p))
        g = tllama._sample_logits_device(
            torch.from_numpy(logits), tsub, t_t, top_k, p_t, False,
            use_top_p).numpy()
        diff += _explain(g, w, want, sub, None)
    # the engine's form: a fold_in key a row, the nucleus always on
    base, tbase = jax.random.PRNGKey(5), prng.PRNGKey(5)
    rids = np.arange(8) * 3 + 1
    want_on = np.asarray(jllama._filter_logits(jnp.asarray(logits), t_j,
                                               top_k, p_j, True))
    for pos in range(0, 4096, 512):
        ks = jax.vmap(lambda r: jax.random.fold_in(
            jax.random.fold_in(base, r), pos))(rids)
        w = np.asarray(_J_ROWS(ks, jnp.asarray(logits), t_j, top_k, p_j))
        g = tle._sample_next(
            torch.from_numpy(logits),
            tle._Sampling(tbase, torch.full((8,), temp),
                          torch.full((8,), top_p), _t(rids), top_k),
            torch.full((8,), pos)).numpy()
        diff += _explain(g, w, want_on, None, ks)
    if diff:
        print(f"sampler: {diff} of 128 draws differ, all near-ties")


#: the reference's sampling head, compiled once per static argument set
_J_SAMPLE = jax.jit(jllama._sample_logits_device, static_argnums=(3, 5, 6))
_J_ROWS = jax.jit(lambda ks, rows, t, top_k, p: jax.vmap(
    lambda k, row: jllama._sample_logits_device(
        row, k, t, top_k, p, False, True))(ks, rows), static_argnums=(3,))


def _explain(got, want, filtered, key=None, row_keys=None):
    """Count the differing tokens, each of which must be a near-tie of the
    reference's perturbed logits (or sit on a keep-mask flip)."""
    bad = np.nonzero(got != want)[0]
    for r in bad:
        if row_keys is not None:
            noise = np.asarray(jax.random.gumbel(row_keys[r], (32000,),
                                                 dtype=jnp.float32))
        else:
            noise = np.asarray(jax.random.gumbel(key, filtered.shape,
                                                 dtype=jnp.float32))[r]
        gap = _top2_gap(noise + filtered[r])
        assert gap < NEAR_TIE or not np.isfinite(filtered[r, got[r]]), \
            (r, gap)
    return len(bad)


def test_argmax_ties_go_to_the_first():
    """Planted ties: ``torch.argmax`` and ``jnp.argmax`` both return the
    first maximum, so greedy rows, the sampler's draw over tied perturbed
    logits, and the engine's greedy path agree."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 96)).astype(np.float32)
    for r in range(16):
        cols = rng.choice(96, size=2 + r % 3, replace=False)
        x[r, cols] = x[r].max() + 1.0
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    assert (want == np.argmax(x, axis=-1)).all()
    np.testing.assert_array_equal(
        torch.argmax(torch.from_numpy(x), dim=-1).numpy(), want)
    np.testing.assert_array_equal(
        tle._sample_next(torch.from_numpy(x), None,
                         torch.zeros(16, dtype=torch.int32)).numpy(), want)
    np.testing.assert_array_equal(
        tllama._sample_logits_device(torch.from_numpy(x), None, None, 0,
                                     None, True, False).numpy(), want)
    # -inf everywhere but a tied pair: the Gumbel-max pick stays inside it
    y = np.full((4, 96), -np.inf, np.float32)
    y[:, [10, 40]] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    w = np.asarray(jax.vmap(jax.random.categorical)(keys, jnp.asarray(y)))
    g = prng.categorical(_t(keys), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(g, w)
    assert set(g.tolist()) <= {10, 40}


def test_top_k_tie_caveat_is_the_reference_s():
    """The reference's documented caveat (``llama.py:257-261``), kept: with
    exact ties at the k-th value every tied entry survives the ``< kth``
    mask while the nucleus normalizes over exactly k."""
    x = np.array([[3.0, 2.0, 2.0, 2.0, 1.0, 0.0]], np.float32)
    one, p = torch.tensor(1.0), torch.tensor(0.99)
    got = tllama._filter_logits(torch.from_numpy(x), one, 2, p, True)
    want = np.asarray(jllama._filter_logits(jnp.asarray(x), jnp.float32(1),
                                            2, jnp.float32(0.99), True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want[0, :4]).all() and np.isinf(want[0, 4:]).all()


def test_default_generator_matches_reference():
    """``Generator``: ``manual_seed``, ``next_seed``, ``get_state``,
    ``set_state``, ``initial_seed`` and ``seed`` step for step with the
    reference's host-side pair."""
    gens = (jrandom.Generator(3), trandom.Generator(3))
    for _ in range(3):
        assert gens[0].next_seed() == gens[1].next_seed()
    assert gens[0].get_state() == gens[1].get_state() == (3, 3)
    for g in gens:
        g.set_state((9, 40))
    assert gens[0].next_seed() == gens[1].next_seed() == (9, 41)
    for g in gens:
        g.manual_seed(12)
    assert gens[0].initial_seed() == gens[1].initial_seed() == 12
    assert gens[0].get_state() == gens[1].get_state() == (12, 0)
    saved = trandom.default_generator.get_state()
    try:
        assert trandom.seed(21) is trandom.default_generator
        assert trandom.default_generator.next_seed() == (21, 1)
    finally:
        trandom.default_generator.set_state(saved)
