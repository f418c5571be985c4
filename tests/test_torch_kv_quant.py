"""Quantized paged KV in paddle_tpu_torch (int8/int4 pools, kernel B4's
plain versions, ``LLMEngine(kv_cache_dtype=...)``) held against the JAX
package on the CPU, mirroring tests/test_kv_quant.py.

- The pool helpers against the reference's, bit for bit. The scale rule
  is held against the reference's COMPILED helper: XLA turns
  ``absmax / qmax`` into a product with the float32 reciprocal under jit,
  and every compiled reference path (the dense fallback, the engine's
  prefill scatter) stores those bits.
- The plain quantized decode and append against the reference's
  ``block_multihead_attention`` dense fallback and its Pallas kernels in
  interpret mode (on the inputs of ``test_kv_quant.py:112-190``): payload
  and scales bit-exact outside the scratch block (the fallback drops what
  a -1 target writes, the kernels park it there), outputs within atol
  2e-5, rtol 1e-4 (float32 on both sides, other summation orders).
- The engine token-exact against the reference engine with the same
  settings, fused and legacy, int8 and int4, on bridged weights (tiny
  model: 2 layers, hidden 64, vocab 96; block 8, chunk 16, 64 positions);
  capacity at equal bytes; constructor errors.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.ops.kernels import paged_attention as JPA

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels.paged_attention import (
    KV_QMAX, kv_block_scale, kv_pack, kv_packed_dim, kv_quantize, kv_unpack,
    paged_attention_append, paged_attention_decode)

torch.set_num_threads(1)
QUANTS = ("int8", "int4")
OUT_TOL = dict(atol=2e-5, rtol=1e-4)
KW = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
          max_position_embeddings=128)


def _j_scale(x, quant, axes):
    """The reference's scale rule as its compiled paths evaluate it."""
    f = jax.jit(JPA.kv_block_scale, static_argnums=(1, 2))
    return np.asarray(f(jnp.asarray(x), quant, axes))


def _quant_pools(rng, lens, grow, Hkv, D, BS, quant):
    """Quantized pools and tables covering ``lens`` (+``grow`` positions
    each), physical blocks shuffled, the trailing block never assigned
    (the engine's scratch). One numpy set serves both packages."""
    B = len(lens)
    need = [(int(L) + max(int(g), 1)) // BS + 1 for L, g in zip(lens, grow)]
    MB = max(need) + 1
    NB = sum(need) + 2
    it = iter(rng.permutation(NB - 1))
    tables = np.full((B, MB), -1, np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(it)
    pools = []
    for _ in range(2):
        f = rng.standard_normal((NB, Hkv, BS, D)).astype(np.float32)
        s = _j_scale(f, quant, (2, 3))
        pools.append((np.asarray(JPA.kv_quantize(
            jnp.asarray(f), jnp.asarray(s)[..., None, None], quant)), s))
    (kc, ks), (vc, vs) = pools
    return kc, vc, ks, vs, tables, np.asarray(lens, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_pools(got, want):
    """Payload and scales bit-exact outside the scratch block."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g)[:-1], np.asarray(w)[:-1])


@pytest.fixture
def pallas(monkeypatch):
    """The reference Pallas kernels in interpret mode; this jax renamed
    ``pltpu.TPUCompilerParams``, aliased for the test only."""
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    return JPA


# ---------------------------------------------------------------------------
# the pool helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("D", [32, 5])
def test_helpers_match_reference(quant, D):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 3, 8, D)) * 3).astype(np.float32)
    x[0, 0] = 0.0                                   # an all-zero block
    assert kv_packed_dim(D, quant) == JPA.kv_packed_dim(D, quant)
    assert kv_packed_dim(D, None) == D
    s = kv_block_scale(torch.from_numpy(x), quant, (2, 3))
    np.testing.assert_array_equal(s.numpy(), _j_scale(x, quant, (2, 3)))
    packed = kv_quantize(torch.from_numpy(x), s[..., None, None], quant)
    want = np.asarray(JPA.kv_quantize(jnp.asarray(x),
                                      jnp.asarray(s.numpy())[..., None, None],
                                      quant))
    np.testing.assert_array_equal(packed.numpy(), want)
    assert packed.shape[-1] == kv_packed_dim(D, quant)
    np.testing.assert_array_equal(
        kv_unpack(packed, quant, D).numpy(),
        np.asarray(JPA.kv_unpack(jnp.asarray(want), quant, D)))
    grid = rng.integers(-int(KV_QMAX[quant]), int(KV_QMAX[quant]) + 1,
                        size=(4, 3, D)).astype(np.int32)
    np.testing.assert_array_equal(
        kv_pack(torch.from_numpy(grid), quant).numpy(),
        np.asarray(JPA.kv_pack(jnp.asarray(grid), quant)))
    np.testing.assert_array_equal(
        kv_unpack(kv_pack(torch.from_numpy(grid), quant), quant, D).numpy(),
        grid.astype(np.float32))


def test_kv_quant_scatter_and_gather_match_reference():
    """The dense write and read rules of the incubate module."""
    rng = np.random.default_rng(1)
    for quant in QUANTS:
        kc, _, ks, _, tables, _ = _quant_pools(rng, [12, 5], [1, 1], 2, 16,
                                               8, quant)
        nb = kc.shape[0]
        wblk = np.array([tables[0, 1], tables[0, 1], nb, tables[1, 0]],
                        np.int32)
        slot = np.array([4, 5, 0, 5], np.int32)
        rows = rng.standard_normal((4, 2, 16)).astype(np.float32)
        ends = np.array([6, 6, 1, 6], np.int32)
        rp, rs = jax.jit(JIF._kv_quant_scatter, static_argnums=(5, 6))(
            jnp.asarray(kc), jnp.asarray(ks), jnp.asarray(wblk),
            jnp.asarray(slot), jnp.asarray(rows), quant, 16,
            jnp.asarray(ends))
        tp, ts = _t(kc, ks)
        TIF._kv_quant_scatter(tp, ts, *_t(wblk, slot, rows), quant, 16,
                              torch.from_numpy(ends))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        safe = np.maximum(tables, 0)
        np.testing.assert_array_equal(
            TIF._kv_quant_gather(tp, ts, torch.from_numpy(safe).long(),
                                 quant, 16).numpy(),
            np.asarray(JIF._kv_quant_gather(rp, rs, jnp.asarray(safe),
                                            quant, 16)))


# ---------------------------------------------------------------------------
# the plain quantized decode and append against the reference
# ---------------------------------------------------------------------------

def _decode_case(rng, quant, group, lens=(16, 17, 7, 3), Hkv=2, D=32, BS=8):
    kc, vc, ks, vs, tables, lens_ = _quant_pools(
        rng, lens, [1] * len(lens), Hkv, D, BS, quant)
    B = len(lens)
    q = rng.standard_normal((B, Hkv * group, D)).astype(np.float32)
    knew = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vnew = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    return kc, vc, ks, vs, tables, lens_, q, knew, vnew


def _ref_decode(kc, vc, ks, vs, tables, lens_, q, knew, vnew, quant):
    B = q.shape[0]
    qkv = np.concatenate([q.reshape(B, -1), knew.reshape(B, -1),
                          vnew.reshape(B, -1)], -1)
    res = JIF.block_multihead_attention(
        paddle.to_tensor(qkv), paddle.to_tensor(kc), paddle.to_tensor(vc),
        None, paddle.to_tensor(lens_), None,
        block_tables=paddle.to_tensor(tables),
        cache_k_quant_scales=paddle.to_tensor(ks),
        cache_v_quant_scales=paddle.to_tensor(vs), cache_quant_type=quant)
    return [np.asarray(t._value) for t in res]


def _port_decode(kc, vc, ks, vs, tables, lens_, q, knew, vnew, quant):
    pools = _t(kc, vc, ks, vs)
    out, *_ = paged_attention_decode(
        *_t(q), pools[0], pools[1], *_t(tables, lens_, knew, vnew),
        k_scale=pools[2], v_scale=pools[3], quant=quant)
    return out.numpy(), [p.numpy() for p in pools]


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("group", [1, 2])
def test_decode_plain_matches_dense_fallback(quant, group):
    """Block boundaries (len % bs in {0, 1, bs-1}) and GQA."""
    case = _decode_case(np.random.default_rng(2), quant, group)
    ro, *rpools = _ref_decode(*case, quant)
    out, pools = _port_decode(*case, quant)
    np.testing.assert_allclose(out, ro.reshape(out.shape), **OUT_TOL)
    _assert_pools(pools, rpools)


def _append_case(rng, quant, Hkv=2, D=32, BS=8, S=8, Hq=4):
    lens = [16, 17, 7, 3]
    q_lens = np.asarray([0, 1, 5, 8], np.int32)
    kc, vc, ks, vs, tables, lens_ = _quant_pools(rng, lens, q_lens, Hkv, D,
                                                 BS, quant)
    B = len(lens)
    qa = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    ka = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    va = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return kc, vc, ks, vs, tables, lens_, q_lens, qa, ka, va


def _port_append(kc, vc, ks, vs, tables, lens_, q_lens, qa, ka, va, quant):
    pools = _t(kc, vc, ks, vs)
    out, *_ = paged_attention_append(
        *_t(qa), pools[0], pools[1], *_t(tables, lens_, q_lens, ka, va),
        k_scale=pools[2], v_scale=pools[3], quant=quant)
    return out.numpy(), [p.numpy() for p in pools]


def _assert_rows(out, ref, q_lens):
    for b, n in enumerate(q_lens):
        if n:
            np.testing.assert_allclose(out[b, :n], ref[b, :n], **OUT_TOL)
        assert not out[b, n:].any()


@pytest.mark.parametrize("quant", QUANTS)
def test_append_plain_matches_dense_fallback(quant):
    """q_lens {0 (idle), 1 (decode-shaped), mid, full chunk}, windows
    crossing block boundaries; the public op returns the scales."""
    case = _append_case(np.random.default_rng(3), quant)
    kc, vc, ks, vs, tables, lens_, q_lens, qa, ka, va = case
    B, S = qa.shape[:2]
    qkv3 = np.concatenate([qa.reshape(B, S, -1), ka.reshape(B, S, -1),
                           va.reshape(B, S, -1)], -1)
    res = JIF.block_multihead_attention(
        paddle.to_tensor(qkv3), paddle.to_tensor(kc), paddle.to_tensor(vc),
        None, paddle.to_tensor(lens_), paddle.to_tensor(q_lens),
        block_tables=paddle.to_tensor(tables),
        cache_k_quant_scales=paddle.to_tensor(ks),
        cache_v_quant_scales=paddle.to_tensor(vs), cache_quant_type=quant)
    ro, *rpools = [np.asarray(t._value) for t in res]
    pools = _t(kc, vc, ks, vs)
    tres = TIF.block_multihead_attention(
        torch.from_numpy(qkv3), pools[0], pools[1], None,
        *_t(lens_, q_lens), block_tables=torch.from_numpy(tables),
        cache_k_quant_scales=pools[2], cache_v_quant_scales=pools[3],
        cache_quant_type=quant)
    assert len(tres) == 5 and tres[3] is pools[2]
    _assert_rows(tres[0].numpy().reshape(qa.shape),
                 ro.reshape(qa.shape), q_lens)
    _assert_pools([p.numpy() for p in pools], rpools)


@pytest.mark.parametrize("quant", QUANTS)
def test_plain_matches_pallas_interpret(pallas, quant):
    """The same inputs through the reference's quantized Pallas kernels
    in interpret mode: the same bits (outside scratch), the same rows."""
    rng = np.random.default_rng(4)
    case = _decode_case(rng, quant, 2)
    kc, vc, ks, vs, tables, lens_, q, knew, vnew = case
    jo, *jpools = pallas.paged_attention_decode(
        *map(jnp.asarray, (q, kc, vc, tables, lens_)),
        new_k=jnp.asarray(knew), new_v=jnp.asarray(vnew),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), quant=quant)
    out, pools = _port_decode(*case, quant)
    np.testing.assert_allclose(out, np.asarray(jo), **OUT_TOL)
    _assert_pools(pools, jpools)
    case = _append_case(rng, quant)
    kc, vc, ks, vs, tables, lens_, q_lens, qa, ka, va = case
    jo, *jpools = pallas.paged_attention_append(
        *map(jnp.asarray, (qa, kc, vc, tables, lens_, q_lens, ka, va)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), quant=quant)
    out, pools = _port_append(*case, quant)
    _assert_rows(out, np.asarray(jo), q_lens)
    _assert_pools(pools, jpools)


def test_scale_grows_on_a_large_fused_write():
    """A new token dwarfing its block GROWS the block's scale (fresh
    absmax over the merged block) and saturates its stored row at the
    grid edge; every other block keeps its bits."""
    rng = np.random.default_rng(5)
    kc, vc, ks, vs, tables, lens_, q, knew, vnew = _decode_case(
        rng, "int8", 1, lens=(11,))
    knew[:] = 50.0
    out, (kc2, _, ks2, _) = _port_decode(kc, vc, ks, vs, tables, lens_, q,
                                         knew, vnew, "int8")
    blk, slot = int(tables[0, 1]), 11 % 8
    np.testing.assert_allclose(ks2[blk], 50.0 / 127.0, rtol=1e-6)
    assert (ks2[blk] > ks[blk]).all()
    np.testing.assert_array_equal(kc2[blk, :, slot], 127)
    others = [i for i in range(kc.shape[0]) if i != blk]
    np.testing.assert_array_equal(kc2[others], kc[others])
    np.testing.assert_array_equal(ks2[others], ks[others])


def test_dirty_block_reuse_does_not_inflate_scale():
    """A reused block's stale content (100x the new owner's values) past
    the new token is zeroed before the absmax: the scale is the live
    row's own, its dequantized row ~= the token, and the reference's
    fallback stores the same bits."""
    rng = np.random.default_rng(6)
    case = list(_decode_case(rng, "int8", 1, lens=(8,)))
    kc, ks, tables = case[0].copy(), case[2].copy(), case[4]
    blk = int(tables[0, 1])
    stale = 100.0 * rng.standard_normal((2, 8, 32)).astype(np.float32)
    ks[blk] = np.abs(stale).max(axis=(1, 2)) / 127.0
    kc[blk] = np.asarray(JPA.kv_quantize(
        jnp.asarray(stale), jnp.asarray(ks[blk])[:, None, None], "int8"))
    case[0], case[2] = kc, ks
    case[7][:] = 0.01                               # knew
    _, (kc2, _, ks2, _) = _port_decode(*case, "int8")
    np.testing.assert_allclose(ks2[blk], 0.01 / 127.0, rtol=1e-6)
    deq = kc2[blk, :, 0].astype(np.float32) * ks2[blk][:, None]
    np.testing.assert_allclose(deq, 0.01, rtol=0.02)
    assert not kc2[blk, :, 1:].any()
    _, rkc, _, rks, _ = _ref_decode(*case, "int8")
    np.testing.assert_array_equal(rkc[blk], kc2[blk])
    np.testing.assert_array_equal(rks[blk], ks2[blk])


@pytest.mark.parametrize("quant", QUANTS)
def test_idle_slot_unchanged_and_minus_one_parks_in_scratch(quant):
    """A q_lens == 0 slot's blocks keep their bytes (no zeroing, no
    re-round); a -1 write target leaves every real block alone and parks
    payload and scale in the scratch block."""
    rng = np.random.default_rng(7)
    case = list(_append_case(rng, quant))
    tables = case[4].copy()
    j = int(case[5][2]) // 8 + 1                    # slot 2's second block
    victim = int(tables[2, j])
    tables[2, j] = -1
    case[4] = tables
    kc, ks = case[0], case[2]
    _, (kc2, _, ks2, _) = _port_append(*case, quant)
    idle = [int(x) for x in tables[0] if x >= 0]
    np.testing.assert_array_equal(kc2[idle], kc[idle])
    np.testing.assert_array_equal(ks2[idle], ks[idle])
    np.testing.assert_array_equal(kc2[victim], kc[victim])
    assert not np.array_equal(kc2[-1], kc[-1]) and ks2[-1].any()


def test_int4_odd_head_dim():
    """Odd D pads one nibble: the plain decode on odd-D int4 pools matches
    the reference's fallback (which resolves D from the qkv width)."""
    case = _decode_case(np.random.default_rng(8), "int4", 1, lens=(9, 4),
                        D=5)
    assert case[0].shape[-1] == kv_packed_dim(5, "int4") == 3
    ro, *rpools = _ref_decode(*case, "int4")
    out, pools = _port_decode(*case, "int4")
    np.testing.assert_allclose(out, ro.reshape(out.shape), **OUT_TOL)
    _assert_pools(pools, rpools)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLlama(JConfig(**KW))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**KW), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 96, size=(n,)).astype(np.int32)
            for n in (13, 9)]


def _kw(**over):
    kw = dict(max_batch=2, max_seq_len=64, chunk_size=16,
              cache_impl="paged", block_size=8, scheduler="fused",
              kv_cache_dtype="int8")
    kw.update(over)
    return kw


def _toks(eng, prompts, n=12):
    return [o.token_ids for o in eng.generate(prompts, max_new_tokens=n)]


def _match_prefix(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


@pytest.fixture(scope="module")
def port_toks(models, prompts):
    _, tm = models
    return {(q, s): _toks(LLMEngine(tm, device="cpu",
                                    **_kw(kv_cache_dtype=q, scheduler=s)),
                          prompts)
            for q in (None, "int8", "int4") for s in ("fused", "legacy")}


@pytest.mark.parametrize("scheduler", ["fused", "legacy"])
@pytest.mark.parametrize("quant", QUANTS)
def test_engine_token_exact_against_reference(models, prompts, port_toks,
                                              quant, scheduler):
    jm, _ = models
    want = _toks(JEngine(jm, **_kw(kv_cache_dtype=quant,
                                   scheduler=scheduler)), prompts)
    assert port_toks[(quant, scheduler)] == want


def test_int8_legacy_equals_fused_and_tracks_bf16(port_toks):
    """Legacy admission writes whole chunk-aligned blocks, the bytes the
    fused append writes for block-aligned grants: the schedulers agree
    under int8; and int8 matches the unquantized stream for >= 8 tokens."""
    assert port_toks[("int8", "legacy")] == port_toks[("int8", "fused")]
    for ref, got in zip(port_toks[(None, "fused")],
                        port_toks[("int8", "fused")]):
        assert _match_prefix(ref, got) >= 8


def test_engine_pools_and_pool_checks(models, prompts, monkeypatch):
    """int4 pools are nibble-packed int8 with float32 scales beside them;
    the allocator audit holds through a drain and a reset."""
    monkeypatch.setenv("PADDLE_TPU_POOL_CHECKS", "1")
    eng = LLMEngine(models[1], device="cpu", **_kw(kv_cache_dtype="int4"))
    assert all(len(t) == 10 for t in _toks(eng, prompts, 10))
    assert eng._k[0].dtype == torch.int8
    assert eng._k[0].shape[-1] == 16 // 2
    assert eng._k_scale[0].shape == (eng.n_blocks + 1, 4)
    assert eng._k_scale[0].dtype == torch.float32
    eng.reset()
    assert not eng._k[0].any() and not eng._k_scale[0].any()
    assert len(eng._free_blocks) == eng.n_blocks


def test_pool_capacity_ratios(models):
    """At equal bytes an int8 (int4) pool holds >= 1.9x (>= 3.5x) the bf16
    blocks, off the real tensors (scales included), and the byte counts
    equal the reference engine's."""
    jm, _ = models
    tm = LlamaForCausalLM(LlamaConfig(**dict(KW, dtype="bfloat16")),
                          device="cpu")
    jb = JLlama(JConfig(**KW)).bfloat16()
    engines = {q: LLMEngine(tm, device="cpu",
                            **_kw(kv_cache_dtype=q, block_size=16))
               for q in (None, "int8", "int4")}
    bpb = {q: e.kv_bytes_per_block() for q, e in engines.items()}
    assert bpb[None] / bpb["int8"] >= 1.9
    assert bpb[None] / bpb["int4"] >= 3.5
    nb = engines[None].n_blocks
    assert engines[None].kv_pool_effective_blocks() == nb
    assert engines["int8"].kv_pool_effective_blocks() >= int(1.9 * nb)
    assert engines["int4"].kv_pool_effective_blocks() >= int(3.5 * nb)
    for q, e in engines.items():
        ref = JEngine(jb, **_kw(kv_cache_dtype=q, block_size=16))
        assert e.kv_pool_nbytes() == ref.kv_pool_nbytes()
        assert e.kv_pool_effective_blocks() == ref.kv_pool_effective_blocks()
        assert e.kv_pool_nbytes() == sum(
            t.numel() * t.element_size()
            for t in (*e._k, *e._v, *e._k_scale, *e._v_scale)
            if t is not None)


def test_constructor_errors(models):
    tm = models[1]
    with pytest.raises(ValueError, match="cache_impl='paged'"):
        LLMEngine(tm, device="cpu", cache_impl="dense", kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        LLMEngine(tm, device="cpu", **_kw(kv_cache_dtype="fp8"))
