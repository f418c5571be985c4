"""paddle_tpu_torch kernel wrappers on the CPU (their plain PyTorch
versions) held against the JAX package's Pallas kernels in interpret mode
and against the dense fallback of ``block_multihead_attention``.

Inputs are float32, made with numpy from fixed seeds. Tolerance atol 1e-5:
both sides compute in float32 with different summation orders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops.kernels.flash_attention import (
    _flash_fwd_res, _keep_mask, flash_attention_fwd as jax_flash)
from paddle_tpu.ops.kernels.paged_attention import (
    paged_attention_append as jax_paged_append,
    paged_attention_decode as jax_paged_decode)

from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops.kernels.flash_attention import (
    FlashAttention, attention_delta, flash_attention_bwd,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
    keep_mask)
from paddle_tpu_torch.ops.kernels.paged_attention import (
    kv_block_scale, kv_quantize, paged_attention_append,
    paged_attention_decode)

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture
def pallas_decode(monkeypatch):
    """The reference decode kernel, in interpret mode on the CPU. This jax
    renamed ``pltpu.TPUCompilerParams`` to ``CompilerParams``; the old
    name is aliased for the duration of the test only (the JAX package is
    not touched)."""
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    return jax_paged_decode


@pytest.fixture
def pallas_append(pallas_decode):
    """The reference append kernel, in interpret mode (same alias)."""
    return jax_paged_append


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(1, 128, 2, 2, 32),
                                          (2, 64, 4, 2, 16)])
def test_flash_plain_matches_pallas_interpret(causal, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(0)
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


def test_flash_refuses_unequal_causal():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention_fwd(q, k, k, causal=True)


# a seed whose float32 view is a normal number: the reference carries the
# seed's bits in a float32 (``seed_f``)
SEED = 0x3F8ABCDE


def _seed_f(seed):
    return jnp.asarray(np.array([[seed]], np.int32).view(np.float32))


def test_keep_mask_matches_reference_bit_for_bit():
    """The dropout hash over a full [bh, sq, sk] grid, at a grid whose
    flat index wraps past 2**31, for a negative and a positive seed."""
    bh, sq, sk = 5, 96, 80
    for seed, p, bh0 in ((SEED, 0.1, 0), (-123456789, 0.37, 280000)):
        rows = jnp.arange(sq, dtype=jnp.int32)[:, None]
        cols = jnp.arange(sk, dtype=jnp.int32)[None, :]
        ref = np.stack([np.asarray(_keep_mask(
            jnp.int32(seed), jnp.int32(bh0 + b), rows, cols, sq, sk, p))
            for b in range(bh)])
        got = keep_mask(seed, bh0 + torch.arange(bh).view(bh, 1, 1),
                        torch.arange(sq)[:, None], torch.arange(sk)[None, :],
                        sq, sk, p).numpy()
        assert np.array_equal(got, ref)
        assert abs(got.mean() - (1 - p)) < 0.02


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,p", [
    (2, 64, 2, 2, 16, True, 0.0), (2, 64, 4, 2, 16, False, 0.0),
    (1, 512, 2, 1, 16, True, 0.0), (1, 512, 2, 2, 16, False, 0.0),
    (1, 64, 4, 2, 16, True, 0.1), (1, 512, 2, 1, 16, False, 0.1)])
def test_flash_bwd_plain_matches_pallas_vjp(B, S, Hq, Hkv, D, causal, p):
    """``FlashAttention`` on the CPU (the plain forward and backward)
    against ``jax.vjp`` of the reference's flash attention (its Pallas
    kernels in interpret mode): out, dq, dk, dv. At S=512 the reference's
    forward tiles (256, 512) and backward tiles (512, 512) differ; with
    dropout both rebuild the same position-hashed mask. float32, atol
    1e-4."""
    rng = np.random.default_rng(S + Hkv)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal, None, p, _seed_f(SEED)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = (out,) + vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = FlashAttention.apply(tq, tk, tv, causal, None, p, SEED)
    o.backward(torch.from_numpy(do))
    for got, want in zip((o.detach(), tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


def test_flash_bwd_pieces_agree_and_refuse_bad_args():
    """On the CPU the dK/dV and dQ wrappers (their plain versions) give
    what the whole backward gives, without a launch; mismatched dout or
    lse shapes are refused."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, h, 16))
                                .astype(np.float32)) for h in (4, 2, 2))
    do = torch.from_numpy(rng.standard_normal((1, 40, 4, 16))
                          .astype(np.float32))
    out, lse = flash_attention_fwd(q, k, v, True)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, True)
    delta = attention_delta(out, do)
    n = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    dq2 = flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    assert n == (flash_attention_bwd_dkv.launches,
                 flash_attention_bwd_dq.launches)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd_dq(q, k, v, do[:, :8], lse, delta, True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_dkv(q, k, v, do, lse[:, :2], delta, True)
    with pytest.raises(ValueError, match="dropout_p"):
        flash_attention_fwd(q, k, v, True, dropout_p=1.0)


def _paged_case(rng, lens, Hq, Hkv, D=16, BS=8):
    """Pools + tables covering ``lens`` (+1 decode position each) with a
    trailing scratch block; physical blocks shuffled, tails -1."""
    B = len(lens)
    lens = np.asarray(lens, np.int32)
    MB = int(lens.max()) // BS + 2
    need = [int(L) // BS + 1 for L in lens]
    NB = sum(need) + 3                     # 2 spare + the scratch block
    order = rng.permutation(NB - 1)
    tables = np.full((B, MB), -1, np.int32)
    it = iter(order)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(it)
    f = np.float32
    return dict(q=rng.standard_normal((B, Hq, D)).astype(f),
                kc=rng.standard_normal((NB, Hkv, BS, D)).astype(f),
                vc=rng.standard_normal((NB, Hkv, BS, D)).astype(f),
                tables=tables, lens=lens,
                knew=rng.standard_normal((B, Hkv, D)).astype(f),
                vnew=rng.standard_normal((B, Hkv, D)).astype(f))


def _port_decode(c):
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    out = paged_attention_decode(t["q"], t["kc"], t["vc"], t["tables"],
                                 t["lens"], t["knew"], t["vnew"])
    return out.numpy(), t["kc"].numpy(), t["vc"].numpy()


def _dense_fallback(c):
    B, Hq, D = c["q"].shape
    Hkv = c["kc"].shape[1]
    qkv = np.concatenate([c["q"].reshape(B, Hq * D),
                          c["knew"].reshape(B, Hkv * D),
                          c["vnew"].reshape(B, Hkv * D)], axis=-1)
    out, kc, vc = JIF.block_multihead_attention(
        paddle.to_tensor(qkv), paddle.to_tensor(c["kc"]),
        paddle.to_tensor(c["vc"]), None, paddle.to_tensor(c["lens"]), None,
        block_tables=paddle.to_tensor(c["tables"]))
    return (np.asarray(out._value).reshape(B, Hq, D), np.asarray(kc._value),
            np.asarray(vc._value))


@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 2), (8, 2)])
def test_paged_plain_matches_pallas_and_dense(Hq, Hkv, pallas_decode):
    """Lengths on (16, 24), just past (17) and just before (7) a block
    boundary, a mid-block one, a -1 tail in every table."""
    rng = np.random.default_rng(Hq)
    c = _paged_case(rng, [16, 17, 7, 3, 24], Hq, Hkv)
    out, kc, vc = _port_decode(c)
    ref_out, ref_kc, ref_vc = pallas_decode(
        jnp.asarray(c["q"]), jnp.asarray(c["kc"]), jnp.asarray(c["vc"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["lens"]),
        new_k=jnp.asarray(c["knew"]), new_v=jnp.asarray(c["vnew"]))
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(kc, np.asarray(ref_kc))
    np.testing.assert_array_equal(vc, np.asarray(ref_vc))
    d_out, d_kc, d_vc = _dense_fallback(c)
    np.testing.assert_allclose(out, d_out, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(kc, d_kc)
    np.testing.assert_array_equal(vc, d_vc)


def test_paged_minus_one_write_target_parks_in_scratch(pallas_decode):
    """A freed slot (stale lens, wiped table): its write lands in the last
    (scratch) block, never a real one; every real block matches both
    references bit for bit, the live rows attend exactly, and the wiped
    row's output is the reference kernel's (nothing visible -> zeros)."""
    rng = np.random.default_rng(5)
    c = _paged_case(rng, [5, 18, 9], Hq=4, Hkv=2)
    c["tables"][0, :] = -1
    NB = c["kc"].shape[0]
    out, kc, vc = _port_decode(c)
    ref_out, ref_kc, _ = pallas_decode(
        jnp.asarray(c["q"]), jnp.asarray(c["kc"]), jnp.asarray(c["vc"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["lens"]),
        new_k=jnp.asarray(c["knew"]), new_v=jnp.asarray(c["vnew"]))
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(kc[:NB - 1], np.asarray(ref_kc)[:NB - 1])
    np.testing.assert_array_equal(kc[NB - 1, :, 5], c["knew"][0])
    d_out, d_kc, d_vc = _dense_fallback(c)
    np.testing.assert_allclose(out[1:], d_out[1:], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(kc[:NB - 1], d_kc[:NB - 1])
    np.testing.assert_array_equal(vc[:NB - 1], d_vc[:NB - 1])


def test_block_multihead_attention_decode_matches_reference():
    """The port's op (qkv split + kernel wrapper) against the reference op
    on the same fused qkv rows; the 3-D form needs q_lens; int8 pools
    return the scales beside the pools, as the reference's op does."""
    rng = np.random.default_rng(9)
    c = _paged_case(rng, [8, 13, 1], Hq=4, Hkv=2)
    B, Hq, D = c["q"].shape
    Hkv = c["kc"].shape[1]
    qkv = np.concatenate([c["q"].reshape(B, Hq * D),
                          c["knew"].reshape(B, Hkv * D),
                          c["vnew"].reshape(B, Hkv * D)], axis=-1)
    kc, vc = torch.from_numpy(c["kc"].copy()), torch.from_numpy(c["vc"].copy())
    out, kc2, vc2 = TIF.block_multihead_attention(
        torch.from_numpy(qkv), kc, vc, None, torch.from_numpy(c["lens"]),
        None, block_tables=torch.from_numpy(c["tables"]))
    assert kc2 is kc and vc2 is vc                 # updated in place
    d_out, d_kc, d_vc = _dense_fallback(c)
    np.testing.assert_allclose(out.numpy().reshape(B, Hq, D), d_out,
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(kc.numpy(), d_kc)
    np.testing.assert_array_equal(vc.numpy(), d_vc)
    # the append form with one row per slot is the same decode step (on
    # fresh copies of the pools): same output, same pools
    kc3, vc3 = torch.from_numpy(c["kc"].copy()), torch.from_numpy(c["vc"].copy())
    out3, _, _ = TIF.block_multihead_attention(
        torch.from_numpy(qkv)[:, None], kc3, vc3, None,
        torch.from_numpy(c["lens"]), torch.ones(B, dtype=torch.int32),
        block_tables=torch.from_numpy(c["tables"]))
    np.testing.assert_allclose(out3.numpy().reshape(B, Hq, D), d_out,
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(kc3.numpy(), d_kc)
    np.testing.assert_array_equal(vc3.numpy(), d_vc)
    with pytest.raises(ValueError, match="seq_lens_this_time"):
        TIF.block_multihead_attention(
            torch.from_numpy(qkv)[:, None], kc3, vc3, None,
            torch.from_numpy(c["lens"]), None,
            block_tables=torch.from_numpy(c["tables"]))
    # quantized pools: the reference op's five-tuple, the same bits
    NB = c["kc"].shape[0]
    with pytest.raises(ValueError, match="cache_k_quant_scales"):
        TIF.block_multihead_attention(
            torch.from_numpy(qkv), kc, vc, None, torch.from_numpy(c["lens"]),
            None, block_tables=torch.from_numpy(c["tables"]),
            cache_quant_type="int8")
    qpools = []
    for f in (c["kc"], c["vc"]):
        sc = kv_block_scale(torch.from_numpy(f), "int8", (2, 3))
        qpools += [kv_quantize(torch.from_numpy(f), sc[..., None, None],
                               "int8"), sc]
    ref = JIF.block_multihead_attention(
        paddle.to_tensor(qkv), *[paddle.to_tensor(t.numpy().copy())
                                 for t in qpools[::2]],
        None, paddle.to_tensor(c["lens"]), None,
        block_tables=paddle.to_tensor(c["tables"]),
        cache_k_quant_scales=paddle.to_tensor(qpools[1].numpy().copy()),
        cache_v_quant_scales=paddle.to_tensor(qpools[3].numpy().copy()),
        cache_quant_type="int8")
    outs = TIF.block_multihead_attention(
        torch.from_numpy(qkv), qpools[0], qpools[2], None,
        torch.from_numpy(c["lens"]), None,
        block_tables=torch.from_numpy(c["tables"]),
        cache_k_quant_scales=qpools[1], cache_v_quant_scales=qpools[3],
        cache_quant_type="int8")
    assert len(outs) == 5 and outs[1] is qpools[0] and outs[3] is qpools[1]
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref[0]._value),
                               atol=ATOL, rtol=0)
    for got, want in zip(outs[1:], ref[1:]):
        np.testing.assert_array_equal(got.numpy()[:NB - 1],
                                      np.asarray(want._value)[:NB - 1])


# ---------------------------------------------------------------------------
# append form (the fused scheduler's mixed step)
# ---------------------------------------------------------------------------

APPEND_S, APPEND_BS = 12, 8
# (lens, q_lens): a first chunk, a window starting mid-block and crossing
# two block boundaries, decode rows on either side of a boundary, a short
# ragged chunk, an idle slot
APPEND_SPECS = [(0, 12), (5, 12), (15, 1), (16, 1), (9, 3), (20, 0)]


def _append_case(rng, specs, Hq, Hkv, D=16, S=APPEND_S, BS=APPEND_BS):
    """Pools + tables covering each window ``[lens, lens + q_lens)`` with a
    trailing scratch block; physical blocks shuffled, tails -1."""
    B = len(specs)
    need = [(L + max(q, 1) - 1) // BS + 1 for L, q in specs]
    MB = max(need) + 1
    NB = sum(need) + 3                     # 2 spare + the scratch block
    it = iter(rng.permutation(NB - 1))
    tables = np.full((B, MB), -1, np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(it)
    f = np.float32
    return dict(q=rng.standard_normal((B, S, Hq, D)).astype(f),
                kc=rng.standard_normal((NB, Hkv, BS, D)).astype(f),
                vc=rng.standard_normal((NB, Hkv, BS, D)).astype(f),
                tables=tables,
                lens=np.array([L for L, _ in specs], np.int32),
                qlens=np.array([q for _, q in specs], np.int32),
                knew=rng.standard_normal((B, S, Hkv, D)).astype(f),
                vnew=rng.standard_normal((B, S, Hkv, D)).astype(f))


def _port_append(c):
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    n0 = paged_attention_append.launches
    out = paged_attention_append(t["q"], t["kc"], t["vc"], t["tables"],
                                 t["lens"], t["qlens"], t["knew"], t["vnew"])
    assert paged_attention_append.launches == n0  # CPU: plain, no launch
    return out.numpy(), t["kc"].numpy(), t["vc"].numpy()


def _pallas_append_run(fn, c):
    out, kc, vc = fn(*(jnp.asarray(c[k]) for k in (
        "q", "kc", "vc", "tables", "lens", "qlens", "knew", "vnew")))
    return np.asarray(out), np.asarray(kc), np.asarray(vc)


def _dense_append(c):
    B, S, Hq, D = c["q"].shape
    Hkv = c["kc"].shape[1]
    qkv = np.concatenate([c["q"].reshape(B, S, Hq * D),
                          c["knew"].reshape(B, S, Hkv * D),
                          c["vnew"].reshape(B, S, Hkv * D)], axis=-1)
    out, kc, vc = JIF.block_multihead_attention(
        paddle.to_tensor(qkv), paddle.to_tensor(c["kc"]),
        paddle.to_tensor(c["vc"]), None, paddle.to_tensor(c["lens"]),
        paddle.to_tensor(c["qlens"]),
        block_tables=paddle.to_tensor(c["tables"]))
    return (np.asarray(out._value).reshape(B, S, Hq, D),
            np.asarray(kc._value), np.asarray(vc._value))


def _assert_real_rows(out, ref, qlens):
    for b, n in enumerate(qlens):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=ATOL, rtol=0)


@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 2), (8, 2)])
def test_append_plain_matches_pallas_and_dense(Hq, Hkv, pallas_append):
    """MHA and GQA; a chunk from 0, a window starting mid-block and
    crossing blocks, q_lens of 0, 1 and S. Real rows agree at atol 1e-5;
    pools are bit-identical outside the scratch block; padding rows and
    the idle slot are zeros."""
    rng = np.random.default_rng(20 + Hq)
    c = _append_case(rng, APPEND_SPECS, Hq, Hkv)
    NB = c["kc"].shape[0]
    out, kc, vc = _port_append(c)
    r_out, r_kc, r_vc = _pallas_append_run(pallas_append, c)
    _assert_real_rows(out, r_out, c["qlens"])
    np.testing.assert_array_equal(kc[:NB - 1], r_kc[:NB - 1])
    np.testing.assert_array_equal(vc[:NB - 1], r_vc[:NB - 1])
    assert not np.array_equal(kc[:NB - 1], c["kc"][:NB - 1])   # rows written
    d_out, d_kc, d_vc = _dense_append(c)
    _assert_real_rows(out, d_out, c["qlens"])
    np.testing.assert_array_equal(kc[:NB - 1], d_kc[:NB - 1])
    np.testing.assert_array_equal(vc[:NB - 1], d_vc[:NB - 1])
    for b, n in enumerate(c["qlens"]):
        assert not out[b, n:].any()


def test_append_minus_one_target_parks_in_scratch(pallas_append):
    """A window that runs into a -1 table entry: the rows it would write
    there land in the scratch block (never a real block) and are not
    attended, as in the reference kernel; an idle slot with a wiped table
    writes nothing real. Held against the Pallas kernel only: the dense
    fallback drops the write but reads block 0 in its place."""
    rng = np.random.default_rng(27)
    c = _append_case(rng, [(6, 12), (0, 9), (4, 0)], Hq=4, Hkv=2)
    c["tables"][0, 2] = -1          # positions 16, 17 of slot 0
    c["tables"][2, :] = -1          # idle slot, wiped row
    NB = c["kc"].shape[0]
    out, kc, vc = _port_append(c)
    r_out, r_kc, r_vc = _pallas_append_run(pallas_append, c)
    _assert_real_rows(out, r_out, c["qlens"])
    np.testing.assert_array_equal(kc[:NB - 1], r_kc[:NB - 1])
    np.testing.assert_array_equal(vc[:NB - 1], r_vc[:NB - 1])
    np.testing.assert_array_equal(kc[NB - 1, :, 0:2],
                                  c["knew"][0, 10:12].transpose(1, 0, 2))


# ---------------------------------------------------------------------------
# what the paged kernels take: the wrappers refuse the rest before a launch
# ---------------------------------------------------------------------------

def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("bad,match", [
    (dict(), None),
    (dict(q=torch.zeros(2, 3, 4, 64)), "bfloat16 q"),
    (dict(block_tables=torch.zeros(2, 4, dtype=torch.int64)), "int32"),
    (dict(D=96), "head_dim"),
    (dict(G=3), "query heads"),
    (dict(bs=256), "block_size"),
    (dict(k_pool=_bf(5, 2, 64, 16).transpose(2, 3)),
     "pools must be contiguous"),
    (dict(q=_bf(2, 3, 4, 65)[..., :64]), "q rows"),
])
def test_paged_kernel_args_refused(bad, match):
    """The checks both paged wrappers run on a CUDA tensor before any
    launch (bf16 only, int32 tables, D in {64, 128}, G in {1, 2, 4, 8},
    block size <= 128, contiguous pools, aligned [H, D] rows)."""
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        _check_kernel_args
    a = dict(q=_bf(2, 3, 4, 64), new_k=_bf(2, 3, 2, 64),
             new_v=_bf(2, 3, 2, 64), k_pool=_bf(5, 2, 16, 64),
             v_pool=_bf(5, 2, 16, 64),
             block_tables=torch.zeros(2, 4, dtype=torch.int32),
             seq_lens=torch.zeros(2, dtype=torch.int32), D=64, G=2, bs=16)
    a.update(bad)
    args = ("paged_attention_append",
            {k: a[k] for k in ("q", "new_k", "new_v")},
            {k: a[k] for k in ("k_pool", "v_pool")},
            {k: a[k] for k in ("block_tables", "seq_lens")},
            a["D"], a["G"], a["bs"])
    if match is None:
        _check_kernel_args(*args)
        return
    with pytest.raises((TypeError, ValueError), match=match):
        _check_kernel_args(*args)
