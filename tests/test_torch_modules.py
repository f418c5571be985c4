"""paddle_tpu_torch modules against their JAX counterparts on the CPU:
RoPE (scalar and per-slot offsets), RMSNorm (cast order), swiglu, and the
scaled_dot_product_attention routing rule. Inputs from numpy, fixed seeds."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattn

torch.set_num_threads(1)


def _np(t):
    return np.asarray(t._value) if hasattr(t, "_value") else np.asarray(t)


@pytest.mark.parametrize("offset", [0, 5, "per_slot"])
def test_rope_matches_reference(offset):
    rng = np.random.default_rng(0)
    B, S, H, D = 3, 4, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    jcos, jsin = jllama.precompute_rope(D, 32)
    tcos, tsin = tllama.precompute_rope(D, 32)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
    if offset == "per_slot":
        off = np.array([0, 7, 20], np.int32)
        joff, toff = jnp.asarray(off), torch.from_numpy(off)
    else:
        joff = toff = offset
    jq, jk = jllama.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin,
                               joff)
    tq, tk = tllama.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tcos,
                               tsin, toff)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    """bf16: float32 mean square, cast back to bf16, THEN the weight
    multiply in bf16 — results agree to one bf16 rounding step."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx = paddle.to_tensor(x).astype(dtype)
    jw = paddle.to_tensor(w).astype(dtype)
    ref = np.asarray(JF.rms_norm(jx, jw, 1e-5)._value).astype(np.float32)
    tdt = getattr(torch, dtype)
    out = TF.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                      1e-5)
    assert out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                                   atol=0)
        # the weight multiply happens after the cast: exact on the cast value
        normed = TF.rms_norm(torch.from_numpy(x).to(tdt), None, 1e-5)
        assert torch.equal(out, normed * torch.from_numpy(w).to(tdt))


def test_swiglu_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 8)).astype(np.float32)
    b = rng.standard_normal((3, 8)).astype(np.float32)
    ref = _np(JF.swiglu(paddle.to_tensor(a), paddle.to_tensor(b)))
    np.testing.assert_allclose(
        TF.swiglu(torch.from_numpy(a), torch.from_numpy(b)).numpy(), ref,
        atol=1e-6)
    ab = np.concatenate([a, b], axis=-1)
    np.testing.assert_allclose(TF.swiglu(torch.from_numpy(ab)).numpy(),
                               _np(JF.swiglu(paddle.to_tensor(ab))), atol=1e-6)


@pytest.mark.parametrize("case,flash", [
    ("causal_equal", True), ("full", True), ("causal_unequal", False),
    ("mask", False), ("dropout_eval", True)])
def test_sdpa_routing_and_values(case, flash, monkeypatch):
    """Flash takes only mask-free calls with dropout_p < 1 and, when
    causal, sq == sk; everything else takes the plain math. Values match
    the reference sdpa either way (GQA: 4 q heads over 2 kv heads)."""
    rng = np.random.default_rng(3)
    sq, sk = (3, 7) if case == "causal_unequal" else (6, 6)
    q = rng.standard_normal((2, sq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 8)).astype(np.float32)
    mask = None
    if case == "mask":
        mask = np.where(rng.random((2, 1, sq, sk)) < 0.3, -1e30,
                        0.0).astype(np.float32)
        mask[..., 0] = 0.0
    causal = case in ("causal_equal", "causal_unequal")
    kw = dict(dropout_p=0.5, training=False) if case == "dropout_eval" else {}
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal, **kw)
    assert bool(calls) == flash
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=None if mask is None else paddle.to_tensor(mask),
        is_causal=causal, **kw)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=0)


def test_sdpa_training_dropout_takes_plain_path(monkeypatch):
    """Training dropout takes the plain math where the reference's
    routing refuses flash: dropout_p >= 1, or a mask beside dropout."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1))
    x = torch.ones(1, 4, 2, 8)
    gen = torch.Generator().manual_seed(0)
    out = TF.scaled_dot_product_attention(x, x, x, dropout_p=1.0,
                                          is_causal=True, training=True,
                                          generator=gen)
    assert not calls and out.shape == x.shape and not out.any()
    out = TF.scaled_dot_product_attention(
        x, x, x, attn_mask=torch.zeros(1, 1, 4, 4), dropout_p=0.5,
        training=True, generator=gen)
    assert not calls and out.shape == x.shape


def test_sdpa_training_dropout_runs_in_flash():
    """0 < dropout_p < 1 goes to flash attention with an int32 seed drawn
    from the caller's generator: one generator state gives one mask, and
    the output is the plain forward's with that seed."""
    from paddle_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_fwd_plain
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    outs = [TF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.3, is_causal=True, training=True,
        generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    seed = int(torch.randint(-2 ** 31, 2 ** 31, (1,),
                             generator=torch.Generator().manual_seed(7)))
    ref, _ = flash_attention_fwd_plain(q, k, v, True, None, 0.3, seed)
    assert torch.equal(outs[0], ref)
    nodrop, _ = flash_attention_fwd_plain(q, k, v, True)
    assert not torch.equal(outs[0], nodrop)
