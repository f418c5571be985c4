"""Stochastic-rounding AdamW (kernel B7) and the float32-grad form of the
fused AdamW update (B6) against paddle_tpu's (CPU): the rounding hash and
the per-(step, param) seed bit for bit, the plain versions against the
reference's Pallas kernels in interpret mode, the rounding's
unbiasedness, and the optimizer's routing under a ``TrainStep``.

Tolerances: float32 moments and masters within 1e-6 of each tensor's
largest magnitude (the same float32 operations in the same order, but XLA
contracts ``b1*m + (1-b1)*g`` into a fused multiply-add); the bf16
moments and the stochastically rounded param bit-identical wherever the
two float32 results agree, and where they differ the param within one
bf16 ulp and the moments within one bf16 ulp (rtol 2**-7) of float32
values that meet the 1e-6 tolerance; ``TrainStep``
losses atol 2e-2 (bf16 activations, rounded at different places by the
two frameworks)."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import paddle_tpu as paddle
import paddle_tpu.core.flags as jflags
import paddle_tpu.ops.kernels.fused_adamw as jfused
from paddle_tpu.jit.api import TrainStep as JTrainStep
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import fused_adamw as tfused
from paddle_tpu_torch.ops.kernels.flash_attention import position_hash
from paddle_tpu_torch.optimizer import AdamW, Optimizer

torch.set_num_threads(1)

M32 = 0xFFFFFFFF


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """A bf16 tensor's or array's 16-bit patterns as int32."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    return np.asarray(t).view(np.int16).astype(np.int32) & 0xFFFF


def _seed_f(seed):
    """The reference's float32 carrier of an int32 seed's bits."""
    s = np.array([[seed & M32]], np.uint32).view(np.int32)
    return jax.lax.bitcast_convert_type(jnp.asarray(s), jnp.float32)


def _ref_round(x, seed, idx):
    out = jfused._sr_round_bf16(jnp.asarray(x), jnp.int32(
        np.array(seed & M32, np.uint32).view(np.int32)), jnp.asarray(idx))
    return _bits(np.asarray(out))


@pytest.mark.parametrize("seed", [0, 1, 0x5BD1E995, 0x9E3779B9, M32])
def test_sr_rounding_matches_reference_bit_for_bit(seed):
    """``sr_round_bf16`` over a flat tensor against the reference's
    ``_sr_round_bf16`` with the same flat indices; then the rounding at
    indices up to ``lm_head``'s 131,072,000 elements (4096 x 32000), where
    the index times the hash constant leaves 32 bits far behind."""
    rng = np.random.default_rng(seed & 0xFFFF)
    x = np.concatenate([rng.standard_normal(3000).astype(np.float32),
                        np.float32([0.0, -0.0, 1e-30, -1e-30, 3.0e38,
                                    -3.0e38])])
    idx = np.arange(x.size, dtype=np.int32)
    got = _bits(tfused.sr_round_bf16(torch.from_numpy(x), seed))
    np.testing.assert_array_equal(got, _ref_round(x, seed, idx))
    big = np.concatenate([np.arange(131_072_000 - 2048, 131_072_000),
                          rng.integers(0, 131_072_000, 2048)])
    xb = rng.standard_normal(big.size).astype(np.float32)
    bits = torch.from_numpy(xb).view(torch.int32).long() & M32
    r16 = position_hash(torch.from_numpy(big), seed) & 0xFFFF
    mine = (((bits + r16) & M32) >> 16).numpy().astype(np.int32)
    np.testing.assert_array_equal(mine, _ref_round(xb, seed,
                                                   big.astype(np.int32)))


def test_sr_seed_matches_reference():
    """The port's seed against the int32 the reference's ``_apply_fused``
    hands its kernel (captured), over a grid of steps and param ids that
    includes int32 wraparound."""
    captured = []

    def capture(p, g, m, v, lr, step, seed_f, **kw):
        captured.append(int(np.asarray(jax.lax.bitcast_convert_type(
            seed_f, jnp.int32)).ravel()[0]) & M32)
        return p, m, v
    jflags.set_flags({"adamw_stochastic_rounding": True})
    orig = jfused.fused_adamw_sr_update
    jfused.fused_adamw_sr_update = capture
    try:
        w = paddle.create_parameter([8, 16], "bfloat16")
        opt = paddle.optimizer.AdamW(parameters=[w], multi_precision=False)
        z = jnp.zeros((8, 16), jnp.bfloat16)
        grid = [(s, i) for s in (1, 2, 7, 1000, 2 ** 31 - 1)
                for i in (0, 1, 5, 290, 12345, 2 ** 20 + 3)]
        for s, i in grid:
            opt._apply_fused(z, z, {"moment1": z, "moment2": z},
                             jnp.float32(1e-3), jnp.int32(s), True,
                             param_id=i)
    finally:
        jfused.fused_adamw_sr_update = orig
        jflags.set_flags({"adamw_stochastic_rounding": False})
    assert captured == [tfused.sr_seed(s, i) for s, i in grid]


def _sr_state(rng, shape, step, g_dtype):
    p = (rng.standard_normal(shape) * 0.05).astype(ml_dtypes.bfloat16)
    g = (rng.standard_normal(shape) * 1e-2).astype(g_dtype)
    m = ((rng.standard_normal(shape) * 1e-3) * (step > 1)) \
        .astype(ml_dtypes.bfloat16)
    v = ((rng.random(shape) * 1e-5) * (step > 1)).astype(ml_dtypes.bfloat16)
    return p, g, m, v


@pytest.mark.parametrize("g_dtype", [ml_dtypes.bfloat16, np.float32],
                         ids=["g_bf16", "g_f32"])
@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("shape,step", [((4096,), 1), ((64, 256), 7)])
def test_sr_update_plain_matches_pallas(g_dtype, decay, shape, step):
    """B7's plain version against the reference's ``fused_adamw_sr_update``
    (interpret mode). The float32 ``new_p`` of each side comes from its
    master-weight update on ``float(p)`` (the same arithmetic); where the
    two agree the stochastically rounded params are the same bits, and
    elsewhere at most one bf16 ulp apart."""
    rng = np.random.default_rng(step + 2 * decay)
    p, g, m, v = _sr_state(rng, shape, step, g_dtype)
    lr, seed = 3e-3, tfused.sr_seed(step, 17)
    kw = dict(weight_decay=0.01, apply_decay=decay)
    ref = jfused.fused_adamw_sr_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(lr, jnp.float32), jnp.asarray(step, jnp.int32),
        _seed_f(seed), **kw)
    assert ref is not None
    rp, rm, rv = ref
    tp, tg, tm, tv = (_t(x) for x in (p, g, m, v))
    n0 = tfused.fused_adamw_sr_update.launches
    tfused.fused_adamw_sr_update(tp, tg, tm, tv, lr, step, seed, **kw)
    assert tfused.fused_adamw_sr_update.launches == n0   # CPU: plain
    # each side's float32 m, v and new_p: its master-weight update on the
    # upcast bf16 state, the same arithmetic as its SR kernel
    p32, m32, v32 = (np.asarray(x).astype(np.float32) for x in (p, m, v))
    ref32 = [np.asarray(x) for x in jfused.fused_adamw_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m32), jnp.asarray(v32),
        jnp.asarray(p32), jnp.asarray(lr, jnp.float32),
        jnp.asarray(step, jnp.int32), **kw)[1:]]
    mine32 = [torch.from_numpy(x.copy()) for x in (m32, v32, p32)]
    tfused.fused_adamw_update_plain(_t(p), _t(g), *mine32, lr, step, **kw)
    for got32, want32, got, want in zip(mine32, ref32, (tm, tv, tp),
                                        (rm, rv, rp)):
        got32 = got32.numpy()
        np.testing.assert_allclose(got32, want32, rtol=0,
                                   atol=1e-6 * np.abs(want32).max())
        same = got32 == want32
        assert same.mean() > 0.5
        a, b = _bits(got), _bits(np.asarray(want))
        np.testing.assert_array_equal(a[same], b[same])
        # elsewhere: one bf16 rounding of values that agree in float32
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want).astype(np.float32),
            rtol=2.0 ** -7, atol=1e-6 * np.abs(want32).max())
    a, b = _bits(tp), _bits(np.asarray(rp))
    assert np.abs(a - b).max() <= 1
    assert (a != _bits(p)).any()


def test_sr_rounding_is_unbiased():
    """Over 4096 seeds each of 64 values between two bf16 neighbours keeps
    its mean within 0.05 ulp of itself (the mean's standard error is at
    most 0.008 ulp), and one seed over 65,536 copies of one value too (the
    reference's own check, ``test_fused_adamw_accum.py:231-251``)."""
    rng = np.random.default_rng(9)
    lo = (rng.standard_normal(64) * 0.1).astype(ml_dtypes.bfloat16) \
        .astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.abs(lo))) - 7).astype(np.float32)
    x = (lo + np.sign(lo) * ulp * rng.uniform(0.05, 0.95, 64)) \
        .astype(np.float32)
    xt = torch.from_numpy(x)
    total = torch.zeros(64, dtype=torch.float64)
    for seed in range(4096):
        total += tfused.sr_round_bf16(xt, tfused.sr_seed(seed, 3)).double()
    mean = (total / 4096).numpy()
    assert (np.abs(mean - x) < 0.05 * ulp).all()
    one = torch.full((65536,), 0.0103, dtype=torch.float32)
    out = tfused.sr_round_bf16(one, 12345).float().numpy()
    uniq = np.unique(out)
    assert len(uniq) == 2
    assert abs(out.mean() - np.float32(0.0103)) < 0.05 * (uniq[1] - uniq[0])


@pytest.mark.parametrize("step", [1, 7])
def test_fused_adamw_f32_grad_plain_matches_pallas(step):
    """B6 with a float32 grad (an accumulated mean), plain against the
    reference's Pallas kernel, which upcasts whatever grad it reads."""
    rng = np.random.default_rng(40 + step)
    shape = (64, 256)
    mw = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    m = (rng.standard_normal(shape) * 1e-3).astype(np.float32) * (step > 1)
    v = (rng.random(shape) * 1e-5).astype(np.float32) * (step > 1)
    p = mw.astype(ml_dtypes.bfloat16)
    ref = jfused.fused_adamw_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(mw), jnp.asarray(3e-4, jnp.float32),
        jnp.asarray(step, jnp.int32), weight_decay=0.01)
    tp, tg, tm, tv, tmw = (_t(x) for x in (p, g, m, v, mw))
    tfused.fused_adamw_update(tp, tg, tm, tv, tmw, 3e-4, step,
                              weight_decay=0.01)
    for got, want in zip((tm, tv, tmw), ref[1:]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    assert np.abs(_bits(tp) - _bits(np.asarray(ref[0]))).max() <= 1


def test_tile_plan_is_the_reference_rule():
    """The port's copy of ``_tile_plan`` over the shapes of Llama-2-7B and
    the bench line, and some awkward ones: the same plan or the same
    refusal (``lm_head`` and a fused ``gate_up`` at 7B widths)."""
    shapes = [(4096, 32000), (32000, 4096), (4096, 4096), (4096, 11008),
              (11008, 4096), (4096, 22016), (4096, 12288), (4096, 11264),
              (11264, 4096), (4096,), (1000,), (7, 3), (5, 40, 6), (96, 64),
              (64, 16384), (131072 * 3,)]
    for s in shapes:
        assert tfused.tile_plan(s) == jfused._tile_plan(s), s
    assert tfused.tile_plan((4096, 32000)) is None
    assert tfused.tile_plan((4096, 22016)) is None


SR_CFG = dict(vocab_size=16384, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              dtype="bfloat16")


def test_train_step_sr_routes_as_reference(monkeypatch):
    """``adamw_stochastic_rounding`` with bf16 moments and no masters
    (the bench's ``BENCH_OPT=adamw_sr``), three ``TrainStep``s of a bf16
    Llama whose ``lm_head [64, 16384]`` the reference does not tile: the
    reference's SR kernel takes every other parameter each step, the port
    sends exactly those to B7 (the plain version here) with the
    reference's seeds, and ``lm_head`` to the chain with the reference's
    warning. Losses agree within 2e-2."""
    import paddle_tpu.core.flags as jf
    ref_calls, port_calls = [], []
    orig_ref = jfused.fused_adamw_sr_update

    def ref_counted(p, *a, **k):
        out = orig_ref(p, *a, **k)
        ref_calls.append((tuple(p.shape), out is not None))
        return out
    monkeypatch.setattr(jfused, "fused_adamw_sr_update", ref_counted)
    orig_port = tfused.fused_adamw_sr_update

    def port_counted(p, g, m, v, lr, step, seed, **k):
        port_calls.append((tuple(p.shape), step, seed))
        return orig_port(p, g, m, v, lr, step, seed, **k)
    monkeypatch.setattr(tfused, "fused_adamw_sr_update", port_counted)
    flags = {"adamw_stochastic_rounding": True, "adamw_bf16_moments": True}
    jf.set_flags(flags)
    tflags.set_flags(flags)
    try:
        paddle.seed(11)
        jm = JLlama(JConfig(**SR_CFG)).bfloat16()
        tm = LlamaForCausalLM(LlamaConfig(**SR_CFG), device="cpu")
        load_reference_params(tm, {n: np.asarray(p.numpy()) for n, p in
                                   jm.named_parameters()})
        jm.train()
        tm.train()
        jstep = JTrainStep(jm, _loss_fn, paddle.optimizer.AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=jm.parameters(), multi_precision=False))
        topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                     parameters=tm.parameters(), multi_precision=False)
        tstep = TrainStep(tm, _loss_fn, topt)
        ids = np.random.default_rng(0).integers(0, 16384, size=(2, 16))
        labels = np.roll(ids, -1, axis=1)
        n_params = len(tstep.params)
        chain0 = Optimizer.chain_updates
        jl, tl = [], []
        for _ in range(3):
            jl.append(float(np.asarray(jstep(paddle.to_tensor(ids),
                                             paddle.to_tensor(labels))
                                       .numpy(), np.float32)))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tl.append(float(tstep(torch.from_numpy(ids),
                                      torch.from_numpy(labels))))
            assert [str(w.message) for w in caught
                    if w.category is RuntimeWarning] == [
                "adamw_stochastic_rounding: shape not tileable for the SR "
                "kernel — falling back to DETERMINISTIC bf16 rounding for "
                "this parameter (small updates may stall)"]
    finally:
        off = {k: False for k in flags}
        jf.set_flags(off)
        tflags.set_flags(off)
    head = tstep.names.index("lm_head.weight")
    # the reference's kernel runs at trace time: its first trace offers it
    # every parameter in TrainStep order and all but lm_head tile
    assert [s for s, _ in ref_calls[:n_params]] == \
        [tuple(p.shape) for p in tstep.params]
    assert [ok for _, ok in ref_calls[:n_params]] == \
        [i != head for i in range(n_params)]
    assert Optimizer.chain_updates - chain0 == 3
    expect = [(tuple(p.shape), s, tfused.sr_seed(s, i))
              for s in (1, 2, 3) for i, p in enumerate(tstep.params)
              if i != head]
    assert port_calls == expect
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    assert tl[-1] < tl[0]


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)[0]
