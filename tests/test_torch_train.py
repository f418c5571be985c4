"""The port's Llama training step against paddle_tpu's on bridged weights
(CPU): attention's backward, the fused cross entropy, ``TrainStep`` with
AdamW over float32 params (the plain chain in both packages) and bf16
params with master weights (the fused AdamW update in both), the optimizer
state bridge, and the refusals.

Tolerances: float32 losses atol 1e-4 and params atol 1e-5 after five
steps at lr 1e-4 (both sides compute in float32 with different summation
orders; Adam scales each element's step to about lr whatever its grad's
size, so an element whose grad is near zero moves by rounding noise, and
lr 1e-4 keeps five such steps inside 1e-5); bf16 losses atol 2e-2 and
float32 masters a mean |difference| of 2e-4 per tensor at lr 1e-3 (bf16
activations, rounded at different places by the two frameworks)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core import random as jrandom
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.jit.api import TrainStep as JTrainStep
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.ops.kernels.fused_ce import fused_softmax_ce as jax_ce

import paddle_tpu_torch.ops.kernels.flash_attention as tflash
from paddle_tpu_torch.bridge import (load_reference_optimizer_state,
                                     load_reference_params)
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.attention import _sdpa_reference
from paddle_tpu_torch.ops.kernels.fused_adamw import fused_adamw_update
from paddle_tpu_torch.ops.kernels.fused_ce import fused_softmax_ce
from paddle_tpu_torch.optimizer import AdamW, Optimizer

torch.set_num_threads(1)

GQA = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)
CONFIGS = {"tiny": LlamaConfig.tiny().__dict__, "gqa": GQA}


def _params_np(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def _pair(cfg_kw, seed=11):
    """The reference model and the port's with its weights. The reference's
    params stay float32 whatever ``dtype`` says; a bf16 run casts them, as
    its bench does (``LlamaForCausalLM(cfg).bfloat16()``)."""
    paddle.seed(seed)
    jm = JLlama(JConfig(**cfg_kw))
    if cfg_kw.get("dtype") == "bfloat16":
        jm = jm.bfloat16()
    tm = LlamaForCausalLM(LlamaConfig(**cfg_kw), device="cpu")
    load_reference_params(tm, _params_np(jm))
    jm.train()
    tm.train()
    return jm, tm


def _batch(vocab, B=2, S=32, seed=0):
    ids = np.random.default_rng(seed).integers(0, vocab, size=(B, S))
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return ids, labels


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)[0]


def _as_f32(x):
    return np.asarray(x.numpy(), dtype=np.float32) if hasattr(x, "numpy") \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("causal,Hkv", [(True, 4), (True, 2), (False, 2)])
def test_training_attention_runs_the_port_backward(monkeypatch, causal, Hkv):
    """Training-mode attention goes through FlashAttention: its backward
    calls the port's plain flash backward on the CPU, and the grads equal
    autograd through the plain ``_sdpa_reference`` math."""
    calls = []
    plain = tflash.flash_attention_bwd_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(tflash, "flash_attention_bwd_plain", counted)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, h, 16))
                                .astype(np.float32)).requires_grad_()
               for h in (4, Hkv, Hkv))
    g = torch.from_numpy(rng.standard_normal((2, 24, 4, 16))
                         .astype(np.float32))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                         training=True)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert len(calls) == 1
    ref = _sdpa_reference(q, k, v, None, causal)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5, rtol=0)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_every_llama_param_gets_a_grad():
    _, tm = _pair(dict(GQA))
    ids, labels = _batch(96)
    loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    missing = [n for n, p in tm.named_parameters() if p.grad is None]
    assert not missing, missing


def test_fused_ce_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((12, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=12)
    labels[[2, 7]] = -100
    g = rng.standard_normal(12).astype(np.float32)
    import jax
    ref, vjp = jax.vjp(lambda x: jax_ce(x, jnp.asarray(labels), -100),
                       jnp.asarray(logits))
    (ref_grad,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).requires_grad_()
    loss = fused_softmax_ce(x, torch.from_numpy(labels), -100)
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               atol=1e-6, rtol=0)
    assert not x.grad[[2, 7]].any()


@pytest.mark.parametrize("kw", [
    {}, {"label_smoothing": 0.1}, {"reduction": "sum"}, {"reduction": "none"},
    {"weight": True}, {"soft_label": True}])
def test_cross_entropy_matches_reference(kw):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=(3, 5))
    labels[1, 2] = -100
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("weight", None):
        w = rng.random(7).astype(np.float32)
        jkw["weight"], tkw["weight"] = paddle.to_tensor(w), torch.from_numpy(w)
    if kw.get("soft_label"):
        labels = rng.random((3, 5, 7)).astype(np.float32)
    ref = paddle.nn.functional.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels), **jkw)
    out = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          **tkw)
    np.testing.assert_allclose(out.numpy(), _as_f32(ref), atol=1e-5, rtol=0)


def _run_pair(cfg_kw, dtype, steps=5, weight_decay=0.01, decay_fun=None):
    """Both TrainSteps on one batch. With ``decay_fun``, both optimizers
    take it and each parameter its structured name (the reference's as
    ``p.name``, the port's from ``named_parameters()``)."""
    kw = dict(cfg_kw, dtype=dtype)
    lr = 1e-4 if dtype == "float32" else 1e-3
    jm, tm = _pair(kw)
    tparams = tm.parameters()
    if decay_fun is not None:
        for n, p in jm.named_parameters():
            p.name = n
        tparams = tm.named_parameters()
    jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=weight_decay,
                                  parameters=jm.parameters(),
                                  multi_precision=True,
                                  apply_decay_param_fun=decay_fun)
    topt = AdamW(learning_rate=lr, weight_decay=weight_decay,
                 parameters=tparams, multi_precision=True,
                 apply_decay_param_fun=decay_fun)
    jstep = JTrainStep(jm, _loss_fn, jopt)
    tstep = TrainStep(tm, _loss_fn, topt)
    ids, labels = _batch(kw["vocab_size"])
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(_as_f32(jstep(paddle.to_tensor(ids),
                                      paddle.to_tensor(labels)))))
        tl.append(float(tstep(torch.from_numpy(ids),
                              torch.from_numpy(labels))))
        assert not tstep.missing_grads
    return jm, tm, np.array(jl), np.array(tl), jopt, topt


@pytest.mark.parametrize("name", ["tiny", "gqa"])
def test_train_step_fp32_matches_reference(name):
    """float32 params: both packages take the AdamW chain."""
    n0, k0 = Optimizer.chain_updates, fused_adamw_update.launches
    jm, tm, jl, tl, _, _ = _run_pair(CONFIGS[name], "float32")
    n_params = len(list(tm.parameters()))
    assert Optimizer.chain_updates - n0 == 5 * n_params
    assert fused_adamw_update.launches == k0
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]
    ref = _params_np(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def test_train_step_decay_mask_matches_reference():
    """AdamW with ``apply_decay_param_fun`` excluding the norms by name:
    the port's params follow the reference's through five float32 steps.
    At weight decay 0.5 a norm weight (1.0) that took the decay would move
    by lr * 0.5 per step, 2.5e-4 over five, 25x the tolerance."""
    def no_norm(name):
        return "norm" not in name
    jm, tm, jl, tl, _, _ = _run_pair(CONFIGS["tiny"], "float32",
                                     weight_decay=0.5, decay_fun=no_norm)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    ref = _params_np(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-5,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["tiny", "gqa"])
def test_train_step_bf16_multi_precision_matches_reference(name, monkeypatch):
    """bf16 params with float32 masters: both packages take the fused
    update (the reference's Pallas kernel in interpret mode, the port's
    plain version of its CUDA kernel) for every param, none the chain; the
    norms are kept out of the decay by name. After five steps each float32
    master is within a mean |difference| of 2e-4 of the reference's: the
    measured gap is at most 8.5e-5 (the two frameworks' bf16 grads differ,
    and Adam moves an element whose grad is near zero by about lr whichever
    its sign), while decaying the norms as well gives 5e-4 and a bias
    correction stuck at step 1 gives 1.9e-3."""
    import paddle_tpu.ops.kernels.fused_adamw as jfused
    ref_kernel = []
    orig = jfused.fused_adamw_update

    def counted(*a, **k):
        out = orig(*a, **k)
        ref_kernel.append(out is not None)
        return out
    monkeypatch.setattr(jfused, "fused_adamw_update", counted)
    n0 = Optimizer.chain_updates
    jm, tm, jl, tl, jopt, topt = _run_pair(
        CONFIGS[name], "bfloat16", weight_decay=0.1,
        decay_fun=lambda n: "norm" not in n)
    assert Optimizer.chain_updates == n0
    n_params = len(list(tm.parameters()))
    assert len(ref_kernel) == n_params and all(ref_kernel)
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    assert tl[-1] < tl[0]
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        got = topt._slots[id(p)]["master_weight"].numpy()
        want = np.asarray(jopt._slots[id(jp[n])]["master_weight"])
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).mean() <= 2e-4, n


def test_optimizer_state_bridge_continues_the_reference_run():
    """Three reference steps, then the reference's params and optimizer
    state carried into the port: the next step matches the reference's."""
    kw = dict(GQA)
    jm, tm = _pair(kw)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=jm.parameters())
    jstep = JTrainStep(jm, _loss_fn, jopt)
    ids, labels = _batch(kw["vocab_size"], seed=1)
    for _ in range(3):
        jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))
    state = {k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
             for k, v in jopt.state_dict().items()}
    load_reference_params(tm, _params_np(jm))
    topt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                 parameters=tm.parameters())
    load_reference_optimizer_state(topt, tm, state)
    assert topt._step_count == 3
    tstep = TrainStep(tm, _loss_fn, topt)
    jl = float(_as_f32(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))))
    tl = float(tstep(torch.from_numpy(ids), torch.from_numpy(labels)))
    assert abs(tl - jl) < 1e-4
    ref = _params_np(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-5,
                                   rtol=0, err_msg=n)
    bad = dict(state)
    bad["no_such.moment1"] = next(v for k, v in state.items()
                                  if k.endswith("moment1"))
    with pytest.raises(KeyError, match="no_such"):
        load_reference_optimizer_state(topt, tm, bad)


def test_refusals():
    """Forms this port once refused and now serves. Quantized KV pools
    (kernel B4, refused before slice 5): an int8 engine builds and a
    layer attends through a quantized paged cache. Sampling (A7, refused
    before it was ported): ``generate`` with ``temperature > 0`` and a
    sampled request on an int8 pool are token for token the reference's
    on bridged float32 weights."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import PagedKVCache
    tm = LlamaForCausalLM(LlamaConfig(**dict(GQA, dtype="bfloat16")),
                          device="cpu")
    tm.eval()
    ids, _ = _batch(96, B=1, S=8)
    qeng = LLMEngine(tm, cache_impl="paged", kv_cache_dtype="int8",
                     device="cpu")
    assert qeng._k[0].dtype == torch.int8
    pool = torch.zeros(4, 2, 64, 16, dtype=torch.int8)
    scales = torch.zeros(4, 2, dtype=torch.float32)
    cache = PagedKVCache(pool, pool.clone(),
                         torch.tensor([[0, -1]], dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), None,
                         scales, scales.clone(), quant="int8")
    with torch.no_grad():
        out, cache2 = tm.llama.layers[0].self_attn(
            torch.ones(1, 1, 64, dtype=torch.bfloat16),
            (tm.llama.rope_cos, tm.llama.rope_sin), kv_cache=cache,
            position_offset=cache.seq_lens)
    assert out.shape == (1, 1, 64) and bool(torch.isfinite(out).all())
    assert cache2.quant == "int8" and int(cache2.seq_lens[0]) == 1
    assert cache.k[0].any() and cache.k_scale[0].all()   # written in place
    assert tm.generate(torch.from_numpy(ids), max_new_tokens=2).shape \
        == (1, 2)
    jm, fm = _pair(GQA)
    jm.eval()
    fm.eval()
    jrandom.default_generator.set_state((6, 0))
    trandom.default_generator.set_state((6, 0))
    np.testing.assert_array_equal(
        fm.generate(torch.from_numpy(ids), max_new_tokens=4,
                    temperature=0.7).numpy(),
        np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=4,
                               temperature=0.7).numpy()))
    kw = dict(cache_impl="paged", kv_cache_dtype="int8", max_seq_len=64,
              block_size=16, chunk_size=16, sampling_seed=5)
    outs = [e.generate([ids[0]], max_new_tokens=4, temperature=0.7)
            for e in (LLMEngine(fm, device="cpu", **kw), JEngine(jm, **kw))]
    assert list(outs[0][0].token_ids) == list(outs[1][0].token_ids)
