"""The port's ``TrainStep`` contract against paddle_tpu's (CPU): gradient
accumulation (``accumulate_steps``), a parameter the loss does not reach,
the optimizer slots built before the first step, the parameter order,
and the fused q/k/v and gate/up projections on bridged weights.

Tolerances: float32 losses atol 1e-4 and params atol 1e-5 at lr 1e-4 (as
``test_torch_train.py``: different summation orders, and Adam moves an
element whose grad is near zero by rounding noise); bf16 losses atol 2e-2
and float32 masters a mean |difference| of 2e-4 per tensor at lr 1e-3
(bf16 activations rounded at different places); logits atol 2e-4 as
``test_torch_llama.py``; the port against itself in float32 atol 1e-6 at
lr 1e-4 (a sum of K grads divided by K is their mean up to roundings)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.kernels.fused_adamw as jfused
from paddle_tpu.jit.api import TrainStep as JTrainStep
from paddle_tpu.jit.functional_call import collect_state
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops.kernels import fused_adamw as tfused
from paddle_tpu_torch.optimizer import AdamW, Optimizer

torch.set_num_threads(1)

GQA = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)


def _params_np(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def _pair(cfg_kw, seed=11):
    paddle.seed(seed)
    jm = JLlama(JConfig(**cfg_kw))
    if cfg_kw.get("dtype") == "bfloat16":
        jm = jm.bfloat16()
    tm = LlamaForCausalLM(LlamaConfig(**cfg_kw), device="cpu")
    load_reference_params(tm, _params_np(jm))
    jm.train()
    tm.train()
    return jm, tm


def _batches(n, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 96, size=(B, S))
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100
        out.append((ids, labels))
    return out


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)[0]


def _f32(x):
    return float(np.asarray(x.numpy(), np.float32))


@pytest.mark.parametrize("K,dtype", [(2, "float32"), (3, "float32"),
                                     (2, "bfloat16")])
def test_accumulation_matches_reference(K, dtype, monkeypatch):
    """Two accumulation cycles of K microbatches each: every call's loss,
    the step count, and the params (bf16: the float32 masters, updated by
    the fused AdamW on the float32 mean grad in both packages)."""
    ref_kernel, port_grads = [], []
    orig = jfused.fused_adamw_update

    def counted(p, g, *a, **k):
        ref_kernel.append(str(g.dtype))
        return orig(p, g, *a, **k)
    monkeypatch.setattr(jfused, "fused_adamw_update", counted)
    orig_port = tfused.fused_adamw_update

    def seen(p, g, *a, **k):
        port_grads.append(g.dtype)
        return orig_port(p, g, *a, **k)
    monkeypatch.setattr(tfused, "fused_adamw_update", seen)
    lr = 1e-4 if dtype == "float32" else 1e-3
    jm, tm = _pair(dict(GQA, dtype=dtype))
    jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=jm.parameters())
    topt = AdamW(learning_rate=lr, weight_decay=0.01,
                 parameters=tm.parameters())
    jstep = JTrainStep(jm, _loss_fn, jopt, accumulate_steps=K)
    tstep = TrainStep(tm, _loss_fn, topt, accumulate_steps=K)
    n0 = orig_port.launches
    jl, tl = [], []
    for ids, labels in _batches(2 * K):
        jl.append(_f32(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))))
        tl.append(float(tstep(torch.from_numpy(ids),
                              torch.from_numpy(labels))))
    assert jopt._step_count == topt._step_count == 2
    assert orig_port.launches == n0     # CPU: the plain version
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
        ref = _params_np(jm)
        for n, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-5,
                                       rtol=0, err_msg=n)
        return
    n_params = len(tstep.params)
    assert ref_kernel == ["float32"] * n_params      # one update trace
    assert port_grads == [torch.float32] * (2 * n_params)
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        got = topt._slots[id(p)]["master_weight"].numpy()
        want = np.asarray(jopt._slots[id(jp[n])]["master_weight"])
        assert np.abs(got - want).mean() <= 2e-4, n


def test_accumulation_equals_one_step_on_the_mean():
    """K microbatches accumulated equal one eager step on the mean of
    their K losses, and K identical microbatches one step on that batch
    (float32, lr 1e-4). Only the K-th call updates."""
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _batches(3)]

    def fresh():
        m = LlamaForCausalLM(LlamaConfig(**GQA), device="cpu", seed=5)
        m.train()
        return m, AdamW(learning_rate=1e-4, parameters=m.parameters())
    m1, o1 = fresh()
    s1 = TrainStep(m1, _loss_fn, o1, accumulate_steps=3)
    for i, b in enumerate(batches):
        s1(*b)
        assert o1._step_count == (1 if i == 2 else 0)
    m2, o2 = fresh()
    loss = sum(_loss_fn(m2, *b) for b in batches) / 3
    loss.backward()
    o2.step()
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)
    m3, o3 = fresh()
    s3 = TrainStep(m3, _loss_fn, o3, accumulate_steps=3)
    for _ in range(3):
        s3(*batches[0])
    m4, o4 = fresh()
    TrainStep(m4, _loss_fn, o4)(*batches[0])
    for a, b in zip(m3.parameters(), m4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("form", ["keyword", "position",
                                  "accumulate_by_position"])
def test_c6_donate_is_accepted_and_keeps_the_step(form):
    """``donate`` is the reference's fourth argument, before
    ``accumulate_steps``: given by keyword or by position (and
    ``accumulate_steps`` by position after it) it is stored and changes no
    loss and no parameter against a step built without it (float32, the
    same seed, so the same bits)."""
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _batches(4)]

    def fresh():
        m = LlamaForCausalLM(LlamaConfig(**GQA), device="cpu", seed=5)
        m.train()
        return m, AdamW(learning_rate=1e-4, parameters=m.parameters())

    m1, o1 = fresh()
    m2, o2 = fresh()
    if form == "keyword":
        s1 = TrainStep(m1, _loss_fn, o1, donate=True)
        s2 = TrainStep(m2, _loss_fn, o2)
        assert s1.donate is True and s1.accumulate_steps == 1
    elif form == "position":
        s1 = TrainStep(m1, _loss_fn, o1, False)
        s2 = TrainStep(m2, _loss_fn, o2)
        assert s1.donate is False and s1.accumulate_steps == 1
    else:
        s1 = TrainStep(m1, _loss_fn, o1, False, 2)
        s2 = TrainStep(m2, _loss_fn, o2, accumulate_steps=2)
        assert s1.donate is False and s1.accumulate_steps == 2
    assert s2.donate is True
    for b in batches:
        np.testing.assert_array_equal(s1(*b).numpy(), s2(*b).numpy())
    assert o1._step_count == o2._step_count > 0
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=n)


class _TwoHeads(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.used = paddle.nn.Linear(8, 4)
        self.unused = paddle.nn.Linear(8, 4)

    def forward(self, x):
        return self.used(x)


class _TTwoHeads(torch.nn.Module):
    def __init__(self):
        super().__init__()
        kw = dict(device="cpu", generator=torch.Generator().manual_seed(0))
        self.used = Linear(8, 4, **kw)
        self.unused = Linear(8, 4, **kw)

    def forward(self, x):
        return self.used(x)


def _sq_loss(m, x):
    return (m(x) ** 2).mean()


def test_unreached_parameter_moves_as_the_reference_moves_it():
    """C1: a parameter the loss does not reach gets a zero grad, so AdamW
    decays it and keeps its moments, as the reference's ``TrainStep``
    (``jax.value_and_grad`` gives it a zero grad); ``missing_grads`` still
    names it."""
    paddle.seed(3)
    jm = _TwoHeads()
    tm = _TTwoHeads()
    load_reference_params(tm, _params_np(jm))
    jstep = JTrainStep(jm, _sq_loss, paddle.optimizer.AdamW(
        learning_rate=0.1, weight_decay=0.1, parameters=jm.parameters()))
    tstep = TrainStep(tm, _sq_loss, AdamW(
        learning_rate=0.1, weight_decay=0.1, parameters=tm.parameters()))
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    before = tm.unused.weight.detach().clone()
    for _ in range(3):
        jstep(paddle.to_tensor(x))
        tstep(torch.from_numpy(x))
    assert tstep.missing_grads == ["unused.weight", "unused.bias"]
    assert not torch.equal(tm.unused.weight.detach(), before)
    ref = _params_np(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-6,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("multi_precision", [True, False])
def test_slots_exist_before_the_first_step(multi_precision):
    """``TrainStep.__init__`` builds every slot, as the reference's does:
    the two state dicts name the same slots, with the same dtypes, before
    any step."""
    jm, tm = _pair(dict(GQA, dtype="bfloat16"))
    jopt = paddle.optimizer.AdamW(parameters=jm.parameters(),
                                  multi_precision=multi_precision)
    topt = AdamW(parameters=tm.parameters(), multi_precision=multi_precision)
    assert topt.state_dict() == {"_step_count": 0}
    JTrainStep(jm, _loss_fn, jopt)
    TrainStep(tm, _loss_fn, topt)
    js, ts = jopt.state_dict(), topt.state_dict()
    assert sorted(js) == sorted(ts)
    for k in js:
        if k != "_step_count":
            assert str(ts[k].dtype).split(".")[-1] == \
                str(js[k]._value.dtype), k
    expect = 3 if multi_precision else 2
    assert len(ts) == 1 + expect * len(list(tm.parameters()))


@pytest.mark.parametrize("fused", [False, True])
def test_parameter_order_is_the_reference_order(fused):
    """The list ``TrainStep`` updates, whose indices seed the stochastic
    rounding, names the reference ``TrainStep``'s parameters in its
    order."""
    kw = dict(GQA, fuse_attention_qkv=fused, fuse_swiglu=fused)
    jm, tm = _pair(kw)
    names, params, _, _ = collect_state(jm)
    jnames = [n for n, p in zip(names, params) if not p.stop_gradient]
    tstep = TrainStep(tm, _loss_fn, AdamW(parameters=tm.parameters()))
    assert tstep.names == jnames
    assert len(JTrainStep(jm, _loss_fn, paddle.optimizer.AdamW(
        parameters=jm.parameters())).params) == len(tstep.params)


def test_fused_projections_match_reference():
    """``fuse_attention_qkv`` and ``fuse_swiglu`` on weights bridged from
    the reference's fused model (its ``qkv_proj`` and ``gate_up_proj`` by
    name): the logits, then three AdamW ``TrainStep``s."""
    kw = dict(GQA, fuse_attention_qkv=True, fuse_swiglu=True)
    jm, tm = _pair(kw)
    names = [n for n, _ in tm.named_parameters()]
    assert "llama.layers.0.self_attn.qkv_proj.weight" in names
    assert "llama.layers.0.mlp.gate_up_proj.weight" in names
    assert not any(n.endswith(("q_proj.weight", "gate_proj.weight"))
                   for n in names)
    ids, labels = _batches(1)[0]
    jm.eval()
    tm.eval()
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    jm.train()
    tm.train()
    jstep = JTrainStep(jm, _loss_fn, paddle.optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01, parameters=jm.parameters()))
    tstep = TrainStep(tm, _loss_fn, AdamW(
        learning_rate=1e-4, weight_decay=0.01, parameters=tm.parameters()))
    chain0 = Optimizer.chain_updates
    for _ in range(3):
        jl = _f32(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)))
        tl = float(tstep(torch.from_numpy(ids), torch.from_numpy(labels)))
        assert abs(tl - jl) < 1e-4
    assert Optimizer.chain_updates - chain0 == 3 * len(tstep.params)
    ref = _params_np(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-5,
                                   rtol=0, err_msg=n)
