"""Activation recompute in the port (CPU): ``recompute`` under every
policy gives the loss and grads of the plain forward, bit for bit (the
replay runs the same operations on the same inputs); the Llama
``TrainStep`` with ``use_recompute`` against the reference's; what each
policy keeps (saved-tensor hooks and the operations the backward
replays); a dropout seed inside a segment repeats on replay; and
``recompute_sequential``.

Tolerances: against the reference, float32 losses atol 1e-4 and params
atol 1e-5 after five steps at lr 1e-4, as ``test_torch_train.py`` holds
the step without recompute (different summation orders; Adam moves an
element whose grad is near zero by rounding noise)."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.jit.api import TrainStep as JTrainStep
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core.random import draw_seed, provide_seed
from paddle_tpu_torch.distributed.fleet import (POLICIES, recompute,
                                                recompute_sequential)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

GQA = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)


def _model(seed=3, **over):
    m = LlamaForCausalLM(LlamaConfig(**dict(GQA, **over)), device="cpu",
                         seed=seed)
    m.train()
    return m


def _batch(B=2, S=24, seed=0):
    ids = np.random.default_rng(seed).integers(0, 96, size=(B, S))
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return torch.from_numpy(ids), torch.from_numpy(labels)


def _loss_and_grads(model):
    ids, labels = _batch()
    loss, _ = model(ids, labels=labels)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.parametrize("policy", list(POLICIES))
def test_recompute_is_exact_for_every_policy(policy):
    """Loss and every grad bit-identical with recompute off and on."""
    plain = _model()
    remat = _model(use_recompute=True, recompute_policy=policy)
    l0, g0 = _loss_and_grads(plain)
    l1, g1 = _loss_and_grads(remat)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)[0]


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_recompute_train_step_matches_reference(policy):
    """Five AdamW ``TrainStep``s with ``use_recompute`` in both packages on
    bridged float32 weights."""
    kw = dict(GQA, use_recompute=True, recompute_policy=policy)
    paddle.seed(11)
    jm = JLlama(JConfig(**kw))
    tm = _model(**{k: v for k, v in kw.items() if k not in GQA})
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    jm.train()
    jstep = JTrainStep(jm, _loss_fn, paddle.optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01, parameters=jm.parameters()))
    tstep = TrainStep(tm, _loss_fn, AdamW(
        learning_rate=1e-4, weight_decay=0.01, parameters=tm.parameters()))
    ids, labels = _batch()
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(np.asarray(jstep(paddle.to_tensor(ids.numpy()),
                                         paddle.to_tensor(labels.numpy()))
                                   .numpy())))
        tl.append(float(tstep(ids, labels)))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]
    ref = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def _saved_outside_segments(model):
    """How many tensors, and how many bytes, the autograd graph saves
    outside any recompute segment (a segment's own hooks take what is
    saved inside it)."""
    count = [0, 0]

    def pack(t):
        count[0] += 1
        count[1] += t.numel() * t.element_size()
        return t
    ids, labels = _batch()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model(ids, labels=labels)
    loss.backward()
    return tuple(count)


def test_full_recompute_keeps_only_layer_inputs():
    """Under ``"full"`` the graph saves what a model with no decoder
    layers saves, plus each layer's input ``[2, 24, 64]`` float32 (the
    checkpoint keeps it for the replay) and nothing else from the layers;
    without recompute it saves far more."""
    remat = _saved_outside_segments(_model(use_recompute=True,
                                           recompute_policy="full"))
    no_layers = _saved_outside_segments(_model(num_hidden_layers=0))
    plain = _saved_outside_segments(_model())
    L, x_bytes = GQA["num_hidden_layers"], 2 * 24 * 64 * 4
    assert remat == (no_layers[0] + L, no_layers[1] + L * x_bytes)
    assert plain[0] > remat[0] + 20 and plain[1] > 2 * remat[1]


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(model):
    ids, labels = _batch()
    loss, _ = model(ids, labels=labels)
    with _CountOps() as mode:
        loss.backward()
    return mode.n


def test_policies_choose_what_the_backward_replays():
    """The backward's matrix products: ``"full"`` replays each layer's
    projections up to the last one whose result the backward needs (the
    replay stops there, so the down projection is not replayed: two
    layers, twelve more ``mm`` than without recompute) and the attention's
    batched products; the ``dots`` policies replay no ``mm``, and only
    ``"dots_saveable"`` keeps the ``bmm`` outputs too;
    ``"everything_saveable"`` replays nothing."""
    base = _backward_ops(_model())
    got = {p: _backward_ops(_model(use_recompute=True, recompute_policy=p))
           for p in ("full", "dots_saveable",
                     "dots_with_no_batch_dims_saveable",
                     "everything_saveable")}
    assert got["full"]["mm"] == base["mm"] + 12
    assert got["full"]["bmm"] > base["bmm"]
    assert got["dots_saveable"]["mm"] == base["mm"]
    assert got["dots_saveable"]["bmm"] == base["bmm"]
    assert got["dots_with_no_batch_dims_saveable"]["mm"] == base["mm"]
    assert got["dots_with_no_batch_dims_saveable"]["bmm"] == \
        got["full"]["bmm"]
    assert got["everything_saveable"] == base


@pytest.mark.parametrize("masked", [False, True], ids=["flash", "plain"])
def test_dropout_inside_a_segment_replays_its_mask(masked):
    """Attention with dropout inside a segment draws its seed from the
    segment's scope, so the replay sees the forward's mask: two identical
    outputs, and the grads of the same segment run without recompute under
    the same scope seed. Without a mask the call takes the flash path (its
    plain version here); with one, the plain ``_sdpa_reference``, whose
    dropout draws from a generator seeded from the scope. The caller's
    generator, which the replay would have advanced, is not consulted
    inside a scope."""
    rng = np.random.default_rng(5)
    lin = Linear(16, 32, device="cpu", generator=torch.Generator()
                 .manual_seed(1))
    x = torch.from_numpy(rng.standard_normal((2, 12, 16))
                         .astype(np.float32)).requires_grad_()
    gen = torch.Generator().manual_seed(7)
    kw = dict(attn_mask=torch.zeros(1, 1, 12, 12)) if masked \
        else dict(is_causal=True)
    outs = []

    def seg(h):
        q = lin(h).view(2, 12, 4, 8)
        out = F.scaled_dot_product_attention(q, q, q, dropout_p=0.3,
                                             training=True, generator=gen,
                                             **kw)
        outs.append(out.detach().clone())
        return out * out    # saves out: the replay runs past the append

    torch.manual_seed(5)
    loss = recompute(seg, x).sum()
    loss.backward()
    assert len(outs) == 2 and torch.equal(outs[0], outs[1])
    grads = (x.grad.clone(), lin.weight.grad.clone())
    x.grad, lin.weight.grad = None, None
    torch.manual_seed(5)
    with provide_seed(draw_seed()):
        plain = seg(x)
    plain.sum().backward()
    assert torch.equal(outs[2], outs[0])
    assert torch.equal(x.grad, grads[0])
    assert torch.equal(lin.weight.grad, grads[1])
    q = lin(x).view(2, 12, 4, 8)
    nodrop = F.scaled_dot_product_attention(q, q, q, **kw)
    assert not torch.equal(nodrop.detach(), outs[0])


def test_recompute_without_grad_runs_plainly():
    lin = Linear(8, 8, device="cpu", generator=torch.Generator()
                 .manual_seed(0))
    with torch.no_grad():
        out = recompute(lin, torch.ones(2, 8), checkpoint_policy="full")
    assert out.grad_fn is None


def test_recompute_sequential_segments():
    """Four layers in two recomputed chunks: the plain chain's loss and
    grads, bit for bit."""
    gen = torch.Generator().manual_seed(2)
    layers = [Linear(16, 16, device="cpu", generator=gen) for _ in range(4)]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 16))
                         .astype(np.float32))

    def run(fn):
        out = fn(x)
        out.tanh().sum().backward()
        grads = [p.weight.grad.clone() for p in layers]
        for p in layers:
            p.weight.grad = None
            p.bias.grad = None
        return out.detach(), grads

    def plain(h):
        for f in layers:
            h = f(h)
        return h
    o0, g0 = run(plain)
    o1, g1 = run(lambda h: recompute_sequential({"segments": 2}, layers, h))
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
