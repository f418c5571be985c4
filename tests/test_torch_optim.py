"""The port's optimizer slice against paddle_tpu's (CPU): the plain version
of the fused AdamW kernel against the reference's Pallas kernel in
interpret mode, each optimizer's ``step()`` against the reference's
``apply_updates`` on the same arrays, the clips, the LR schedulers, the
flags and the state dict.

Tolerances: the fused update's moments and master within 1e-6 of each
tensor's largest magnitude, and its bf16 param within one bf16 ulp: the
same float32 operations in the same order, but XLA contracts ``b1*m +
(1-b1)*g`` into a fused multiply-add, so where the two terms cancel one
rounding of the larger term is a larger share of the small result (and
the bias-correction powers may differ in their last bit). The chains atol
1e-6 (float32 arithmetic in one order on both sides)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import paddle_tpu as paddle
from paddle_tpu.ops.kernels.fused_adamw import (
    fused_adamw_update as jax_fused_adamw)

from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.ops.kernels.fused_adamw import (
    fused_adamw_update, fused_adamw_update_plain)
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(1)


def _state(rng, shape, step):
    """bf16 param and grad, float32 moments and master at a mid-run state."""
    mw = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    g = (rng.standard_normal(shape) * 1e-2).astype(ml_dtypes.bfloat16)
    m = (rng.standard_normal(shape) * 1e-3).astype(np.float32) * (step > 1)
    v = (rng.random(shape) * 1e-5).astype(np.float32) * (step > 1)
    return mw.astype(ml_dtypes.bfloat16), g, m, v, mw


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("step", [1, 7])
@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("shape", [(64, 256), (4, 40, 6)])
def test_fused_adamw_plain_matches_pallas(step, decay, shape):
    rng = np.random.default_rng(step + 10 * decay)
    p, g, m, v, mw = _state(rng, shape, step)
    lr = 3e-4
    ref = jax_fused_adamw(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
                          jnp.asarray(v), jnp.asarray(mw),
                          jnp.asarray(lr, jnp.float32),
                          jnp.asarray(step, jnp.int32), weight_decay=0.01,
                          apply_decay=decay)
    assert ref is not None
    rp, rm, rv, rmw = (np.asarray(x) for x in ref)
    tp, tg, tm, tv, tmw = (_t(x) for x in (p, g, m, v, mw))
    n0 = fused_adamw_update.launches
    fused_adamw_update(tp, tg, tm, tv, tmw, lr, step, weight_decay=0.01,
                       apply_decay=decay)
    assert fused_adamw_update.launches == n0      # CPU: the plain version
    for got, want in ((tm, rm), (tv, rv), (tmw, rmw)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    # the bf16 param: within one ulp (bit patterns differ by at most 1)
    a = tp.view(torch.int16).numpy().astype(np.int32)
    b = rp.view(np.int16).astype(np.int32)
    assert np.abs(a - b).max() <= 1
    if not decay:           # decay off: lrwd must be exactly 0
        p2, g2, m2, v2, mw2 = (_t(x) for x in (p, g, m, v, mw))
        fused_adamw_update_plain(p2, g2, m2, v2, mw2, lr, step,
                                 weight_decay=0.0)
        assert torch.equal(mw2, tmw)


def test_fused_adamw_refuses_mismatched_state():
    p = torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        fused_adamw_update(p, p, torch.zeros(4, 8), torch.zeros(4, 8),
                           torch.zeros(8, 4), 1e-3, 1)
    with pytest.raises(TypeError, match="float32"):
        fused_adamw_update(p, p, torch.zeros(4, 8), torch.zeros(4, 8),
                           torch.zeros(4, 8, dtype=torch.bfloat16), 1e-3, 1)


def _ref_opt(kind, **kw):
    return getattr(paddle.optimizer, kind)(**kw)


CHAINS = [
    ("AdamW", dict(learning_rate=1e-3, weight_decay=0.05), {}),
    ("AdamW", dict(learning_rate=1e-3, weight_decay=0.05), {"bf16m": True}),
    ("Adam", dict(learning_rate=1e-3, weight_decay=0.01), {}),
    ("Adam", dict(learning_rate=1e-3, amsgrad=True), {}),
    ("SGD", dict(learning_rate=0.1, weight_decay=0.01), {}),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9, use_nesterov=True),
     {}),
    ("AdamW", dict(learning_rate=1e-3, weight_decay=0.05), {"clip": 0.05}),
]


@pytest.mark.parametrize("kind,kw,opts", CHAINS)
def test_update_chain_matches_reference(kind, kw, opts):
    """Three updates of float32 params: the reference's ``apply_updates``
    against the port's ``step()`` on the same grads; decay masked off for
    the second param (by its name, where the optimizer takes a mask)."""
    rng = np.random.default_rng(3)
    shapes = [(16, 8), (8,)]
    vals = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if "clip" in opts:
        jkw["grad_clip"] = paddle.optimizer.ClipGradByGlobalNorm(opts["clip"])
        tkw["grad_clip"] = topt.ClipGradByGlobalNorm(opts["clip"])
    import paddle_tpu.core.flags as jflags
    jflags.set_flags({"adamw_bf16_moments": bool(opts.get("bf16m"))})
    tflags.set_flags({"adamw_bf16_moments": bool(opts.get("bf16m"))})
    try:
        jo = _ref_opt(kind, **jkw)
        tparams = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                   for v in vals]
        if kind == "AdamW":
            tkw["apply_decay_param_fun"] = lambda name: name == "w"
        to = getattr(topt, kind)(parameters=zip("wb", tparams), **tkw)
        jslots = [jo._init_slots(jnp.asarray(v)) for v in vals]
        jvals = [jnp.asarray(v) for v in vals]
        for step in (1, 2, 3):
            grads = [rng.standard_normal(s).astype(np.float32)
                     for s in shapes]
            jvals, jslots = jo.apply_updates(
                jvals, [jnp.asarray(g) for g in grads], jslots,
                jnp.asarray(kw["learning_rate"], jnp.float32),
                jnp.asarray(step, jnp.int32), (True, False))
            for p, g in zip(tparams, grads):
                p.grad = torch.from_numpy(g)
            to.step()
        tslots = [to._slots[id(p)] for p in tparams]
        assert to._step_count == 3
    finally:
        jflags.set_flags({"adamw_bf16_moments": False})
        tflags.set_flags({"adamw_bf16_moments": False})
    for jv, tp in zip(jvals, tparams):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jv),
                                   atol=1e-6, rtol=0)
    for js, ts in zip(jslots, tslots):
        assert sorted(js) == sorted(ts)
        for k in js:
            np.testing.assert_allclose(
                ts[k].float().numpy(),
                np.asarray(js[k]).astype(np.float32), atol=1e-6, rtol=0)
            assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype)


def test_eager_step_and_state_dict_round_trip():
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 4).to(torch.bfloat16)
    opt = topt.AdamW(learning_rate=1e-2, parameters=lin.parameters())
    for _ in range(2):
        lin(torch.randn(3, 8, dtype=torch.bfloat16)).float().sum().backward()
        opt.step()
        opt.clear_grad()
    assert opt._step_count == 2
    sd = opt.state_dict()
    assert sorted(k.split(".", 1)[1] for k in sd if k != "_step_count") == \
        sorted(["master_weight", "moment1", "moment2"] * 2)
    opt2 = topt.AdamW(learning_rate=1e-2, parameters=lin.parameters())
    opt2.set_state_dict({k: (v.numpy() if torch.is_tensor(v) else v)
                         for k, v in sd.items()})
    assert opt2._step_count == 2
    for p in lin.parameters():
        for k, val in opt._slots[id(p)].items():
            assert torch.equal(opt2._slots[id(p)][k], val)


NAMES = ["proj.weight", "proj.bias", "norm.weight", "norm.bias"]


def _no_decay(name):
    return not (name.endswith("bias") or name.startswith("norm."))


def test_decay_mask_follows_parameter_names():
    """``apply_decay_param_fun`` gets each parameter's own name, as the
    reference's does: over the same names the two masks agree, and the
    names key the state dict. A nameless torch parameter raises rather than
    hand the function ""."""
    jm = paddle.nn.Sequential(paddle.nn.Linear(8, 4), paddle.nn.LayerNorm(4))
    jparams = list(jm.parameters())
    for n, p in zip(NAMES, jparams):
        p.name = n
    tm = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.LayerNorm(4))
    jo = paddle.optimizer.AdamW(parameters=jparams,
                                apply_decay_param_fun=_no_decay)
    to = topt.AdamW(parameters=zip(NAMES, tm.parameters()),
                    apply_decay_param_fun=_no_decay)
    jmask = [jo._decay_mask(p) for p in jparams]
    assert jmask == [True, False, False, False]
    assert [to._decay_mask(p) for p in tm.parameters()] == jmask
    tm(torch.randn(3, 8)).sum().backward()
    to.step()
    assert sorted(k.split(".moment")[0] for k in to.state_dict()
                  if k.endswith("moment1")) == sorted(NAMES)
    nameless = topt.AdamW(parameters=tm.parameters(),
                          apply_decay_param_fun=_no_decay)
    with pytest.raises(ValueError, match="named_parameters"):
        nameless.step()
    assert topt.AdamW(parameters=tm.parameters())._decay_mask(
        next(tm.parameters()))


@pytest.mark.parametrize("name,args", [
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=5)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=3, start_lr=0.0,
                          end_lr=0.1)),
    ("StepDecay", dict(learning_rate=0.1, step_size=2, gamma=0.5)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=4))])
def test_lr_schedules_match_reference(name, args):
    js = getattr(paddle.optimizer.lr, name)(**args)
    ts = getattr(tlr, name)(**args)
    for _ in range(7):
        assert ts.get_lr() == js.get_lr()
        js.step()
        ts.step()
    opt = topt.SGD(learning_rate=ts)
    assert opt.get_lr() == js.get_lr()


def test_flags_surface():
    """Paddle's flag surface; ``use_fused_adamw`` is accepted but routes
    nothing: a bf16 param with a master still takes the fused update."""
    assert tflags.get_flags("FLAGS_use_fused_adamw") == \
        {"FLAGS_use_fused_adamw": True}
    tflags.set_flags({"FLAGS_use_fused_adamw": False})
    try:
        assert tflags.flag_value("use_fused_adamw") is False
        p = torch.nn.Parameter(torch.ones(4, 8, dtype=torch.bfloat16))
        p.grad = torch.ones_like(p)
        n0 = topt.Optimizer.chain_updates
        topt.AdamW(parameters=[p], multi_precision=True).step()
        assert topt.Optimizer.chain_updates == n0
    finally:
        tflags.set_flags({"use_fused_adamw": True})
    with pytest.raises(ValueError, match="unknown flag"):
        tflags.set_flags({"use_fused_adamw": True, "no_such_flag": 1})
    assert tflags.flag_value("use_fused_adamw") is True
