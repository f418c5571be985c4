"""Optimizer base and the Llama training slice's optimizers (counterpart:
``paddle_tpu/optimizer/optimizer.py``: ``Optimizer`` :32-249, ``SGD``,
``Momentum``, ``Adam`` :283-397, ``AdamW`` :400-418).

:meth:`Optimizer.apply_updates` is the one update, over an explicit list
of parameters and their grads, as the reference's ``apply_updates``
(:81-134): each parameter's ``param_id`` is its index in that list. The
eager ``step()`` hands it the parameters that have a grad (reference
:170-181); :class:`paddle_tpu_torch.jit.TrainStep` hands it every
trainable parameter. The reference's rule is pure and its train step
donates the buffers; here the update writes params and slots IN PLACE,
which keeps the state's memory flat.

Slots: Adam keeps ``moment1``/``moment2`` (float32, or bf16 under
``adamw_bf16_moments`` for float32 params, or the param's own dtype for a
low-precision param without a master); with ``multi_precision`` a
bf16/fp16 param also keeps a float32 ``master_weight``. The routing of the
reference's ``Adam._apply_fused`` (:323-397) holds:

- a master weight with float32 moments (no amsgrad, no coupled decay):
  the fused AdamW kernel;
- a bf16 param without a master under ``adamw_stochastic_rounding``: the
  stochastic-rounding kernel, seeded per (step, ``param_id``), where the
  reference's ``_tile_plan`` tiles the shape; elsewhere the plain chain
  with the reference's ``RuntimeWarning``;
- everything else (float32 params, bf16 moments beside a master): the
  reference's plain chain (``Adam._apply`` plus decoupled decay).

The port does not read ``use_fused_adamw``: the kernels always take the
params above.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.flags import flag_value
from .lr import LRScheduler


def _is_low_precision(dtype):
    return dtype in (torch.bfloat16, torch.float16)


def as_tensor(value):
    """A tensor from a tensor or a numpy array (numpy's bfloat16 extension
    dtype included, which torch cannot read directly)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Optimizer:
    #: how many parameter updates took the plain chain (not the fused
    #: kernel), summed over every optimizer in the process
    chain_updates = 0

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        # torch parameters carry no name: ``(name, param)`` pairs, as
        # ``named_parameters()`` yields them, give each its own
        self._names: dict[int, str] = {}
        self._parameter_list = []
        for item in parameters or []:
            if isinstance(item, tuple):
                name, item = item
                self._names[id(item)] = name
            self._parameter_list.append(item)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # Paddle: a float weight_decay is L2Decay, coupled into the grad
        self._wd_kind = "l2"
        if weight_decay is None:
            self._wd = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._wd = float(weight_decay)
        else:  # an L1Decay/L2Decay object
            self._wd = float(getattr(weight_decay, "_coeff", 0.0))
            self._wd_kind = getattr(weight_decay, "_kind", "l2")
        self._decoupled_wd = False
        self._slots: dict[int, dict] = {}
        self._step_count = 0

    # -- subclass interface -------------------------------------------------
    def _init_slots(self, p) -> dict:
        return {}

    def _apply(self, p, g, slots, lr, step) -> tuple:
        raise NotImplementedError

    def _apply_fused(self, p, g, slots, lr, step, decay_mask, param_id):
        """Update ``p`` and ``slots`` in place with a fused kernel and
        return True, or return False for the plain chain."""
        return False

    def _decay_mask(self, param) -> bool:
        """Whether decoupled weight decay applies to this param (AdamW)."""
        return True

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- the update ---------------------------------------------------------
    def _ensure_slots(self, params):
        for p in params:
            if id(p) in self._slots:
                continue
            low = self._multi_precision and _is_low_precision(p.dtype)
            with torch.no_grad():
                s = self._init_slots(p.detach().float() if low else p.detach())
                if low:
                    s["master_weight"] = p.detach().float().clone()
            self._slots[id(p)] = s

    def _trainable(self):
        return [p for p in self._parameter_list if p.requires_grad]

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a grad, and its slots, in place
        (Paddle's eager ``optimizer.step()``)."""
        params = [p for p in self._trainable() if p.grad is not None]
        if not params:
            self._step_count += 1
            return
        self.apply_updates(params, [p.grad for p in params])

    @torch.no_grad()
    def apply_updates(self, params, grads):
        """One update of ``params`` with ``grads`` (aligned lists; a grad is
        any float dtype, float32 for an accumulated mean), in place:
        advances the step count, then updates each parameter and its slots.
        A parameter's index in ``params`` is its ``param_id``."""
        self._step_count += 1
        self._ensure_slots(params)
        decay_flags = [bool(self._decay_mask(p)) for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip.apply(params, grads)
        lr, step = self.get_lr(), self._step_count
        for i, (p, g, dm) in enumerate(zip(params, grads, decay_flags)):
            s = self._slots[id(p)]
            if self._apply_fused(p, g, s, lr, step, dm, i):
                continue
            Optimizer.chain_updates += 1
            master = s.get("master_weight")
            work_p = master if master is not None else p
            g32 = g.to(work_p.dtype)
            if self._wd and not self._decoupled_wd:
                if self._wd_kind == "l1":
                    g32 = g32 + self._wd * torch.sign(work_p)
                else:
                    g32 = g32 + self._wd * work_p
            new_p, new_s = self._apply(work_p, g32, s, lr, step)
            if self._decoupled_wd and self._wd and dm:
                # the reference's float32 ``lr`` promotes this term, and a
                # low-precision param with it, to float32; the port keeps
                # the param's dtype and rounds the float32 result once
                new_p = new_p.float() - float(np.float32(lr) *
                                              np.float32(self._wd)) \
                    * work_p.float()
            for k, val in new_s.items():
                s[k].copy_(val)
            if master is not None:
                master.copy_(new_p)
            p.copy_(new_p.to(p.dtype))

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # -- state dict ---------------------------------------------------------
    def _param_name(self, p):
        """``p.name`` where set (as the reference reads it), else the name
        ``p`` was given with in ``parameters``, else None."""
        return getattr(p, "name", None) or self._names.get(id(p))

    def _param_names(self):
        """Each parameter's name, else the reference's ``param_{i}`` by
        position in the parameter list."""
        return {id(p): (self._param_name(p) or f"param_{i}")
                for i, p in enumerate(self._parameter_list)}

    def state_dict(self):
        out = {"_step_count": self._step_count}
        names = self._param_names()
        for p in self._parameter_list:
            for k, val in self._slots.get(id(p), {}).items():
                out[f"{names[id(p)]}.{k}"] = val
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """Load slots by the names of :meth:`state_dict`; values may be
        tensors or numpy arrays and land on each param's device, in the
        dtype of the slot they replace (a new slot keeps its own)."""
        self._step_count = int(state.get("_step_count", 0))
        if "LR_Scheduler" in state and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        names = self._param_names()
        for p in self._parameter_list:
            prefix = names[id(p)] + "."
            old = self._slots.get(id(p), {})
            slot = {}
            for key, value in state.items():
                if isinstance(key, str) and key.startswith(prefix):
                    name = key[len(prefix):]
                    t = as_tensor(value)
                    dtype = old[name].dtype if name in old else t.dtype
                    slot[name] = t.to(device=p.device, dtype=dtype).clone()
            if slot:
                self._slots[id(p)] = slot


class SGD(Optimizer):
    def _apply(self, p, g, slots, lr, step):
        return p - float(np.float32(lr)) * g, {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, v):
        return {"velocity": torch.zeros_like(v)}

    def _apply(self, p, g, slots, lr, step):
        vel = self._momentum * slots["velocity"] + g
        update = g + self._momentum * vel if self._nesterov else vel
        return p - float(np.float32(lr)) * update, {"velocity": vel}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _init_slots(self, v):
        mdt = torch.bfloat16 if (flag_value("adamw_bf16_moments")
                                 and v.dtype == torch.float32) else v.dtype
        s = {"moment1": torch.zeros(v.shape, dtype=mdt, device=v.device),
             "moment2": torch.zeros(v.shape, dtype=mdt, device=v.device)}
        if self._amsgrad:
            s["moment2_max"] = torch.zeros(v.shape, dtype=mdt,
                                           device=v.device)
        return s

    def _apply(self, p, g, slots, lr, step):
        """The reference's chain (``optimizer.py:310-321``): float32 math
        on moments stored in ``moment1``'s dtype; the bias corrections as
        float32 host scalars."""
        b1, b2 = self._beta1, self._beta2
        mdt = slots["moment1"].dtype
        m1 = slots["moment1"].to(p.dtype)
        m2 = slots["moment2"].to(p.dtype)
        m = b1 * m1 + (1 - b1) * g
        v = b2 * m2 + (1 - b2) * (g * g)
        stepf = np.float32(step)
        bc1 = float(np.float32(1) - np.power(np.float32(b1), stepf))
        bc2 = float(np.float32(1) - np.power(np.float32(b2), stepf))
        ns = {"moment1": m.to(mdt), "moment2": v.to(mdt)}
        if self._amsgrad:
            vmax = torch.maximum(slots["moment2_max"].to(p.dtype), v)
            ns["moment2_max"] = vmax.to(mdt)
            denom = torch.sqrt(vmax / bc2) + self._eps
        else:
            denom = torch.sqrt(v / bc2) + self._eps
        update = (m / bc1) / denom
        return p - float(np.float32(lr)) * update, ns

    def _apply_fused(self, p, g, slots, lr, step, decay_mask, param_id):
        """The fused kernels where the reference takes its Pallas kernels:
        multi-precision (a master weight) with float32 moments, or, under
        ``adamw_stochastic_rounding``, a bf16 param without a master whose
        shape the reference tiles. No amsgrad, no coupled decay."""
        if self._amsgrad or (self._wd and not self._decoupled_wd):
            return False
        from ..ops.kernels import fused_adamw as K
        kw = dict(beta1=self._beta1, beta2=self._beta2, eps=self._eps,
                  weight_decay=self._wd if self._decoupled_wd else 0.0,
                  apply_decay=bool(decay_mask))
        if slots.get("master_weight") is None:
            if not flag_value("adamw_stochastic_rounding") or \
                    p.dtype != torch.bfloat16:
                return False
            if K.tile_plan(tuple(p.shape)) is None:
                warnings.warn(
                    "adamw_stochastic_rounding: shape not tileable for the "
                    "SR kernel — falling back to DETERMINISTIC bf16 "
                    "rounding for this parameter (small updates may stall)",
                    RuntimeWarning, stacklevel=4)
                return False
            K.fused_adamw_sr_update(p, g, slots["moment1"], slots["moment2"],
                                    lr, step, K.sr_seed(step, param_id), **kw)
            return True
        if slots["moment1"].dtype != torch.float32:
            return False
        K.fused_adamw_update(p, g, slots["moment1"], slots["moment2"],
                             slots["master_weight"], lr, step, **kw)
        return True


class AdamW(Adam):
    """Decoupled weight decay (Paddle's python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._wd = float(getattr(weight_decay, "_coeff", weight_decay))
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_mask(self, param):
        """``apply_decay_param_fun(name)``, as the reference calls it with
        the parameter's name. A torch parameter has none unless given one
        (``parameters=model.named_parameters()``), and a function of ""
        would decay every parameter or none, so a nameless one raises."""
        if self._apply_decay_param_fun is None:
            return True
        name = self._param_name(param)
        if name is None:
            raise ValueError(
                "apply_decay_param_fun needs each parameter's name; pass "
                "parameters=model.named_parameters()")
        return bool(self._apply_decay_param_fun(name))
