"""Weight bridge from the reference package (counterpart of
``paddle_tpu.jit.functional_call.collect_state`` / ``read_values``).

The caller hands over the reference model's ``named_parameters()`` as
plain numpy arrays under the same names; this module never imports the
reference.
"""
from __future__ import annotations

import numpy as np
import torch


def load_reference_params(model: torch.nn.Module,
                          params: dict[str, np.ndarray]) -> None:
    """Copy ``params`` into ``model`` name for name, strictly: a missing,
    extra or wrongly shaped name raises. Values cast to each parameter's
    dtype and device. Non-persistable buffers (the rope tables) are
    recomputed by the model, not copied."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    for name, arr in params.items():
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} vs "
                             f"{tuple(own[name].shape)}")
    with torch.no_grad():
        for name, arr in params.items():
            arr = np.asarray(arr)
            if arr.dtype.name == "bfloat16":   # numpy extension dtype
                arr = arr.astype(np.float32)
            own[name].copy_(torch.from_numpy(np.array(arr)))
    for module in model.modules():
        if hasattr(module, "reset_rope"):
            module.reset_rope()


def load_reference_optimizer_state(opt, model: torch.nn.Module,
                                   state: dict) -> None:
    """Carry a reference optimizer's ``state_dict()`` (values as numpy
    arrays) into the port's ``opt`` over ``model``: ``_step_count`` and each
    parameter's ``moment1``, ``moment2`` and ``master_weight`` (and any
    other slot), mapped by parameter name.

    A key names its parameter as ``{pname}.{slot}``: ``pname`` is either
    the parameter's name in ``model.named_parameters()`` or the
    reference's default ``param_{i}``, the ``i``-th parameter of its
    optimizer's list — which this function takes to be the model's
    parameters in order, and checks that ``opt`` was built over them in
    that order. Strict: an unknown name or a shape that differs raises.
    Slots land on each parameter's device; an existing slot keeps its
    dtype."""
    named = list(model.named_parameters())
    own = [p for _, p in named]
    if [id(p) for p in opt._parameter_list] != [id(p) for p in own]:
        raise ValueError("the optimizer must hold the model's parameters, "
                         "in named_parameters() order")
    by_name = {n: i for i, (n, _) in enumerate(named)}
    keys = opt._param_names()
    port_state = {}
    for key, value in state.items():
        if key == "_step_count":
            port_state[key] = int(np.asarray(value))
            continue
        pname, _, slot = key.rpartition(".")
        if pname in by_name:
            i = by_name[pname]
        elif pname.startswith("param_") and pname[6:].isdigit() and \
                int(pname[6:]) < len(named):
            i = int(pname[6:])
        else:
            raise KeyError(f"optimizer state key {key!r} names no parameter")
        arr = np.asarray(value)
        if tuple(arr.shape) != tuple(own[i].shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} vs "
                             f"{tuple(own[i].shape)}")
        port_state[f"{keys[id(own[i])]}.{slot}"] = arr
    opt.set_state_dict(port_state)
