"""The training step (counterpart: ``paddle_tpu/jit/api.py`` ``TrainStep``,
:449-747).

The reference traces forward, backward and the optimizer update into one
jitted program with donated buffers. The port runs the same stages
eagerly: ``loss_fn(model, *batch)`` inside a per-step
:func:`paddle_tpu_torch.core.random.provide_seed` scope (the reference's
``provide_key`` with a per-step key), ``loss.backward()`` (the flash
backward kernels through autograd), then the optimizer's
``apply_updates`` over every trainable parameter, which writes params and
slots in place (the fused kernels where the reference takes its kernels)
and counts the step. A parameter the loss does not reach gets a zero
grad, as ``jax.value_and_grad`` gives it one, so AdamW still moves its
moments and decays it.

With ``accumulate_steps=K`` (reference :596-747) each call is a
microstep: its grads are added into float32 accumulators made at the
first microstep of a cycle, and the K-th call updates on their float32
mean ``acc / K``; the step count advances once per K calls and every call
returns its own loss. The step count, the learning rate and every seed
are host numbers, so no call reads anything back from the card; the
returned loss is a device tensor.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.random import draw_seed, provide_seed


class TrainStep:
    """One training iteration: forward, backward, optimizer update.

    ``loss_fn(model, *batch)`` returns a scalar loss tensor. The update
    covers the model's trainable parameters in ``named_parameters()``
    order, the reference's order, and the optimizer builds their slots
    here. After each call, ``missing_grads`` names the trainable
    parameters that had no grad after the backward; they are updated with
    a zero grad, as in the reference.

    ``donate`` is the reference's argument, kept in its place and stored as
    ``self.donate``; it changes nothing here. The reference donates the
    parameter and slot buffers to its jitted step so the update does not
    hold two copies of the weights; the port's update writes parameters
    and slots in place already (``optimizer/optimizer.py``), so there is
    no second copy to avoid."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate=True, accumulate_steps=1):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.donate = donate
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.missing_grads: list[str] = []
        self.accumulate_steps = int(accumulate_steps)
        self._acc = None
        self._acc_count = 0
        optimizer._ensure_slots(self.params)

    def __call__(self, *batch):
        for p in self.params:
            p.grad = None
        with provide_seed(draw_seed()):
            loss = self.loss_fn(self.model, *batch)
        loss.backward()
        loss = loss.detach()
        self.missing_grads = [n for n, p in zip(self.names, self.params)
                              if p.grad is None]
        if self.accumulate_steps == 1:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        else:
            with torch.no_grad():
                if self._acc is None:
                    self._acc = [torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                                 for p in self.params]
                for a, p in zip(self._acc, self.params):
                    if p.grad is not None:
                        a.add_(p.grad)
            self._acc_count += 1
            for p in self.params:
                p.grad = None
            if self._acc_count < self.accumulate_steps:
                return loss
            grads = [a.div_(self.accumulate_steps) for a in self._acc]
            self._acc, self._acc_count = None, 0
        self.optimizer.apply_updates(self.params, grads)
        for p in self.params:
            p.grad = None
        return loss
