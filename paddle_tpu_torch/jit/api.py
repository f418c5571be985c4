"""The training step (counterpart: ``paddle_tpu/jit/api.py`` ``TrainStep``,
:449-534).

The reference traces forward, backward and the optimizer update into one
jitted program with donated buffers. The port runs the same three stages
eagerly: ``loss_fn(model, *batch)``, ``loss.backward()`` (the flash
backward kernels through autograd), then the optimizer's own ``step()``,
which writes params and slots in place (the fused AdamW kernel where the
reference takes its kernel) and counts the step, and ``clear_grad()``.
The step count and the learning rate are host numbers, so a step reads
nothing back from the card; the returned loss is a device tensor.
"""
from __future__ import annotations

from typing import Callable

import torch


class TrainStep:
    """One training iteration: forward, backward, optimizer update.

    ``loss_fn(model, *batch)`` returns a scalar loss tensor. The optimizer
    updates the parameters it was built over, normally the model's. After
    each call, ``missing_grads`` names the model's trainable parameters
    that had no grad after the backward (those are left unchanged, as the
    reference skips a ``None`` grad)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 accumulate_steps=1):
        if int(accumulate_steps) > 1:
            raise NotImplementedError(
                "TrainStep accumulate_steps > 1 (gradient accumulation in "
                "float32 across micro-steps) is not ported yet: ROADMAP A12")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.missing_grads: list[str] = []

    def __call__(self, *batch):
        opt = self.optimizer
        opt.clear_grad()
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        self.missing_grads = [n for n, p in zip(self.names, self.params)
                              if p.grad is None]
        opt.step()
        opt.clear_grad()
        return loss.detach()
