"""Memory-lean fused softmax cross-entropy (counterpart:
``paddle_tpu/ops/kernels/fused_ce.py`` ``fused_softmax_ce``, :23-60).

Plain PyTorch, as the reference is pure JAX (no Pallas kernel). The
residuals are the low-precision logits (already live) and one float32
``lse`` per token: the forward accumulates ``lse`` in float32 from the
logits without keeping a float32 copy for the backward, and the backward
rebuilds ``softmax = exp(l - lse)`` in one float32 buffer, subtracts the
one-hot and scales it in place, and casts it to the logits' dtype.
"""
from __future__ import annotations

import torch


class FusedSoftmaxCE(torch.autograd.Function):
    """Per-token CE loss: logits ``(T, V)`` of any float dtype, labels
    ``(T,)`` int; float32 ``(T,)`` loss with ignored tokens zeroed."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_index=-100):
        l32 = logits.float()
        m = l32.amax(dim=-1)
        lse = m + torch.log(torch.exp(l32 - m[:, None]).sum(dim=-1))
        idx = labels.long().clamp(0, logits.shape[-1] - 1)
        tgt = l32.gather(1, idx[:, None])[:, 0]
        del l32
        valid = labels != ignore_index
        loss = torch.where(valid, lse - tgt, torch.zeros_like(lse))
        ctx.save_for_backward(logits, labels, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        idx = labels.long().clamp(0, logits.shape[-1] - 1)
        valid = labels != ctx.ignore_index
        scale = torch.where(valid, g, torch.zeros_like(g)).float()
        grad = logits.float()
        grad.sub_(lse[:, None]).exp_()
        grad.scatter_add_(1, idx[:, None],
                          -torch.ones_like(lse)[:, None])
        grad.mul_(scale[:, None])
        return grad.to(logits.dtype), None, None


def fused_softmax_ce(logits, labels, ignore_index=-100):
    """Per-token CE loss of ``logits (T, V)`` against ``labels (T,)``:
    float32 ``(T,)``, ignored positions zero."""
    return FusedSoftmaxCE.apply(logits, labels, ignore_index)
