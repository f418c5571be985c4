"""Loss functionals (counterpart: ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` keeps the reference's two branches (``loss.py:27-100``):
hard integer labels over the last axis with no class weights and no
smoothing take the memory-lean fused CE (``ops/kernels/fused_ce.py``); soft
labels, class weights, label smoothing, ``use_softmax=False`` or another
axis take the generic float32 log-softmax. Both keep the per-token loss in
float32 through the masking and the mean; only ``reduction="none"`` casts
back to the logits' dtype.
"""
from __future__ import annotations

import torch

from ...ops.kernels.fused_ce import fused_softmax_ce


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _log_probs(logits, ax, use_softmax):
    l32 = logits.float()
    if use_softmax:
        return torch.log_softmax(l32, dim=ax)
    return torch.log(torch.clamp(l32, min=1e-30))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """paddle.nn.functional.cross_entropy (softmax + CE, fused on the hot
    path)."""
    logits, lbl = input, label
    ax = int(axis) % logits.dim()
    n_classes = logits.shape[ax]
    if soft_label:
        logp = _log_probs(logits, ax, use_softmax)
        loss = -(lbl * logp).sum(dim=ax).to(logits.dtype)
        if weight is not None:
            loss = loss * weight
        return _reduce(loss, reduction)
    lbl_int = lbl.long()
    if lbl_int.dim() == logits.dim():
        lbl_int = lbl_int.squeeze(ax)
    if (use_softmax and label_smoothing == 0.0 and weight is None
            and ax == logits.dim() - 1 and not lbl.is_floating_point()):
        flat = fused_softmax_ce(logits.reshape(-1, n_classes),
                                lbl_int.reshape(-1), ignore_index)
        loss = flat.reshape(lbl_int.shape)
    else:
        logp = _log_probs(logits, ax, use_softmax)
        idx = lbl_int.clamp(0, n_classes - 1).unsqueeze(ax)
        nll = -logp.gather(ax, idx).squeeze(ax)
        if label_smoothing > 0.0:
            eps = label_smoothing
            loss = (1 - eps) * nll + eps * (-logp.mean(dim=ax))
        else:
            loss = nll
    valid = lbl_int != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        cw = weight[lbl_int.clamp(0, n_classes - 1)]
        cw = torch.where(valid, cw, torch.zeros_like(cw))
        loss = loss * cw
        if reduction == "mean":
            return loss.sum() / torch.clamp(cw.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
    out = _reduce(loss, reduction)
    if reduction == "none":
        out = out.to(logits.dtype)
    return out
