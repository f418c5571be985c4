"""Attention functionals (counterpart:
``paddle_tpu/nn/functional/attention.py``).

Paddle's ``[batch, seq, heads, head_dim]`` layout at the public API. The
routing rule is the reference's on its accelerator (``attention.py:56-102``):
flash attention takes a call while the ``use_pallas_flash_attention`` flag
is on, there is no mask, ``dropout_p < 1``, and — causal — ``sq == sk``,
because the kernels mask top-left and Paddle's causal mask is bottom-right;
the two agree only for equal lengths. On a CUDA tensor the kernels must
also take the call (bf16, head dim 64 or 128: :func:`kernel_takes`). The
rule is decided from these before anything launches; a call the kernels
take and that fails raises. CPU tensors run the flash path's plain version.
It goes through the differentiable :class:`FlashAttention`, so training
reaches the backward kernels; dropout runs inside the kernels from an int32
seed (:func:`paddle_tpu_torch.core.random.draw_seed`: from the innermost
``provide_seed`` scope on the host, else from the caller's generator).
Every other call takes the plain ``_sdpa_reference`` math, whose dropout
draws from a generator seeded the same way inside a scope.
"""
from __future__ import annotations

import torch

from ...core.flags import flag_value
from ...core.random import draw_seed, in_seed_scope, make_generator
from ...ops.kernels.flash_attention import flash_attention, kernel_takes


def _sdpa_reference(q, k, v, mask, causal, dropout_p=0.0, generator=None,
                    scale=None):
    """Exact attention in ``[B, S, H, D]`` layout, float32 softmax; causal
    masks bottom-right (``tril(k=sk-sq)``), GQA repeats kv heads."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = torch.matmul(qt, kt.transpose(-1, -2)).float() * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones((sq, sk), dtype=torch.bool,
                           device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~cmask, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    out = torch.matmul(probs.to(v.dtype), vt)
    return out.transpose(1, 2)


def _takes_flash(q, k, v, mask, dropout_p, causal):
    """The routing rule (module docstring): the flag, the reference's
    conditions, and on a CUDA tensor the kernels' dtype and head dim."""
    if not flag_value("use_pallas_flash_attention"):
        return False
    if mask is not None or dropout_p >= 1.0 or (causal and
                                                q.shape[1] != k.shape[1]):
        return False
    if q.device.type != "cuda":
        return True
    return all(kernel_takes(t.dtype, q.shape[-1]) for t in (q, k, v))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """paddle.nn.functional.scaled_dot_product_attention, ``[B, S, H, D]``."""
    if not training:
        dropout_p = 0.0
    if _takes_flash(query, key, value, attn_mask, dropout_p, is_causal):
        seed = draw_seed(generator) if dropout_p > 0.0 else 0
        return flash_attention(query, key, value, causal=is_causal,
                               dropout_p=dropout_p, seed=seed)
    if dropout_p > 0.0 and in_seed_scope():
        generator = make_generator(draw_seed(), query.device)
    return _sdpa_reference(query, key, value, attn_mask, is_causal, dropout_p,
                           generator)
