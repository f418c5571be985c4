"""Gradient clipping (counterpart: ``paddle_tpu/optimizer/clip.py``;
Paddle's python/paddle/nn/clip.py).

Each clip maps a list of grads (``None`` where a parameter has none) to a
new list, in float32 where the reference accumulates in float32. The
global norm stays a device tensor: clipping reads nothing back to the host.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def apply(self, params, grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def apply(self, params, grads):
        return [g.clamp(self.min, self.max) if g is not None else None
                for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Per-tensor L2 norm clip."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, params, grads):
        out = []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            g32 = g.float()
            norm = torch.sqrt(torch.sum(g32 * g32))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((g32 * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Global L2 norm clip across all grads (float32 accumulation)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads):
        sq = [torch.sum(g.float() * g.float()) for g in grads if g is not None]
        if not sq:
            return torch.zeros((), dtype=torch.float32)
        return torch.sqrt(sum(sq))

    def apply(self, params, grads):
        norm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [(g.float() * scale).to(g.dtype) if g is not None else None
                for g in grads]
