"""Weight-only quantized inference (counterpart: ``paddle_tpu/nn/quant``).

Per-output-channel int8 or int4 weights with float32 scales, the
deploy-form ``WeightOnlyLinear`` and the in-place swap that serves a model
with them. The reference's helpers compute in numpy; these compute on the
weight's device, with each dtype step of the reference's numpy spelled out
so the packed bytes and scales are the same bits.

``weight_only_linear`` routes as the reference does (``:85-157``): an int4
GEMM of at most 128 rows on a tileable shape goes to kernel B8
(``ops/kernels/int4_matmul.py``) where the reference would take its Pallas
kernel, here on a CUDA tensor under ``FLAGS_use_pallas_int4``; everything
else (CPU tensors, prefill rows, odd or untileable shapes, int8) takes the
reference's plain dequantize-and-matmul products.

Not ported yet: ``llm_int8_linear`` and the QAT layers the reference
re-exports from ``paddle_tpu/quantization``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.flags import flag_value
from ...ops.kernels.int4_matmul import (int4_matmul, int4_matmul_tileable,
                                        nibbles as _nibbles)
from ..layer.common import Linear

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "int4_routes_to_kernel", "WeightOnlyLinear",
           "quantize_linears_for_inference"]

_ALGOS = ("weight_only_int8", "llm.int8", "weight_only_int4")


def weight_quantize(weight, algo="weight_only_int8", group_size=-1):
    """Per-out-channel quantization of ``weight [in, out]`` (reference
    ``:32-52``; ``group_size`` is accepted and ignored, as there).

    int8: ``(int8 [in, out], float32 scales [out])``. int4: ``(int8
    [ceil(in / 2), out], scales)``, row 2k in the low nibble and row 2k+1
    in the high one, an odd ``in`` padded with a zero row. The scale is
    ``max(absmax, 1e-9) / qmax`` in float32 (the absmax taken in the
    weight's dtype), and ``round(w / scale)`` rounds half to even in
    float32. Both divisions divide by a float32 tensor on the weight's
    device: a Python divisor would be multiplied by its reciprocal on the
    card, one ulp off the reference's numpy division."""
    if algo not in _ALGOS:
        raise NotImplementedError(f"unknown weight_quantize algo {algo!r}")
    w = weight.detach()
    int4 = algo == "weight_only_int4"
    qmax = 7.0 if int4 else 127.0
    f32 = dict(dtype=torch.float32, device=w.device)
    absmax = w.abs().amax(dim=0).to(torch.float32)
    scales = torch.maximum(absmax, torch.tensor(1e-9, **f32)) / \
        torch.tensor(qmax, **f32)
    q = torch.clamp(torch.round(w / scales[None, :]), -8.0 if int4 else -qmax,
                    qmax).to(torch.int8)
    if not int4:
        return q, scales
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1, q.shape[1]))])
    return (q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4), scales


def weight_dequantize(quant_weight, scale, algo="weight_only_int8",
                      in_features=None):
    """Inverse of :func:`weight_quantize`, in ``scale``'s dtype. For int4,
    ``in_features`` strips the zero row of an odd input dim (without it the
    padded ``[2 * rows, out]`` comes back)."""
    q = quant_weight
    if algo == "weight_only_int4":
        low, high = _nibbles(q)
        q = torch.stack([low, high], dim=1).reshape(-1, q.shape[-1])
        if in_features is not None:
            q = q[:in_features]
    return q.to(scale.dtype) * scale[None, :]


class _Int4Matmul(torch.autograd.Function):
    """B8's route with a gradient: the kernel has no backward of its own,
    so the x-gradient runs the split-nibble dequantized products (the
    reference's ``_mm_bwd``, ``:123-134``)."""

    @staticmethod
    def forward(ctx, x2d, q, s):
        ctx.save_for_backward(q, s)
        ctx.n_in = x2d.shape[-1]
        return int4_matmul(x2d, q, s)

    @staticmethod
    def backward(ctx, dy):
        q, s = ctx.saved_tensors
        low, high = _nibbles(q)
        sd = s.to(dy.dtype)
        dxe = torch.matmul(dy, (low.to(dy.dtype) * sd[None, :]).t())
        dxo = torch.matmul(dy, (high.to(dy.dtype) * sd[None, :]).t())
        # weight rows interleave low/high nibbles: dx[2i] = dxe[i],
        # dx[2i+1] = dxo[i], cut to an odd n_in
        dx = torch.stack([dxe, dxo], dim=-1).reshape(
            dy.shape[:-1] + (2 * low.shape[0],))[..., :ctx.n_in]
        return dx, None, None


def int4_routes_to_kernel(rows, n_in, n_out, device):
    """The reference's routing rule (``:105-108``) with the card in the
    TPU's place: ``FLAGS_use_pallas_int4``, a CUDA ``device``, at most 128
    rows and a tileable shape."""
    return bool(flag_value("use_pallas_int4")
                and torch.device(device).type == "cuda" and rows <= 128
                and int4_matmul_tileable(n_in, n_out))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", group_size=-1):
    """``y = x @ dequant(weight) + bias`` (reference ``:85-157``).

    int4 takes B8 when ``FLAGS_use_pallas_int4`` is on, ``x`` lies on the
    card, ``prod(x.shape[:-1]) <= 128`` and the shape tiles; otherwise two
    half-size products in ``x``'s dtype against the low and high nibbles
    times the scales rounded to ``x``'s dtype (an odd ``n_in`` pads the odd
    half of x). int8: ``x @ (q * s)`` in ``x``'s dtype."""
    q, s = weight, weight_scale
    if weight_dtype == "int4":
        n_in, n_out = x.shape[-1], q.shape[-1]
        if int4_routes_to_kernel(math.prod(x.shape[:-1]), n_in, n_out,
                                 x.device):
            y = _Int4Matmul.apply(x.reshape(-1, n_in), q, s).reshape(
                x.shape[:-1] + (n_out,))
        else:
            sb = s.to(x.dtype)
            low, high = _nibbles(q)
            x_even = x[..., 0::2]
            x_odd = x[..., 1::2]
            if n_in % 2:
                x_odd = nn.functional.pad(x_odd, (0, 1))
            y = (torch.matmul(x_even, low.to(x.dtype) * sb[None, :])
                 + torch.matmul(x_odd, high.to(x.dtype) * sb[None, :]))
    else:
        y = torch.matmul(x, q.to(x.dtype) * s.to(x.dtype)[None, :])
    if bias is not None:
        y = y + bias
    return y


class WeightOnlyLinear(nn.Module):
    """Deploy-form ``Linear`` with weight-only quantized storage (reference
    ``:190-216``): the float weight is dropped, ``quant_weight`` (int8) and
    ``weight_scale`` (float32) are frozen parameters under the reference's
    names, so a quantized reference model bridges name for name. Casting
    the module would turn the float32 scales to the cast's dtype: nothing
    on the serving path casts a quantized model."""

    def __init__(self, linear, weight_dtype="int8"):
        super().__init__()
        q, s = weight_quantize(linear.weight,
                               algo=f"weight_only_{weight_dtype}")
        self.quant_weight = nn.Parameter(q, requires_grad=False)
        self.weight_scale = nn.Parameter(s, requires_grad=False)
        self.bias = linear.bias
        self.weight_dtype = weight_dtype
        self.in_features = int(linear.weight.shape[0])
        self.out_features = int(linear.weight.shape[1])

    def forward(self, x):
        return weight_only_linear(x, self.quant_weight, self.bias,
                                  self.weight_scale, self.weight_dtype)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"weight_dtype={self.weight_dtype}")


def quantize_linears_for_inference(layer, weight_dtype="int8",
                                   skip=lambda name, lin: False):
    """Swap every port ``Linear`` under ``layer`` in place for a
    :class:`WeightOnlyLinear` (reference ``:219-239``); ``skip(qualified
    name, linear)`` exempts one. Returns ``(layer, number of swaps)``: for
    Llama, 7 per decoder layer plus ``lm_head``."""
    n = 0

    def visit(mod, prefix):
        nonlocal n
        for name, sub in list(mod.named_children()):
            qual = f"{prefix}{name}"
            if isinstance(sub, Linear) and not skip(qual, sub):
                setattr(mod, name, WeightOnlyLinear(sub, weight_dtype))
                n += 1
            else:
                visit(sub, qual + ".")

    visit(layer, "")
    return layer, n
