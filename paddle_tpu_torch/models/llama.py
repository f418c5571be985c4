"""Llama decoder LM (counterpart: ``paddle_tpu/models/llama.py``).

Parameter names, shapes and layouts match the reference (``Linear``
weights ``[in, out]``), so :func:`paddle_tpu_torch.bridge.load_reference_params`
copies a reference model's weights name for name. Attention goes through
``F.scaled_dot_product_attention`` (the flash kernel for the causal
no-cache forward) or, with a :class:`PagedKVCache`, through
``block_multihead_attention`` (the paged-decode kernel for one token per
slot, the paged-append kernel for the fused scheduler's mixed step).

``forward(labels=...)`` returns ``(loss, logits)`` with the loss from the
port's ``F.cross_entropy`` (the fused CE on hard labels), so training runs
the flash backward kernels through ``F.scaled_dot_product_attention``.
``use_recompute`` wraps each decoder layer in
:func:`paddle_tpu_torch.distributed.fleet.recompute` under
``recompute_policy`` when training without a cache (reference
``llama.py:610-617``). ``fuse_attention_qkv`` makes one ``qkv_proj`` whose
output splits into ``[q | k | v]`` (reference :314-348) and
``fuse_swiglu`` one ``gate_up_proj`` split at ``intermediate_size``
(:529-551).

A :class:`PagedKVCache` may carry int8/int4 quantized pools with their
scale arrays (the engine's ``kv_cache_dtype``); attention routes them to
the quantized paged kernels.

The dense engine's caches, :class:`SlotKVCache` (a decode step, or a
window of ``s`` rows, per slot at its own length) and
:class:`ChunkKVCache` (the fused scheduler's mixed step over per-slot
buffers), write the slot buffers in place and attend with
:func:`_window_causal_mask`: masked attention, as in the reference, so
``F.scaled_dot_product_attention`` takes its plain math and no flash or
paged kernel runs.

``LlamaForCausalLM.generate`` is the reference's decode over the static
or the paged cache, run eagerly in windows of ``GEN_WINDOW`` steps:
greedy, or sampled through the reference's sampling head
(:func:`_filter_logits`, :func:`_sample_logits_device`) under threefry
keys from :mod:`paddle_tpu_torch.core.prng`. The engine samples through
the same head.

Not in this port yet, raising where reached: LoRA scopes.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core import prng
from ..core import random as _random
from ..core.random import make_generator
from ..distributed.fleet.recompute import recompute
from ..incubate.nn import functional as IF
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    fuse_attention_qkv: bool = False
    fuse_swiglu: bool = False
    use_recompute: bool = False
    recompute_policy: str | None = None
    dtype: str = "float32"

    @staticmethod
    def llama2_7b(**over):
        return LlamaConfig(**{**dict(hidden_size=4096, intermediate_size=11008,
                                     num_hidden_layers=32, num_attention_heads=32),
                              **over})

    @staticmethod
    def tiny(**over):
        return LlamaConfig(**{**dict(vocab_size=1024, hidden_size=128,
                                     intermediate_size=352, num_hidden_layers=2,
                                     num_attention_heads=4, num_key_value_heads=4,
                                     max_position_embeddings=256), **over})


def precompute_rope(head_dim, max_len, theta=10000.0, device="cpu"):
    """float32 ``(cos, sin)`` tables ``[max_len, head_dim]``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device,
                                              dtype=torch.float32) / head_dim))
    t = torch.arange(max_len, device=device, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)                     # [T, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)              # [T, D]
    return torch.cos(emb), torch.sin(emb)


def apply_rope(q, k, cos, sin, position_offset=0):
    """q, k: ``[B, S, H, D]``; rotate-half in float32. ``position_offset``
    is a scalar (shared offset) or a ``[B]`` tensor (per-slot positions of
    the continuous-batching decode step)."""
    s = q.shape[1]
    if isinstance(position_offset, torch.Tensor) and position_offset.dim() == 1:
        # clamped into the table like the reference's jnp.take
        pos = (position_offset.to(device=cos.device, dtype=torch.long)[:, None]
               + torch.arange(s, device=cos.device)[None]).clamp(
                   max=cos.shape[0] - 1)
        cos_t = cos[pos][:, :, None, :]                  # [B, S, 1, D]
        sin_t = sin[pos][:, :, None, :]
    else:
        off = int(position_offset)
        cos_t = cos[off:off + s][None, :, None, :]
        sin_t = sin[off:off + s][None, :, None, :]

    def rot(x):
        x32 = x.float()
        half = x.shape[-1] // 2
        x1, x2 = x32[..., :half], x32[..., half:]
        rotated = torch.cat([-x2, x1], dim=-1)
        return (x32 * cos_t + rotated * sin_t).to(x.dtype)
    return rot(q), rot(k)


#: greedy decode steps between two reads of the finished flags (with an
#: eos id): the host waits on the device once a window, not once a token
GEN_WINDOW = 16


class StaticKVCache:
    """Per-layer KV buffers ``[B, T, H, D]`` written IN PLACE at the step's
    position offset (the reference writes them functionally)."""

    __slots__ = ("k", "v")

    def __init__(self, k, v):
        self.k, self.v = k, v


class PagedKVCache:
    """Paged KV cache: physical pools ``k``/``v [num_blocks, Hkv,
    block_size, D]``, ``block_tables [B, max_blocks]`` (-1 = unallocated)
    and ``seq_lens [B]`` tokens already cached. ``q_lens [B]`` marks a
    mixed step (seq len > 1): how many of each slot's rows are real. Both
    steps update the pools in place. ``quant`` ("int8"/"int4") marks
    quantized pools: int8 payload ``[num_blocks, Hkv, block_size,
    kv_packed_dim(D)]`` with float32 ``k_scale``/``v_scale [num_blocks,
    Hkv]``, also updated in place."""

    __slots__ = ("k", "v", "block_tables", "seq_lens", "q_lens",
                 "k_scale", "v_scale", "quant")

    def __init__(self, k, v, block_tables, seq_lens, q_lens=None,
                 k_scale=None, v_scale=None, quant=None):
        self.k, self.v = k, v
        self.block_tables, self.seq_lens = block_tables, seq_lens
        self.q_lens = q_lens
        self.k_scale, self.v_scale = k_scale, v_scale
        self.quant = quant


class SlotKVCache:
    """Per-slot KV buffers ``k``/``v [B, capacity, Hkv, D]`` of the dense
    engine with per-slot lengths ``lens [B]``: a step writes slot ``b``'s
    ``s`` new rows at ``lens[b]`` and row ``i`` attends positions ``<=
    lens[b] + i``. The buffers are updated in place; the engine, not the
    model, advances ``lens``."""

    __slots__ = ("k", "v", "lens")

    def __init__(self, k, v, lens):
        self.k, self.v, self.lens = k, v, lens


class ChunkKVCache:
    """The dense engine's cache under the fused scheduler's mixed step:
    slot buffers ``k``/``v [B, capacity, Hkv, D]``, ``lens [B]`` tokens
    cached, ``q_lens [B]`` real rows of the step's ``s``. Row ``i`` of slot
    ``b`` writes position ``lens[b] + i`` only while ``i < q_lens[b]`` and
    the position is inside the buffer; padding and past-capacity rows are
    dropped. Row ``i`` attends positions ``<= lens[b] + i``."""

    __slots__ = ("k", "v", "lens", "q_lens")

    def __init__(self, k, v, lens, q_lens):
        self.k, self.v, self.lens, self.q_lens = k, v, lens, q_lens


def _window_causal_mask(s, T):
    """The additive float32 mask of a per-slot window, the one copy both
    dense branches use: row ``i`` of slot ``b`` sits at ``lens[b] + i`` and
    sees positions up to it (0), nothing after (-1e30). Returns
    ``mask_fn(lens) -> [B, 1, s, T]``."""
    def mask_fn(lens):
        rows = lens.to(torch.long)[:, None, None, None] + torch.arange(
            s, device=lens.device)[None, None, :, None]
        valid = torch.arange(T, device=lens.device)[None, None, None, :] \
            <= rows
        return torch.where(valid, 0.0, -1e30).to(torch.float32)
    return mask_fn


def _slot_write(buf, new, lens):
    """Slot ``b``'s rows ``new[b]`` into ``buf[b]`` from ``lens[b]``, the
    start clamped to ``[0, T - s]`` as the reference's dynamic update
    clamps it (a slot past its end overwrites its own last rows)."""
    b, s = new.shape[:2]
    start = lens.to(torch.long).clamp(0, buf.shape[1] - s)
    pos = start[:, None] + torch.arange(s, device=buf.device)[None]
    bidx = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    buf[bidx, pos] = new.to(buf.dtype)


def _chunk_write(buf, new, lens, q_lens):
    """Row ``i`` of ``new[b]`` into ``buf[b, lens[b] + i]`` while ``i <
    q_lens[b]`` and the position is inside the buffer; other rows drop.
    A boolean selection would read its count back from the card, so every
    row writes instead: to its position clamped into the buffer, with the
    value that position holds once the real rows are in (a real row's, or
    the buffer's own). Rows sharing a position carry equal values."""
    b, s = new.shape[:2]
    T = buf.shape[1]
    lens = lens.to(torch.long)[:, None]
    tgt = (lens + torch.arange(s, device=buf.device)[None]).clamp(max=T - 1)
    rel = tgt - lens
    fresh = (rel >= 0) & (rel < q_lens.to(torch.long)[:, None])
    bidx = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    src = new.gather(1, rel.clamp(0, s - 1)[:, :, None, None]
                     .expand(new.shape))
    buf[bidx, tgt] = torch.where(fresh[:, :, None, None],
                                 src.to(buf.dtype), buf[bidx, tgt])


def _to_device(t, dev):
    """CPU tensor ``t`` on ``dev`` without blocking the host: on the card
    it goes up from a pinned copy."""
    if torch.device(dev).type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _softmax(x):
    """``exp(x - max) / sum`` along the last axis, the reference's
    ``jax.nn.softmax`` operation for operation (torch's fused softmax
    multiplies by the reciprocal of the sum instead)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _nucleus_cutoff(sorted_desc, top_p_val):
    """The smallest logit of the minimal prefix of ``sorted_desc`` (each
    row sorted descending) whose mass reaches ``top_p_val``: a position
    survives while the mass BEFORE it is still below ``top_p_val``."""
    probs = _softmax(sorted_desc)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p_val
    return torch.where(keep, sorted_desc, float("inf")).amin(
        dim=-1, keepdim=True)


def _filter_logits(logits, temp_val, top_k, top_p_val, use_top_p=True):
    """The temperature / top-k / top-p filter (reference ``llama.py:
    243-286``): scale by ``temp_val`` in float32, mask below the k-th
    largest logit, then mask below the nucleus cutoff of the surviving
    distribution. ``temp_val`` and ``top_p_val`` are float32 tensors that
    broadcast against the logits' leading dimensions (``[B, 1]`` per row,
    or 0-d); ``top_k`` and ``use_top_p`` are static.

    With ``0 < top_k < V`` one ``torch.topk`` serves both cuts: the
    nucleus is computed over the k-slice. As in the reference, with EXACT
    ties at the k-th value the ``< kth`` mask keeps every tied entry while
    the slice normalizes over exactly k (a measure-zero divergence for
    real logits). Without top-k the nucleus runs over a full descending
    sort."""
    logits = logits.float() / temp_val
    V = logits.shape[-1]
    if top_k and 0 < int(top_k) < V:
        vals = torch.topk(logits, int(top_k), dim=-1).values
        logits = logits.masked_fill(logits < vals[..., -1:], float("-inf"))
        if use_top_p:
            logits = logits.masked_fill(
                logits < _nucleus_cutoff(vals, top_p_val), float("-inf"))
        return logits
    if use_top_p:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        logits = logits.masked_fill(
            logits < _nucleus_cutoff(sorted_desc, top_p_val), float("-inf"))
    return logits


def _sample_logits_device(logits, key, temp_val, top_k, top_p_val, greedy,
                          use_top_p):
    """The sampling head (reference ``llama.py:288-300``): the argmax when
    ``greedy``, else a categorical draw under ``key`` from the filtered
    logits. ``key [*K, 2]`` covers ``logits [*K, *S, V]`` (one key for a
    whole ``[B, V]`` batch in ``generate``, one per row in the engine).
    Returns int64 token ids ``[*K, *S]``; nothing here reads the device."""
    if greedy:
        return torch.argmax(logits.float(), dim=-1)
    filtered = _filter_logits(logits, temp_val, top_k, top_p_val, use_top_p)
    return prng.categorical(key, filtered)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.fused = bool(c.fuse_attention_qkv)
        kw = dict(device=device, dtype=dtype, generator=generator)
        if self.fused:
            self.qkv_proj = Linear(
                c.hidden_size,
                (self.num_heads + 2 * self.num_kv_heads) * self.head_dim,
                bias_attr=False, **kw)
        else:
            self.q_proj = Linear(c.hidden_size,
                                 self.num_heads * self.head_dim,
                                 bias_attr=False, **kw)
            self.k_proj = Linear(c.hidden_size,
                                 self.num_kv_heads * self.head_dim,
                                 bias_attr=False, **kw)
            self.v_proj = Linear(c.hidden_size,
                                 self.num_kv_heads * self.head_dim,
                                 bias_attr=False, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, c.hidden_size,
                             bias_attr=False, **kw)

    def forward(self, x, rope_cache, attn_mask=None, kv_cache=None,
                position_offset=0):
        b, s = x.shape[0], x.shape[1]
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        if self.fused:
            q, k, v = self.qkv_proj(x).split([H * D, Hkv * D, Hkv * D], -1)
            # the kernels take contiguous tensors (rope copies q and k)
            q, k = q.reshape(b, s, H, D), k.reshape(b, s, Hkv, D)
            v = v.reshape(b, s, Hkv, D).contiguous()
        else:
            q = self.q_proj(x).view(b, s, H, D)
            k = self.k_proj(x).view(b, s, Hkv, D)
            v = self.v_proj(x).view(b, s, Hkv, D)
        cos, sin = rope_cache
        q, k = apply_rope(q, k, cos, sin, position_offset)
        if isinstance(kv_cache, PagedKVCache):
            kvq = kv_cache.quant
            qargs = dict(cache_k_quant_scales=kv_cache.k_scale,
                         cache_v_quant_scales=kv_cache.v_scale,
                         cache_quant_type=kvq) if kvq else {}
            if s != 1:
                # fused mixed step: S rows per slot, q_lens of them real —
                # the append form of the op (the paged-append kernel)
                if kv_cache.q_lens is None:
                    raise ValueError(
                        "PagedKVCache with seq len > 1 is the fused append "
                        "step and needs per-slot q_lens")
                qkv = torch.cat([q.reshape(b, s, H * D),
                                 k.reshape(b, s, Hkv * D),
                                 v.reshape(b, s, Hkv * D)], dim=-1)
                outs = IF.block_multihead_attention(
                    qkv, kv_cache.k, kv_cache.v, None, kv_cache.seq_lens,
                    kv_cache.q_lens, block_tables=kv_cache.block_tables,
                    **qargs)
                out = self.o_proj(outs[0].view(b, s, H * D))
                return out, PagedKVCache(
                    outs[1], outs[2], kv_cache.block_tables,
                    kv_cache.seq_lens + kv_cache.q_lens, kv_cache.q_lens,
                    *(outs[3:] if kvq else (None, None)), quant=kvq)
            qkv = torch.cat([q.reshape(b, H * D), k.reshape(b, Hkv * D),
                             v.reshape(b, Hkv * D)], dim=-1)
            outs = IF.block_multihead_attention(
                qkv, kv_cache.k, kv_cache.v, None, kv_cache.seq_lens, None,
                block_tables=kv_cache.block_tables, **qargs)
            out = self.o_proj(outs[0].view(b, 1, H * D))
            return out, PagedKVCache(
                outs[1], outs[2], kv_cache.block_tables,
                kv_cache.seq_lens + 1, None,
                *(outs[3:] if kvq else (None, None)), quant=kvq)
        if isinstance(kv_cache, StaticKVCache):
            off = int(position_offset)
            T = kv_cache.k.shape[1]
            if off + s > T:
                raise ValueError(f"write [{off}, {off + s}) past the "
                                 f"static cache's {T} positions")
            kv_cache.k[:, off:off + s] = k.to(kv_cache.k.dtype)
            kv_cache.v[:, off:off + s] = v.to(kv_cache.v.dtype)
            # causal against the absolute position: row i may see cached
            # and current positions <= off + i
            rows = off + torch.arange(s, device=x.device)
            valid = torch.arange(T, device=x.device)[None, None, None, :] \
                <= rows[None, None, :, None]
            mask = torch.where(valid, 0.0, -1e30).to(torch.float32)
            out = F.scaled_dot_product_attention(
                q, kv_cache.k, kv_cache.v, attn_mask=mask, is_causal=False,
                training=self.training)
            out = self.o_proj(out.reshape(b, s, H * D))
            return out, kv_cache
        if isinstance(kv_cache, (ChunkKVCache, SlotKVCache)):
            # the dense engine's step: the slot buffers take this step's
            # rows in place, then masked attention against each row's own
            # absolute position (the plain math, as in the reference)
            if isinstance(kv_cache, ChunkKVCache):
                _chunk_write(kv_cache.k, k, kv_cache.lens, kv_cache.q_lens)
                _chunk_write(kv_cache.v, v, kv_cache.lens, kv_cache.q_lens)
            else:
                _slot_write(kv_cache.k, k, kv_cache.lens)
                _slot_write(kv_cache.v, v, kv_cache.lens)
            mask = _window_causal_mask(s, kv_cache.k.shape[1])(kv_cache.lens)
            out = F.scaled_dot_product_attention(
                q, kv_cache.k, kv_cache.v, attn_mask=mask, is_causal=False,
                training=self.training)
            return self.o_proj(out.reshape(b, s, H * D)), kv_cache
        if kv_cache is not None:
            if not isinstance(kv_cache, tuple):
                raise TypeError(
                    f"unknown kv cache {type(kv_cache).__name__}")
            k = torch.cat([kv_cache[0], k], dim=1)
            v = torch.cat([kv_cache[1], v], dim=1)
            kv_cache = (k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=(attn_mask is None),
            training=self.training)
        out = self.o_proj(out.reshape(b, s, H * D))
        return (out, kv_cache) if kv_cache is not None else out


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        c = config
        self.fused = bool(c.fuse_swiglu)
        self._ff = c.intermediate_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        if self.fused:
            self.gate_up_proj = Linear(c.hidden_size, 2 * c.intermediate_size,
                                       bias_attr=False, **kw)
        else:
            self.gate_proj = Linear(c.hidden_size, c.intermediate_size,
                                    bias_attr=False, **kw)
            self.up_proj = Linear(c.hidden_size, c.intermediate_size,
                                  bias_attr=False, **kw)
        self.down_proj = Linear(c.intermediate_size, c.hidden_size,
                                bias_attr=False, **kw)

    def forward(self, x):
        if self.fused:
            gate, up = self.gate_up_proj(x).split(self._ff, -1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.swiglu(gate, up))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.self_attn = LlamaAttention(config, **kw)
        self.mlp = LlamaMLP(config, **kw)
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                       device=device, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, device=device,
            dtype=dtype)

    def forward(self, x, rope_cache, attn_mask=None, kv_cache=None,
                position_offset=0):
        if kv_cache is not None:
            attn_out, new_cache = self.self_attn(
                self.input_layernorm(x), rope_cache, attn_mask, kv_cache,
                position_offset)
            x = x + attn_out
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, new_cache
        x = x + self.self_attn(self.input_layernorm(x), rope_cache, attn_mask)
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device=device, dtype=dtype,
                                      generator=generator)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(config, device=device, dtype=dtype,
                              generator=generator)
            for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)
        self.register_buffer("rope_cos", None, persistent=False)
        self.register_buffer("rope_sin", None, persistent=False)
        self.reset_rope()

    def reset_rope(self):
        """(Re)compute the non-persistable rope tables on the model's
        device."""
        c = self.config
        cos, sin = precompute_rope(c.hidden_size // c.num_attention_heads,
                                   c.max_position_embeddings, c.rope_theta,
                                   device=self.norm.weight.device)
        self.rope_cos, self.rope_sin = cos, sin

    def forward(self, input_ids, attn_mask=None, kv_caches=None,
                position_offset=0):
        x = self.embed_tokens(input_ids.long())
        rope = (self.rope_cos, self.rope_sin)
        if kv_caches is not None:
            new_caches = []
            for layer, cache in zip(self.layers, kv_caches):
                x, c = layer(x, rope, attn_mask, cache, position_offset)
                new_caches.append(c)
            return self.norm(x), new_caches
        remat = self.config.use_recompute and self.training
        for layer in self.layers:
            if remat:
                x = recompute(layer, x, rope, attn_mask,
                              checkpoint_policy=self.config.recompute_policy)
            else:
                x = layer(x, rope, attn_mask)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM on ``device`` (default: the card; ``"cpu"`` only
    when asked for), parameters in ``config.dtype``, initialized from a
    generator seeded with ``seed``."""

    def __init__(self, config: LlamaConfig, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        dtype = convert_dtype(config.dtype)
        gen = make_generator(seed, dev)
        self.config = config
        self.llama = LlamaModel(config, device=dev, dtype=dtype, generator=gen)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False, device=dev, dtype=dtype,
                                  generator=gen)

    @property
    def device(self):
        return self.llama.norm.weight.device

    def _logits(self, hidden):
        if self.config.tie_word_embeddings:
            return torch.matmul(hidden, self.llama.embed_tokens.weight.t())
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None, attn_mask=None):
        hidden = self.llama(input_ids, attn_mask)
        logits = self._logits(hidden)
        if labels is None:
            return logits
        # no float32 pre-cast: the fused CE accumulates its lse in float32
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1), ignore_index=-100)
        return loss, logits

    def flops_per_token(self, seq_len):
        """Model FLOPs per token (forward + backward = 3x forward) for MFU
        accounting, as the reference counts them (``llama.py:848-859``)."""
        c = self.config
        d, L = c.hidden_size, c.num_hidden_layers
        ff = c.intermediate_size
        per_layer = (
            2 * d * d * (1 + 2 * c.num_key_value_heads / c.num_attention_heads
                         + 1)
            + 2 * 2 * d * seq_len / 2   # attention scores + values, causal half
            + 2 * 3 * d * ff
        )
        embed = 2 * d * c.vocab_size
        return 3 * (L * per_layer + embed)

    def _gen_programs(self, B, prompt_len, limit, total, temperature, top_k,
                      top_p, eos_token_id, cache_impl, block_size):
        """The two generation programs (reference ``llama.py:649-776``),
        built once per key and cached on the model:

        - ``prefill(ids [B, prompt_len])`` -> ``(logits [B, V], k_bufs,
          v_bufs)``: embed, every layer with empty tuple caches (the
          causal forward, so the flash kernel at bf16 D 64/128), the
          last position's logits, and each layer's K/V laid out as the
          decode's caches: ``StaticKVCache`` buffers ``[B, total, Hkv,
          D]``, or paged pools ``[B * mb + 1, Hkv, block_size, D]`` in
          which logical block ``i`` of sequence ``b`` is physical block
          ``b * mb + i`` (``mb = ceil(total / block_size)``; the trailing
          block is the paged kernels' scratch target, which no table
          entry names);
        - ``decode(k_bufs, v_bufs, logits, rng_key, temp_val,
          top_p_val)`` -> ``(buf [B, limit] int64, n)``: the decode loop
          over the caches it is given (updated in place), ``buf[:, :n]``
          the tokens. Each step samples from the carried logits: the
          argmax when greedy, else ``rng_key, sub = split(rng_key)`` and
          one categorical draw over the whole ``[B, V]`` batch under
          ``sub`` from the filtered logits (reference ``:739-745``).

        Both run eagerly on the model's device under ``no_grad``. The
        program structure (greedy or not, ``top_k``, the nucleus on or
        off) keys the cache; the temperature and ``top_p`` values are
        decode arguments."""
        greedy = float(temperature) <= 0.0
        use_top_p = bool(top_p) and float(top_p) < 1.0
        key = (B, prompt_len, limit, total, greedy, int(top_k), use_top_p,
               eos_token_id, cache_impl, int(block_size))
        cache = getattr(self, "_gen_cache", None)
        if cache is None:
            cache = self._gen_cache = {}
        if key in cache:
            return cache[key]

        c = self.config
        D = c.hidden_size // c.num_attention_heads
        Hkv, L = c.num_key_value_heads, c.num_hidden_layers
        paged = cache_impl == "paged"
        bs = int(block_size)
        mb = -(-total // bs)
        dev = self.device
        dt = self.llama.embed_tokens.weight.dtype
        tables = torch.arange(B * mb, dtype=torch.int32,
                              device=dev).view(B, mb) if paged else None

        def lay_out(t):
            """One layer's prompt K or V ``[B, prompt_len, Hkv, D]`` as the
            decode's cache (reference ``:701-721``)."""
            if not paged:
                buf = torch.zeros((B, total, Hkv, D), dtype=t.dtype,
                                  device=dev)
                buf[:, :prompt_len] = t
                return buf
            rows = torch.zeros((B, mb * bs, Hkv, D), dtype=t.dtype,
                               device=dev)
            rows[:, :prompt_len] = t
            pool = torch.zeros((B * mb + 1, Hkv, bs, D), dtype=t.dtype,
                               device=dev)
            pool[:B * mb] = rows.view(B, mb, bs, Hkv, D).transpose(2, 3) \
                .reshape(B * mb, Hkv, bs, D)
            return pool

        @torch.no_grad()
        def prefill(ids):
            ids = ids.to(device=dev, dtype=torch.long)
            empty = [(torch.zeros((B, 0, Hkv, D), dtype=dt, device=dev),
                      torch.zeros((B, 0, Hkv, D), dtype=dt, device=dev))
                     for _ in range(L)]
            hidden, grown = self.llama(ids, kv_caches=empty,
                                       position_offset=0)
            logits = self._logits(hidden[:, -1:])[:, 0]
            return (logits, [lay_out(k) for k, _ in grown],
                    [lay_out(v) for _, v in grown])

        def one_token(tok, off, k_bufs, v_bufs):
            """One model step on ``tok [B]`` at position ``off``; the caches
            update in place. Returns the next logits."""
            if paged:
                lens = torch.full((B,), off, dtype=torch.int32, device=dev)
                caches = [PagedKVCache(k, v, tables, lens)
                          for k, v in zip(k_bufs, v_bufs)]
            else:
                caches = [StaticKVCache(k, v) for k, v in zip(k_bufs, v_bufs)]
            hidden, _ = self.llama(tok[:, None], kv_caches=caches,
                                   position_offset=off)
            return self._logits(hidden)[:, 0]

        eos = eos_token_id

        @torch.no_grad()
        def decode(k_bufs, v_bufs, logits, rng_key=None, temp_val=None,
                   top_p_val=None):
            # The reference's while_loop runs body i (sample, latch, write
            # buf[:, i], one step) while i < limit and, with eos, not every
            # row has finished: it returns n = the first i + 1 after which
            # every row had finished, else limit. Here the loop runs in
            # windows of GEN_WINDOW steps and reads the finished flags once
            # a window: n is the first step of the window whose flags show
            # every row finished, plus one. Steps run past n in that window
            # only append eos to finished rows and are cut off, so buf[:, :n]
            # is the reference's buffer. No step after the last token runs:
            # its logits would not be read.
            buf = torch.zeros((B, limit), dtype=torch.int64, device=dev)
            finished = torch.zeros((B,), dtype=torch.bool, device=dev)
            i = 0
            while i < limit:
                end = min(i + GEN_WINDOW, limit)
                all_done = []
                for j in range(i, end):
                    if greedy:
                        nxt = torch.argmax(logits.float(), dim=-1)
                    else:
                        rng_key, sub = prng.split(rng_key)
                        nxt = _sample_logits_device(
                            logits, sub, temp_val, int(top_k), top_p_val,
                            False, use_top_p)
                    if eos is not None:
                        nxt = nxt.masked_fill(finished, eos)
                        finished = finished | (nxt == eos)
                        all_done.append(finished.all())
                    buf[:, j] = nxt
                    if j + 1 < limit:
                        logits = one_token(nxt, prompt_len + j, k_bufs,
                                           v_bufs)
                if eos is not None:
                    # the window's one read of the device
                    flags = torch.stack(all_done).cpu().numpy()
                    if flags.any():
                        return buf, i + int(np.argmax(flags)) + 1
                i = end
            return buf, limit

        cache[key] = (prefill, decode)
        return cache[key]

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, cache_impl="static",
                 block_size=64):
        """Autoregressive decoding (reference ``llama.py:778-846``):
        one prefill over the prompt, then one token a step through
        :class:`StaticKVCache` buffers (``cache_impl="static"``: masked
        plain attention, as the reference) or paged pools of
        ``block_size``-token blocks (``"paged"``: the paged-decode kernel
        through ``block_multihead_attention``). Returns an int64 tensor
        ``[B, n]`` on the model's device: ``n`` is ``max_new_tokens``
        capped at the rope table's end (with a ``RuntimeWarning``), or
        fewer when every row has emitted ``eos_token_id``, after which a
        row emits only ``eos_token_id``. The decode reads the device once
        every ``GEN_WINDOW`` steps with ``eos_token_id``, and never
        without it. ``temperature <= 0`` is greedy; otherwise each step
        draws from the temperature / ``top_k`` / ``top_p`` filtered logits
        under threefry keys split from ``fold_in(PRNGKey(seed), counter)``
        of ``default_generator.next_seed()``, which every call that
        decodes advances, greedy or not, as the reference's does."""
        c = self.config
        dev = self.device
        ids = input_ids if isinstance(input_ids, torch.Tensor) \
            else torch.as_tensor(np.asarray(input_ids))
        B, prompt_len = int(ids.shape[0]), int(ids.shape[1])
        if prompt_len >= c.max_position_embeddings:
            raise ValueError(
                f"prompt length {prompt_len} >= max_position_embeddings "
                f"{c.max_position_embeddings}: no positions left to decode")
        if cache_impl not in ("static", "paged"):
            raise ValueError(f"unknown cache_impl {cache_impl!r}")
        limit = min(int(max_new_tokens),
                    c.max_position_embeddings - prompt_len)
        if limit < int(max_new_tokens):
            warnings.warn(
                f"generate: capping max_new_tokens {max_new_tokens} -> "
                f"{limit} (rope table ends at position "
                f"{c.max_position_embeddings})", RuntimeWarning,
                stacklevel=2)
        if limit <= 0:
            return torch.zeros((B, 0), dtype=torch.int64, device=dev)
        seed, counter = _random.default_generator.next_seed()
        sample = ()
        if float(temperature) > 0.0:
            # the key and the two values go up once, from pinned copies
            sample = (
                _to_device(prng.fold_in(prng.PRNGKey(seed), counter), dev),
                _to_device(torch.tensor(max(float(temperature), 1e-6),
                                        dtype=torch.float32), dev),
                _to_device(torch.tensor(float(top_p), dtype=torch.float32),
                           dev))
        was_training = self.training
        self.eval()
        try:
            prefill, decode = self._gen_programs(
                B, prompt_len, limit, prompt_len + limit, temperature,
                top_k, top_p, eos_token_id, cache_impl, block_size)
            logits, k_bufs, v_bufs = prefill(ids)
            buf, n = decode(k_bufs, v_bufs, logits, *sample)
        finally:
            if was_training:
                self.train()
        return buf[:, :n]
