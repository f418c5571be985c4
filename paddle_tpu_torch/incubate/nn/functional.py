"""Counterpart: ``paddle_tpu/incubate/nn/functional/__init__.py``
``block_multihead_attention`` (``:592-751``) and its append form
``_block_mha_append`` (``:771-878``), unquantized."""
from __future__ import annotations

import torch

from ...ops.kernels.paged_attention import (paged_attention_append,
                                            paged_attention_decode)


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              block_tables=None, cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              cache_quant_type=None):
    """Paged-KV attention over the block pools, decode or append form.

    Decode form: ``qkv [B, (Hq + 2*Hkv)*D]`` splits into q, the new k and
    the new v; ``key_cache``/``value_cache [num_blocks, Hkv, block_size,
    D]`` are the physical pools (the last block is the scratch target of
    ``-1`` writes), ``block_tables [B, max_blocks]`` maps logical to
    physical blocks (-1 = unallocated), ``seq_lens_decoder [B]`` counts
    tokens already cached. Returns ``(out [B, Hq*D], key_cache,
    value_cache)``.

    Append form (the fused scheduler's mixed step): ``qkv [B, S,
    (Hq + 2*Hkv)*D]`` with ``seq_lens_this_time [B]`` = how many of the S
    rows are real for each sequence (0 = idle slot). Sequence b's rows sit
    at positions ``[seq_lens_decoder[b], seq_lens_decoder[b] +
    seq_lens_this_time[b])`` and attend causally to the pooled history
    plus their own chunk prefix; padding rows write nothing and their
    outputs are ignored. Returns ``(out [B, S, Hq*D], key_cache,
    value_cache)``.

    The pools are updated IN PLACE and returned for the reference's call
    shape. CUDA tensors run the paged-decode or paged-append kernel, CPU
    tensors their plain versions. Quantized pools are not in this port yet
    (ROADMAP B4)."""
    if block_tables is None:
        raise ValueError("block_mha requires block_tables")
    if cache_quant_type or cache_k_quant_scales is not None or \
            cache_v_quant_scales is not None:
        raise NotImplementedError(
            "quantized KV pools (int8/int4) are not ported yet: ROADMAP B4")
    _, Hkv, _, D = key_cache.shape
    tables = block_tables.to(torch.int32).contiguous()
    lens = seq_lens_decoder.to(torch.int32).contiguous()
    if qkv.dim() == 3:
        if seq_lens_this_time is None:
            raise ValueError("append-step block_mha (3-D qkv) requires "
                             "seq_lens_this_time (per-sequence q_lens)")
        b, S = qkv.shape[0], qkv.shape[1]
        Hq = qkv.shape[2] // D - 2 * Hkv
        q = qkv[:, :, :Hq * D].view(b, S, Hq, D)
        knew = qkv[:, :, Hq * D:(Hq + Hkv) * D].view(b, S, Hkv, D)
        vnew = qkv[:, :, (Hq + Hkv) * D:].view(b, S, Hkv, D)
        qlens = seq_lens_this_time.to(torch.int32).contiguous()
        out = paged_attention_append(q, key_cache, value_cache, tables, lens,
                                     qlens, knew, vnew)
        return out.reshape(b, S, Hq * D), key_cache, value_cache
    b = qkv.shape[0]
    Hq = qkv.shape[1] // D - 2 * Hkv
    q = qkv[:, :Hq * D].view(b, Hq, D)
    knew = qkv[:, Hq * D:(Hq + Hkv) * D].view(b, Hkv, D)
    vnew = qkv[:, (Hq + Hkv) * D:].view(b, Hkv, D)
    out = paged_attention_decode(q, key_cache, value_cache, tables, lens,
                                 knew, vnew)
    return out.reshape(b, Hq * D), key_cache, value_cache
