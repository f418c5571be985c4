"""Counterpart: ``paddle_tpu/incubate/nn/functional/__init__.py``
``block_multihead_attention`` (``:592-751``), its append form
``_block_mha_append`` (``:771-878``), and the quantized-pool rules
``_kv_quant_scatter`` (``:546``), ``_kv_quant_gather`` (``:583``) and
``_quant_head_dim`` (``:754``)."""
from __future__ import annotations

import torch

from ...core.flags import flag_value
from ...ops.kernels.paged_attention import (kernel_takes, kv_block_scale,
                                            kv_dequantize, kv_quantize,
                                            paged_attention_append,
                                            paged_attention_append_plain,
                                            paged_attention_decode,
                                            paged_attention_decode_plain)


def _kv_quant_scatter(pool, scales, wblk, slot, rows, quant, D, end_rows):
    """Merge new rows into a QUANTIZED block pool, IN PLACE: every block
    written dequantizes, takes its new rows, zeroes its rows at or past
    ``end_rows`` (stale content of a reused block must not inflate the
    scale), recomputes its per-(block, head) absmax scale and requantizes;
    every untouched block keeps its exact payload and scale. ``wblk``,
    ``slot``, ``rows [N, Hkv, D]`` and ``end_rows`` are flat write
    coordinates; ``wblk == pool.shape[0]`` drops the row (the decode
    form's -1-table contract); ``end_rows[i]`` is the live row COUNT of
    block ``wblk[i]`` after the write (equal for all rows of a block).
    Returns ``(pool, scales)``."""
    nb, _, bs, _ = pool.shape
    keep = wblk < nb
    wblk, slot, rows, end_rows = (x[keep] for x in (wblk, slot, rows,
                                                    end_rows))
    blocks, where = torch.unique(wblk, return_inverse=True)
    pf = kv_dequantize(pool[blocks], scales[blocks], quant, D)
    pf[where, :, slot] = rows.float()
    live_end = torch.zeros_like(blocks)
    live_end[where] = end_rows.to(live_end.dtype)
    dead = torch.arange(bs, device=pool.device)[None, :] >= live_end[:, None]
    pf = torch.where(dead[:, None, :, None], torch.zeros_like(pf), pf)
    s_new = kv_block_scale(pf, quant, (2, 3))                # [U, Hkv]
    pool[blocks] = kv_quantize(pf, s_new[..., None, None], quant)
    scales[blocks] = s_new
    return pool, scales


def _kv_quant_gather(pool, scales, safe_tables, quant, D):
    """Per-sequence logical KV off a QUANTIZED pool: the table's blocks
    dequantized with their scales, float32 ``[B, MB, Hkv, bs, D]``."""
    return kv_dequantize(pool[safe_tables], scales[safe_tables], quant, D)


def _quant_head_dim(qkv_width, Hkv, Dp, quant):
    """Head dim of a quantized-pool call from the qkv row width and the
    packed pool head dim ``Dp``: D = Dp for int8; 2*Dp for int4, or
    2*Dp - 1 when only that divides the width into a whole GQA head
    count."""
    if quant == "int8":
        return Dp
    D = 2 * Dp
    if qkv_width % D == 0 and (qkv_width // D - 2 * Hkv) > 0 \
            and (qkv_width // D - 2 * Hkv) % Hkv == 0:
        return D
    return D - 1


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

    Quantized pools (``cache_quant_type="int8"|"int4"``, int8 payload
    ``[num_blocks, Hkv, block_size, kv_packed_dim(D)]`` with float32
    ``cache_k_quant_scales``/``cache_v_quant_scales [num_blocks, Hkv]``):
    blocks dequantize on read, every written block is requantized under a
    fresh absmax scale, and the return grows the scale arrays:
    ``(out, key_cache, value_cache, k_scales, v_scales)``.

    The pools (and scales) are updated IN PLACE and returned for the
    reference's call shape. CUDA tensors run the paged kernels (B2/B3, or
    B4 on quantized pools) while the ``use_paged_attention`` flag is on and
    the kernels take the call (``paged_attention.kernel_takes``: dtypes,
    head dim, query heads per kv head, block size), a rule decided before
    anything launches; every other call runs their plain versions (the
    reference's dense-gather fallback), as every CPU call does."""
    if block_tables is None:
        raise ValueError("block_mha requires block_tables")
    quant = cache_quant_type
    if quant and (cache_k_quant_scales is None
                  or cache_v_quant_scales is None):
        raise ValueError("cache_quant_type needs cache_k_quant_scales and "
                         "cache_v_quant_scales ([num_blocks, Hkv] fp32)")
    _, Hkv, _, Dp = key_cache.shape
    D = _quant_head_dim(qkv.shape[-1], Hkv, Dp, quant) if quant else Dp
    qargs = dict(k_scale=cache_k_quant_scales, v_scale=cache_v_quant_scales,
                 quant=quant) if quant else {}
    Hq = qkv.shape[-1] // D - 2 * Hkv
    # the kernels' wrappers (which run the plain versions on the CPU) while
    # the flag is on and, on the card, the kernels take the call
    routed = flag_value("use_paged_attention") and (
        qkv.device.type == "cpu" or kernel_takes(
            qkv.dtype, key_cache.dtype, D, Hq // Hkv if Hq % Hkv == 0 else 0,
            key_cache.shape[2], quant))
    decode = paged_attention_decode if routed else \
        paged_attention_decode_plain
    append = paged_attention_append if routed else \
        paged_attention_append_plain
    tables = block_tables.to(torch.int32).contiguous()
    lens = seq_lens_decoder.to(torch.int32).contiguous()
    if qkv.dim() == 3:
        if seq_lens_this_time is None:
            raise ValueError("append-step block_mha (3-D qkv) requires "
                             "seq_lens_this_time (per-sequence q_lens)")
        b, S = qkv.shape[0], qkv.shape[1]
        q = qkv[:, :, :Hq * D].view(b, S, Hq, D)
        knew = qkv[:, :, Hq * D:(Hq + Hkv) * D].view(b, S, Hkv, D)
        vnew = qkv[:, :, (Hq + Hkv) * D:].view(b, S, Hkv, D)
        qlens = seq_lens_this_time.to(torch.int32).contiguous()
        res = append(q, key_cache, value_cache, tables, lens, qlens, knew,
                     vnew, **qargs)
        out = res[0] if quant else res
        out = out.reshape(b, S, Hq * D)
    else:
        b = qkv.shape[0]
        q = qkv[:, :Hq * D].view(b, Hq, D)
        knew = qkv[:, Hq * D:(Hq + Hkv) * D].view(b, Hkv, D)
        vnew = qkv[:, (Hq + Hkv) * D:].view(b, Hkv, D)
        res = decode(q, key_cache, value_cache, tables, lens, knew, vnew,
                     **qargs)
        out = res[0] if quant else res
        out = out.reshape(b, Hq * D)
    if quant:
        return (out, key_cache, value_cache, cache_k_quant_scales,
                cache_v_quant_scales)
    return out, key_cache, value_cache
