"""paddle_tpu_torch LlamaForCausalLM against paddle_tpu's on bridged
weights (CPU, float32, atol 2e-4), plus the bridge's strictness and the
port's own cache paths agreeing with its no-cache forward."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           PagedKVCache, StaticKVCache)

torch.set_num_threads(1)

GQA = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)


def _pair(cfg_kw, seed=7):
    paddle.seed(seed)
    jm = JLlama(JConfig(**cfg_kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**cfg_kw), device="cpu")
    tm.eval()
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("name", ["tiny", "gqa"])
def test_forward_logits_match_reference(name):
    kw = LlamaConfig.tiny().__dict__ if name == "tiny" else GQA
    jm, tm = _pair(dict(kw))
    ids = np.random.default_rng(0).integers(0, kw["vocab_size"], size=(2, 40))
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    # with labels: (loss, logits), -100 ignored
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    ref_loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(np.asarray(
        ref_loss.numpy())), atol=2e-4, rtol=0)


def test_cache_paths_agree_with_forward():
    """Chunked prefill through StaticKVCache, a paged one-token decode step
    and the tuple cache all reproduce the no-cache forward's logits."""
    _, tm = _pair(GQA)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (1, 21)))
    with torch.no_grad():
        full = tm(ids)[0]
        H, D = 2, 16
        static = [StaticKVCache(torch.zeros(1, 32, H, D),
                                torch.zeros(1, 32, H, D)) for _ in range(2)]
        h1, _ = tm.llama(ids[:, :16], kv_caches=static, position_offset=0)
        h2, _ = tm.llama(ids[:, 16:20], kv_caches=static, position_offset=16)
        np.testing.assert_allclose(tm._logits(h2)[0].numpy(),
                                   full[16:20].numpy(), atol=2e-4)
        # paged: the 20 cached positions in blocks [3, 0, 2] of a 4+1 pool
        bs = 8
        pools = []
        for c in static:
            kp = torch.zeros(5, H, bs, D)
            vp = torch.zeros(5, H, bs, D)
            for j, phys in enumerate([3, 0, 2]):
                kp[phys] = c.k[0, j * bs:(j + 1) * bs].transpose(0, 1)
                vp[phys] = c.v[0, j * bs:(j + 1) * bs].transpose(0, 1)
            pools.append((kp, vp))
        tables = torch.tensor([[3, 0, 2, -1]], dtype=torch.int32)
        lens = torch.tensor([20], dtype=torch.int32)
        paged = [PagedKVCache(k, v, tables, lens) for k, v in pools]
        h3, new = tm.llama(ids[:, 20:21], kv_caches=paged,
                           position_offset=lens)
        np.testing.assert_allclose(tm._logits(h3)[0, 0].numpy(),
                                   full[20].numpy(), atol=2e-4)
        assert int(new[0].seq_lens[0]) == 21
        empty = [(torch.zeros(1, 0, H, D), torch.zeros(1, 0, H, D))] * 2
        h4, grown = tm.llama(ids, kv_caches=empty, position_offset=0)
        assert grown[0][0].shape == (1, 21, H, D)
        np.testing.assert_allclose(tm._logits(h4)[0].numpy(), full.numpy(),
                                   atol=2e-4)


def test_bridge_is_strict():
    jm, tm = _pair(GQA)
    params = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    with pytest.raises(KeyError, match="missing"):
        load_reference_params(tm, {k: v for k, v in params.items()
                                   if k != "lm_head.weight"})
    with pytest.raises(KeyError, match="extra"):
        load_reference_params(tm, {**params, "llama.bogus": params[
            "lm_head.weight"]})
    bad = dict(params)
    bad["lm_head.weight"] = bad["lm_head.weight"].T
    with pytest.raises(ValueError, match="lm_head.weight"):
        load_reference_params(tm, bad)
    # rope tables are recomputed, not copied (non-persistable buffers)
    tm.llama.rope_cos.zero_()
    load_reference_params(tm, params)
    assert float(tm.llama.rope_cos[0, 0]) == 1.0


@pytest.mark.parametrize("flag", ["fuse_attention_qkv", "fuse_swiglu"])
def test_unported_options_raise(flag):
    """The fused projections are ported: a fused model holding the
    unfused one's weights, concatenated along the output dimension
    (``[q | k | v]``, ``[gate | up]``), gives its logits (float32, atol
    1e-5: the same products, summed in one order), and its greedy and
    sampled ``generate`` the same tokens (sampled: both from one
    ``default_generator`` state)."""
    plain = LlamaForCausalLM(LlamaConfig(**GQA), device="cpu")
    fused = LlamaForCausalLM(LlamaConfig(**GQA, **{flag: True}),
                             device="cpu")
    own = dict(plain.named_parameters())
    params = {}
    for n, p in fused.named_parameters():
        parts = {"qkv_proj": ("q_proj", "k_proj", "v_proj"),
                 "gate_up_proj": ("gate_proj", "up_proj")}
        key = next((k for k in parts if f".{k}." in n), None)
        params[n] = (np.concatenate([own[n.replace(key, part)].detach()
                                     .numpy() for part in parts[key]], -1)
                     if key else own[n].detach().numpy())
    load_reference_params(fused, params)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (2, 24)))
    with torch.no_grad():
        np.testing.assert_allclose(fused(ids).numpy(), plain(ids).numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(
            fused.generate(ids[:, :8], max_new_tokens=6).numpy(),
            plain.generate(ids[:, :8], max_new_tokens=6).numpy())
    sampled = []
    for m in (fused, plain):
        trandom.default_generator.set_state((2, 0))
        sampled.append(m.generate(ids[:, :8], max_new_tokens=6,
                                  temperature=0.5, top_k=20).numpy())
    np.testing.assert_array_equal(*sampled)
