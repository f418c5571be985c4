"""paddle_tpu_torch LLMEngine(cache_impl="paged", scheduler="legacy")
against paddle_tpu's engine with the same arguments, on bridged weights:
greedy and sampled streams must be TOKEN-EXACT, with the same finish
reasons. Sampled cases set both packages' ``default_generator`` to one
state first, so an engine without ``sampling_seed`` derives the same base
key in both. CPU, float32, the models of tests/test_llm_engine.py (2
layers, hidden 64, vocab 96) in GQA (4 heads over 2 kv heads) and MHA
form."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random as jrandom
from paddle_tpu.inference.llm_engine import (
    LLMEngine as JEngine, PoolCapacityError as JPoolCapacityError)
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.inference import LLMEngine, PoolCapacityError
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)


def _models(kvh):
    kw = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=kvh, max_position_embeddings=128)
    paddle.seed(7)
    jm = JLlama(JConfig(**kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def gqa():
    return _models(2)


@pytest.fixture(scope="module")
def mha():
    return _models(4)


def _kw(**over):
    kw = dict(cache_impl="paged", scheduler="legacy", max_batch=2,
              max_seq_len=64, chunk_size=16, block_size=8)
    kw.update(over)
    return kw


def _serve(engine, requests):
    """Submit ``(prompt, kwargs)`` pairs, drain, return [(tokens, reason)]."""
    rids = [engine.add_request(p, **kw) for p, kw in requests]
    while engine.has_unfinished():
        engine.step()
    return [(list(engine.finished_outputs[r].token_ids),
             engine.finished_outputs[r].finish_reason) for r in rids]


def _both(models, requests, **engine_kw):
    jm, tm = models
    ref_eng = JEngine(jm, **_kw(**engine_kw))
    eng = LLMEngine(tm, device="cpu", **_kw(**engine_kw))
    ref = _serve(ref_eng, requests)
    out = _serve(eng, requests)
    return ref, out, ref_eng, eng


def _seed_both(state):
    """Both packages' global generators at one (seed, counter) state."""
    jrandom.default_generator.set_state(state)
    trandom.default_generator.set_state(state)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, size=(n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("which", ["gqa", "mha"])
def test_ragged_prompts_more_requests_than_slots(which, request):
    """Prompts crossing chunk (16) and block (8) boundaries, 6 requests
    through 2 slots: slots are reused as requests retire."""
    prompts = _prompts(31, (9, 17, 5, 30, 16, 33))
    reqs = [(p, dict(max_new_tokens=8)) for p in prompts]
    ref, out, _, eng = _both(request.getfixturevalue(which), reqs)
    assert out == ref
    assert all(r == "length" for _, r in out)
    assert eng.stats["prefill_chunks"] == sum(-(-len(p) // 16)
                                              for p in prompts)
    assert len(eng._free_blocks) == eng.n_blocks
    assert (eng._tables == -1).all()
    # the stream callback sees every token, in order, per request
    seen = {}
    streamer = LLMEngine(request.getfixturevalue(which)[1], device="cpu",
                         stream_callback=lambda rid, tok: seen.setdefault(
                             rid, []).append(tok), **_kw())
    outs = streamer.generate(prompts[:3], max_new_tokens=8)
    assert [seen[o.request_id] for o in outs] == [t for t, _ in ref[:3]]


def test_eos_and_budgets(gqa):
    """Per-request budgets and an eos that occurs mid-stream, with a
    horizon of 4 (eos and budget deactivate inside a step)."""
    prompts = _prompts(4, (6, 12, 21))
    probe = _serve(JEngine(gqa[0], **_kw()),
                   [(prompts[0], dict(max_new_tokens=12))])
    eos = probe[0][0][3]
    reqs = [(prompts[0], dict(max_new_tokens=12, eos_token_id=eos)),
            (prompts[1], dict(max_new_tokens=3)),
            (prompts[2], dict(max_new_tokens=10, eos_token_id=eos))]
    ref, out, _, _ = _both(gqa, reqs, horizon=4)
    assert out == ref
    assert out[0][1] == "eos" and out[0][0][-1] == eos
    assert out[1] == (ref[1][0], "length") and len(out[1][0]) == 3


def test_pool_pressure_preempts_and_stays_exact(gqa):
    """A pool of 8 blocks (64 tokens) under two 25+ token prompts: the
    newest slot is preempted and re-prefills; streams stay token-exact."""
    reqs = [(p, dict(max_new_tokens=10)) for p in _prompts(33, (25, 27))]
    ref, out, ref_eng, eng = _both(gqa, reqs, kv_pool_blocks=8, horizon=4)
    assert out == ref
    assert eng.stats["preemptions"] == ref_eng.stats["preemptions"] >= 1
    assert len(eng._free_blocks) == 8


def test_newest_self_preempts_then_finishes(gqa):
    """Pool of 6 blocks: the newer request hits the dry pool while the
    older decodes, self-preempts, and still reaches its full budget."""
    p0, p1 = _prompts(36, (26, 15))
    reqs = [(p0, dict(max_new_tokens=5)), (p1, dict(max_new_tokens=24))]
    ref, out, ref_eng, eng = _both(gqa, reqs, kv_pool_blocks=6, horizon=1)
    assert out == ref
    assert out[1][1] == "length" and len(out[1][0]) == 24
    assert eng.stats["preemptions"] == ref_eng.stats["preemptions"] >= 1


def test_pool_capacity_error_and_pool_edge(gqa):
    """A prompt whose chunk-rounded prefill needs more blocks than the
    pool holds raises PoolCapacityError; a lone sequence that outgrows a
    barely-large-enough pool retires 'preempted_pool' with the same
    prefix as the reference."""
    (p,) = _prompts(35, (17,))
    jm, tm = gqa
    with pytest.raises(JPoolCapacityError):
        JEngine(jm, **_kw(kv_pool_blocks=3)).generate([p], max_new_tokens=30)
    with pytest.raises(PoolCapacityError, match="kv_pool_blocks too small"):
        LLMEngine(tm, device="cpu", **_kw(kv_pool_blocks=3)).generate(
            [p], max_new_tokens=30)
    ref, out, _, _ = _both(gqa, [(p, dict(max_new_tokens=30))],
                           kv_pool_blocks=4)
    assert out == ref and out[0][1] == "preempted_pool"


def test_unported_options_raise(gqa):
    jm, tm = gqa
    for scheduler in ("legacy", "fused"):
        for kw in (dict(adapter_store=object()), dict(mesh=object())):
            with pytest.raises(NotImplementedError):
                LLMEngine(tm, device="cpu",
                          **{**_kw(scheduler=scheduler), **kw})
    # the host KV tier is ported (tests/test_torch_kv_tier.py): fused
    # paged engines take it; a legacy one refuses the swap with the
    # reference's ValueError
    tier = dict(enable_prefix_cache=True, kv_host_swap=True,
                kv_host_spill_bytes=1 << 20)
    eng = LLMEngine(tm, device="cpu", **_kw(scheduler="fused", **tier))
    assert eng.kv_host_swap and eng.kv_host_spill_bytes == 1 << 20
    with pytest.raises(ValueError, match="scheduler='fused'"):
        LLMEngine(tm, device="cpu", **_kw(**tier))
    # speculation is ported: the fused verify grants (dense and bf16
    # paged) and the legacy dense scan, which constructs and serves
    # (tests/test_torch_legacy_spec.py holds it to the reference); a
    # legacy paged engine refuses it with the reference's ValueError, and
    # quantized pools are the rest of its second half
    assert LLMEngine(tm, device="cpu", speculative_k=2,
                     **_kw(scheduler="fused")).speculative_k == 2
    with pytest.raises(ValueError, match="dense-only"):
        LLMEngine(tm, device="cpu", speculative_k=2, **_kw())
    spec = LLMEngine(tm, device="cpu", speculative_k=2,
                     **_kw(cache_impl="dense"))
    (out,) = spec.generate([np.arange(1, 9, dtype=np.int32)],
                           max_new_tokens=6)
    assert out.finished and len(out.token_ids) == 6
    assert spec.stats["spec_proposed_tokens"] > 0
    with pytest.raises(NotImplementedError,
                       match="A8\\(e\\), second half"):
        LLMEngine(tm, device="cpu", speculative_k=2,
                  **_kw(scheduler="fused", kv_cache_dtype="int8"))
    # multi-step decode is ported: the fused scheduler takes a stride,
    # the legacy one refuses it as the reference does (its `horizon`)
    assert LLMEngine(tm, device="cpu", readout_stride=2,
                     **_kw(scheduler="fused")).readout_stride == 2
    with pytest.raises(ValueError, match="fused"):
        LLMEngine(tm, device="cpu", readout_stride=2,
                  **_kw(scheduler="legacy"))
    with pytest.raises(ValueError, match="scheduler"):
        LLMEngine(tm, device="cpu", **_kw(scheduler="warp"))
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        LLMEngine(tm, device="cpu", **_kw(kv_cache_dtype="fp8"))
    # the reference default, cache_impl="dense", is ported: it constructs
    # and serves (tests/test_torch_dense_engine.py holds it to the
    # reference)
    dense = LLMEngine(tm, device="cpu", max_batch=2, max_seq_len=64,
                      chunk_size=16)
    assert dense.cache_impl == "dense"
    (out,) = dense.generate(_prompts(5, (9,)), max_new_tokens=4)
    assert out.finish_reason == "length" and len(out.token_ids) == 4
    # sampling is ported: a temperature > 0 request is served, token for
    # token the reference engine's from one generator state
    req = [(np.array([1, 2, 3]), dict(max_new_tokens=6, temperature=0.7))]
    _seed_both((9, 0))
    ref, out, _, _ = _both(gqa, req)
    assert out == ref and len(out[0][0]) == 6


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_mixed_sampling_isolation(gqa, cache_impl):
    """A sampling slot does not perturb a greedy slot's stream (reference
    tests/test_llm_engine.py:94), and both are the reference's token for
    token under the engine's static ``top_k``; the first step draws once
    from the global generator in both packages."""
    rng = np.random.default_rng(5)
    pg = rng.integers(1, 96, size=(7,)).astype(np.int32)
    ps = rng.integers(1, 96, size=(6,)).astype(np.int32)
    greedy = _both(gqa, [(pg, dict(max_new_tokens=8))],
                   cache_impl=cache_impl)[1]
    _seed_both((123, 0))
    ref, out, _, _ = _both(
        gqa, [(pg, dict(max_new_tokens=8, temperature=0.0)),
              (ps, dict(max_new_tokens=8, temperature=1.3, top_p=0.9))],
        cache_impl=cache_impl, top_k=8)
    assert out == ref
    assert out[0] == greedy[0]
    assert len(out[1][0]) == 8 and all(0 <= t < 96 for t in out[1][0])
    assert trandom.default_generator.get_state() == \
        jrandom.default_generator.get_state() == (123, 1)


@pytest.mark.parametrize("scheduler", ["legacy", "fused"])
def test_sampling_seed_is_honoured(gqa, scheduler):
    """``sampling_seed=s`` makes the base key ``PRNGKey(s)`` (reference
    ``llm_engine.py:3643-3648``): the streams are the reference's at the
    same seed whatever the global generators hold, neither generator
    advances, another engine with the seed repeats them and another seed
    changes them."""
    _, tm = gqa
    reqs = [(q, dict(max_new_tokens=6, temperature=0.8, top_p=0.9))
            for q in _prompts(4, (7, 9))]
    _seed_both((1, 0))
    ref, out, _, eng = _both(gqa, reqs, scheduler=scheduler,
                             sampling_seed=7)
    assert out == ref
    assert trandom.default_generator.get_state() == \
        jrandom.default_generator.get_state() == (1, 0)
    assert torch.equal(eng._rng_key, prng.PRNGKey(7))
    _seed_both((2, 5))
    again = _serve(LLMEngine(tm, device="cpu", **_kw(
        scheduler=scheduler, sampling_seed=7)), reqs)
    other = _serve(LLMEngine(tm, device="cpu", **_kw(
        scheduler=scheduler, sampling_seed=8)), reqs)
    assert again == out and other != out


def test_unseeded_engine_draws_once_at_first_step(gqa):
    """Without ``sampling_seed`` the base key is ``fold_in(PRNGKey(seed),
    counter)`` of ONE ``default_generator`` draw, made at the first step
    that runs (a step with nothing to do draws nothing), and it survives
    ``reset()``: after a reset the streams (later rids) are still the
    reference's and no second draw happens."""
    jm, tm = gqa
    _seed_both((5, 3))
    jeng = JEngine(jm, **_kw())
    eng = LLMEngine(tm, device="cpu", **_kw())
    assert eng.step() == [] and jeng.step() == []
    assert trandom.default_generator.get_state() == (5, 3)
    reqs = [(q, dict(max_new_tokens=5, temperature=0.9))
            for q in _prompts(8, (6, 10, 4))]
    assert _serve(eng, reqs) == _serve(jeng, reqs)
    assert trandom.default_generator.get_state() == \
        jrandom.default_generator.get_state() == (5, 4)
    key = prng.fold_in(prng.PRNGKey(5), 4)
    assert torch.equal(eng._rng_key, key)
    eng.reset()
    jeng.reset()
    assert _serve(eng, reqs) == _serve(jeng, reqs)
    assert torch.equal(eng._rng_key, key)
    assert trandom.default_generator.get_state() == (5, 4)
