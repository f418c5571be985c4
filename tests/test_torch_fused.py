"""paddle_tpu_torch LLMEngine(cache_impl="paged", scheduler="fused"): the
fused token-budget scheduler, held TOKEN-EXACT against the reference's
fused paged engine (chunk boundaries, GQA, the oversubscribed pool,
depth-2 pipelining) and against the port's own legacy paged engine, which
tests/test_torch_engine.py holds token-exact to the reference. The cases
mirror tests/test_fused_scheduler.py. CPU, float32, 2 layers, hidden 64,
vocab 96, on bridged weights."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm_engine import LLMEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.inference import LLMEngine, PoolCapacityError
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           PagedKVCache)

torch.set_num_threads(1)


def _models(kvh, seed):
    kw = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=kvh, max_position_embeddings=128)
    paddle.seed(seed)
    jm = JLlama(JConfig(**kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def mha():
    return _models(4, 7)


@pytest.fixture(scope="module")
def gqa():
    return _models(2, 11)


@pytest.fixture
def pool_checks(monkeypatch):
    """The allocator audit after every alloc, free and unfence."""
    monkeypatch.setenv("PADDLE_TPU_POOL_CHECKS", "1")


def _kw(**over):
    kw = dict(cache_impl="paged", max_batch=2, max_seq_len=64,
              chunk_size=16, block_size=8)
    kw.update(over)
    return kw


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, size=(n,)).astype(np.int32) for n in sizes]


def _tokens(outs):
    return [list(o.token_ids) for o in outs]


def _ref_fused(jm, prompts, max_new_tokens=8, **kw):
    eng = JEngine(jm, **_kw(scheduler="fused", **kw))
    return _tokens(eng.generate(prompts, max_new_tokens=max_new_tokens)), eng


def _port(tm, prompts, max_new_tokens=8, scheduler="fused", **kw):
    eng = LLMEngine(tm, device="cpu", **_kw(scheduler=scheduler, **kw))
    return _tokens(eng.generate(prompts, max_new_tokens=max_new_tokens)), eng


def _drain_pipelined(eng):
    """step_begin the next step BEFORE step_finish of the previous one
    (depth 2), as a pipelined server does."""
    outs = {}
    pending = eng.step_begin()
    while eng.has_unfinished():
        nxt = eng.step_begin() if pending is not None else None
        if pending is not None:
            for o in eng.step_finish(pending):
                outs[o.request_id] = o
        pending = nxt
        if pending is None and eng.has_unfinished():
            pending = eng.step_begin()
    if pending is not None:
        for o in eng.step_finish(pending):
            outs[o.request_id] = o
    return outs


@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_chunk_boundary_prompt_lens(which, request, pool_checks):
    """len % chunk in {0, 1, chunk-1} plus short prompts, more requests
    than slots: the port's fused streams equal the reference's fused
    streams and the port's legacy streams."""
    jm, tm = request.getfixturevalue(which)
    prompts = _prompts(1, (16, 17, 15, 5, 32, 3))   # %16: 0,1,15,5,0,3
    ref, ref_eng = _ref_fused(jm, prompts)
    out, eng = _port(tm, prompts)
    legacy, _ = _port(tm, prompts, scheduler="legacy")
    assert out == ref == legacy
    assert eng.stats["fused_steps"] == ref_eng.stats["fused_steps"] > 0
    assert eng.stats["prefill_tokens"] == sum(len(p) for p in prompts)
    assert len(eng._free_blocks) == eng.n_blocks
    assert (eng._tables == -1).all()


def test_gqa_against_reference(gqa, pool_checks):
    prompts = _prompts(2, (9, 17, 16, 6))
    ref, _ = _ref_fused(gqa[0], prompts)
    out, _ = _port(gqa[1], prompts)
    assert out == ref


def test_mid_stream_admission_exact(mha):
    """A request joining while another decodes ramps in through mixed
    steps without perturbing the running stream."""
    _, tm = mha
    p1, p2 = _prompts(3, (19, 14))
    (r1,), _ = _port(tm, [p1], max_new_tokens=10, scheduler="legacy")
    (r2,), _ = _port(tm, [p2], max_new_tokens=5, scheduler="legacy")
    eng = LLMEngine(tm, device="cpu", **_kw(scheduler="fused"))
    a = eng.add_request(p1, max_new_tokens=10)
    for _ in range(3):
        eng.step()
    b = eng.add_request(p2, max_new_tokens=5)
    while eng.has_unfinished():
        eng.step()
    assert eng.finished_outputs[a].token_ids == r1
    assert eng.finished_outputs[b].token_ids == r2


def test_budget_throttles_prefill_not_decode(mha):
    """A tight max_step_tokens spreads ramp-in over more mixed steps
    (grants smaller than a chunk) but never changes tokens."""
    _, tm = mha
    prompts = _prompts(4, (33, 21))
    ref, _ = _port(tm, prompts, scheduler="legacy")
    out, eng = _port(tm, prompts, max_step_tokens=5)
    assert out == ref
    assert eng.stats["fused_steps"] > sum(-(-len(p) // 16) for p in prompts)


def test_horizon_composes(mha):
    """All-decode steps fall through to the horizon decode path."""
    _, tm = mha
    prompts = _prompts(5, (11, 7))
    ref, _ = _port(tm, prompts, 12, scheduler="legacy")
    out, eng = _port(tm, prompts, 12, horizon=4)
    assert out == ref
    assert eng.stats["steps"] < eng.stats["tokens_generated"]


def test_eos_finishes_request(mha):
    _, tm = mha
    (p,) = _prompts(6, (9,))
    (ref,), _ = _port(tm, [p], 12, scheduler="legacy", max_batch=1)
    eos = ref[2]
    legacy = LLMEngine(tm, device="cpu", **_kw(max_batch=1))
    (le,) = legacy.generate([p], max_new_tokens=12, eos_token_id=eos)
    fused = LLMEngine(tm, device="cpu", **_kw(scheduler="fused", max_batch=1))
    (fu,) = fused.generate([p], max_new_tokens=12, eos_token_id=eos)
    assert fu.token_ids == le.token_ids
    assert fu.finish_reason == "eos"


def test_capacity_cap(mha):
    """A slot that reaches engine capacity retires like the legacy path
    (the capped budget ends it at the capacity edge)."""
    _, tm = mha
    (p,) = _prompts(14, (10,))
    kw = dict(max_batch=1, max_seq_len=16, chunk_size=8)
    legacy = LLMEngine(tm, device="cpu", **_kw(**kw))
    (ref,) = legacy.generate([p], max_new_tokens=50)
    fused = LLMEngine(tm, device="cpu", **_kw(scheduler="fused", **kw))
    (out,) = fused.generate([p], max_new_tokens=50)
    assert out.token_ids == ref.token_ids
    assert out.finish_reason == ref.finish_reason
    assert len(out.token_ids) + 10 <= 16


def test_oversubscribed_pool_preempts_and_stays_exact(mha, pool_checks):
    """An 8-block pool under two 25+ token prompts: preemption, streams
    equal to the reference's fused engine on the same pool and to the
    full pool's, every block free afterwards."""
    jm, tm = mha
    prompts = _prompts(7, (25, 27))
    ref, ref_eng = _ref_fused(jm, prompts, 10, kv_pool_blocks=8)
    full, _ = _port(tm, prompts, 10)
    out, eng = _port(tm, prompts, 10, kv_pool_blocks=8)
    assert out == ref == full
    assert eng.stats["preemptions"] == ref_eng.stats["preemptions"] >= 1
    assert len(eng._free_blocks) == 8
    assert not eng._quarantine and not eng._write_fence


def test_block_aligned_prompt_filling_pool_errors_loudly(mha):
    """A block-aligned prompt whose blocks exactly fill the pool leaves no
    room for one decode token: the fused admission counts that block and
    raises the too-small-pool error."""
    _, tm = mha
    (p,) = _prompts(16, (24,))          # 24 % 8 == 0 -> exactly 3 blocks
    eng = LLMEngine(tm, device="cpu",
                    **_kw(scheduler="fused", max_batch=1, kv_pool_blocks=3))
    assert eng.prefill_blocks_needed(24) == 4
    with pytest.raises(PoolCapacityError, match="kv_pool_blocks too small"):
        eng.generate([p], max_new_tokens=4)


def test_fused_needs_exact_blocks_not_chunk_rounded(mha, pool_checks):
    """The fused scheduler writes exact positions, so a pool too small for
    the legacy chunk-rounded prefill still serves it, to the pool edge."""
    _, tm = mha
    (p,) = _prompts(9, (17,))
    # legacy: round_up(17, chunk=16) = 32 tokens = 4 blocks > pool(3)
    with pytest.raises(PoolCapacityError, match="kv_pool_blocks too small"):
        LLMEngine(tm, device="cpu", **_kw(max_batch=1, kv_pool_blocks=3)) \
            .generate([p], max_new_tokens=4)
    (ref,), _ = _port(tm, [p], 30, max_batch=1)
    fused = LLMEngine(tm, device="cpu",
                      **_kw(scheduler="fused", max_batch=1, kv_pool_blocks=3))
    (out,) = fused.generate([p], max_new_tokens=30)
    # 17 tokens -> 3 blocks (24 positions): ramps in, decodes to the pool
    # edge, retires with the distinct pool reason
    assert out.finish_reason == "preempted_pool"
    n = len(out.token_ids)
    assert 0 < n < 30 and out.token_ids == ref[:n]
    assert len(fused._free_blocks) == 3


def test_depths(mha):
    _, tm = mha
    assert LLMEngine(tm, device="cpu", **_kw()).max_pipeline_depth() == 1
    assert LLMEngine(tm, device="cpu", **_kw(scheduler="fused")) \
        .max_pipeline_depth() == 3
    assert LLMEngine(tm, device="cpu", **_kw(
        scheduler="fused", kv_pool_blocks=8)).max_pipeline_depth() == 2
    # the legacy engine refuses a second step_begin before step_finish
    eng = LLMEngine(tm, device="cpu", **_kw())
    eng.add_request(_prompts(17, (6,))[0], max_new_tokens=4)
    first = eng.step_begin()
    with pytest.raises(RuntimeError, match="pipeline"):
        eng.step_begin()
    eng.step_finish(first)


def test_full_pool_pipelines_depth2_exact(mha, pool_checks):
    """step_begin twice, then step_finish in order: the pipelined streams
    equal the reference's fused streams, and every block is free."""
    jm, tm = mha
    prompts = _prompts(10, (9, 17, 12, 5))
    ref, _ = _ref_fused(jm, prompts)
    eng = LLMEngine(tm, device="cpu", **_kw(scheduler="fused"))
    for p in prompts:
        eng.add_request(p, max_new_tokens=8)
    outs = _drain_pipelined(eng)
    assert [outs[i].token_ids for i in sorted(outs)] == ref
    assert len(eng._free_blocks) == eng.n_blocks
    assert not eng._quarantine and not eng._write_fence
    assert eng._inflight == 0


def test_oversubscribed_rejects_third_begin(mha, pool_checks):
    """An oversubscribed pool pipelines at depth 2 and rejects depth 3; a
    pipelined drain under preemption stays exact and frees every block."""
    _, tm = mha
    eng = LLMEngine(tm, device="cpu",
                    **_kw(scheduler="fused", kv_pool_blocks=8))
    eng.add_request(_prompts(11, (6,))[0], max_new_tokens=4)
    first = eng.step_begin()
    second = eng.step_begin()
    assert first is not None and second is not None
    with pytest.raises(RuntimeError, match="pipeline"):
        eng.step_begin()
    eng.step_finish(first)
    eng.step_finish(second)
    while eng.has_unfinished():
        eng.step()
    prompts = _prompts(7, (25, 27))
    ref, _ = _port(tm, prompts, 10)
    for p in prompts:
        eng.add_request(p, max_new_tokens=10)
    outs = _drain_pipelined(eng)
    assert [outs[i].token_ids for i in sorted(outs)][-2:] == ref
    assert eng.stats["preemptions"] >= 1
    assert len(eng._free_blocks) == 8
    assert not eng._quarantine and not eng._write_fence


def test_append_step_needs_q_lens(mha):
    """The model's paged step with seq len > 1 is the fused append step
    and raises without q_lens, as the reference does."""
    _, tm = mha
    c = tm.config
    hd = c.hidden_size // c.num_attention_heads
    pool = torch.zeros(5, c.num_key_value_heads, 8, hd)
    cache = PagedKVCache(pool, pool.clone(),
                         torch.zeros(1, 4, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))
    with torch.no_grad(), pytest.raises(ValueError, match="q_lens"):
        tm.llama(torch.ones(1, 3, dtype=torch.int32), kv_caches=[cache] * 2,
                 position_offset=cache.seq_lens)
