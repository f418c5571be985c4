"""paddle_tpu_torch LLMEngine(enable_prefix_cache=True): the content-
addressed block store with copy-on-write tails, held TOKEN-EXACT against
the reference's cache-on engine and the port's cache-off engine under
both schedulers, with the reference's chain hashes, block tables and
prefix stats, and the pool audit (PADDLE_TPU_POOL_CHECKS=1, set by the
suite's conftest) after every alloc, free and unfence. The cases port
tests/test_prefix_cache.py except those that need the flight recorder
(ROADMAP A11), and add COW over int8/int4 pools (payload and scale rows
cloned bit for bit). CPU, float32, 1 layer, hidden 64, vocab 96, on
bridged weights; the workhorse engines are module-scoped and each test's
prompts come from their own seed, so no test's cached content collides
with another's."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm_engine import LLMEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import AsyncLLMServer

torch.set_num_threads(1)

STATS = ("prefix_hit_tokens", "prefix_cow_blocks", "prefix_evicted_blocks",
         "prefill_tokens", "preemptions")


@pytest.fixture(scope="module")
def models():
    kw = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=4, max_position_embeddings=128)
    paddle.seed(7)
    jm = JLlama(JConfig(**kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


def _kw(scheduler, cache_on, **over):
    kw = dict(cache_impl="paged", scheduler=scheduler, max_batch=2,
              max_seq_len=64, chunk_size=16, block_size=8,
              enable_prefix_cache=cache_on)
    kw.update(over)
    return kw


def _engine(tm, cache_on, scheduler="fused", **over):
    return LLMEngine(tm, device="cpu", **_kw(scheduler, cache_on, **over))


def _jengine(jm, cache_on, scheduler="fused", **over):
    return JEngine(jm, **_kw(scheduler, cache_on, **over))


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, size=(n,)).astype(np.int32) for n in sizes]


def _shared_workload(seed, sys_len, tail_sizes):
    """Prompts opening with one shared system prefix, then unique tails."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, 96, size=(sys_len,)).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(1, 96, size=(n,))
                            .astype(np.int32)]) for n in tail_sizes]


def _toks(eng, prompts, n):
    return [list(o.token_ids) for o in eng.generate(prompts,
                                                    max_new_tokens=n)]


def _stats(eng):
    return {k: eng.stats[k] for k in STATS}


def _fresh(eng):
    assert all(s is None for s in eng.slots) and not eng.waiting
    eng.finished_outputs.clear()
    eng.reset_stats()
    return eng


def _pool_accounted(eng):
    """free + LRU-cached + live-referenced distinct blocks == n_blocks."""
    live = {p for blocks in eng._slot_blocks for p in blocks}
    return len(eng._free_blocks) + len(eng._lru) + len(live) == eng.n_blocks


@pytest.fixture(scope="module")
def ref_fused(models):
    """The port's cache-OFF fused engine: the parity reference."""
    return _engine(models[1], False)


@pytest.fixture(scope="module")
def on_fused(models):
    """The port's cache-ON fused engine; its store stays warm across
    tests (their prompts cannot collide), the long-lived server's
    shape."""
    eng = _engine(models[1], True)
    assert eng._debug_pool, "the suite's conftest arms the pool audit"
    return eng


@pytest.mark.parametrize("scheduler", ["fused", "legacy"])
def test_mixed_shared_unshared_workload(models, scheduler):
    """Shared-prefix prompts between unrelated ones: the streams equal the
    cache-off engine's and the reference cache-on engine's, hit tokens
    are served from the store (not prefilled), and every prefix stat
    equals the reference's."""
    jm, tm = models
    shared = _shared_workload(1, 20, (5, 9, 3))
    prompts = [shared[0], _prompts(2, (13,))[0], shared[1], shared[2]]
    off = _engine(tm, False, scheduler)
    ref = _toks(off, prompts, 6)
    jon = _jengine(jm, True, scheduler)
    on = _engine(tm, True, scheduler)
    assert _toks(on, prompts, 6) == _toks(jon, prompts, 6) == ref
    assert on.stats["prefix_hit_tokens"] > 0
    assert on.stats["prefill_tokens"] < off.stats["prefill_tokens"]
    assert on.stats["prefill_tokens"] + on.stats["prefix_hit_tokens"] \
        == sum(len(p) for p in prompts)
    assert _stats(on) == {k: jon.stats[k] for k in STATS}
    if scheduler == "legacy":
        # legacy hits are whole chunks
        assert on.stats["prefix_hit_tokens"] % 16 == 0
        assert on.stats["prefix_cow_blocks"] == 0


def test_warm_identical_prompt_capped_at_p_minus_1(ref_fused, on_fused):
    """An identical prompt hits all but its last position, which is
    recomputed for the logits admission samples from."""
    (p,) = _shared_workload(3, 24, (0,))
    (ref,) = _toks(_fresh(ref_fused), [p], 6)
    on = _fresh(on_fused)
    (first,) = _toks(on, [p], 6)
    hits0 = on.stats["prefix_hit_tokens"]
    (again,) = _toks(on, [p], 6)
    assert first == again == ref
    assert on.stats["prefix_hit_tokens"] - hits0 == len(p) - 1


def test_cow_tail_extends_hit_to_token_granularity(models, ref_fused,
                                                   on_fused):
    """A hit ending mid-block clones the matching cached block into a
    private tail (copy-on-write); the reference engine books the same
    hits and clones."""
    jm, _ = models
    prompts = _shared_workload(4, 20, (7, 11))     # 20 % 8 != 0: tails
    ref = _toks(_fresh(ref_fused), prompts, 6)
    jon = _jengine(jm, True)

    def serial(eng):
        out = []
        for p in prompts:
            rid = eng.add_request(p, max_new_tokens=6)
            while eng.has_unfinished():
                eng.step()
            out.append(list(eng.finished_outputs[rid].token_ids))
        return out

    on = _fresh(on_fused)
    assert serial(on) == serial(jon) == ref
    assert on.stats["prefix_cow_blocks"] >= 1
    # 16 of the 20 shared tokens in whole blocks, the COW tail the rest
    assert on.stats["prefix_hit_tokens"] >= 20
    assert {k: on.stats[k] for k in STATS[:3]} == \
        {k: jon.stats[k] for k in STATS[:3]}


def test_live_cross_slot_sharing_and_cancel(ref_fused, on_fused):
    """Two concurrent same-prefix requests reference the same physical
    blocks (refcount 2); cancelling one releases its references without
    touching the survivor's stream."""
    prompts = _shared_workload(5, 16, (3, 5))
    ref = _toks(_fresh(ref_fused), prompts, 8)
    on = _fresh(on_fused)
    a = on.add_request(prompts[0], max_new_tokens=8)
    for _ in range(4):
        on.step()
    b = on.add_request(prompts[1], max_new_tokens=8)
    for _ in range(2):
        on.step()
    sa, sb = (next(i for i, s in enumerate(on.slots)
                   if s is not None and s.req.request_id == r)
              for r in (a, b))
    shared_blocks = set(on._slot_blocks[sa]) & set(on._slot_blocks[sb])
    assert shared_blocks, "no physical block shared across slots"
    assert all(on._block_ref[p] == 2 for p in shared_blocks)
    on.cancel(b)
    assert all(on._block_ref[p] == 1 for p in shared_blocks)
    while on.has_unfinished():
        on.step()
    assert on.finished_outputs[a].token_ids == ref[0]
    assert _pool_accounted(on)


def test_lru_eviction_under_pressure(models):
    """Distinct prompts through a small pool: retired content parks in
    the LRU and is evicted oldest first when allocation runs dry; the
    reference evicts the same blocks."""
    jm, tm = models
    prompts = _prompts(6, (17, 19, 21, 15))
    ref = _toks(_engine(tm, False, max_batch=1, kv_pool_blocks=8),
                prompts, 4)
    jon = _jengine(jm, True, max_batch=1, kv_pool_blocks=8)
    on = _engine(tm, True, max_batch=1, kv_pool_blocks=8)
    assert _toks(on, prompts, 4) == _toks(jon, prompts, 4) == ref
    assert on.stats["prefix_evicted_blocks"] > 0
    assert _stats(on) == {k: jon.stats[k] for k in STATS}
    assert len(on._free_blocks) + len(on._lru) == on.n_blocks
    assert list(on._lru) == list(jon._lru)
    assert (on._tables == -1).all()


def test_oversubscribed_pool_preempts_exactly(models):
    """Over an oversubscribed pool the LRU goes before any slot, then
    preemption fires (distinct prompts grow together) and the preempted
    request's re-prefill hits its own registered blocks: the streams stay
    exact and the stats are the reference's."""
    jm, tm = models
    prompts = _prompts(7, (15, 17))
    ref = _toks(_engine(tm, False, kv_pool_blocks=8), prompts, 20)
    jon = _jengine(jm, True, kv_pool_blocks=8)
    on = _engine(tm, True, kv_pool_blocks=8)
    assert _toks(on, prompts, 20) == _toks(jon, prompts, 20) == ref
    assert on.stats["preemptions"] >= 1
    assert on.stats["prefix_hit_tokens"] > 0
    assert _stats(on) == {k: jon.stats[k] for k in STATS}
    assert len(on._free_blocks) + len(on._lru) == on.n_blocks


@pytest.mark.parametrize("cache_on", [False, True])
def test_churn_admit_cancel_preempt_finish(models, cache_on):
    """Random admit/cancel/finish churn with pool-pressure preemption:
    the audit runs inside every operation and the drained pool accounts
    for every block."""
    eng = _engine(models[1], cache_on, kv_pool_blocks=10)
    rng = np.random.default_rng(8)
    shared = _shared_workload(9, 10, tuple(rng.integers(2, 14, 10)))
    live = []
    for p in shared:
        rid = eng.add_request(p, max_new_tokens=int(rng.integers(2, 8)))
        live.append(rid)
        for _ in range(int(rng.integers(1, 4))):
            for out in eng.step():
                if out.request_id in live:
                    live.remove(out.request_id)
        if live and rng.random() < 0.5:
            eng.cancel(live.pop(int(rng.integers(0, len(live)))))
    while eng.has_unfinished():
        eng.step()
    assert not any(eng._slot_blocks)
    assert len(eng._free_blocks) + len(eng._lru) == eng.n_blocks
    assert (eng._tables == -1).all()
    if not cache_on:
        assert len(eng._free_blocks) == eng.n_blocks


def _layout_history(eng, prompts):
    for p in prompts[:2]:
        eng.add_request(p, max_new_tokens=4)
    history, steps = [], 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        if steps == 3:        # mid-run admission reuses retired blocks
            eng.add_request(prompts[2], max_new_tokens=4)
        history.append([list(b) for b in eng._slot_blocks])
    return history


@pytest.mark.parametrize("cache_on", [False, True])
def test_identical_runs_identical_tables(models, cache_on):
    """Allocation pops the smallest free index, so two identical runs lay
    blocks out identically step for step, and as the reference does."""
    jm, tm = models
    prompts = _shared_workload(11, 12, (5, 9, 7))
    a = _layout_history(_engine(tm, cache_on), prompts)
    assert a == _layout_history(_engine(tm, cache_on), prompts)
    assert a == _layout_history(_jengine(jm, cache_on), prompts)


def test_engine_level_rid_reuse_after_cancel(ref_fused, on_fused):
    seed, follow = _shared_workload(13, 16, (3, 5))
    (ref,) = _toks(_fresh(ref_fused), [follow], 5)
    on = _fresh(on_fused)
    _toks(on, [seed], 3)
    rid = on.add_request(follow, max_new_tokens=5, request_id=77)
    on.step()                        # the hit admitted, a decode in flight
    assert on.stats["prefix_hit_tokens"] > 0
    on.cancel(rid)
    on.finished_outputs.pop(rid)
    rid2 = on.add_request(follow, max_new_tokens=5, request_id=77)
    while on.has_unfinished():
        on.step()
    assert on.finished_outputs[rid2].token_ids == ref
    assert _pool_accounted(on)


def test_server_rid_reuse_with_a_hit_in_flight(models, ref_fused):
    """A request with a prefix hit is cancelled mid-stream through the
    server; its shared references release, and a second server on the same
    engine, whose request ids restart, admits the reused id with a hit and
    the exact stream. The server books the engine's prefix stats."""
    seed, follow = _shared_workload(12, 16, (4, 7))
    (ref,) = _toks(_fresh(ref_fused), [follow], 6)
    eng = _engine(models[1], True)
    server = AsyncLLMServer(eng, max_queue_size=8)
    with server:
        server.submit(seed, max_new_tokens=4).result(timeout=120)
        h = server.submit(follow, max_new_tokens=30)
        stream = h.tokens(timeout=120)
        next(stream)
        h.cancel()
        assert h.result(timeout=120).finish_reason == "cancelled"
    assert _pool_accounted(eng) and not any(eng._slot_blocks)
    snap = server.telemetry.snapshot()
    assert snap["counters"]["prefix_hit_tokens"] \
        == eng.stats["prefix_hit_tokens"] > 0
    hits0 = eng.stats["prefix_hit_tokens"]
    with AsyncLLMServer(eng, max_queue_size=8) as server2:
        r = server2.submit(follow, max_new_tokens=6).result(timeout=120)
    assert r.token_ids == ref
    assert eng.stats["prefix_hit_tokens"] > hits0


@pytest.mark.parametrize("block_size", [4, 8])
def test_chain_hashes_equal_the_reference_bytes(models, block_size):
    jm, tm = models
    kw = dict(block_size=block_size, chunk_size=16)
    on = _engine(tm, True, **kw)
    jon = _jengine(jm, True, **kw)
    for p in _prompts(14, (1, 4, 9, 17, 33)):
        got = on.prefix_chain_hashes(p)
        assert got == jon.prefix_chain_hashes(p)
        assert len(got) == (len(p) - 1) // block_size
        assert all(isinstance(h, bytes) and len(h) == 16 for h in got)
    assert _engine(tm, False).prefix_chain_hashes(p) == []


def test_probe_prefix_len(models):
    """The read-only probe: full cached blocks only, no refcounts or
    table writes, as the reference answers after the same run."""
    jm, tm = models
    on, jon = _engine(tm, True), _jengine(jm, True)
    seed, other = _shared_workload(15, 21, (0, 6))
    for eng in (on, jon):
        assert eng.probe_prefix_len(seed) == 0
        _toks(eng, [seed], 3)
    refs = list(on._block_ref)
    for p in (seed, other, _prompts(16, (30,))[0]):
        assert on.probe_prefix_len(p) == jon.probe_prefix_len(p)
        assert on.probe_prefix_len(
            p, chain_hashes=on.prefix_chain_hashes(p)) \
            == on.probe_prefix_len(p)
    assert on.probe_prefix_len(other) == 16
    assert on._block_ref == refs
    assert _engine(tm, False).probe_prefix_len(seed) == 0


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_cow_over_quantized_pools(models, quant):
    """COW over int8/int4 pools: the clone carries the source block's
    payload and scale rows bit for bit, and the streams equal the
    reference's cache-on quantized engine's."""
    jm, tm = models
    prompts = _shared_workload(17, 20, (7, 11))
    kw = dict(kv_cache_dtype=quant)
    jon = _jengine(jm, True, **kw)
    on = _engine(tm, True, **kw)
    copies = []
    orig = on._cow_copy

    def watched(src, dst):
        before = [t[src].clone() for t in (*on._k, *on._v, *on._k_scale,
                                           *on._v_scale)]
        orig(src, dst)
        after = [t[dst] for t in (*on._k, *on._v, *on._k_scale,
                                  *on._v_scale)]
        copies.append(all(torch.equal(a, b) for a, b in zip(before, after)))

    on._cow_copy = watched
    out = []
    for eng in (on, jon):
        toks = []
        for p in prompts:
            rid = eng.add_request(p, max_new_tokens=6)
            while eng.has_unfinished():
                eng.step()
            toks.append(list(eng.finished_outputs[rid].token_ids))
        out.append(toks)
    assert out[0] == out[1]
    assert copies and all(copies)
    assert on.stats["prefix_cow_blocks"] == jon.stats["prefix_cow_blocks"] \
        == len(copies)
    assert _stats(on) == {k: jon.stats[k] for k in STATS}


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("scheduler", ["fused", "legacy"])
def test_quantized_pools_token_exact(models, quant, scheduler):
    jm, tm = models
    prompts = _shared_workload(18, 20, (5, 9, 3))
    kw = dict(kv_cache_dtype=quant)
    jon = _jengine(jm, True, scheduler, **kw)
    on = _engine(tm, True, scheduler, **kw)
    assert _toks(on, prompts, 6) == _toks(jon, prompts, 6)
    assert on.stats["prefix_hit_tokens"] > 0
    assert _stats(on) == {k: jon.stats[k] for k in STATS}


def test_construction_edges(models):
    _, tm = models
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(tm, device="cpu", cache_impl="dense",
                  enable_prefix_cache=True, max_seq_len=64, chunk_size=16)
    # the host spill store is ported (tests/test_torch_kv_tier.py): it
    # constructs beside the prefix cache and, as in the reference, raises
    # without it
    assert _engine(tm, True, kv_host_spill_bytes=1 << 20) \
        .kv_host_spill_bytes == 1 << 20
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        _engine(tm, False, kv_host_spill_bytes=1 << 20)
    on = _engine(tm, True)
    _toks(on, _shared_workload(19, 16, (2, 3)), 2)
    assert on._store and on._lru
    on.reset()
    assert not (on._store or on._lru or on._block_hash or on._children)
    assert len(on._free_blocks) == on.n_blocks
