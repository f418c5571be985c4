"""paddle_tpu_torch LLMEngine's host KV tier (kv_host_swap,
kv_host_spill_bytes): preemption swap and prefix spill over bf16-shaped
(here float32) and int8/int4 pools, held against the reference's engine
run beside it on the same bridged weights. The cases mirror
tests/test_kv_tier.py at its shapes (2 layers, hidden 64, block 8, chunk
16, pool 8) with PADDLE_TPU_POOL_CHECKS=1: the streams token for token,
the preemption, prefill, prefix and tier counters equal, the StepRecords'
tier fields equal step for step, and every restored block's payload and
scales the bytes that were swapped out; sampled streams too, through
the swap cycle (the per-(rid, position) keys make the stitch sample the
exact continuation). Also C5: the port's stats carry the reference's
whole key schema. CPU, float32."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random as jrandom
from paddle_tpu.inference import llm_engine as jle
from paddle_tpu.inference.llm_engine import LLMEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.profiler import flight_recorder as jfr
from paddle_tpu.serving import ServerQueueFull as JServerQueueFull
from paddle_tpu.serving.scheduler import AdmissionQueue as JAdmissionQueue

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.inference import LLMEngine, llm_engine as tle
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler import FlightRecorder
from paddle_tpu_torch.serving import (AdmissionQueue, AsyncLLMServer,
                                      FaultInjector, RestartPolicy,
                                      ServerQueueFull)
from paddle_tpu_torch.serving.faults import InjectedFault

torch.set_num_threads(1)

V = 96
CFG = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=128)

#: the counters each case holds equal to the reference's
COUNTERS = ("preemptions", "prefill_tokens", "prefix_hit_tokens",
            "kv_swap_out_blocks", "kv_swap_in_blocks", "kv_swap_out_bytes",
            "kv_swap_in_bytes", "kv_swap_saved_tokens", "kv_spill_blocks",
            "kv_promote_blocks")

#: the StepRecord fields the tier decides, and those that place a step
TIER_FIELDS = ("kind", "grants", "tokens_scheduled", "preemptions",
               "free_blocks", "prefix_hit_tokens", "cached_blocks",
               "kv_swap_in_bytes", "kv_swap_out_bytes",
               "kv_host_spill_blocks", "kv_pool_bytes", "finished")


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLlama(JConfig(**CFG))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(autouse=True)
def pool_checks(monkeypatch):
    """The allocator audit after every alloc, free and unfence."""
    monkeypatch.setenv("PADDLE_TPU_POOL_CHECKS", "1")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, V, size=(n,)).astype(np.int32)
            for n in (25, 27)]


def _kw(**over):
    kw = dict(max_batch=2, max_seq_len=64, chunk_size=16,
              cache_impl="paged", block_size=8, scheduler="fused")
    kw.update(over)
    return kw


def _pair(models, **over):
    """The reference's engine and the port's, configured alike."""
    jm, tm = models
    return JEngine(jm, **_kw(**over)), LLMEngine(tm, device="cpu",
                                                 **_kw(**over))


def _seed_both(state):
    """Both packages' global generators at one (seed, counter) state, so
    engines made next draw the same base key at their first steps."""
    jrandom.default_generator.set_state(state)
    trandom.default_generator.set_state(state)


def _toks(eng, prompts, n=10, **sampling):
    return [list(o.token_ids) for o in eng.generate(prompts,
                                                    max_new_tokens=n,
                                                    **sampling)]


def _counters(eng):
    return {k: eng.stats[k] for k in COUNTERS}


def _same_bits(a, b):
    """Bit equality of two host tensors of one dtype (float payloads and
    scales compared as integers, so -0.0 and NaN payloads count)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return torch.equal(a, b)


def _pool_rows(eng, blocks):
    """``blocks`` of every pool, in a staged copy's layout."""
    pools, scales = eng._tier_pools()
    idx = torch.as_tensor(blocks, dtype=torch.long)
    kv = torch.stack([p.index_select(0, idx) for p in pools], dim=1)
    sc = None if scales is None else torch.stack(
        [t.index_select(0, idx) for t in scales], dim=1)
    return kv, sc


def _watch_round_trips(eng):
    """Wrap the staging gather and the restore scatter: every staged copy
    must equal its source blocks bit for bit when made, and every
    restored block must equal the host rows it came from, payload and
    scales. Returns the log of (gathers, restores)."""
    log = {"gathers": 0, "restores": 0}
    stage, restore = eng._stage_blocks, eng._restore_blocks

    def staged(blocks):
        entry = stage(blocks)
        kv, sc = _pool_rows(eng, blocks)
        assert _same_bits(entry["kv"], kv)
        assert (sc is None) == (entry["scale"] is None)
        if sc is not None:
            assert _same_bits(entry["scale"], sc)
        log["gathers"] += 1
        return entry

    def restored(entry, lo, dst):
        restore(entry, lo, dst)
        kv, sc = _pool_rows(eng, dst)
        assert _same_bits(kv, entry["kv"][lo:lo + len(dst)])
        if sc is not None:
            assert _same_bits(sc, entry["scale"][lo:lo + len(dst)])
        log["restores"] += 1

    eng._stage_blocks, eng._restore_blocks = staged, restored
    return log


def _clean(eng):
    assert len(eng._free_blocks) + len(eng._lru) == eng.n_blocks
    assert not eng._swap_store
    eng._debug_pool = True
    eng._check_pool_invariants()


# ---------------------------------------------------------------------------
# C5: the stats schema
# ---------------------------------------------------------------------------

def test_c5_stats_keys_are_the_reference_schema(models):
    """The port's stats carry the reference's whole key set, each at the
    reference's zero, and keep it through reset_stats: a tier-off engine
    reads kv_swap_out_blocks as 0 where it raised KeyError."""
    want, got = jle.default_engine_stats(), tle.default_engine_stats()
    assert set(got) == set(want)
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}
    assert all(v == 0 for v in got.values())
    eng = LLMEngine(models[1], device="cpu", **_kw())
    _toks(eng, [np.arange(1, 6, dtype=np.int32)], n=2)
    eng.reset_stats()
    assert set(eng.stats) == set(want)
    assert eng.stats["kv_swap_out_blocks"] == 0
    assert eng.stats["swap_out_time_s"] == 0.0


# ---------------------------------------------------------------------------
# the constructor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over, match", [
    (dict(cache_impl="dense", kv_host_swap=True), "cache_impl='paged'"),
    (dict(scheduler="legacy", kv_host_swap=True), "scheduler='fused'"),
    (dict(kv_host_spill_bytes=1 << 20), "enable_prefix_cache"),
    (dict(cache_impl="dense", enable_prefix_cache=False,
          kv_host_spill_bytes=1 << 20), "enable_prefix_cache"),
])
def test_tier_constructor_validation(models, over, match):
    jm, tm = models
    kw = _kw(**over)
    if kw["cache_impl"] == "dense":
        kw.pop("block_size")
    with pytest.raises(ValueError, match=match):
        JEngine(jm, **kw)
    with pytest.raises(ValueError, match=match):
        LLMEngine(tm, device="cpu", **kw)


def test_tier_constructs_beside_the_paths_it_composes_with(models):
    """The whole rung configuration constructs; the tier beside bf16-form
    paged speculation too, as in the reference; quantized speculation
    still raises, naming its own queue item."""
    jm, tm = models
    full = _kw(enable_prefix_cache=True, kv_host_swap=True,
               kv_host_spill_bytes=1 << 20)
    eng = LLMEngine(tm, device="cpu", **full)
    assert eng.kv_host_swap and eng.kv_host_spill_bytes == 1 << 20
    assert eng.swap_resident_rids() == ()
    spec = _kw(kv_host_swap=True, speculative_k=3)
    JEngine(jm, **spec)
    LLMEngine(tm, device="cpu", **spec)
    with pytest.raises(NotImplementedError, match=r"A8\(e\), second half"):
        LLMEngine(tm, device="cpu", **_kw(kv_host_swap=True,
                                          speculative_k=3,
                                          kv_cache_dtype="int8"))
    assert LLMEngine(tm, device="cpu", **_kw()).swap_resident_rids() == ()


# ---------------------------------------------------------------------------
# preemption swap
# ---------------------------------------------------------------------------

def test_swap_cycle_token_exact_and_reprefill_avoided(models, prompts):
    """Pool pressure preempts through the host tier; the restored streams
    equal the full-pool engine's and the reference's, greedy AND sampled
    (reference tests/test_kv_tier.py:103-113: engines seeded alike draw
    one base key), every counter equals the reference's, the tiered run
    re-prefills fewer tokens than the untiered one, and the pool drains
    clean."""
    jm, tm = models
    _seed_both((321, 0))
    j_full, full = _pair(models)
    greedy_ref = _toks(j_full, prompts)
    assert _toks(full, prompts) == greedy_ref
    j_plain, plain = _pair(models, kv_pool_blocks=8)
    assert _toks(plain, prompts) == _toks(j_plain, prompts) == greedy_ref
    assert _counters(plain) == _counters(j_plain)
    assert plain.stats["preemptions"] >= 1          # pressure is real
    _seed_both((321, 0))
    j_tier, tier = _pair(models, kv_pool_blocks=8, kv_host_swap=True)
    log = _watch_round_trips(tier)
    assert _toks(tier, prompts) == _toks(j_tier, prompts) == greedy_ref
    assert _counters(tier) == _counters(j_tier)
    assert tier.stats["preemptions"] >= 1
    assert tier.stats["kv_swap_out_blocks"] >= 1
    assert tier.stats["kv_swap_in_blocks"] >= 1
    assert tier.stats["kv_swap_out_bytes"] == \
        tier.stats["kv_swap_out_blocks"] * tier.kv_bytes_per_block() > 0
    assert tier.stats["kv_swap_saved_tokens"] >= 1
    assert log["gathers"] >= 1 and log["restores"] >= 1
    assert len(tier._free_blocks) == 8              # nothing leaked
    _clean(tier)
    total_prompt = sum(len(p) for p in prompts)
    re_plain = plain.stats["prefill_tokens"] - total_prompt
    re_tier = tier.stats["prefill_tokens"] - total_prompt
    assert 0 <= re_tier < re_plain
    # the sampled half: the same rids on every engine, so the swapped and
    # restored streams continue the full pool's token for token
    sampled = dict(temperature=0.8, top_p=0.9)
    sampled_ref = _toks(j_full, prompts, **sampled)
    assert _toks(full, prompts, **sampled) == sampled_ref
    swaps = tier.stats["kv_swap_in_blocks"]
    assert _toks(tier, prompts, **sampled) == \
        _toks(j_tier, prompts, **sampled) == sampled_ref
    assert _counters(tier) == _counters(j_tier)
    assert tier.stats["kv_swap_in_blocks"] > swaps
    _clean(tier)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantized_pool_swap_round_trip(models, prompts, dtype):
    """Quantized pools swap token-exactly: payload and scale rows ride the
    host tier bit for bit, so a restored block dequantizes to what the
    untiered quantized engine reads."""
    j_plain, plain = _pair(models, kv_pool_blocks=8, kv_cache_dtype=dtype)
    ref = _toks(j_plain, prompts)
    assert _toks(plain, prompts) == ref
    assert plain.stats["preemptions"] >= 1
    j_tier, tier = _pair(models, kv_pool_blocks=8, kv_cache_dtype=dtype,
                         kv_host_swap=True)
    log = _watch_round_trips(tier)
    assert _toks(tier, prompts) == _toks(j_tier, prompts) == ref
    assert _counters(tier) == _counters(j_tier)
    assert tier.stats["kv_swap_in_blocks"] >= 1
    assert log["restores"] >= 1
    assert tier.kv_bytes_per_block() == j_tier.kv_bytes_per_block()
    _clean(tier)


def _drain_pipelined(eng):
    """step_begin the next step before step_finish of the previous one
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


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_swap_pipelined_depth2_exact(models, prompts, dtype):
    """At the oversubscribed pool's depth 2 a swap-out gathers behind an
    in-flight dispatch and a restore writes only fresh private blocks
    (the fence keeps every block that dispatch may write out of the
    allocator): the streams stay the reference's, the audit holds after
    every operation, and the pool drains clean."""
    jm, tm = models
    j_tier = JEngine(jm, **_kw(kv_pool_blocks=8, kv_cache_dtype=dtype,
                               kv_host_swap=True))
    want = _toks(j_tier, prompts)
    tier = LLMEngine(tm, device="cpu", **_kw(
        kv_pool_blocks=8, kv_cache_dtype=dtype, kv_host_swap=True))
    assert tier.max_pipeline_depth() == 2
    log = _watch_round_trips(tier)
    rids = [tier.add_request(p, max_new_tokens=10) for p in prompts]
    outs = _drain_pipelined(tier)
    assert [list(outs[r].token_ids) for r in rids] == want
    assert tier.stats["kv_swap_out_blocks"] >= 1 and log["restores"] >= 1
    assert not tier._write_fence and not tier._quarantine
    _clean(tier)


def test_swap_resident_window_and_entry_cleanup(models, prompts):
    """Between the preempting step and the re-admitting one the request is
    swap-resident, at the same steps as in the reference; terminal
    finishes, cancellation included, drop any leftover entry."""
    seen = []
    for eng in _pair(models, kv_pool_blocks=8, kv_host_swap=True):
        rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        steps = []
        while eng.has_unfinished():
            eng.step()
            steps.append(tuple(eng.swap_resident_rids()))
        assert {r for s in steps for r in s} & set(rids)
        assert not eng._swap_store
        seen.append(steps)
        for r in rids:
            eng.finished_outputs.pop(r)
    assert seen[1] == seen[0]
    eng = _pair(models, kv_pool_blocks=8, kv_host_swap=True)[1]
    rid = eng.add_request(prompts[0], max_new_tokens=4)
    eng._swap_store[rid] = {"tokens": np.zeros(1, np.int32),
                            "adapter_id": 0, "n_blocks": 1, "kv": None,
                            "scale": None, "nbytes": 0}
    assert eng.swap_resident_rids() == (rid,)
    eng.cancel(rid)
    assert rid not in eng._swap_store


def test_stale_entry_is_dropped_not_restored(models, prompts):
    """An entry whose tokens are not the re-admitted prompt's prefix (rid
    reuse) is dropped at the first mixed step, never restored: the
    request prefills as if there were none, as in the reference."""
    outs = []
    for eng in _pair(models, kv_host_swap=True):
        rid = eng.add_request(prompts[0], max_new_tokens=4)
        eng._swap_store[rid] = {
            "tokens": prompts[1][:17], "adapter_id": 0, "n_blocks": 3,
            "kv": None, "scale": None, "k": None, "v": None,
            "ready": True, "nbytes": 0}
        while eng.has_unfinished():
            eng.step()
        outs.append(list(eng.finished_outputs.pop(rid).token_ids))
        assert eng.stats["kv_swap_in_blocks"] == 0
        assert not eng._swap_store
    assert outs[1] == outs[0]


def test_ramp_livelock_shape_completes(models):
    """2 slots x 4-block prompts x 4-block pool: the admission-defer
    progress guarantee serializes the ramps, with no preemption and the
    reference's steps."""
    rng = np.random.default_rng(3)
    ps = [rng.integers(1, V, size=(26,)).astype(np.int32)
          for _ in range(2)]
    kw = dict(max_batch=2, max_seq_len=32, chunk_size=8,
              cache_impl="paged", block_size=8, scheduler="fused")
    jm, tm = models
    ref = _toks(JEngine(jm, **kw), ps, n=5)
    j_sub = JEngine(jm, kv_pool_blocks=4, **kw)
    assert _toks(j_sub, ps, n=5) == ref
    sub = LLMEngine(tm, device="cpu", kv_pool_blocks=4, **kw)
    t0 = time.perf_counter()
    outs = sub.generate(ps, max_new_tokens=5)
    assert time.perf_counter() - t0 < 60
    assert [list(o.token_ids) for o in outs] == ref
    assert [o.finish_reason for o in outs] == ["length", "length"]
    assert sub.stats["preemptions"] == 0
    assert sub.stats["steps"] == j_sub.stats["steps"] <= 40


# ---------------------------------------------------------------------------
# the prefix spill store
# ---------------------------------------------------------------------------

def test_prefix_spill_promotion_tenant_keyed(models, prompts):
    """An LRU-evicted prefix block demotes to the host spill store; the
    same prompt's re-admission promotes it back (a prefix hit, no
    recompute), with the reference's counters at every stage; the swap
    bytes stay 0 (swap is off). Adapter tenants are ROADMAP A10."""
    rng = np.random.default_rng(5)
    churn = [rng.integers(1, V, size=(27,)).astype(np.int32)
             for _ in range(2)]
    p0 = prompts[0]
    j_eng, eng = _pair(models, kv_pool_blocks=8, enable_prefix_cache=True,
                       kv_host_spill_bytes=4 << 20)
    log = _watch_round_trips(eng)
    for stage in ([p0], churn):
        n = 4 if len(stage) == 1 else 8
        assert _toks(eng, stage, n) == _toks(j_eng, stage, n)
        assert _counters(eng) == _counters(j_eng)
    hits_before = eng.stats["prefix_hit_tokens"]
    assert eng.stats["kv_spill_blocks"] >= 1
    assert len(eng._spill) == len(j_eng._spill) >= 1
    assert eng._spill_bytes == j_eng._spill_bytes
    assert set(eng._spill) == set(j_eng._spill)     # the same chain hashes
    assert eng.probe_prefix_len(p0, adapter_id=0) == \
        j_eng.probe_prefix_len(p0, adapter_id=0) >= eng.block_size
    assert j_eng.probe_prefix_len(p0, adapter_id=1) == 0
    with pytest.raises(NotImplementedError, match="A10"):
        eng.probe_prefix_len(p0, adapter_id=1)
    assert _toks(eng, [p0], 4) == _toks(j_eng, [p0], 4)
    assert _counters(eng) == _counters(j_eng)
    assert eng.stats["kv_promote_blocks"] >= 1
    assert eng.stats["prefix_hit_tokens"] > hits_before
    assert log["restores"] == eng.stats["kv_promote_blocks"]
    assert eng.stats["kv_swap_in_bytes"] == 0
    assert eng.stats["kv_swap_out_bytes"] == 0
    eng._check_pool_invariants()


def test_spill_byte_budget_bounds_store(models, prompts):
    """The spill store is byte-bounded: a budget of one block holds one
    entry (oldest out); a budget below one block stops spilling (the
    bound is read at each eviction)."""
    rng = np.random.default_rng(8)
    churn = [rng.integers(1, V, size=(27,)).astype(np.int32)
             for _ in range(2)]
    per = LLMEngine(models[1], device="cpu",
                    **_kw(kv_pool_blocks=8)).kv_bytes_per_block()
    j_one, one = _pair(models, kv_pool_blocks=8, enable_prefix_cache=True,
                       kv_host_spill_bytes=per)
    assert j_one.kv_bytes_per_block() == per
    for eng in (j_one, one):
        _toks(eng, [prompts[0]], 4)
        _toks(eng, churn, 8)
    assert _counters(one) == _counters(j_one)
    assert one.stats["kv_spill_blocks"] >= 1
    assert len(one._spill) == 1 and one._spill_bytes <= per
    for eng in (j_one, one):
        eng.kv_host_spill_bytes = max(per // 2, 1)
    spilled = one.stats["kv_spill_blocks"]
    assert _toks(one, [prompts[1]], 8) == _toks(j_one, [prompts[1]], 8)
    assert one.stats["kv_spill_blocks"] == spilled
    assert _counters(one) == _counters(j_one)


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def _drive(eng, rec, batches):
    eng.flight_recorder = rec
    out = []
    for ps, n in batches:
        rids = [eng.add_request(p, max_new_tokens=n) for p in ps]
        while eng.has_unfinished():
            eng.step()
        out += [list(eng.finished_outputs.pop(r).token_ids) for r in rids]
    return out


def _tier_events(rec):
    return {rid: [(e["kind"], e["step_id"], e["value"])
                  for e in tl["events"] if e["kind"] in
                  ("swapped_in", "preempted", "cached_prefix", "prefill")]
            for rid, tl in rec.timelines().items()}


@pytest.mark.parametrize("case", ["swap", "spill_and_swap"])
def test_steprecords_carry_tier_traffic_step_for_step(models, prompts, case):
    """Driven alike at depth 1, the port's StepRecords equal the
    reference's in every field the tier decides (the swap byte deltas,
    the spill store's size), and the swapped_in events join the same
    steps with the same values."""
    rng = np.random.default_rng(5)
    if case == "swap":
        over = dict(kv_pool_blocks=8, kv_host_swap=True)
        batches = [(prompts, 10)]
    else:
        over = dict(kv_pool_blocks=8, kv_host_swap=True,
                    enable_prefix_cache=True, kv_host_spill_bytes=4 << 20)
        churn = [rng.integers(1, V, size=(27,)).astype(np.int32)
                 for _ in range(2)]
        batches = [([prompts[0]], 4), (churn, 12), (prompts, 10)]
    j_eng, eng = _pair(models, **over)
    want = _drive(j_eng, jfr.FlightRecorder(capacity=1024), batches)
    got = _drive(eng, FlightRecorder(capacity=1024), batches)
    assert got == want
    w_recs = j_eng.flight_recorder.records()
    g_recs = eng.flight_recorder.records()
    assert len(g_recs) == len(w_recs)
    for w, g in zip(w_recs, g_recs):
        wd, gd = w.to_dict(), g.to_dict()
        assert {k: gd[k] for k in TIER_FIELDS} == \
            {k: wd[k] for k in TIER_FIELDS}, f"step {w.step_id}"
    assert any(r.kv_swap_out_bytes for r in g_recs)
    assert any(r.kv_swap_in_bytes for r in g_recs)
    if case != "swap":
        assert any(r.kv_host_spill_blocks for r in g_recs)
    assert _tier_events(eng.flight_recorder) == \
        _tier_events(j_eng.flight_recorder)
    assert _counters(eng) == _counters(j_eng)


def test_steprecord_and_gauges_carry_tier_traffic(models, prompts):
    """Through AsyncLLMServer: the records of the preempting and restoring
    steps carry the swap byte deltas, and the server samples the tier's
    gauges and books its counters (equal to the engine's stats)."""
    eng = LLMEngine(models[1], device="cpu",
                    **_kw(kv_pool_blocks=8, kv_host_swap=True))
    server = AsyncLLMServer(eng, flight_recorder=FlightRecorder())
    server.start()
    try:
        handles = [server.submit(p, max_new_tokens=10) for p in prompts]
        for h in handles:
            h.result(timeout=300)
    finally:
        server.stop()
    recs = server.flight_recorder.records()
    assert any((r.kv_swap_out_bytes or 0) > 0 for r in recs)
    assert any((r.kv_swap_in_bytes or 0) > 0 for r in recs)
    assert all(r.kv_host_spill_blocks is not None for r in recs)
    d = recs[-1].to_dict()
    for key in ("kv_swap_in_bytes", "kv_swap_out_bytes",
                "kv_host_spill_blocks"):
        assert key in d
    g = server.telemetry.get_gauges()
    assert g["kv_swap_out_bytes"] == eng.stats["kv_swap_out_bytes"] > 0
    assert g["kv_swap_in_bytes"] == eng.stats["kv_swap_in_bytes"] > 0
    assert g["kv_host_spill_blocks"] == 0       # spill off on this engine
    assert g["kv_host_spill_bytes"] == 0
    c = server.telemetry.counters
    for key in ("kv_swap_out_blocks", "kv_swap_in_blocks",
                "kv_swap_saved_tokens"):
        assert c[key] == eng.stats[key] >= 1
    assert c["kv_spill_blocks"] == c["kv_promote_blocks"] == 0
    text = server.telemetry.prometheus_text()
    assert "kv_swap_in_bytes" in text and "kv_host_spill_blocks" in text


class _CrashWhen(FaultInjector):
    """Raise the injected fault at the first step_begin whose engine state
    meets ``cond``: a crash at a tier state, however the server's steps
    fall."""

    def __init__(self, cond):
        super().__init__()
        self.cond = cond
        self.at = None

    def on_step_begin(self, engine):
        if self.at is None and self.cond(engine):
            self.at = {"swap_entries": len(engine._swap_store),
                       **{k: engine.stats[k] for k in COUNTERS}}
            raise InjectedFault("injected fault with host-tier state")
        return super().on_step_begin(engine)


@pytest.mark.parametrize("when", ["swapped_out", "restored"])
def test_supervised_restart_with_swapped_slots(models, prompts, when):
    """A crash while the engine holds host-tier state (an entry awaiting
    re-admission, or after a restore): the restart rebuilds the pools and
    drops the swap store, re-admission re-prefills, and every stream
    continues as the reference engine's full-pool stream."""
    jm, tm = models
    want = _toks(JEngine(jm, **_kw()), prompts)
    eng = LLMEngine(tm, device="cpu",
                    **_kw(kv_pool_blocks=8, kv_host_swap=True))
    if when == "swapped_out":
        fi = _CrashWhen(lambda e: bool(e._swap_store))
    else:
        fi = _CrashWhen(lambda e: e.stats["kv_swap_in_blocks"] > 0)
    server = AsyncLLMServer(eng, supervise=RestartPolicy(max_restarts=2,
                                                         backoff_s=0.01),
                            fault_injector=fi)
    server.start()
    try:
        handles = [server.submit(p, max_new_tokens=10) for p in prompts]
        got = [list(h.result(timeout=300).token_ids) for h in handles]
    finally:
        server.stop()
    assert got == want
    assert fi.at is not None and server.restarts >= 1
    if when == "swapped_out":
        assert fi.at["swap_entries"] >= 1
    assert not eng._swap_store
    assert not eng._spill and eng._spill_bytes == 0
    eng._check_pool_invariants()


def test_reset_drops_the_tier(models, prompts):
    """reset() mid-swap empties the swap and spill stores with the pools:
    the entries describe buffers that no longer exist."""
    eng = LLMEngine(models[1], device="cpu", **_kw(
        kv_pool_blocks=8, kv_host_swap=True, enable_prefix_cache=True,
        kv_host_spill_bytes=4 << 20))
    for p in prompts:
        eng.add_request(p, max_new_tokens=10)
    while not eng._swap_store:
        eng.step()
    eng.reset()
    assert not eng._swap_store
    assert not eng._spill and eng._spill_bytes == 0
    eng._check_pool_invariants()


def test_admission_queue_front_grant():
    """AdmissionQueue.put(front=True), the re-admission grant, jumps fresh
    arrivals but still honours the bound, as the reference's does."""
    orders = []
    for q, full in ((JAdmissionQueue(max_size=3), JServerQueueFull),
                    (AdmissionQueue(max_size=3), ServerQueueFull)):
        q.put("a")
        q.put("b")
        q.put("r", front=True)
        first = q.pop()
        q.put("c")                              # back to capacity
        with pytest.raises(full):
            q.put("late", block=False, front=True)
        orders.append([first, q.pop(), q.pop(), q.pop()])
    assert orders[1] == orders[0] == ["r", "a", "b", "c"]
