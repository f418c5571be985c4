"""paddle_tpu_torch LLMEngine(scheduler="fused", readout_stride=k):
multi-step all-decode (A8(d)), held TOKEN-EXACT against the reference's
engine at the same stride and against the port's legacy engine, dense
and paged, pipelined to depth 1-3. The cases mirror
tests/test_multi_step.py: the mid-stride eos exit, the latency-tier pin,
the stride-1 path, the depth contract, the write fence and quarantine,
the server at depth 3, amortized emit stamps, supervised crash and hang
around a stride, int8/int4 pools, and the A/B tool. CPU, float32, 2
layers, hidden 64, vocab 96, on bridged weights."""
import collections
import functools

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
from paddle_tpu_torch.profiler import FlightRecorder
from paddle_tpu_torch.serving import (AsyncLLMServer, FaultInjector,
                                      RestartPolicy)
from paddle_tpu_torch.tools.multi_step_ab import serve_multi_step_ab

torch.set_num_threads(1)

V = 96
KW = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
          max_position_embeddings=128)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLlama(JConfig(**KW))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**KW), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture
def pool_checks(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_POOL_CHECKS", "1")


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, size=(n,)).astype(np.int32) for n in sizes]


def _kw(cache_impl="dense", **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("chunk_size", 16)
    if cache_impl == "paged":
        kw.setdefault("block_size", 8)
    return dict(cache_impl=cache_impl, **kw)


def _engine(tm, cache_impl="dense", **kw):
    return LLMEngine(tm, device="cpu", **_kw(cache_impl, **kw))


def _tokens(outs):
    return [list(o.token_ids) for o in outs]


@functools.lru_cache(maxsize=None)
def _ref_engine(jm, cache_impl, stride):
    """One reference fused engine per (cache, stride): its compiled
    programs serve every case that asks for it."""
    return JEngine(jm, **_kw(cache_impl, scheduler="fused",
                             readout_stride=stride))


def _ref(jm, cache_impl, stride, seed, sizes, n=8, **sampling):
    """The reference's fused engine at ``stride``, driven to the end."""
    eng = _ref_engine(jm, cache_impl, stride)
    assert not eng.has_unfinished()
    return _tokens(eng.generate(_prompts(seed, sizes), max_new_tokens=n,
                                **sampling))


def _drain_at_depth(eng, depth):
    """Up to ``depth`` step_begin()s in flight before each oldest
    step_finish(), the serving loop's deque discipline, without
    threads."""
    outs = {}
    pending = collections.deque()
    while eng.has_unfinished() or pending:
        while len(pending) < depth and eng.has_unfinished():
            p = eng.step_begin()
            if p is None:
                break
            pending.append(p)
        if not pending:
            break
        for o in eng.step_finish(pending.popleft()):
            outs[o.request_id] = o
    return outs


def _pool_clean(eng):
    assert len(eng._free_blocks) == eng.n_blocks
    assert not eng._write_fence and not eng._quarantine


# ---------------------------------------------------------------------------
# the parity matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_parity_matrix(models, pool_checks, cache_impl, stride, depth):
    """Greedy token-exact against the reference's engine at the same
    stride and against the port's legacy engine, for every (stride,
    depth), dense and paged; a paged pool ends fully free, unfenced."""
    jm, tm = models
    sizes = (16, 17, 15, 5)
    prompts = _prompts(1, sizes)
    want = _ref(jm, cache_impl, stride, 1, sizes)
    legacy = _tokens(_engine(tm, cache_impl).generate(prompts,
                                                      max_new_tokens=8))
    eng = _engine(tm, cache_impl, scheduler="fused", readout_stride=stride)
    assert depth <= eng.max_pipeline_depth()
    rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    outs = _drain_at_depth(eng, depth)
    got = [list(outs[r].token_ids) for r in rids]
    assert got == want == legacy
    assert (eng.stats["multi_steps"] > 0) == (stride > 1)
    if cache_impl == "paged":
        _pool_clean(eng)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_pool_under_stride(models, pool_checks, quant):
    """An int8/int4 paged pool under stride 4 (B4-decode's plain version
    inside every iteration) is token-exact against the reference's
    quantized engine at stride 4, at depth 3."""
    jm, tm = models
    prompts = _prompts(21, (13, 9, 20))
    kw = _kw("paged", scheduler="fused", readout_stride=4,
             kv_cache_dtype=quant)
    want = _tokens(JEngine(jm, **kw).generate(prompts, max_new_tokens=12))
    eng = LLMEngine(tm, device="cpu", **kw)
    rids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
    outs = _drain_at_depth(eng, 3)
    assert [list(outs[r].token_ids) for r in rids] == want
    assert eng.stats["multi_steps"] > 0
    _pool_clean(eng)


def test_mid_stride_early_exit(models):
    """Every slot hits eos inside a stride: the readout sees the live
    rows only and the stream equals the reference's and the legacy
    engine's; the whole post-ramp stream rode multi-step dispatches."""
    jm, tm = models
    (p,) = _prompts(2, (9,))
    (probe,) = _engine(tm).generate([p], max_new_tokens=12)
    eos = probe.token_ids[2]        # eos lands 3 tokens in: mid-stride
    (legacy,) = _engine(tm).generate([p], max_new_tokens=12,
                                     eos_token_id=eos)
    (ref,) = _ref(jm, "dense", 4, 2, (9,), 12, eos_token_id=eos)
    eng = _engine(tm, scheduler="fused", readout_stride=4)
    (out,) = eng.generate([p], max_new_tokens=12, eos_token_id=eos)
    assert out.token_ids == ref == legacy.token_ids
    assert out.finish_reason == "eos"
    assert eng.stats["multi_steps"] >= 1
    assert eng.stats["tokens_generated"] == len(ref)


def test_latency_tier_pin_forces_stride_1(models):
    """A request pinning readout_stride=1 drags every all-decode step it
    is resident in to per-step readout, and tokens stay exact."""
    jm, tm = models
    p1, p2 = _prompts(3, (16, 17))
    ref = _ref_engine(jm, "dense", 4)
    ref.reset_stats()
    a = ref.add_request(p1, max_new_tokens=8)
    b = ref.add_request(p2, max_new_tokens=8, readout_stride=1)
    while ref.has_unfinished():
        ref.step()
    eng = _engine(tm, scheduler="fused", readout_stride=4)
    pa = eng.add_request(p1, max_new_tokens=8)
    pb = eng.add_request(p2, max_new_tokens=8, readout_stride=1)
    while eng.has_unfinished():
        eng.step()
    assert eng.finished_outputs[pa].token_ids == \
        ref.finished_outputs[a].token_ids
    assert eng.finished_outputs[pb].token_ids == \
        ref.finished_outputs[b].token_ids
    assert eng.stats["multi_steps"] == ref.stats["multi_steps"] == 0
    ref.finished_outputs.clear()


def test_stride_1_takes_the_pre_stride_path(models):
    """readout_stride=1 at depth <= 2 is the pre-stride engine: every
    dispatch reads one row, no multi-step dispatch, no emit backdate."""
    _, tm = models
    eng = _engine(tm, scheduler="fused")
    rows = []
    begin = eng.step_begin

    def counted():
        p = begin()
        if p is not None and p.toks is not None:
            rows.append(p.toks.shape[0])
        return p

    eng.step_begin = counted
    rids = [eng.add_request(p, max_new_tokens=6)
            for p in _prompts(4, (9, 14))]
    outs = _drain_at_depth(eng, 2)
    assert all(outs[r].finished for r in rids)
    assert rows and set(rows) == {1}
    assert eng.stats["multi_steps"] == 0
    assert eng.emit_backdate_s == 0.0


# ---------------------------------------------------------------------------
# the depth contract and the in-flight write fence
# ---------------------------------------------------------------------------

def test_depth_contract(models):
    _, tm = models
    assert _engine(tm).max_pipeline_depth() == 2
    assert _engine(tm, "paged").max_pipeline_depth() == 1
    assert _engine(tm, scheduler="fused",
                   readout_stride=4).max_pipeline_depth() == 3
    assert _engine(tm, "paged", scheduler="fused",
                   readout_stride=4).max_pipeline_depth() == 3
    assert _engine(tm, "paged", scheduler="fused", readout_stride=4,
                   kv_pool_blocks=8).max_pipeline_depth() == 2


def test_paged_depth_guard_allows_3_rejects_4(models):
    _, tm = models
    eng = _engine(tm, "paged", scheduler="fused", readout_stride=2)
    eng.add_request(_prompts(5, (6,))[0], max_new_tokens=16)
    pendings = [eng.step_begin() for _ in range(3)]
    with pytest.raises(RuntimeError, match="pipeline"):
        eng.step_begin()
    for p in pendings:
        eng.step_finish(p)
    while eng.has_unfinished():
        eng.step()
    _pool_clean(eng)


def test_oversubscribed_preemption_under_pipelining_stays_exact(
        models, pool_checks):
    """Pool pressure preempts mid-flight at depth 2 with a stride: the
    fence quarantines the victim's blocks, streams stay exact against
    the full-pool legacy engine, and the pool reconciles."""
    _, tm = models
    prompts = _prompts(6, (25, 27))
    ref = _tokens(_engine(tm, "paged").generate(prompts,
                                                max_new_tokens=10))
    sub = _engine(tm, "paged", scheduler="fused", kv_pool_blocks=8,
                  readout_stride=2)
    rids = [sub.add_request(p, max_new_tokens=10) for p in prompts]
    outs = _drain_at_depth(sub, 2)
    assert [list(outs[r].token_ids) for r in rids] == ref
    assert sub.stats["preemptions"] >= 1
    _pool_clean(sub)


def test_release_under_fence_quarantines(models):
    """A fenced block released at refcount 0 parks in quarantine until
    its last in-flight fence drops, then returns to the free heap."""
    _, tm = models
    eng = _engine(tm, "paged", scheduler="fused")
    eng.add_request(_prompts(7, (6,))[0], max_new_tokens=4)
    pending = eng.step_begin()
    assert pending.fenced
    phys = pending.fenced[0]
    assert eng._write_fence[phys] >= 1
    eng.cancel(0)
    assert phys in eng._quarantine and phys not in eng._free_blocks
    eng.step_finish(pending)
    assert phys not in eng._quarantine and phys in eng._free_blocks
    eng._check_pool_invariants()


def test_registered_block_release_under_fence_quarantines(models):
    """A mixed step's prefill grant registers its filled blocks at
    dispatch, so a block can be registered and fenced at once: released,
    it quarantines, and its unfence routes it to the LRU."""
    _, tm = models
    eng = _engine(tm, "paged", scheduler="fused", enable_prefix_cache=True)
    eng.add_request(_prompts(14, (12,))[0], max_new_tokens=4)
    pending = eng.step_begin()
    reg = [ph for ph in pending.fenced if ph in eng._block_hash]
    assert reg, "grant did not register a fenced block at dispatch"
    eng.cancel(0)
    for ph in reg:
        assert ph in eng._quarantine
        assert ph not in eng._lru and ph not in eng._free_blocks
    eng.step_finish(pending)
    for ph in reg:
        assert ph in eng._lru and ph not in eng._quarantine
    eng._check_pool_invariants()


def test_probe_attaches_quarantined_registered_block(models):
    """A prefix probe may attach a registered block out of quarantine:
    it leaves quarantine on attach, the hit serves, and the stream is
    exact against a cold run."""
    _, tm = models
    (p,) = _prompts(15, (12,))
    (ref,) = _engine(tm, "paged", scheduler="fused").generate(
        [p], max_new_tokens=4)
    eng = _engine(tm, "paged", scheduler="fused", enable_prefix_cache=True)
    eng.add_request(p, max_new_tokens=4)
    pending = eng.step_begin()
    reg = [ph for ph in pending.fenced if ph in eng._block_hash]
    assert reg
    eng.cancel(0)
    assert all(ph in eng._quarantine for ph in reg)
    rid = eng.add_request(p, max_new_tokens=4)
    pending2 = eng.step_begin()
    assert all(ph not in eng._quarantine for ph in reg)
    assert eng.stats["prefix_hit_tokens"] >= 8
    eng.step_finish(pending)
    eng.step_finish(pending2)
    while eng.has_unfinished():
        eng.step()
    assert eng.finished_outputs[rid].token_ids == ref.token_ids
    eng._check_pool_invariants()


# ---------------------------------------------------------------------------
# serving: depth 3 with a stride, the pin, amortized stamps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_serve_depth3_stride4_token_exact(models, cache_impl):
    jm, tm = models
    sizes = (9, 17, 12, 5)
    prompts = _prompts(8, sizes)
    want = _ref(jm, cache_impl, 4, 8, sizes)
    server = AsyncLLMServer(_engine(tm, cache_impl, scheduler="fused",
                                    readout_stride=4),
                            max_queue_size=8, pipeline_depth=3)
    assert server.pipeline_depth == 3
    with server:
        handles = [server.submit(p, max_new_tokens=8) for p in prompts]
        results = [h.result(timeout=240) for h in handles]
    assert [list(r.token_ids) for r in results] == want
    snap = server.telemetry.snapshot()
    assert snap["counters"]["multi_steps"] >= 1
    assert snap["counters"]["tokens_emitted"] == sum(len(t) for t in want)


def test_server_stride_pin_plumbs_through(models):
    """submit(readout_stride=1) reaches the engine request and holds the
    whole serve at per-step readout; the stream stays exact."""
    _, tm = models
    (p,) = _prompts(9, (9,))
    (ref,) = _engine(tm).generate([p], max_new_tokens=6)
    eng = _engine(tm, scheduler="fused", readout_stride=4)
    server = AsyncLLMServer(eng, max_queue_size=4)
    with server:
        res = server.submit(p, max_new_tokens=6,
                            readout_stride=1).result(timeout=120)
        with pytest.raises(ValueError, match="readout_stride"):
            server.submit(p, readout_stride=0)
    assert res.token_ids == ref.token_ids
    assert eng.stats["multi_steps"] == 0


def test_amortized_stamps_monotonic_and_spread(models):
    """A k-row readout backdates each row to its amortized device step
    boundary: gaps are non-negative, stamps monotone, and the rows of one
    stride carry distinct stamps; the records carry the stride."""
    _, tm = models
    eng = _engine(tm, scheduler="fused", readout_stride=4)
    rec = FlightRecorder()
    eng.flight_recorder = rec
    (out,) = eng.generate(_prompts(10, (9,)), max_new_tokens=12)
    tl = rec.request_trace(out.request_id)
    toks = [e for e in tl["events"] if e["kind"] == "token"]
    assert len(toks) == 12
    assert all(e["value"] >= 0.0 for e in toks if e["value"] is not None)
    stamps = [e["t"] for e in toks]
    assert stamps == sorted(stamps)
    by_step = collections.Counter(e["step_id"] for e in toks)
    multi = [sid for sid, n in by_step.items() if n > 1]
    assert multi, "no multi-row readout recorded"
    for sid in multi:
        row = [e["t"] for e in toks if e["step_id"] == sid]
        assert len(set(row)) == len(row)
    assert 4 in {r.readout_stride for r in rec.records()}


# ---------------------------------------------------------------------------
# supervised crash and hang around a multi-step dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", [
    dict(),
    dict(cache_impl="paged"),
    dict(cache_impl="paged", enable_prefix_cache=True),
], ids=["dense", "paged", "paged_prefix"])
@pytest.mark.parametrize("phase", ["begin", "finish"])
def test_crash_around_multi_step_dispatch_recovers_exact(models, pool_checks,
                                                         config, phase):
    """A crash at a stride's dispatch boundary (finish: a whole stride's
    tokens unread when the loop dies) recovers token-exactly under
    supervise= at depth 3 and stride 4."""
    _, tm = models
    prompts = _prompts(11, (9, 5, 17))
    eng = _engine(tm, scheduler="fused", readout_stride=4, **config)
    want = _tokens(eng.generate(prompts, max_new_tokens=8))
    eng.reset_stats()
    fi = FaultInjector().crash_at_step(4, phase=phase)
    server = AsyncLLMServer(
        eng, max_queue_size=8, fault_injector=fi, pipeline_depth=3,
        supervise=RestartPolicy(max_restarts=2, backoff_s=0.01))
    with server:
        handles = [server.submit(p, max_new_tokens=8) for p in prompts]
        results = [h.result(timeout=240) for h in handles]
    assert [list(r.token_ids) for r in results] == want
    assert fi.fired and fi.fired[0][0] == "raise"
    assert 1 <= server.restarts <= 2
    assert server.telemetry.snapshot()["counters"]["requests_resumed"] >= 1
    if eng.cache_impl == "paged":
        assert not eng._write_fence and not eng._quarantine
        eng._check_pool_invariants()


def test_hang_inside_multi_step_dispatch_serves_out(models):
    """A non-interruptible hang at a stride's dispatch stalls the loop
    and changes nothing: streams exact, the schedule fired once."""
    _, tm = models
    prompts = _prompts(13, (9, 17))
    eng = _engine(tm, "paged", scheduler="fused", readout_stride=4,
                  enable_prefix_cache=True)
    want = _tokens(eng.generate(prompts, max_new_tokens=8))
    fi = FaultInjector().hang_at_step(3, 0.15, interruptible=False)
    server = AsyncLLMServer(eng, max_queue_size=8, fault_injector=fi,
                            pipeline_depth=3)
    with server:
        handles = [server.submit(p, max_new_tokens=8) for p in prompts]
        results = [h.result(timeout=240) for h in handles]
    assert [list(r.token_ids) for r in results] == want
    assert fi.fired == [("hang", 3, 0.15)]
    assert not eng._write_fence and not eng._quarantine
    eng._check_pool_invariants()


# ---------------------------------------------------------------------------
# the constructor contract, the device, the A/B tool
# ---------------------------------------------------------------------------

def test_stride_needs_fused(models):
    jm, tm = models
    for mk in (lambda **kw: JEngine(jm, **kw),
               lambda **kw: LLMEngine(tm, device="cpu", **kw)):
        with pytest.raises(ValueError, match="fused"):
            mk(max_batch=1, max_seq_len=64, chunk_size=16, readout_stride=4)
        with pytest.raises(ValueError, match="horizon"):
            mk(max_batch=1, max_seq_len=64, chunk_size=16,
               scheduler="fused", horizon=4, readout_stride=4)
        eng = mk(max_batch=1, max_seq_len=64, chunk_size=16,
                 scheduler="fused")
        with pytest.raises(ValueError, match="readout_stride"):
            eng.add_request(np.asarray([3, 4], np.int32), readout_stride=0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
def test_stride_engine_asks_for_the_card(models):
    """A stride engine built without a device asks for the card and
    raises where there is none: no silent CPU fallback."""
    _, tm = models
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(tm, **_kw(scheduler="fused", readout_stride=4))


def test_multi_step_ab_tool(models):
    """The A/B tool at tiny size: token parity (asserted inside), the
    reference's keys per arm, multi-step dispatches in the stride arm
    only and fewer host round trips there. No wall-clock ratio is
    asserted: on the CPU the dispatch timer absorbs the compute."""
    _, tm = models
    prompts = _prompts(12, (20, 33, 17, 9, 25, 40))
    ab = serve_multi_step_ab(tm, prompts, new_tokens=48, B=3, cap=128,
                             stride=8, rtt_s=1e-3, chunk_size=16,
                             timeout=240, device="cpu")
    assert ab["token_parity"] is True and ab["readout_stride"] == 8
    assert ab["multi_step_speedup"] > 0
    on, off = ab["on"], ab["off"]
    for key in ("readout_stride", "tokens_per_sec", "host_round_trips",
                "multi_steps", "host_sync_share", "dispatch_share",
                "rtt_share", "host_tax_s", "host_tax_ms_per_token",
                "pipeline_depth"):
        assert key in on and key in off, key
    assert on["multi_steps"] > 0 and off["multi_steps"] == 0
    assert on["host_round_trips"] < off["host_round_trips"]
    assert on["rtt_share"] < off["rtt_share"]
