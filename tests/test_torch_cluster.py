"""paddle_tpu_torch.serving.ReplicaRouter over the port's AsyncLLMServer
replicas: the router cases of tests/test_cluster.py (and the router case
of tests/test_kv_tier.py) at their shapes (2 layers, hidden 64, vocab 96,
seed 7; replicas of ``max_batch=2, max_seq_len=64, chunk_size=16,
block_size=8``, paged, fused, prefix cache on, flight recorder), on the CPU
in float32 over bridged weights, with ``PADDLE_TPU_POOL_CHECKS=1``.

Where a reference case takes its expected tokens from its dense parity
engine, they come here from the REFERENCE's ``LLMEngine.generate`` on the
same prompts and weights: every routed greedy stream equals the JAX
package's token for token. Cross-package cases: the reference's router
over two reference engines and the port's over two port engines place the
same prompts on the same replicas (pinned, sequential affinity after a
concurrent seed wave, ``random`` under one seed) with the same
``affinity_tokens`` and streams; ``snapshot()`` and ``stats`` carry the
reference's keys; the signatures equal the reference's; what is not
ported raises naming its ROADMAP item.

Timing: placements match the reference's only where timing cannot enter
(the load term reads gauges each serve loop samples), so the
cross-package placements are pinned, one at a time on idle replicas, or
random. The hung-replica cases wait on the watchdog (a 0.5 s step
timeout, hangs of 3 s); every ``result()`` has a timeout."""
import inspect
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.jit.api import TrainStep as JTrainStep
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.serving import (AsyncLLMServer as JServer,
                                ReplicaRouter as JRouter)

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (AsyncLLMServer, FaultInjector,
                                      ReplicaRouter, RestartPolicy)
from paddle_tpu_torch.serving.cluster import FLEET_TAIL_CAUSES

torch.set_num_threads(1)

V = 96
CFG = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=128)
T = 120          # seconds a result() may take before the case fails


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLlama(JConfig(**CFG))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def tm(models):
    return models[1]


@pytest.fixture(scope="module")
def ref_tokens(models):
    """The reference's dense parity engine (``router_ref_eng``): greedy
    streams of the JAX package for the same prompts and weights."""
    eng = JEngine(models[0], max_batch=2, max_seq_len=64, chunk_size=16)

    def run(prompts, n):
        assert all(s is None for s in eng.slots) and not eng.waiting
        return [list(o.token_ids)
                for o in eng.generate(prompts, max_new_tokens=n)]
    return run


def _engine_kw(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("chunk_size", 16)
    return dict(cache_impl="paged", block_size=8, scheduler="fused",
                enable_prefix_cache=True, **kw)


def _replica(model, i, fault_injector=None, **kw):
    srv_kw = {k: kw.pop(k) for k in ("step_timeout_s", "supervise")
              if k in kw}
    eng = LLMEngine(model, device="cpu", **_engine_kw(**kw))
    return AsyncLLMServer(eng, max_queue_size=8, replica=i,
                          flight_recorder=True,
                          fault_injector=fault_injector, **srv_kw)


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, size=(n,)).astype(np.int32) for n in sizes]


def _shared_prompts(seed, sys_len, tail_sizes):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, V, size=(sys_len,)).astype(np.int32)
    return [np.concatenate([sysp,
                            rng.integers(1, V, size=(n,)).astype(np.int32)])
            for n in tail_sizes]


def _throttle(engine, dt=0.01):
    """Slow an engine's readout so a queued request is still queued when
    the case acts on it."""
    orig = engine.step_finish
    engine.step_finish = lambda p: (time.sleep(dt), orig(p))[1]


def _warm(servers, prompt):
    """Run one short request through each engine before a tight
    ``step_timeout_s`` arms, as the reference's cases do."""
    for srv in servers:
        srv.engine.generate([prompt], max_new_tokens=2)
        srv.engine.reset()


# ---------------------------------------------------------------------------
# twins of tests/test_cluster.py's router cases
# ---------------------------------------------------------------------------

def test_probe_prefix_len_read_only(tm):
    """The router's affinity probe reports the cached prefix without
    touching allocator state (no refcount bumps, no table writes)."""
    eng = LLMEngine(tm, device="cpu", **_engine_kw())
    prompts = _shared_prompts(5, 24, (5,))
    eng.generate(prompts, max_new_tokens=4)
    before = (list(eng._free_blocks), list(eng._block_ref))
    assert eng.probe_prefix_len(prompts[0]) == 24
    assert eng.probe_prefix_len(prompts[0][:17]) == 16
    hashes = eng.prefix_chain_hashes(prompts[0])
    assert len(hashes) == 3
    assert eng.probe_prefix_len(prompts[0], chain_hashes=hashes) == 24
    assert eng.probe_prefix_len(np.arange(1, 40, dtype=np.int32)) == 0
    assert (list(eng._free_blocks), list(eng._block_ref)) == before
    eng._check_pool_invariants()
    dense = LLMEngine(tm, device="cpu", max_batch=1, max_seq_len=64,
                      chunk_size=16)
    assert dense.probe_prefix_len(prompts[0]) == 0
    assert eng.tp_degree() == dense.tp_degree() == 1


def test_router_affinity_placement(tm, ref_tokens):
    """A request sharing a cached system prompt routes to the replica
    that holds it; the placement is observable on ServeResult.routing and
    in the request's trace; streams equal the reference's."""
    prompts = _shared_prompts(0, 24, (5, 7, 3))
    want = ref_tokens(prompts, 6)
    router = ReplicaRouter([_replica(tm, 0), _replica(tm, 1)])
    router.start()
    try:
        r0 = router.submit(prompts[0], max_new_tokens=6).result(timeout=T)
        seeded = r0.routing["replica"]
        assert r0.routing["affinity_tokens"] == 0
        r1 = router.submit(prompts[1], max_new_tokens=6,
                           routing_key="tenantA").result(timeout=T)
        assert r1.routing["replica"] == seeded
        assert r1.routing["affinity_tokens"] == 24
        assert r1.routing["routing_key"] == "tenantA"
        assert r1.routing["policy"] == "affinity"
        assert "routed" in [e["kind"] for e in r1.trace["events"]]
        assert [r0.token_ids, r1.token_ids] == want[:2]
        h2 = router.submit(prompts[2], max_new_tokens=6)
        assert list(h2.tokens(timeout=T)) == want[2]
        assert router.stats["affinity_routed"] >= 1
    finally:
        assert router.stop() == []
    assert router.num_outstanding() == 0


def test_router_least_loaded_spreads(tm):
    """Without affinity signal, placement balances by load: two requests
    on two single-slot replicas land on DIFFERENT replicas."""
    srv0 = _replica(tm, 0, max_batch=1)
    srv1 = _replica(tm, 1, max_batch=1)
    router = ReplicaRouter([srv0, srv1], policy="least_loaded")
    router.start()
    try:
        _throttle(srv0.engine)
        _throttle(srv1.engine)
        prompts = _prompts(9, (9, 9))
        h0 = router.submit(prompts[0], max_new_tokens=12)
        time.sleep(0.15)
        h1 = router.submit(prompts[1], max_new_tokens=12)
        h0.result(timeout=T), h1.result(timeout=T)
        assert {h0.replica, h1.replica} == {0, 1}
        assert router.stats["placements"] == [1, 1]
    finally:
        router.stop()


def test_router_failover_mid_stream(tm, ref_tokens):
    """A killed replica's QUEUED requests complete on the survivor with
    the reference's tokens; its IN-FLIGHT request fails ``replica_lost``
    with the tokens streamed so far; the survivor's pool holds."""
    prompts = _shared_prompts(1, 16, (5, 7, 3))
    want = ref_tokens(prompts, 6)
    fi0 = FaultInjector()
    srv0 = _replica(tm, 0, fault_injector=fi0, max_batch=1)
    srv1 = _replica(tm, 1)
    router = ReplicaRouter([srv0, srv1])
    router.start()
    try:
        _throttle(srv0.engine)
        h_live = router.submit(prompts[0], max_new_tokens=30, replica=0)
        h_q1 = router.submit(prompts[1], max_new_tokens=6, replica=0)
        h_q2 = router.submit(prompts[2], max_new_tokens=6, replica=0)
        first = next(h_live.tokens(timeout=T))
        fi0.kill("injected replica death")
        lost = h_live.result(timeout=T)
        assert lost.finish_reason == "replica_lost"
        assert lost.token_ids[0] == first
        assert lost.routing["replica"] == 0
        assert lost.trace_ctx is not None and lost.trace_ctx.hop == 0
        for h, tokens in ((h_q1, want[1]), (h_q2, want[2])):
            res = h.result(timeout=T)
            assert res.finish_reason in ("length", "eos")
            assert res.token_ids == tokens
            assert h.replica == 1 and h.resubmits == 1
            assert res.routing["resubmits"] == 1
            assert res.trace_ctx.hop == 1
            assert res.trace_ctx.via == "failover"
        assert router.stats["replica_lost"] == 1
        assert router.stats["resubmitted"] == 2
        srv1.engine._check_pool_invariants()
        assert not router.alive(0) and router.alive(1)
        text = srv1.telemetry.prometheus_text()
        assert 'replica="1"' in text
        assert 'stage="idle",replica="1"' in text
        assert srv1.telemetry.snapshot()["replica"] == 1
        tail = srv1.flight_recorder.explain_tail(0.0)
        assert tail and all(e["routing"]["resubmits"] == 1 for e in tail)
    finally:
        errors = router.stop()
    assert [i for i, _ in errors] == [0]
    assert "injected replica death" in str(errors[0][1])


def test_router_hung_replica_failover_resume(tm, ref_tokens):
    """A replica wedged INSIDE a step (thread alive, heartbeat stale past
    ``step_timeout_s``) reads "hung"; the router evicts its residents
    (``AsyncLLMServer.evict_request``) without waiting for the thread,
    and with ``resume_inflight`` the stream continues on the survivor,
    equal to the reference's stream."""
    prompts = _shared_prompts(3, 16, (5,))
    want = ref_tokens(prompts, 10)
    fi0 = FaultInjector()
    srv0 = _replica(tm, 0, fault_injector=fi0, step_timeout_s=0.5)
    srv1 = _replica(tm, 1)
    _warm((srv0, srv1), prompts[0])
    router = ReplicaRouter([srv0, srv1], resume_inflight=True)
    router.start()
    try:
        h = router.submit(prompts[0], max_new_tokens=10, replica=0)
        first = next(h.tokens(timeout=T))
        # two working steps after scripting (the reference's 5): the
        # 10-token stream is still running however late this thread gets
        # here, on a loaded CPU
        fi0.hang_at_step(2, seconds=3.0, interruptible=False)
        res = h.result(timeout=T)
        assert res.finish_reason in ("length", "eos")
        assert res.token_ids == want[0]
        assert res.token_ids[0] == first
        assert h.replica == 1 and h.resubmits == 1
        assert router.stats["evicted_hung"] >= 1
        assert router.stats["resumed"] >= 1
        assert router.alive(0) and not router.healthy(0)
        assert srv0.health()["state"] == "hung"
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and \
                srv0.telemetry.get_gauges()["server_healthy"] != 0.0:
            time.sleep(0.01)
        assert srv0.telemetry.get_gauges()["server_healthy"] == 0.0
        srv1.engine._check_pool_invariants()
    finally:
        router.stop(timeout=T)
    assert router.num_outstanding() == 0


def test_evict_request_detaches_and_keeps_the_engine(tm):
    """``evict_request`` from another thread: the handle finishes at once
    with the given reason and every token emitted so far, a queued
    request leaves the queue, and unknown or finished ids answer None;
    the engine still serves the evicted slot to its end."""
    srv = _replica(tm, 0, max_batch=1)
    _throttle(srv.engine)
    prompts = _prompts(4, (9, 6))
    with srv:
        h_run = srv.submit(prompts[0], max_new_tokens=12)
        h_q = srv.submit(prompts[1], max_new_tokens=4)
        first = next(h_run.tokens(timeout=T))
        assert srv.evict_request(h_q.request_id) is h_q
        assert h_q.result(timeout=T).finish_reason == "evicted"
        assert h_q.result(timeout=T).token_ids == []
        assert len(srv._queue) == 0
        assert srv.evict_request(h_run.request_id, reason="x") is h_run
        res = h_run.result(timeout=T)
        assert res.finish_reason == "x" and res.token_ids[0] == first
        assert srv.evict_request(h_run.request_id) is None
        assert srv.evict_request(12345) is None
    assert srv.engine.stats["tokens_generated"] >= 12
    assert not srv.engine.has_unfinished() and srv.num_outstanding() == 0


def test_router_supervised_replica_recovers_in_place(tm, ref_tokens):
    """A SUPERVISED replica's crash is not a failover event: the restart
    resumes every stream in place and the router never resubmits."""
    prompts = _shared_prompts(9, 16, (5, 7))
    want = ref_tokens(prompts, 6)
    fi0 = FaultInjector().crash_at_step(3)
    srv0 = _replica(tm, 0, fault_injector=fi0,
                    supervise=RestartPolicy(max_restarts=1, backoff_s=0.01))
    srv1 = _replica(tm, 1)
    router = ReplicaRouter([srv0, srv1])
    router.start()
    try:
        hs = [router.submit(p, max_new_tokens=6, replica=0)
              for p in prompts]
        assert [h.result(timeout=T).token_ids for h in hs] == want
        assert all(h.replica == 0 and h.resubmits == 0 for h in hs)
        assert srv0.restarts == 1
        assert router.stats["resubmitted"] == 0
        assert router.stats["replica_lost"] == 0
        srv0.engine._check_pool_invariants()
    finally:
        router.stop()


def test_chaos_soak_three_replicas(tm, ref_tokens):
    """A seeded fault schedule (crashes + sub-watchdog hangs) over 3
    supervised replicas under mixed load: every stream finishes equal to
    the reference's or fails attributably; pool invariants hold."""
    rng = np.random.default_rng(42)
    prompts = _shared_prompts(10, 24, tuple(3 + i % 9 for i in range(18)))
    want = ref_tokens(prompts, 8)
    fis = [FaultInjector() for _ in range(3)]
    replicas = [_replica(tm, i, fault_injector=fis[i],
                         supervise=RestartPolicy(max_restarts=3,
                                                 backoff_s=0.01),
                         step_timeout_s=5.0)
                for i in range(3)]
    _warm(replicas, prompts[0][:8])
    for fi in fis:
        for step in sorted(int(s) for s in rng.integers(2, 40, size=3)):
            if rng.random() < 0.5:
                fi.crash_at_step(step)
            else:
                fi.hang_at_step(step, seconds=0.2)
    router = ReplicaRouter(replicas, resume_inflight=True)
    router.start()
    try:
        handles = [router.submit(p, max_new_tokens=8) for p in prompts]
        results = [h.result(timeout=T) for h in handles]
        exact = 0
        for r, tokens in zip(results, want):
            if r.finish_reason in ("length", "eos"):
                assert r.token_ids == tokens
                exact += 1
            else:
                assert r.finish_reason == "replica_lost", r
        assert exact >= len(prompts) - 2
        assert sum(len(fi.fired) for fi in fis) >= 3
        for srv in replicas:
            if srv._crashed is None:
                srv.engine._check_pool_invariants()
    finally:
        router.stop(timeout=T)


def test_router_drain_migrates_queued(tm, ref_tokens):
    """drain(): the replica takes no new work, its queued requests
    migrate to survivors, its running one finishes in place."""
    prompts = _shared_prompts(2, 16, (5, 7))
    want = ref_tokens(prompts, 6)
    srv0 = _replica(tm, 0, max_batch=1)
    srv1 = _replica(tm, 1)
    router = ReplicaRouter([srv0, srv1])
    router.start()
    try:
        _throttle(srv0.engine)
        h_run = router.submit(prompts[0], max_new_tokens=25, replica=0)
        h_q = router.submit(prompts[1], max_new_tokens=6, replica=0)
        next(h_run.tokens(timeout=T))
        router.drain(0, timeout=T)
        run_res = h_run.result(timeout=T)
        assert run_res.finish_reason in ("length", "eos")
        assert len(run_res.token_ids) == 25
        q_res = h_q.result(timeout=T)
        assert q_res.token_ids == want[1]
        assert q_res.routing["replica"] == 1
        assert not router.alive(0) and router.alive(1)
        h_new = router.submit(prompts[0], max_new_tokens=4)
        assert h_new.result(timeout=T).routing["replica"] == 1
    finally:
        router.stop()


def test_replica_labels_and_merged_trace(tmp_path, tm):
    """Replica-labeled Prometheus lines merge into one family per metric,
    snapshots carry the index, explain_tail entries carry the routing
    record, and the merged chrome trace has one lane group per
    replica."""
    prompts = _shared_prompts(4, 16, (5, 7))
    router = ReplicaRouter([_replica(tm, 0), _replica(tm, 1)])
    router.start()
    try:
        hs = [router.submit(p, max_new_tokens=6, replica=i % 2,
                            routing_key=f"t{i}")
              for i, p in enumerate(prompts)]
        for h in hs:
            h.result(timeout=T)
        text = router.prometheus_text()
        assert 'replica="0"' in text and 'replica="1"' in text
        fam = "paddle_tpu_serving_requests_finished_total"
        assert text.count(f"# TYPE {fam}") == 1
        assert text.count(f'{fam}{{replica="0"}}') == 1
        assert text.count(f'{fam}{{replica="1"}}') == 1
        assert 'stage="idle",replica="0"' in text
        snap = router.snapshot()
        assert snap["replicas"][0]["telemetry"]["replica"] == 0
        tail = router.replicas[0].flight_recorder.explain_tail(0.0)
        assert tail and all(e["routing"]["replica"] == 0 for e in tail)
        merged = router.export_merged_trace(
            str(tmp_path / "cluster_trace.json"))
        events = json.load(open(merged))["traceEvents"]
        names = {e["args"]["name"] for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        assert {"rank0:replica0", "rank1:replica1"} <= names
        assert {e["pid"] for e in events} == {0, 1}
        fleet = router.explain_tail(0.0)
        assert fleet and all(e["cause"] not in FLEET_TAIL_CAUSES
                             for e in fleet)
    finally:
        router.stop()


def test_routing_metadata_plain_server(tm):
    """submit(..., routing=...) surfaces on ServeResult and in the trace
    on a plain AsyncLLMServer, without the router."""
    eng = LLMEngine(tm, device="cpu", max_batch=1, max_seq_len=64,
                    chunk_size=16)
    server = AsyncLLMServer(eng, max_queue_size=4, flight_recorder=True)
    with server:
        h = server.submit(np.arange(1, 8, dtype=np.int32),
                          max_new_tokens=4,
                          routing={"routing_key": "abc", "shard": 3})
        res = h.result(timeout=T)
    assert res.routing == {"routing_key": "abc", "shard": 3}
    routed = [e for e in res.trace["events"] if e["kind"] == "routed"]
    assert routed and routed[0]["value"]["shard"] == 3


def test_failover_retries_through_full_survivor_queue(tm, ref_tokens):
    """A survivor whose admission queue is momentarily FULL does not turn
    a failover resubmission into request loss: the router parks the
    handle and retries until the queue frees."""
    prompts = _shared_prompts(6, 16, (5, 7, 3, 4))
    want = ref_tokens(prompts, 4)
    fi0 = FaultInjector()
    srv0 = _replica(tm, 0, fault_injector=fi0, max_batch=1)
    srv1 = AsyncLLMServer(
        LLMEngine(tm, device="cpu", **_engine_kw(max_batch=1)),
        max_queue_size=1, replica=1)
    router = ReplicaRouter([srv0, srv1], failover_retry_s=60.0)
    router.start()
    try:
        _throttle(srv0.engine)
        _throttle(srv1.engine)
        s_run = router.submit(prompts[0], max_new_tokens=25, replica=1)
        next(s_run.tokens(timeout=T))
        s_w = router.submit(prompts[1], max_new_tokens=4, replica=1)
        s_q = router.submit(prompts[2], max_new_tokens=4, replica=1)
        h_q = router.submit(prompts[3], max_new_tokens=4, replica=0)
        fi0.kill("injected replica death")
        res = h_q.result(timeout=T)
        assert res.finish_reason in ("length", "eos")
        assert res.token_ids == want[3]
        assert h_q.replica == 1 and h_q.resubmits == 1
        for h, tokens in ((s_w, want[1]), (s_q, want[2])):
            assert h.result(timeout=T).token_ids == tokens
        s_run.result(timeout=T)
    finally:
        router.stop()


def test_router_soak_under_churn(tm):
    """Mixed load across 3 replicas with a mid-run drain: every request
    finishes (complete or attributably migrated), pool invariants hold."""
    prompts = _shared_prompts(8, 24, tuple(3 + i % 9 for i in range(24)))
    replicas = [_replica(tm, i) for i in range(3)]
    router = ReplicaRouter(replicas)
    router.start()
    try:
        handles = [router.submit(p, max_new_tokens=8) for p in prompts[:16]]
        router.drain(0, timeout=T)
        handles += [router.submit(p, max_new_tokens=8)
                    for p in prompts[16:]]
        results = [h.result(timeout=T) for h in handles]
        assert all(r.finish_reason in ("length", "eos", "cancelled")
                   for r in results)
        for srv in replicas[1:]:
            srv.engine._check_pool_invariants()
    finally:
        router.stop()
    assert router.num_outstanding() == 0


def test_router_counts_swap_resident_failover(tm):
    """Twin of tests/test_kv_tier.py's router case over the port's host
    tier: a request whose KV lives in the wedged replica's host tier is
    evicted and resumed like a running one, and the router books it
    (stats, and the snapshot's kv_tier view)."""
    prompts = _prompts(0, (25, 27))
    fi0 = FaultInjector()
    srv0 = AsyncLLMServer(
        LLMEngine(tm, device="cpu", max_batch=2, max_seq_len=64,
                  chunk_size=16, cache_impl="paged", block_size=8,
                  scheduler="fused", kv_pool_blocks=8, kv_host_swap=True),
        replica=0, fault_injector=fi0, step_timeout_s=0.5)
    srv1 = AsyncLLMServer(
        LLMEngine(tm, device="cpu", max_batch=2, max_seq_len=64,
                  chunk_size=16, cache_impl="paged", block_size=8,
                  scheduler="fused"), replica=1)
    _warm((srv0, srv1), prompts[0][:5])
    router = ReplicaRouter([srv0, srv1], resume_inflight=True)
    router.start()
    try:
        h = router.submit(prompts[0], max_new_tokens=10, replica=0)
        first = next(h.tokens(timeout=T))
        # the swap-resident state, made deterministically on the replica
        # about to wedge, in the port's entry format; its rid is the
        # INNER (replica-local) request id the router probes by
        srv0.engine._swap_store[h._inner.request_id] = {
            "kv": torch.zeros(1), "scale": None,
            "tokens": np.zeros(1, np.int32), "adapter_id": 0,
            "n_blocks": 1, "nbytes": 0}
        snap = router.snapshot()
        assert snap["replicas"][0]["kv_tier"]["swap_resident"] == 1
        assert snap["replicas"][0]["tp_degree"] == 1
        fi0.hang_at_step(2, seconds=3.0, interruptible=False)
        res = h.result(timeout=T)
        assert res.finish_reason in ("length", "eos")
        assert res.token_ids[0] == first
        assert router.stats["evicted_hung"] >= 1
        assert router.stats["swap_resident_failover"] >= 1
        assert router.stats["kv_ship_abandoned"] >= 1
    finally:
        router.stop(timeout=T)


# ---------------------------------------------------------------------------
# cross-package cases
# ---------------------------------------------------------------------------

def _routers(models):
    jm, tm_ = models

    def jrep(i):
        return JServer(JEngine(jm, **_engine_kw()), max_queue_size=8,
                       replica=i)

    def trep(i):
        return AsyncLLMServer(LLMEngine(tm_, device="cpu", **_engine_kw()),
                              max_queue_size=8, replica=i)
    return jrep, trep


def _serve_one_at_a_time(router, prompts, n, **kw):
    out = []
    for i, p in enumerate(prompts):
        out.append(router.submit(p, max_new_tokens=n, **{
            k: (v(i) if callable(v) else v) for k, v in kw.items()})
            .result(timeout=T))
    return out


def _placements(results):
    return [(r.routing["replica"], r.routing["affinity_tokens"],
             list(r.token_ids)) for r in results]


def test_router_places_and_streams_as_the_reference(models):
    """The same prompts through the reference's router over two reference
    engines and the port's over two port engines: a concurrent seed wave
    (one request per tenant), one-at-a-time affinity placements and
    pinned submissions, then ``random`` under one seed. Every
    stream and every ``routing`` ``replica`` and ``affinity_tokens``
    equal; so do the routers' counters."""
    jrep, trep = _routers(models)
    tenants = [_shared_prompts(20 + t, 16, (3 + t, 6 + t, 4 + t, 5 + t,
                                            7 + t, 2 + t))
               for t in range(2)]
    seed_wave = [tenants[0][0], tenants[1][0]]
    later = [tenants[i % 2][1 + i // 2] for i in range(10)]
    pinned = _prompts(21, (9, 5, 12, 7))
    got = {}
    for side, rep, Router in (("ref", jrep, JRouter),
                              ("port", trep, ReplicaRouter)):
        out = {}
        router = Router([rep(0), rep(1)])
        router.start()
        try:
            # the seed wave first, on idle fresh replicas: the router's own
            # outstanding count, not a sampled gauge, spreads the tenants
            hs = [router.submit(p, max_new_tokens=5,
                                routing_key=f"tenant{i}")
                  for i, p in enumerate(seed_wave)]
            out["seed"] = _placements([h.result(timeout=T) for h in hs])
            out["affinity"] = _placements(_serve_one_at_a_time(
                router, later, 5, routing_key=lambda i: f"tenant{i % 2}"))
            out["pinned"] = _placements(_serve_one_at_a_time(
                router, pinned, 5, replica=lambda i: i % 2))
            out["stats"] = dict(router.stats)
        finally:
            router.stop()
        router = Router([rep(0), rep(1)], policy="random", seed=3)
        router.start()
        try:
            out["random"] = _placements(_serve_one_at_a_time(
                router, later, 5))
            out["random_stats"] = dict(router.stats)
        finally:
            router.stop()
        got[side] = out
    assert [r for r, _, _ in got["port"]["pinned"]] == [0, 1, 0, 1]
    assert sorted(r for r, _, _ in got["port"]["seed"]) == [0, 1]
    assert any(a > 0 for _, a, _ in got["port"]["affinity"])
    assert len({r for r, _, _ in got["port"]["random"]}) == 2
    for key in ("pinned", "seed", "affinity", "random", "stats",
                "random_stats"):
        assert got["port"][key] == got["ref"][key], key


def _key_tree(obj):
    if isinstance(obj, dict):
        return {str(k): _key_tree(v) for k, v in obj.items()}
    return None


def test_snapshot_and_stats_carry_the_reference_keys(models):
    """``snapshot()`` (router, per-replica kv_tier and telemetry views)
    and ``stats`` carry the reference router's key sets, recursively,
    after the same pinned requests."""
    jrep, trep = _routers(models)
    prompts = _prompts(22, (6, 9))
    trees = {}
    for side, rep, Router in (("ref", jrep, JRouter),
                              ("port", trep, ReplicaRouter)):
        router = Router([rep(0), rep(1)])
        router.start()
        try:
            _serve_one_at_a_time(router, prompts, 3,
                                 replica=lambda i: i % 2)
            trees[side] = (_key_tree(router.snapshot()),
                           _key_tree(router.stats))
        finally:
            router.stop()
    assert trees["port"] == trees["ref"]


@pytest.mark.parametrize("pair", [
    (ReplicaRouter, JRouter, "__init__"),
    (ReplicaRouter, JRouter, "submit"),
    (AsyncLLMServer, JServer, "evict_request"),
    (TrainStep, JTrainStep, "__init__"),
], ids=["router", "router_submit", "evict_request", "trainstep"])
def test_signatures_equal_the_reference(pair):
    """The names, order and defaults of the arguments equal the
    reference's (C6 for ``TrainStep``)."""
    port, ref, name = pair

    def sig(cls):
        return [(p.name, p.default)
                for p in inspect.signature(getattr(cls, name))
                .parameters.values()]
    assert sig(port) == sig(ref)


@pytest.mark.parametrize("case", ["roles", "transport", "pull_on_miss"])
def test_disaggregation_arguments_construct_as_the_reference(models, case):
    """``roles``, ``transport`` and ``pull_on_miss`` construct as the
    reference's do (tests/test_torch_kv_ship.py serves through them): the
    same roles, transport and flag on both routers, one replica in both
    role sets allowed; a role set that is empty or out of range raises
    ValueError in both."""
    jm, tm = models
    kw = {"roles": {"roles": {"prefill": [0], "decode": [0]}},
          "transport": {"transport": object()},
          "pull_on_miss": {"pull_on_miss": True}}[case]
    port = ReplicaRouter([AsyncLLMServer(
        LLMEngine(tm, device="cpu", **_engine_kw()))], **kw)
    ref = JRouter([JServer(JEngine(jm, **_engine_kw()))], **kw)
    assert port.roles == ref.roles
    assert port.pull_on_miss == ref.pull_on_miss
    assert (port.transport is None) == (ref.transport is None)
    if case == "transport":
        assert port.transport is ref.transport is kw["transport"]
    elif port.transport is not None:
        assert type(port.transport).__name__ == \
            type(ref.transport).__name__ == "InProcessTransport"
    if case == "roles":
        for bad in ({"prefill": [0], "decode": []},
                    {"prefill": [1], "decode": [0]}):
            for router, srv in ((ReplicaRouter, AsyncLLMServer(LLMEngine(
                    tm, device="cpu", **_engine_kw()))),
                    (JRouter, JServer(JEngine(jm, **_engine_kw())))):
                with pytest.raises(ValueError, match="roles"):
                    router([srv], roles=bad)


@pytest.mark.parametrize("case", ["slo_report", "dump_debug_bundle"])
def test_unported_parts_raise_naming_their_item(tm, tmp_path, case):
    """The fleet SLO report and debug bundle raise naming A11; the module
    names no TP engine factory (A14)."""
    import paddle_tpu_torch.serving.cluster as cluster
    assert not any(hasattr(cluster, n) for n in
                   ("tp_serving_mesh", "shard_model_tp", "tp_engine"))
    srv = AsyncLLMServer(LLMEngine(tm, device="cpu", **_engine_kw()))
    router = ReplicaRouter([srv])
    call = {"slo_report": router.slo_report,
            "dump_debug_bundle": lambda: router.dump_debug_bundle(
                str(tmp_path))}[case]
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        call()
