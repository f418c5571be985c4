"""paddle_tpu_torch.serving.AsyncLLMServer over the port's LLMEngine: the
cases of tests/test_serving.py and tests/test_faults.py on paged engines
(fused, legacy, and fused over an int8 pool), on the CPU at a tiny size
(2 layers, hidden 64, vocab 96, bridged weights).

Streams equal the port engine's own ``generate`` and the reference's
``AsyncLLMServer`` streams on the same weights (greedy, token-exact);
cancellation frees pool blocks; deadlines expire queued and running
requests; the queue pushes back; supervised crash recovery is token-exact
under a scripted ``FaultInjector``, greedy and sampled (the sampling base
key survives the restart, so the per-(rid, position) keys continue each
sampled stream). The reference's timing-dependent
assertions get generous bounds here: the watchdog must flip health within
1 s of a 0.3 s timeout (reference: 0.5 s), and a busy window's attributed
share must reach 0.5 (reference: 0.9), since these tests share the CPU
with other test processes."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.serving import AsyncLLMServer as JServer

from paddle_tpu_torch.analysis import lock_watchdog
from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler.serving_telemetry import (
    GAUGES, STAGES, LatencyHistogram, ServingTelemetry)
from paddle_tpu_torch.serving import (AdmissionQueue, AsyncLLMServer,
                                      FaultInjector, InjectedFault,
                                      RestartPolicy, ServerQueueFull)

torch.set_num_threads(1)
V = 96
CONFIGS = {
    "fused": dict(scheduler="fused"),
    "legacy": dict(scheduler="legacy"),
    "int8": dict(scheduler="fused", kv_cache_dtype="int8"),
}


@pytest.fixture(scope="module")
def models():
    kw = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, max_position_embeddings=128)
    paddle.seed(7)
    jm = JLlama(JConfig(**kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


def _kw(**over):
    kw = dict(cache_impl="paged", max_batch=2, max_seq_len=64,
              chunk_size=16, block_size=8)
    kw.update(over)
    return kw


def _engine(tm, config="fused", **over):
    return LLMEngine(tm, device="cpu", **_kw(**{**CONFIGS[config], **over}))


@pytest.fixture(scope="module")
def engines(models):
    _, tm = models
    return {name: _engine(tm, name) for name in CONFIGS}


@pytest.fixture(scope="module")
def b1_eng(models):
    return _engine(models[1], "fused", max_batch=1)


def _fresh(eng):
    """A reused engine must be drained; clear its bookkeeping."""
    assert all(s is None for s in eng.slots)
    assert not eng.waiting
    eng.finished_outputs.clear()
    eng.reset_stats()
    return eng


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, size=(n,)).astype(np.int32) for n in sizes]


def _serve(server, prompts, **kw):
    with server:
        handles = [server.submit(p, **kw) for p in prompts]
        streams = [list(h.tokens(timeout=120)) for h in handles]
        results = [h.result(timeout=120) for h in handles]
    return streams, results


# ---------------------------------------------------------------------------
# streaming exactness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", list(CONFIGS))
def test_streams_match_generate_and_reference_server(models, engines,
                                                     config):
    """Per request, in order: the streams equal the engine's generate()
    and the reference server's streams over the reference engine with the
    same settings. The fused engine pipelines at depth 2, legacy at 1."""
    jm, _ = models
    eng = _fresh(engines[config])
    prompts = _prompts(1, (5, 11, 3, 8))
    ref = [o.token_ids for o in eng.generate(prompts, max_new_tokens=6)]
    _fresh(eng)
    server = AsyncLLMServer(eng, max_queue_size=8)
    assert server.pipeline_depth == (1 if config == "legacy" else 2)
    streams, results = _serve(server, prompts, max_new_tokens=6)
    assert streams == ref
    for r, tokens in zip(results, ref):
        assert r.token_ids == tokens and r.finish_reason == "length"
        assert r.ttft_s is not None and r.e2e_s >= r.ttft_s
        assert r.trace_ctx is not None and r.trace_ctx.hop == 0
    snap = server.telemetry.snapshot()
    assert snap["counters"]["requests_finished"] == 4
    assert snap["counters"]["tokens_emitted"] == 24
    jeng = JEngine(jm, **_kw(**CONFIGS[config]))
    jstreams, _ = _serve(JServer(jeng, max_queue_size=8), prompts,
                         max_new_tokens=6)
    assert streams == jstreams


def test_mid_stream_submission(engines):
    """A request submitted while another decodes joins by continuous
    batching without perturbing the first stream."""
    eng = _fresh(engines["fused"])
    p1, p2 = _prompts(3, (9, 4))
    ref1 = eng.generate([p1], max_new_tokens=10)[0].token_ids
    ref2 = eng.generate([p2], max_new_tokens=5)[0].token_ids
    with AsyncLLMServer(eng) as server:
        h1 = server.submit(p1, max_new_tokens=10)
        it1 = h1.tokens(timeout=120)
        first = [next(it1) for _ in range(2)]
        h2 = server.submit(p2, max_new_tokens=5)
        assert first + list(it1) == ref1
        assert list(h2.tokens(timeout=120)) == ref2


# ---------------------------------------------------------------------------
# lifecycle: cancellation, deadlines, backpressure
# ---------------------------------------------------------------------------

def test_cancellation_frees_pool_blocks(b1_eng):
    """Cancelling a running request frees its slot and returns every pool
    block at the next step boundary."""
    eng = _fresh(b1_eng)
    with AsyncLLMServer(eng) as server:
        h = server.submit(_prompts(4, (12,))[0], max_new_tokens=40)
        it = h.tokens(timeout=120)
        got = [next(it)]          # running for sure
        h.cancel()
        got += list(it)
        res = h.result(timeout=120)
        assert res.finish_reason == "cancelled"
        assert res.token_ids[:len(got)] == got and len(res.token_ids) < 40
        deadline = time.monotonic() + 30
        while len(eng._free_blocks) != eng.n_blocks:
            assert time.monotonic() < deadline, "pool blocks leaked"
            time.sleep(0.01)
        assert all(s is None for s in eng.slots)
    assert server.telemetry.counters["requests_cancelled"] == 1
    eng._check_pool_invariants()


def test_deadline_expiry_frees_slot(b1_eng):
    """A running request whose deadline passes finishes 'deadline' with
    its slot and blocks free, and a queued one with a hopeless deadline
    expires without ever being admitted."""
    eng = _fresh(b1_eng)
    server = AsyncLLMServer(eng)
    orig_on_token = server._on_token
    server._on_token = lambda rid, tok: (time.sleep(0.01),
                                         orig_on_token(rid, tok))
    with server:
        h = server.submit(_prompts(5, (10,))[0], max_new_tokens=50,
                          deadline_s=0.25)
        h2 = server.submit(_prompts(5, (6,))[0], max_new_tokens=4,
                           deadline_s=0.05)
        r, r2 = h.result(timeout=120), h2.result(timeout=120)
    assert r.finish_reason == "deadline" and 0 < len(r.token_ids) < 50
    assert r2.finish_reason == "deadline"
    assert r2.token_ids == [] and r2.queue_wait_s is None
    assert len(eng._free_blocks) == eng.n_blocks
    assert all(s is None for s in eng.slots)
    assert server.telemetry.counters["requests_expired"] == 2


def test_backpressure_full_queue(models):
    """With the engine thread not draining, a bounded queue rejects
    (block=False) or times out (block=True), counting rejections, and
    releases once a slot frees."""
    server = AsyncLLMServer(_engine(models[1]), max_queue_size=2)
    server._accepting = True          # accept without the drain thread
    p = _prompts(6, (5,))[0]
    server.submit(p, max_new_tokens=4)
    server.submit(p, max_new_tokens=4)
    with pytest.raises(ServerQueueFull):
        server.submit(p, max_new_tokens=4, block=False)
    t0 = time.monotonic()
    with pytest.raises(ServerQueueFull):
        server.submit(p, max_new_tokens=4, timeout=0.05)
    assert time.monotonic() - t0 >= 0.04
    assert server.telemetry.counters["requests_rejected_queue_full"] == 2
    server._queue.pop()
    assert server.submit(p, max_new_tokens=4, timeout=1.0) is not None


def test_submit_validation_is_synchronous(models):
    server = AsyncLLMServer(_engine(models[1], "legacy", kv_pool_blocks=2))
    server._accepting = True
    with pytest.raises(ValueError, match="empty"):
        server.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="capacity"):
        server.submit(np.ones((70,), np.int32))
    with pytest.raises(ValueError, match="pool"):
        server.submit(np.ones((30,), np.int32))  # 4 blocks > pool of 2
    with pytest.raises(NotImplementedError, match="A10"):
        server.submit(np.ones((5,), np.int32), kind="embed")
    # the KV-export flag is accepted and rides the request record (the
    # router's prefill leg; tests/test_torch_kv_ship.py ships it)
    h = server.submit(np.ones((5,), np.int32), max_new_tokens=2,
                      export_kv=True)
    assert h.request.export_kv is True
    assert server.submit(np.ones((5,), np.int32),
                         max_new_tokens=2).request.export_kv is False
    with pytest.raises(ValueError, match="readout_stride"):
        server.submit(np.ones((5,), np.int32), readout_stride=0)
    # a stride pin and a speculation EWMA seed are accepted (inert on
    # this stride-1, non-speculative engine, as in the reference) and
    # ride the server's request record
    for pin in (1, 2):
        h = server.submit(np.ones((5,), np.int32), max_new_tokens=2,
                          readout_stride=pin)
        assert h.request.readout_stride == pin
    h = server.submit(np.ones((5,), np.int32), max_new_tokens=2,
                      spec_ewma=0.5)
    assert h.request.spec_ewma == 0.5


def test_admission_queue_fifo_and_remove():
    q = AdmissionQueue(max_size=3)
    q.put("a"), q.put("b"), q.put("c")
    with pytest.raises(ServerQueueFull):
        q.put("d", block=False)
    assert q.remove("b") is True and q.remove("zz") is False
    q.put("d", block=False)
    assert [q.pop(), q.pop(), q.pop(), q.pop()] == ["a", "c", "d", None]


def test_a11_arguments_raise(engines):
    """The SLO/detector/black-box rest of ROADMAP A11: asked for, each
    raises; the flight recorder and the metrics store are ported and
    construct, alone or together with the detectors declined; together
    with the default detectors (None) they raise, naming A11."""
    eng = engines["fused"]
    for kw in (dict(slos=[object()]), dict(pathology_detectors=[object()]),
               dict(black_box=True),
               dict(flight_recorder=True, metrics_store=True)):
        with pytest.raises(NotImplementedError, match="A11"):
            AsyncLLMServer(eng, **kw)
    from paddle_tpu_torch.profiler import FlightRecorder, MetricsStore
    for kw in (dict(flight_recorder=True), dict(metrics_store=True),
               dict(flight_recorder=True, metrics_store=True,
                    pathology_detectors=False)):
        srv = AsyncLLMServer(eng, replica=3, **kw)
        if "flight_recorder" in kw:
            assert isinstance(srv.flight_recorder, FlightRecorder)
            assert srv.flight_recorder.replica == 3
        if "metrics_store" in kw:
            assert isinstance(srv.metrics_store, MetricsStore)
    server = AsyncLLMServer(eng, pathology_detectors=False)
    with pytest.raises(NotImplementedError, match="A11"):
        server.slo_report()
    with pytest.raises(NotImplementedError, match="A11"):
        server.dump_debug_bundle("unused.json")


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_latency_histogram_quantiles_and_prometheus():
    h = LatencyHistogram(bounds=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.005, 0.005, 0.05, 2.0):
        h.observe(v)
    assert h.count == 5 and h.maximum == 2.0
    assert h.quantile(0.5) == 0.01
    assert h.quantile(1.0) == 2.0
    lines = h.prometheus_lines("x_seconds")
    assert 'x_seconds_bucket{le="+Inf"} 5' in lines
    assert any(line.startswith("x_seconds_sum") for line in lines)


def test_telemetry_snapshot_schema_and_attribution(engines):
    """Every named stage, gauge and histogram in the snapshot and the
    Prometheus text; the legacy engine's prefill share; the pool gauges;
    and an attribution that explains most of a busy window."""
    eng = _fresh(engines["legacy"])
    prompts = _prompts(7, (7, 12, 5, 9, 6, 10))
    server = AsyncLLMServer(eng, max_queue_size=16)
    with server:
        t0 = time.perf_counter()
        for h in [server.submit(p, max_new_tokens=8) for p in prompts]:
            h.result(timeout=240)
        wall = time.perf_counter() - t0
    snap = server.telemetry.snapshot(wall_s=wall)
    for key in ("uptime_s", "counters", "gauges", "stages_s", "latency",
                "attribution", "prefill_token_share"):
        assert key in snap, key
    assert set(STAGES) <= set(snap["stages_s"])
    assert set(GAUGES) <= set(snap["gauges"])
    assert snap["gauges"]["queue_depth"] == 0
    assert snap["gauges"]["running_slots"] == 0
    assert snap["gauges"]["kv_pool_effective_blocks"] == eng.n_blocks
    for hist in ("ttft", "inter_token", "e2e", "queue_wait",
                 "admission_stall"):
        assert {"p50_s", "p90_s", "p99_s", "mean_s"} <= set(
            snap["latency"][hist])
    assert snap["latency"]["ttft"]["count"] == len(prompts)
    assert snap["counters"]["prefill_tokens"] == \
        sum(len(p) for p in prompts)
    assert 0.0 < snap["prefill_token_share"] < 1.0
    assert snap["latency"]["admission_stall"]["count"] >= 1
    att = snap["attribution"]
    assert 0.5 <= att["attributed_share"] <= 1.0, att
    assert snap["counters"]["requests_finished"] == len(prompts)
    text = server.telemetry.prometheus_text()
    assert "# TYPE paddle_tpu_serving_requests_finished_total counter" \
        in text
    assert 'paddle_tpu_serving_stage_seconds_total{stage="host_sync"}' \
        in text
    assert "paddle_tpu_serving_ttft_seconds_bucket" in text
    for g in GAUGES:
        assert f"# TYPE paddle_tpu_serving_{g} gauge" in text, g


def test_quantized_pool_gauge_reads_effective_blocks(engines):
    eng = _fresh(engines["int8"])
    server = AsyncLLMServer(eng)
    _serve(server, _prompts(8, (6,)), max_new_tokens=3)
    gauge = server.telemetry.get_gauges()["kv_pool_effective_blocks"]
    assert gauge == eng.kv_pool_effective_blocks() >= int(1.9 * eng.n_blocks)


def test_telemetry_strict_names_and_register():
    """A typo'd stage/counter/gauge name raises; register() extends and
    survives reset()."""
    tel = ServingTelemetry()
    with pytest.raises(KeyError, match="unknown telemetry stage"):
        tel.add_stage("prefil_dispatch", 0.1)
    with pytest.raises(KeyError, match="unknown telemetry counter"):
        tel.inc("request_finished")
    with pytest.raises(KeyError, match="unknown telemetry gauge"):
        tel.set_gauge("queue_dept", 3)
    for name in ("requests_rejected_validation", "requests_shed_deadline",
                 "requests_resumed", "engine_restarts", "faults_injected",
                 "multi_steps", "prefix_hit_tokens"):
        tel.inc(name)
    tel.set_gauge("server_healthy", 1.0)
    tel.inc_tenant(0, 3)
    tel.inc_tenant(7, 5)
    assert tel.snapshot()["tenant_tokens"] == {"0": 3, "7": 5}
    assert 'tenant_tokens_total{tenant="7"} 5' in tel.prometheus_text()
    with pytest.raises(ValueError, match="register kind"):
        tel.register("histogram", "x")
    tel.register("counter", "custom_total")
    tel.inc("custom_total", 2)
    tel.reset()
    tel.inc("custom_total")
    assert tel.counters["custom_total"] == 1


def test_engine_stage_stats_accumulate(engines):
    eng = _fresh(engines["fused"])
    eng.generate(_prompts(8, (6,)), max_new_tokens=4)
    assert eng.stats["dispatch_time_s"] > 0
    assert eng.stats["host_sync_time_s"] > 0
    assert eng.stats["emit_time_s"] > 0
    eng.reset_stats()
    assert eng.stats["dispatch_time_s"] == 0.0 and eng.stats["steps"] == 0


def test_legacy_engine_rejects_pipelined_begin(engines):
    eng = _fresh(engines["legacy"])
    eng.add_request(_prompts(9, (6,))[0], max_new_tokens=4)
    pending = eng.step_begin()
    assert pending is not None
    with pytest.raises(RuntimeError, match="pipeline"):
        eng.step_begin()
    eng.step_finish(pending)
    while eng.has_unfinished():
        eng.step()


def test_lock_watchdog_finds_cycles(monkeypatch):
    assert lock_watchdog.find_cycle({("a", "b"), ("b", "c")}) is None
    assert lock_watchdog.find_cycle({("a", "b"), ("b", "a")}) == \
        ["a", "b", "a"]
    import threading
    monkeypatch.setenv("PADDLE_TPU_LOCK_CHECKS", "1")
    lock_watchdog.reset_edges()
    a = lock_watchdog.tracked(threading.Lock(), "A")
    b = lock_watchdog.tracked(threading.Lock(), "B")
    with a, b:
        pass
    with pytest.raises(lock_watchdog.LockOrderError, match="cycle"):
        with b, a:
            pass
    assert not a.locked() and not b.locked()
    lock_watchdog.reset_edges()


# ---------------------------------------------------------------------------
# faults: injection, supervised restart, watchdog, shedding
# ---------------------------------------------------------------------------

def test_injector_schedule_consumed_once(engines):
    eng = _fresh(engines["fused"])
    fi = FaultInjector().crash_at_step(2)
    eng.fault_injector = fi
    try:
        with pytest.raises(InjectedFault):
            eng.generate(_prompts(0, (5,)), max_new_tokens=8)
    finally:
        eng.fault_injector = None
        eng.reset()
    assert fi.fired == [("raise", 2, "injected fault")]
    assert fi.step == 2


def test_injected_queue_full_burst(engines):
    eng = _fresh(engines["fused"])
    fi = FaultInjector().queue_full_burst(2)
    server = AsyncLLMServer(eng, max_queue_size=8, fault_injector=fi)
    p = _prompts(1, (6,))[0]
    with server:
        for _ in range(2):
            with pytest.raises(ServerQueueFull, match="injected"):
                server.submit(p, max_new_tokens=4, block=False)
        assert server.submit(p, max_new_tokens=4).result(
            timeout=120).finish_reason == "length"
    snap = server.telemetry.snapshot()
    assert snap["counters"]["requests_rejected_queue_full"] == 2
    assert snap["counters"]["faults_injected"] == 2
    assert server.num_outstanding() == 0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_crash_recovery_token_exact(engines, config):
    """A mid-stream engine crash under supervise=: every request's final
    tokens equal an uninjected run, <= max_restarts consumed, the pool
    invariants clean after recovery, the restart on the Prometheus
    export."""
    eng = _fresh(engines[config])
    prompts = _prompts(3, (9, 5, 17))
    want = [o.token_ids for o in eng.generate(prompts, max_new_tokens=8)]
    _fresh(eng)
    fi = FaultInjector().crash_at_step(4)
    server = AsyncLLMServer(
        eng, max_queue_size=8, fault_injector=fi,
        supervise=RestartPolicy(max_restarts=2, backoff_s=0.01))
    with server:
        results = [h.result(timeout=240) for h in
                   [server.submit(p, max_new_tokens=8) for p in prompts]]
    assert [r.token_ids for r in results] == want
    assert all(r.finish_reason == "length" for r in results)
    assert fi.fired and fi.fired[0][0] == "raise"
    assert 1 <= server.restarts <= 2
    snap = server.telemetry.snapshot()
    assert snap["counters"]["engine_restarts"] == server.restarts
    assert snap["counters"]["requests_resumed"] >= 1
    text = server.telemetry.prometheus_text()
    assert f"paddle_tpu_serving_engine_restarts_total {server.restarts}" \
        in text
    assert "paddle_tpu_serving_faults_injected_total 1" in text
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eng, "_debug_pool", True)
        eng._check_pool_invariants()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_crash_recovery_sampled_exact(models, config):
    """SAMPLED streams resume token-exactly across a supervised restart
    (reference tests/test_faults.py:202): token p of request r samples
    from ``fold_in(fold_in(base, r), p)`` and ``reset()`` keeps the base
    key, so the restart replays the same per-position keys. The crashed
    run equals the same engine's uninjected run (a fresh server: rids
    restart at 0) and the reference server's at the same
    ``sampling_seed``."""
    jm, tm = models
    kw = {**CONFIGS[config], "sampling_seed": 5}
    eng = _engine(tm, config, sampling_seed=5)
    prompts = _prompts(5, (9, 5))

    def run(server_cls, engine, fi):
        server = server_cls(
            engine, fault_injector=fi,
            supervise=RestartPolicy(max_restarts=2, backoff_s=0.01))
        with server:
            hs = [server.submit(p, max_new_tokens=8, temperature=0.8,
                                top_p=0.9) for p in prompts]
            return [list(h.result(timeout=240).token_ids) for h in hs]

    want = run(AsyncLLMServer, eng, FaultInjector())
    fi = FaultInjector().crash_at_step(3)
    got = run(AsyncLLMServer, eng, fi)
    assert fi.fired and fi.fired[0][0] == "raise"
    from paddle_tpu.serving import FaultInjector as JFaultInjector
    from paddle_tpu.serving import RestartPolicy as JRestartPolicy

    jserver = JServer(JEngine(jm, **_kw(**kw)),
                      fault_injector=JFaultInjector(),
                      supervise=JRestartPolicy(max_restarts=2,
                                               backoff_s=0.01))
    with jserver:
        hs = [jserver.submit(p, max_new_tokens=8, temperature=0.8,
                             top_p=0.9) for p in prompts]
        jwant = [list(h.result(timeout=240).token_ids) for h in hs]
    assert got == want == jwant
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eng, "_debug_pool", True)
        eng._check_pool_invariants()


def test_fail_request_poison_pill(engines):
    eng = _fresh(engines["fused"])
    prompts = _prompts(7, (6, 12))
    want = [o.token_ids for o in eng.generate(prompts, max_new_tokens=6)]
    _fresh(eng)
    fi = FaultInjector().fail_request(1)
    server = AsyncLLMServer(
        eng, fault_injector=fi,
        supervise=RestartPolicy(max_restarts=1, backoff_s=0.01))
    with server:
        hs = [server.submit(p, max_new_tokens=6) for p in prompts]
        assert [h.result(timeout=240).token_ids for h in hs] == want
    assert [f[0] for f in fi.fired] == ["fail_request"]


def test_restarts_exhausted_fails_attributably(engines):
    """A crash loop consumes the policy, then every waiter fails with
    "server_error" carrying its partial tokens (the legacy engine decodes
    a token in its admission step, so each life streams some)."""
    eng = _fresh(engines["legacy"])
    fi = FaultInjector()
    for step in (3, 6, 9):
        fi.crash_at_step(step)
    server = AsyncLLMServer(
        eng, fault_injector=fi,
        supervise=RestartPolicy(max_restarts=2, backoff_s=0.01))
    try:
        server.start()
        h = server.submit(_prompts(8, (6,))[0], max_new_tokens=30)
        res = h.result(timeout=240)
        assert res.finish_reason.startswith("server_error")
        assert len(res.token_ids) >= 1 and res.token_ids == h.emitted
        assert server.restarts == 2 and len(fi.fired) == 3
        assert server.health()["state"] == "crashed"
        assert server.telemetry.get_gauges()["server_healthy"] == 0.0
        with pytest.raises(Exception, match="crashed"):
            server.submit(_prompts(8, (5,))[0])
        with pytest.raises(RuntimeError, match="injected fault"):
            server.stop()
    finally:
        eng.fault_injector = None
        eng.reset()


def test_unsupervised_crash_fails_waiters(engines):
    eng = _fresh(engines["legacy"])
    server = AsyncLLMServer(eng, fault_injector=FaultInjector()
                            .crash_at_step(3))
    try:
        server.start()
        res = server.submit(_prompts(9, (6,))[0],
                            max_new_tokens=30).result(timeout=240)
        assert res.finish_reason.startswith("server_error")
        assert len(res.token_ids) >= 1 and server.restarts == 0
        with pytest.raises(RuntimeError, match="injected fault"):
            server.stop()
    finally:
        eng.fault_injector = None
        eng.reset()


def test_hang_flips_health_and_watchdog_interrupts(engines):
    """An injected interruptible hang flips health() to "hung" and the
    gauge to 0 while the thread lives; the watchdog interrupts it and the
    stream finishes token-exactly. Health is read when the watchdog
    interrupts the hang, inside the hung window, so that a loaded machine
    cannot let a polling reader miss the window."""
    eng = _fresh(engines["fused"])
    prompts = _prompts(11, (7,))
    want = eng.generate(prompts, max_new_tokens=10)[0].token_ids
    _fresh(eng)
    fi = FaultInjector().hang_at_step(4, seconds=60.0, interruptible=True)
    server = AsyncLLMServer(eng, fault_injector=fi, step_timeout_s=0.3)
    seen = []
    interrupt = fi.interrupt

    def watched_interrupt():
        seen.append((server.health(),
                     server.telemetry.get_gauges()["server_healthy"]))
        interrupt()

    fi.interrupt = watched_interrupt
    with server:
        h = server.submit(prompts[0], max_new_tokens=10)
        assert h.result(timeout=240).token_ids == want
        assert seen, "the watchdog never interrupted the hang"
        st, gauge = seen[0]
        assert st["state"] == "hung" and st["thread_alive"]
        assert 0.3 < st["heartbeat_age_s"] <= 0.3 + 1.0
        assert gauge == 0.0
        assert server.health()["state"] == "running"
        assert server.telemetry.get_gauges()["server_healthy"] == 1.0
    assert fi.fired == [("hang", 4, 60.0)]


def test_health_states(engines):
    eng = _fresh(engines["fused"])
    server = AsyncLLMServer(eng)
    assert server.health()["state"] == "stopped"
    assert server.telemetry.get_gauges()["server_healthy"] == 0.0
    server.start()
    server.submit(_prompts(12, (5,))[0], max_new_tokens=4).result(
        timeout=120)
    st = server.health()
    assert st["state"] == "running" and st["healthy"]
    assert st["thread_alive"] and st["restarts"] == 0
    server.stop()
    assert server.health()["state"] == "stopped"
    assert server.telemetry.get_gauges()["server_healthy"] == 0.0


def test_resume_already_at_eos_finishes_without_decode(engines):
    eng = _fresh(engines["fused"])
    with AsyncLLMServer(eng) as server:
        p = _prompts(17, (6,))[0]
        steps_before = eng.stats["steps"]
        h = server.submit(p, max_new_tokens=8, eos_token_id=42,
                          resume_tokens=[7, 9, 42])
        res = h.result(timeout=120)
        assert res.finish_reason == "eos" and res.token_ids == [7, 9, 42]
        assert list(h) == [] and eng.stats["steps"] == steps_before
        res2 = server.submit(p, max_new_tokens=4,
                             resume_tokens=[7, 9]).result(timeout=120)
        assert res2.finish_reason == "length"
        assert res2.token_ids[:2] == [7, 9] and len(res2.token_ids) == 4


def test_stop_timeout_then_second_stop(engines):
    eng = _fresh(engines["fused"])
    prompts = _prompts(13, (6,))
    want = eng.generate(prompts, max_new_tokens=8)[0].token_ids
    _fresh(eng)
    fi = FaultInjector().hang_at_step(2, seconds=1.0, interruptible=False)
    server = AsyncLLMServer(eng, fault_injector=fi)
    server.start()
    h = server.submit(prompts[0], max_new_tokens=8)
    with pytest.raises(TimeoutError, match="call stop\\(\\) again"):
        server.stop(timeout=0.1)
    assert server._thread is not None and server._thread.is_alive()
    server.stop(timeout=120)
    assert server._thread is None
    assert h.result(timeout=5).token_ids == want


def test_stop_during_supervised_restart(engines):
    eng = _fresh(engines["fused"])
    prompts = _prompts(14, (8, 5))
    want = [o.token_ids for o in eng.generate(prompts, max_new_tokens=8)]
    _fresh(eng)
    fi = FaultInjector().crash_at_step(3)
    server = AsyncLLMServer(
        eng, fault_injector=fi,
        supervise=RestartPolicy(max_restarts=1, backoff_s=0.5))
    server.start()
    hs = [server.submit(p, max_new_tokens=8) for p in prompts]
    deadline = time.monotonic() + 30.0
    while not fi.fired and time.monotonic() < deadline:
        time.sleep(0.005)
    assert fi.fired
    server.stop(drain=True, timeout=240)
    assert [h.result(timeout=5).token_ids for h in hs] == want
    assert server.restarts == 1


def test_deadline_shedding_flag_gated(engines):
    eng = _fresh(engines["fused"])
    p = _prompts(15, (7,))[0]
    server = AsyncLLMServer(eng)
    with server:
        server.submit(p, max_new_tokens=6).result(timeout=120)
        res = server.submit(p, max_new_tokens=6,
                            deadline_s=1e-6).result(timeout=120)
    assert res.finish_reason == "deadline"
    assert server.telemetry.counters["requests_shed_deadline"] == 0
    assert server.telemetry.counters["requests_expired"] >= 1
    _fresh(eng)
    server = AsyncLLMServer(eng, shed_deadlines=True)
    with server:
        server.submit(p, max_new_tokens=6).result(timeout=120)
        prefill_before = server.telemetry.counters["prefill_tokens"]
        h = server.submit(p, max_new_tokens=6, deadline_s=1e-6)
        res = h.result(timeout=5)
        assert res.finish_reason == "deadline" and res.token_ids == []
        assert list(h) == []
        ok = server.submit(p, max_new_tokens=6, deadline_s=120.0)
        assert ok.result(timeout=120).finish_reason == "length"
    snap = server.telemetry.snapshot()
    assert snap["counters"]["requests_shed_deadline"] == 1
    assert snap["counters"]["prefill_tokens"] == prefill_before + len(p)


def test_feed_engine_rejection_counted(engines):
    eng = _fresh(engines["fused"])
    server = AsyncLLMServer(eng)
    orig = eng.add_request
    calls = {"n": 0}

    def flaky(*a, **kw):
        if calls["n"] == 0:
            calls["n"] += 1
            raise ValueError("synthetic validation failure")
        return orig(*a, **kw)

    eng.add_request = flaky
    try:
        with server:
            res = server.submit(_prompts(16, (6,))[0],
                                max_new_tokens=4).result(timeout=120)
    finally:
        del eng.add_request
    assert res.finish_reason == "rejected: synthetic validation failure"
    assert server.telemetry.counters["requests_rejected_validation"] == 1
