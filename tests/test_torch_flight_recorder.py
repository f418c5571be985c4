"""paddle_tpu_torch.profiler.flight_recorder (A11): the StepRecord ring,
per-request timelines, the chrome-trace export and the slow-token
explainer, held against paddle_tpu's.

Engine level: the same requests through the port's and the reference's
engines at depth 1 (no threads) give equal StepRecords step for step in
kind, grants, scheduled tokens, budget, stride, preemptions and pool
fields, and every token joins to the same step. Server level: the serve
and join matrix (legacy and fused x dense and paged) of
tests/test_flight_recorder.py. Pure Python: one scripted sequence of calls
at injected times through both packages' recorders gives equal
snapshots, tail explanations and trace JSON. CPU, float32, 2 layers,
hidden 64, vocab 96, on bridged weights."""
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm_engine import LLMEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.profiler import flight_recorder as jfr
from paddle_tpu.profiler import merge_profile as j_merge_profile

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler import (FlightRecorder, StepRecord,
                                       TAIL_CAUSES, merge_profile)
from paddle_tpu_torch.profiler import flight_recorder as tfr
from paddle_tpu_torch.serving import AsyncLLMServer

torch.set_num_threads(1)

V = 96
KW = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
          max_position_embeddings=128)

#: the StepRecord fields an engine decides (the rest are wall times)
STEP_FIELDS = ("kind", "grants", "tokens_scheduled", "token_budget",
               "readout_stride", "preemptions", "free_blocks",
               "total_blocks", "prefix_hit_tokens", "cached_blocks",
               "queue_depth", "pipeline_inflight", "finished",
               "kv_pool_bytes", "kv_cache_dtype", "kv_swap_in_bytes",
               "kv_swap_out_bytes", "kv_host_spill_blocks",
               "kv_ship_in_bytes", "kv_ship_out_bytes", "adapter_slots",
               "adapter_swaps", "scheduler")


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JLlama(JConfig(**KW))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**KW), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


def _kw(cache_impl="dense", scheduler="legacy", **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("chunk_size", 16)
    if cache_impl == "paged":
        kw.setdefault("block_size", 8)
    return dict(cache_impl=cache_impl, scheduler=scheduler, **kw)


def _engine(tm, cache_impl="dense", scheduler="legacy", **kw):
    return LLMEngine(tm, device="cpu", **_kw(cache_impl, scheduler, **kw))


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, size=(n,)).astype(np.int32) for n in sizes]


def _serve(eng, prompts, rec, max_new_tokens=5):
    server = AsyncLLMServer(eng, max_queue_size=16, flight_recorder=rec)
    with server:
        handles = [server.submit(p, max_new_tokens=max_new_tokens)
                   for p in prompts]
        results = [h.result(timeout=300) for h in handles]
    return server, results


# ---------------------------------------------------------------------------
# engine-level StepRecord parity against the reference engine
# ---------------------------------------------------------------------------

def _shared_head(seed, n):
    """Prompts sharing a 17-token head (two full blocks and a tail)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, V, size=(17,)).astype(np.int32)
    return [np.concatenate([head, rng.integers(1, V, size=(k,))
                            .astype(np.int32)]) for k in (3, 9, 5)][:n]


PARITY_CASES = {
    "legacy_dense": (dict(), _prompts(1, (7, 12, 5, 9)), 5),
    "legacy_paged": (dict(cache_impl="paged"), _prompts(1, (7, 12, 5, 9)),
                     5),
    "fused_dense": (dict(scheduler="fused"), _prompts(1, (7, 12, 5, 20)),
                    5),
    "fused_paged": (dict(cache_impl="paged", scheduler="fused"),
                    _prompts(1, (7, 12, 5, 20)), 5),
    "fused_dense_stride4": (dict(scheduler="fused", readout_stride=4),
                            _prompts(2, (9, 14, 6)), 11),
    "fused_paged_stride4": (dict(cache_impl="paged", scheduler="fused",
                                 readout_stride=4),
                            _prompts(2, (9, 14, 6)), 11),
    "legacy_dense_horizon4": (dict(horizon=4), _prompts(3, (8, 5)), 9),
    "legacy_paged_churn": (dict(cache_impl="paged", kv_pool_blocks=6),
                           _prompts(5, (9, 11)), 16),
    "fused_paged_churn_stride2": (dict(cache_impl="paged", scheduler="fused",
                                       kv_pool_blocks=6, readout_stride=2),
                                  _prompts(5, (9, 11)), 16),
    "fused_paged_prefix": (dict(cache_impl="paged", scheduler="fused",
                                enable_prefix_cache=True),
                           _shared_head(6, 3), 6),
    "legacy_paged_prefix": (dict(cache_impl="paged", chunk_size=8,
                                 enable_prefix_cache=True),
                            _shared_head(6, 3), 6),
}


def _drive(eng, rec, prompts, n):
    eng.flight_recorder = rec
    for p in prompts:
        eng.add_request(p, max_new_tokens=n)
    while eng.has_unfinished():
        eng.step()
    return rec


def _events(rec):
    """Each request's timeline without its wall stamps: (kind, step id,
    value) per event, a token's value (its gap) left out."""
    return {rid: [(e["kind"], e["step_id"],
                   None if e["kind"] == "token" else e["value"])
                  for e in tl["events"]]
            for rid, tl in rec.timelines().items()}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_engine_step_records_match_reference(models, case):
    jm, tm = models
    over, prompts, n = PARITY_CASES[case]
    kw = _kw(**over)
    ref = _drive(JEngine(jm, **kw), jfr.FlightRecorder(capacity=1024),
                 prompts, n)
    eng = LLMEngine(tm, device="cpu", **kw)
    got = _drive(eng, FlightRecorder(capacity=1024), prompts, n)
    want_recs, got_recs = ref.records(), got.records()
    assert [r.kind for r in got_recs] == [r.kind for r in want_recs]
    for w, g in zip(want_recs, got_recs):
        wd, gd = w.to_dict(), g.to_dict()
        assert {k: gd[k] for k in STEP_FIELDS} == \
            {k: wd[k] for k in STEP_FIELDS}, f"step {w.step_id}"
    assert _events(got) == _events(ref)
    if "churn" in case:
        assert any(r.preemptions for r in got_recs)
    if "prefix" in case:
        assert any(r.prefix_hit_tokens for r in got_recs)
    if "stride" in case:
        assert {r.readout_stride for r in got_recs} >= {1, over.get(
            "readout_stride")}
        assert eng.stats["multi_steps"] > 0


# ---------------------------------------------------------------------------
# the server matrix: fused x legacy, dense x paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["legacy", "fused"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_serve_records_join_and_trace(models, tmp_path, scheduler,
                                      cache_impl):
    _, tm = models
    eng = _engine(tm, cache_impl, scheduler)
    rec = FlightRecorder(capacity=256)
    server, results = _serve(eng, _prompts(1, (7, 12, 5, 9)), rec)
    assert eng.flight_recorder is None       # restored at stop

    recs = rec.records()
    assert recs, "no steps recorded"
    ids = [r.step_id for r in recs]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    for r in recs:
        assert r.scheduler == scheduler
        assert r.kind in ("decode", "mixed", "drain")
        assert r.budget_utilization >= 0.0
        assert r.admit_s >= 0 and r.schedule_s >= 0 and r.dispatch_s >= 0
        assert r.t_finish >= r.t_begin > 0
        assert r.sync_s >= 0 and r.emit_s >= 0
        assert r.pipeline_inflight >= 0
        if cache_impl == "paged":
            assert 0 <= r.free_blocks <= r.total_blocks == eng.n_blocks
        else:
            assert r.free_blocks is None and r.total_blocks is None
        for slot, rid, gkind, n in r.grants:
            assert 0 <= slot < eng.B
            assert gkind in ("prefill", "decode") and n >= 1
        assert r.tokens_scheduled == sum(g[3] for g in r.grants)
    if scheduler == "fused":
        assert any(r.kind == "mixed" and r.prefill_tokens > 0
                   for r in recs), "fused ramp-in never recorded a mixed step"

    idset = set(ids)
    n_tokens = 0
    for rid, tl in rec.timelines().items():
        kinds = [e["kind"] for e in tl["events"]]
        assert kinds[0] == "queued"
        assert "admitted" in kinds and kinds[-1] == "finish"
        assert "prefill" in kinds, "no prefill span recorded"
        for ev in tl["events"]:
            if ev["kind"] == "token":
                n_tokens += 1
                assert ev["step_id"] in idset
    assert n_tokens == sum(len(r.token_ids) for r in results) == 20
    finished = {rid for r in recs for rid in r.finished}
    assert finished == {r.request_id for r in results}

    for r in results:
        assert r.trace is not None and r.trace["request_id"] == r.request_id
        assert any(e["kind"] == "token" for e in r.trace["events"])
        assert r.trace["trace_ctx"]["trace_id"] == r.trace_ctx.trace_id

    path = rec.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.load(open(path))["traceEvents"]
    lanes = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "engine steps" in lanes
    for r in results:
        assert f"req {r.request_id} [{r.trace_ctx.trace_id}/" \
            f"{r.trace_ctx.hop}]" in lanes
    steps = [e for e in events if e.get("cat") == "engine"]
    assert len(steps) == len(recs)
    tok_spans = [e for e in events
                 if e.get("cat") == "request" and e["name"] == "token"]
    assert len(tok_spans) == n_tokens
    for e in events:
        if e.get("ph") == "X":
            assert e["dur"] >= 0 and "ts" in e
        if e.get("cat") == "request" and e["name"] == "token":
            assert e["args"]["step_id"] in idset

    tail = rec.explain_tail(0.99)
    assert tail, "no tail attribution for a busy serve"
    assert tail == sorted(tail, key=lambda e: -e["gap_s"])
    for e in tail:
        assert e["cause"] in TAIL_CAUSES
        assert e["step"] is not None and e["step_id"] in idset


def test_chrome_trace_counter_tracks(models, tmp_path):
    """Every recorded step emits queue_depth and token_budget_utilization
    counter samples, and kv_pool_occupancy on a paged engine; a counter
    event has no duration."""
    _, tm = models
    eng = _engine(tm, "paged", "fused")
    rec = FlightRecorder(capacity=256)
    server, _ = _serve(eng, _prompts(9, (7, 12)), rec)
    assert "token_budget_utilization" in server.telemetry.get_gauges()
    path = rec.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.load(open(path))["traceEvents"]
    counters = [e for e in events if e.get("ph") == "C"]
    names = {e["name"] for e in counters}
    assert {"queue_depth", "token_budget_utilization",
            "kv_pool_occupancy"} <= names
    for e in counters:
        assert {"pid", "name", "ts", "args"} <= set(e)
        assert "dur" not in e
        assert isinstance(e["args"]["value"], (int, float))
    recs = rec.records()
    for track in ("queue_depth", "token_budget_utilization",
                  "kv_pool_occupancy"):
        assert sum(1 for e in counters if e["name"] == track) == len(recs)
    occs = [e["args"]["value"] for e in counters
            if e["name"] == "kv_pool_occupancy"]
    assert all(0.0 <= v <= 1.0 for v in occs) and any(v > 0 for v in occs)
    assert sorted(e["ts"] for e in counters if e["name"] == "queue_depth") \
        == sorted(r.t_begin * 1e6 for r in recs)
    assert "spec_acceptance_rate" not in names


def test_trace_merges_across_ranks(models, tmp_path):
    """merge_profile treats a flight-recorder trace like any rank trace,
    and its merged file equals the reference's merge of the same
    files."""
    _, tm = models
    rec = FlightRecorder(capacity=64)
    _serve(_engine(tm), _prompts(2, (6, 8)), rec, max_new_tokens=3)
    p1 = rec.export_chrome_trace(str(tmp_path / "r0.json"))
    p2 = rec.export_chrome_trace(str(tmp_path / "r1.json"))
    out = merge_profile([p1, p2], str(tmp_path / "merged.json"))
    merged = json.load(open(out))
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    ref = j_merge_profile([p1, p2], str(tmp_path / "ref.json"))
    assert merged == json.load(open(ref))
    both = merge_profile([str(tmp_path)], str(tmp_path / "dir" / "m.json"))
    assert len({e["pid"] for e in json.load(open(both))["traceEvents"]}) \
        == 4                                  # r0, r1, merged, ref
    with pytest.raises(ValueError, match="no trace files"):
        merge_profile([], str(tmp_path / "none.json"))


def test_ring_buffer_retains_newest(models):
    _, tm = models
    eng = _engine(tm, max_batch=1)
    rec = FlightRecorder(capacity=4)
    eng.flight_recorder = rec
    eng.generate(_prompts(3, (5,)), max_new_tokens=12)
    recs = rec.records()
    assert len(recs) == 4
    total = rec.snapshot()["steps_total"]
    assert total > 4
    assert [r.step_id for r in recs] == list(range(total - 4, total))
    assert rec.get_step(0) is None and rec.get_step(total - 1) is not None


def test_disabled_recorder_records_nothing(models):
    _, tm = models
    rec = FlightRecorder(enabled=False)
    _, results = _serve(_engine(tm, max_batch=1), _prompts(4, (6,)), rec,
                        max_new_tokens=3)
    assert rec.records() == [] and rec.timelines() == {}
    assert rec.explain_tail() == [] and results[0].trace is None
    _, results = _serve(_engine(tm, max_batch=1), _prompts(4, (6,)), None,
                        max_new_tokens=3)
    assert results[0].trace is None and results[0].finish_reason == "length"


def test_recorder_survives_preemption_churn(models):
    """An oversubscribed paged pool preempts mid-serve: the preemption
    lands in a StepRecord."""
    _, tm = models
    eng = _engine(tm, "paged", max_batch=2, kv_pool_blocks=6)
    rec = FlightRecorder(capacity=512)
    _, results = _serve(eng, _prompts(5, (9, 11)), rec, max_new_tokens=16)
    assert all(r.finished for r in results)
    assert eng.stats["preemptions"] >= 1
    pre = [r for r in rec.records() if r.preemptions]
    assert pre and all(isinstance(rid, int) for r in pre
                       for rid in r.preemptions)


# ---------------------------------------------------------------------------
# pure Python: both packages' recorders on one scripted sequence
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        self.t += 0.001
        return self.t


def _mk_step(rec, *, kind="decode", grants=(), preempted=(), dispatch_s=0.01,
             sync_s=0.0, emit_s=0.0, wall_s=None, t0=100.0, admit_s=0.0,
             readout_stride=1, kv_swap_in_bytes=None, kv_swap_out_bytes=None,
             **extra):
    sid = rec.begin_step(
        scheduler="fused", kind=kind, grants=grants,
        tokens_scheduled=sum(g[3] for g in grants), token_budget=32,
        queue_depth=0, free_blocks=None, total_blocks=None,
        pipeline_inflight=1, preemptions=preempted, admit_s=admit_s,
        schedule_s=0.0, dispatch_s=dispatch_s, t_begin=t0,
        readout_stride=readout_stride, kv_swap_in_bytes=kv_swap_in_bytes,
        kv_swap_out_bytes=kv_swap_out_bytes, **extra)
    rec.finish_step(sid, sync_s, emit_s)
    r = rec.get_step(sid)
    if wall_s is not None:
        r.t_finish = r.t_begin + wall_s
    return sid


def _tok(rec, rid, sid, t):
    """A token event at an exact wall time."""
    with rec._lock:
        tr = rec._trace(rid)
        gap = t - tr.last_token_t if tr.last_token_t is not None else None
        tr.last_token_t = t
        tr.events.append(("token", t, sid, gap))


def _both():
    return (jfr.FlightRecorder(capacity=16), FlightRecorder(capacity=16))


@pytest.mark.parametrize("setup,expect", [
    (dict(preempted=(7,), wall_s=0.1), "preempt_reprefill"),
    (dict(preempted=(7,), wall_s=0.1, kv_swap_out_bytes=4096),
     "preempt_swap"),
    (dict(preempted=(7,), wall_s=0.1, kv_swap_in_bytes=4096),
     "preempt_swap"),
    (dict(grants=((0, 1, "prefill", 16), (1, 2, "decode", 1)),
          kind="mixed", wall_s=0.1), "interfering_prefill"),
    (dict(admit_s=0.08, wall_s=0.1), "interfering_prefill"),
    (dict(sync_s=0.09, wall_s=0.1), "host_sync"),
    (dict(sync_s=0.09, wall_s=0.1, readout_stride=4), "batched_readout"),
    (dict(wall_s=0.01), "idle_bubble"),
    (dict(wall_s=0.09), "dispatch"),
    (dict(adapter_swaps=1, wall_s=0.1), "adapter_swap"),
    (dict(kv_ship_in_bytes=64, wall_s=0.1), "kv_ship"),
])
def test_explain_tail_causes(setup, expect):
    """Each cause of the taxonomy, from one synthetic step and one 100 ms
    gap, equal to the reference recorder's explanation."""
    out = []
    for rec in _both():
        sid = _mk_step(rec, **setup)
        _tok(rec, 5, sid, 100.0)
        _tok(rec, 5, sid, 100.1)
        (expl,) = rec.explain_tail(0.99)
        assert expl["cause"] == expect
        assert expl["request_id"] == 5 and expl["step_id"] == sid
        assert expl["gap_s"] == pytest.approx(0.1)
        out.append(expl)
    ref, got = out
    for e in (ref, got):
        e["step"].pop("t_finish")
    assert got == ref


def test_restart_recovery_cause_and_cold_miss():
    """A gap spanning a "crashed" span is a restart recovery; a prefill
    interference gap on a prefix-cache step names its cold miss; both
    as the reference names them."""
    out = []
    for rec in _both():
        sid = _mk_step(rec, grants=((0, 3, "prefill", 8),), kind="mixed",
                       wall_s=0.1, prefix_hit_tokens=0, cached_blocks=2)
        rec.req_event(3, "queued", t=99.0)
        rec.req_event(3, "cached_prefix", value=0, t=99.1)
        _tok(rec, 5, sid, 100.0)
        _tok(rec, 5, sid, 100.1)
        rec.req_event(6, "queued", t=99.0)
        _tok(rec, 6, sid, 100.0)
        rec.req_event(6, "crashed", value="boom", t=100.05)
        _tok(rec, 6, sid, 100.2)
        tail = rec.explain_tail(0.0)
        for e in tail:
            e["step"].pop("t_finish")
        out.append(tail)
    ref, got = out
    assert got == ref
    assert [e["cause"] for e in got] == ["restart_recovery",
                                         "interfering_prefill"]
    assert got[1]["cold_miss"] is True


def test_scripted_sequence_matches_reference(monkeypatch, tmp_path):
    """One scripted sequence of recorder calls at injected times (steps,
    lifecycle events, tokens, trace contexts, a ring wrap, a replica id)
    through both packages' recorders: equal ``snapshot()``,
    ``explain_tail()``, timelines and exported chrome JSON."""
    results = []
    for mod in (jfr, tfr):
        monkeypatch.setattr(time, "perf_counter", _Clock())
        rec = mod.FlightRecorder(capacity=6, max_requests=4, replica=2)
        seen = []
        rec.subscribe(lambda r: seen.append(r.step_id))
        rec.subscribe(lambda r: 1 / 0)          # a broken subscriber
        t = 100.0
        for i in range(9):
            rid = i % 3
            if i < 3:
                rec.req_event(rid, "queued", t=t)
                rec.set_trace_ctx(rid, {"trace_id": f"tr{rid}", "hop": 0,
                                        "parent": None, "via": "submit"})
                rec.req_event(rid, "routed", value={"replica": 2}, t=t)
                rec.req_event(rid, "admitted", t=t + 0.001)
            kind = "mixed" if i % 4 == 0 else "decode"
            grants = ((rid, rid, "prefill" if kind == "mixed" else "decode",
                       8 if kind == "mixed" else 4),)
            if kind == "mixed":
                rec.req_event(rid, "prefill", step_id=rec.next_step_id(),
                              value=8, t=t + 0.002)
            sid = rec.begin_step(
                scheduler="fused", kind=kind, grants=grants,
                tokens_scheduled=grants[0][3], token_budget=16,
                queue_depth=i % 2, free_blocks=10 - i, total_blocks=12,
                pipeline_inflight=1 + i % 2,
                preemptions=(1,) if i == 5 else (), admit_s=0.001 * i,
                schedule_s=0.0005, dispatch_s=0.002, t_begin=t,
                readout_stride=4 if kind == "decode" else 1,
                prefix_hit_tokens=0, cached_blocks=1)
            for k in range(grants[0][3] if kind == "decode" else 1):
                rec.on_token(rid, sid, t=t + 0.003 + 0.004 * k * (i + 1))
            rec.finish_step(sid, 0.001 * (i % 3), 0.0002,
                            finished=(rid,) if i >= 6 else ())
            if i >= 6:
                rec.req_event(rid, "finish", value="length", t=t + 0.05)
            t += 0.05 + 0.01 * (i % 4)
        rec.on_token(7, 3)                      # an unseen rid, no stamp
        path = rec.export_chrome_trace(str(tmp_path / f"{mod.__name__}.json"))
        with open(path) as f:
            trace = json.load(f)
        tail = rec.explain_tail(0.9)
        results.append(dict(
            snapshot=rec.snapshot(tail=tail), snapshot_fresh=rec.snapshot(),
            tail=tail, timelines=rec.timelines(), trace=trace,
            records=[r.to_dict() for r in rec.records()], seen=seen,
            last=rec.last_record().to_dict(),
            one=rec.request_trace(1), gap=rec.classify_token_gap(
                1, 8, 0.5)[0]))
    ref, got = results
    assert got == ref
    assert got["snapshot"]["steps_total"] == 9 and len(got["seen"]) == 9


def test_live_timelines_are_bounded():
    """A recorder attached to an engine alone sees no "finish" events:
    its live set still stays bounded."""
    for rec in (jfr.FlightRecorder(capacity=4, max_requests=8),
                FlightRecorder(capacity=4, max_requests=8)):
        sid = _mk_step(rec)
        for rid in range(50):
            _tok(rec, rid, sid, 100.0 + rid)
        with rec._lock:
            assert len(rec._live) <= 8 and len(rec._done) <= 8
        assert set(rec.timelines()) == set(range(34, 50))


def test_queued_event_starts_fresh_timeline():
    """A reused id's "queued" event begins a new timeline, with no
    phantom gap from the finished one."""
    rec = FlightRecorder(capacity=16)
    sid = _mk_step(rec, wall_s=0.01)
    rec.req_event(0, "queued", t=100.0)
    _tok(rec, 0, sid, 100.1)
    rec.req_event(0, "finish", value="length", t=100.2)
    rec.req_event(0, "queued", t=900.0)
    _tok(rec, 0, sid, 900.1)
    (tl,) = rec.timelines().values()
    assert [e["kind"] for e in tl["events"]] == ["queued", "token"]
    assert tl["events"][1]["value"] is None
    assert rec.explain_tail(0.99) == []


def test_explain_tail_evicted_step_is_unrecorded():
    rec = FlightRecorder(capacity=1)
    sid = _mk_step(rec)
    _tok(rec, 1, sid, 100.0)
    _tok(rec, 1, sid, 100.1)
    _mk_step(rec, t0=200.0)
    (expl,) = rec.explain_tail(0.99)
    assert expl["cause"] == "unrecorded" and expl["step"] is None


def test_explain_tail_quantile_selects_tail():
    rec = FlightRecorder(capacity=16)
    sid = _mk_step(rec, wall_s=0.001)
    t = 100.0
    _tok(rec, 1, sid, t)
    for _ in range(99):
        t += 0.001
        _tok(rec, 1, sid, t)
    t += 0.5
    _tok(rec, 1, sid, t)
    tail = rec.explain_tail(0.99)
    assert len(tail) == 1 and tail[0]["gap_s"] == pytest.approx(0.5)
    assert len(rec.explain_tail(0.5)) > 1


def test_chrome_trace_spec_counter_track(tmp_path):
    """A step with verify accounting emits the spec_acceptance_rate
    counter sample."""
    rec = FlightRecorder(capacity=8)
    sid = rec.begin_step(
        scheduler="fused", kind="mixed", grants=((0, 1, "verify", 4),),
        tokens_scheduled=4, token_budget=32, queue_depth=1,
        free_blocks=None, total_blocks=None, pipeline_inflight=1,
        preemptions=(), admit_s=0.0, schedule_s=0.0, dispatch_s=0.01,
        t_begin=100.0)
    rec.finish_step(sid, 0.0, 0.0, spec_accepted=2, spec_rejected=1)
    events = json.load(open(rec.export_chrome_trace(
        str(tmp_path / "trace.json"))))["traceEvents"]
    (spec,) = [e for e in events if e.get("ph") == "C"
               and e["name"] == "spec_acceptance_rate"]
    assert spec["args"]["value"] == pytest.approx(2 / 3, abs=1e-4)


def test_step_record_to_dict_schema():
    args = (3, 1.0, "fused", "mixed",
            ((0, 11, "prefill", 16), (1, 12, "decode", 1)),
            17, 32, 2, 5, 8, 1, (9,), 0.001, 0.002, 0.003)
    r = StepRecord(*args)
    d = r.to_dict()
    assert d == jfr.StepRecord(*args).to_dict()
    for key in ("step_id", "scheduler", "kind", "grants", "tokens_scheduled",
                "token_budget", "queue_depth", "free_blocks", "total_blocks",
                "pipeline_inflight", "preemptions", "admit_s", "schedule_s",
                "dispatch_s", "sync_s", "emit_s", "finished",
                "budget_utilization", "prefill_tokens", "readout_stride",
                "spec_accepted", "spec_rejected",
                "kv_pool_bytes", "kv_cache_dtype"):
        assert key in d, key
    assert d["readout_stride"] == 1
    assert d["budget_utilization"] == round(17 / 32, 4)
    assert d["prefill_tokens"] == 16 and r.decode_slots == 1
    json.dumps(d)
    over = StepRecord(4, 1.0, "fused", "mixed", ((0, 1, "decode", 5),),
                      5, 2, 0, None, None, 1, (), 0.0, 0.0, 0.0)
    assert over.budget_utilization == 2.5
    assert tfr.TAIL_CAUSES == jfr.TAIL_CAUSES
    assert tfr.REQUEST_EVENT_KINDS == jfr.REQUEST_EVENT_KINDS
    assert tfr.COUNTER_TRACKS == jfr.COUNTER_TRACKS
