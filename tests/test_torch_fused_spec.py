"""paddle_tpu_torch LLMEngine(scheduler="fused", speculative_k=k): the
fused scheduler's speculative verify windows (A8(e), first half), held
TOKEN-EXACT against paddle_tpu's engine at the same settings on bridged
weights, and against the port's own non-speculative engine.

The drafting helpers against the reference's on random buffers (JAX's
clamped slices, the roll's wrap-around, ``L < ngram``, no match, a full
row); the parity matrix {dense, paged} x {prefix off, on} x stride {1, 4}
driven in lockstep with the reference (streams, ``stats``, ``_spec_ewma``
after every step, StepRecords and token joins), then at depth 2; the
server at depth 2; rollback under preemption with the pool audit armed;
the acceptance-adaptive window, its mirror, its drop at finish and its
survival across ``reset``; ``speculative_k=1`` as the plain fused engine;
``submit(spec_ewma=)``, the server's spec counters and gauge against the
reference server's; a crash mid verify window under ``RestartPolicy``;
sampled streams (the coupled acceptance rule) against the reference's
non-speculative engine, also across a crash; the validation errors and
the forms not ported yet. The cases mirror tests/test_fused_spec.py.
CPU, float32, 2 layers, hidden 64, vocab 96."""
import collections
import functools

import jax.numpy as jnp
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
from paddle_tpu.serving import AsyncLLMServer as JServer

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference import llm_engine as tle
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler import FlightRecorder
from paddle_tpu_torch.serving import (AsyncLLMServer, FaultInjector,
                                      RestartPolicy)

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
               "kv_pool_bytes", "kv_cache_dtype", "spec_accepted",
               "spec_rejected", "scheduler")


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


def _kw(cache_impl="dense", spec_k=4, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("chunk_size", 16)
    if cache_impl == "paged":
        kw.setdefault("block_size", 8)
    return dict(cache_impl=cache_impl, scheduler="fused",
                speculative_k=spec_k, **kw)


def _engine(tm, cache_impl="dense", spec_k=4, **kw):
    return LLMEngine(tm, device="cpu", **_kw(cache_impl, spec_k, **kw))


def _prompts(seed=14):
    """A repetition-heavy prompt (drafts accept), a random one (drafts
    mostly reject) and a long repetitive one that ramps over chunks while
    the others decode: three requests over two slots, so one re-admits."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, V, size=(6,)).astype(np.int32)
    other = rng.integers(1, V, size=(5,)).astype(np.int32)
    return [np.concatenate([base, base, base[:3]]),
            rng.integers(1, V, size=(9,)).astype(np.int32),
            np.tile(other, 8)[:37]]


def _shared_head(seed=6):
    """Prompts sharing a repetitive 19-token head (two full blocks and a
    COW tail at block 8), then distinct tails."""
    rng = np.random.default_rng(seed)
    head = np.tile(rng.integers(1, V, size=(4,)).astype(np.int32), 5)[:19]
    return [np.concatenate([head, rng.integers(1, V, size=(k,))
                            .astype(np.int32)]) for k in (3, 9, 5)]


def _tokens(outs):
    return [list(o.token_ids) for o in outs]


def _seed_both(state):
    """Both packages' global generators at one (seed, counter) state."""
    jrandom.default_generator.set_state(state)
    trandom.default_generator.set_state(state)


@functools.lru_cache(maxsize=None)
def _plain_ref(jm, prompts_key, n):
    """The reference's NON-speculative fused dense engine's greedy
    streams: the stream every speculative cell must reproduce."""
    eng = JEngine(jm, max_batch=3, max_seq_len=96, chunk_size=16,
                  scheduler="fused")
    prompts = [np.asarray(p, np.int32) for p in prompts_key]
    return _tokens(eng.generate(prompts, max_new_tokens=n))


def _plain(jm, prompts, n):
    return _plain_ref(jm, tuple(tuple(int(t) for t in p) for p in prompts),
                      n)


def _drain_at_depth(eng, depth):
    """Up to ``depth`` step_begin()s in flight before each oldest
    step_finish(), without threads."""
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


def _pool_drained(eng):
    eng._check_pool_invariants()
    assert len(eng._free_blocks) + len(eng._lru) == eng.n_blocks
    assert not eng._write_fence and not eng._quarantine


def _counters(eng):
    # guarded_syncs is in the port's stats for the reference's key schema
    # only: the reference books it under PADDLE_TPU_TRANSFER_CHECKS=1, a
    # guard the port does not have (ROADMAP A11)
    return {k: v for k, v in eng.stats.items()
            if not k.endswith("_s") and k != "guarded_syncs"}


def _events(rec):
    return {rid: [(e["kind"], e["step_id"],
                   None if e["kind"] == "token" else e["value"])
                  for e in tl["events"]]
            for rid, tl in rec.timelines().items()}


# ---------------------------------------------------------------------------
# the drafting helpers against the reference's
# ---------------------------------------------------------------------------

def _draft_cases():
    """(buffer [B, cap], lens [B]) pairs over every clamp the reference's
    slices take."""
    cap, rng = 24, np.random.default_rng(3)
    cases = []
    # random histories at every length 0..cap, small vocab (many matches,
    # L < ngram reading the zeros past L, the full row)
    cases.append((rng.integers(0, 4, size=(cap + 1, cap)).astype(np.int32),
                  np.arange(cap + 1, dtype=np.int32)))
    # distinct tokens: no match anywhere, the last-token fallback
    cases.append((np.stack([rng.permutation(100)[:cap] for _ in range(4)])
                  .astype(np.int32), np.array([0, 2, 13, cap], np.int32)))
    # a match at the tail's edge: the last position the mask admits
    row = rng.integers(10, 99, size=(cap,)).astype(np.int32)
    row[9:12] = row[12:15] = [5, 6, 7]
    cases.append((row[None], np.array([15], np.int32)))
    # a continuation clamped near capacity: a run of ones at the end, so
    # the most recent match starts a continuation past the buffer
    row = rng.integers(10, 99, size=(cap,)).astype(np.int32)
    row[cap - 6:] = 1
    cases.append((np.stack([row] * 3),
                  np.array([cap, cap - 1, cap - 2], np.int32)))
    # a periodic row: matches everywhere, the most recent wins
    row = np.tile(np.array([3, 8, 2], np.int32), cap // 3)
    cases.append((np.stack([row] * 5),
                  np.array([1, 2, 7, 22, cap], np.int32)))
    return cases


@pytest.mark.parametrize("ngram,k_draft", [(3, 3), (3, 5), (1, 2), (2, 4)])
def test_lookup_draft_matches_reference(ngram, k_draft):
    for buf, lens in _draft_cases():
        want = np.asarray(jle._lookup_draft(jnp.asarray(buf),
                                            jnp.asarray(lens), k_draft,
                                            ngram))
        got = tle._lookup_draft(torch.from_numpy(buf),
                                torch.from_numpy(lens), k_draft, ngram)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_write_window_matches_reference():
    """The window lands at each row's length, the start clamped into the
    buffer as ``dynamic_update_slice`` clamps it; masked rows stay."""
    rng = np.random.default_rng(5)
    cap, Kw = 20, 4
    buf = rng.integers(0, 50, size=(6, cap)).astype(np.int32)
    win = rng.integers(50, 99, size=(6, Kw)).astype(np.int32)
    lens = np.array([0, 5, 16, 17, 19, 20], np.int32)
    want = np.asarray(jle._write_window(jnp.asarray(buf), jnp.asarray(win),
                                        jnp.asarray(lens)))
    mask = np.array([1, 1, 1, 1, 0, 1], bool)
    got = torch.from_numpy(buf.copy())
    tle._write_window(got, torch.from_numpy(win), torch.from_numpy(lens),
                      torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy()[mask], want[mask])
    np.testing.assert_array_equal(got.numpy()[~mask], buf[~mask])


# ---------------------------------------------------------------------------
# the parity matrix, in lockstep with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("cache_impl,prefix", [
    ("dense", False), ("paged", False), ("paged", True)],
    ids=["dense", "paged", "paged_prefix"])
def test_parity_matrix(models, pool_checks, cache_impl, prefix, stride):
    """Step for step at depth 1 the port's engine and the reference's take
    the same grants: equal counters and acceptance EWMAs after every step,
    equal streams, StepRecords (kind, grants, strides, spec acceptance)
    and token joins; the streams are the non-speculative engine's. Then
    the port alone at depth 2: the same streams, the pool drained."""
    jm, tm = models
    prompts = _shared_head() if prefix else _prompts()
    kw = _kw(cache_impl, readout_stride=stride,
             enable_prefix_cache=prefix)
    ref, eng = JEngine(jm, **kw), LLMEngine(tm, device="cpu", **kw)
    jrec, rec = jfr.FlightRecorder(capacity=1024), FlightRecorder(
        capacity=1024)
    ref.flight_recorder, eng.flight_recorder = jrec, rec
    for p in prompts:
        ref.add_request(p, max_new_tokens=14)
        eng.add_request(p, max_new_tokens=14)
    step = 0
    while ref.has_unfinished():
        ref.step()
        eng.step()
        step += 1
        got, want = _counters(eng), _counters(ref)
        assert got == {k: want[k] for k in got}, f"step {step}"
        assert eng._spec_ewma == pytest.approx(ref._spec_ewma), step
    assert not eng.has_unfinished()
    want = [list(ref.finished_outputs[r].token_ids) for r in range(3)]
    got = [list(eng.finished_outputs[r].token_ids) for r in range(3)]
    assert got == want == _plain(jm, prompts, 14)
    assert eng.stats["spec_proposed_tokens"] > 0
    assert eng.stats["spec_accepted_tokens"] > 0
    assert (eng.stats["multi_steps"] > 0) == (stride > 1)
    w_recs, g_recs = jrec.records(), rec.records()
    assert [r.kind for r in g_recs] == [r.kind for r in w_recs]
    assert {"spec", "mixed"} <= {r.kind for r in g_recs}
    for w, g in zip(w_recs, g_recs):
        wd, gd = w.to_dict(), g.to_dict()
        assert {k: gd[k] for k in STEP_FIELDS} == \
            {k: wd[k] for k in STEP_FIELDS}, f"step {w.step_id}"
    assert _events(rec) == _events(jrec)
    if prefix:
        assert eng.stats["prefix_hit_tokens"] > 0
    if cache_impl == "paged":
        _pool_drained(eng)
    # depth 2, the speculative contract's depth
    eng2 = LLMEngine(tm, device="cpu", **kw)
    assert eng2.max_pipeline_depth() == 2
    rids = [eng2.add_request(p, max_new_tokens=14) for p in prompts]
    outs = _drain_at_depth(eng2, 2)
    assert [list(outs[r].token_ids) for r in rids] == want
    if cache_impl == "paged":
        _pool_drained(eng2)


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_server_depth2_token_exact(models, pool_checks, cache_impl):
    """AsyncLLMServer pipelines a speculative engine at depth 2 and its
    streams are the non-speculative reference's."""
    jm, tm = models
    prompts = _prompts(21)
    eng = _engine(tm, cache_impl, readout_stride=4)
    server = AsyncLLMServer(eng, max_queue_size=8)
    assert server.pipeline_depth == 2
    with server:
        handles = [server.submit(p, max_new_tokens=12) for p in prompts]
        results = [h.result(timeout=240) for h in handles]
    assert [list(r.token_ids) for r in results] == _plain(jm, prompts, 12)
    assert eng.stats["spec_proposed_tokens"] > 0
    if cache_impl == "paged":
        _pool_drained(eng)


def test_rollback_under_preemption(models, pool_checks):
    """An oversubscribed pool (9 blocks of 8 under 3 slots): verify
    windows shrink under pressure, rejected tails release through the
    fence and quarantine, preemption replays token-exactly carrying the
    request's EWMA; every step equals the reference's, and the drained
    pool accounts for every block."""
    jm, tm = models
    rng = np.random.default_rng(9)
    base = rng.integers(1, V, size=(5,)).astype(np.int32)
    prompts = [np.tile(base, 4)[:18], np.tile(base[::-1].copy(), 4)[:14],
               rng.integers(1, V, size=(11,)).astype(np.int32)]
    kw = _kw("paged", max_batch=3, kv_pool_blocks=9)
    ref, eng = JEngine(jm, **kw), LLMEngine(tm, device="cpu", **kw)
    for p in prompts:
        ref.add_request(p, max_new_tokens=16)
        eng.add_request(p, max_new_tokens=16)
    while ref.has_unfinished():
        ref.step()
        eng.step()
        got, want = _counters(eng), _counters(ref)
        assert got == {k: want[k] for k in got}
        assert eng._spec_ewma == pytest.approx(ref._spec_ewma)
        assert eng._tables.tolist() == ref._tables.tolist()
    out = [list(eng.finished_outputs[r].token_ids) for r in range(3)]
    assert out == [list(ref.finished_outputs[r].token_ids)
                   for r in range(3)] == _plain(jm, prompts, 16)
    assert eng.stats["preemptions"] > 0
    assert eng.stats["spec_proposed_tokens"] > 0
    _pool_drained(eng)


# ---------------------------------------------------------------------------
# the acceptance-adaptive window
# ---------------------------------------------------------------------------

def test_adaptive_k_converges_and_shrinks(models):
    """The EWMA drives the draft count as the reference's does: the full
    window by default, one draft (never zero) after zero acceptance, the
    full window again after full acceptance, and the rid-keyed mirror
    holding the request's value."""
    jm, tm = models
    slots = []
    for mod, eng in ((jle, JEngine(jm, **_kw(spec_k=5))),
                     (tle, _engine(tm, spec_k=5))):
        req = mod.GenerationRequest(0, np.zeros((4,), np.int32))
        slot = mod._Slot(req, 4)
        seen = [eng._spec_k_for(slot)]
        for acc in [0] * 12 + [4] * 12 + [1, 3, 2, 0, 4]:
            eng._update_spec_ewma(slot, proposed=4, accepted=acc)
            seen.append(eng._spec_k_for(slot))
        eng._update_spec_ewma(slot, proposed=0, accepted=0)   # no-op
        slots.append((seen, req.spec_ewma, eng.spec_ewma_for(0)))
    (want, w_ewma, w_mirror), (got, g_ewma, g_mirror) = slots
    assert got == want
    assert got[0] == 4 and min(got) == 1 and got[24] == 4
    assert g_ewma == pytest.approx(w_ewma) and g_mirror == g_ewma
    assert w_mirror == pytest.approx(w_ewma)


def test_ewma_mirror_lifecycle(models):
    """A random prompt drags its EWMA below the optimistic default while
    it runs, equal to the reference's after every step; the mirror entry
    drops at finish; it survives reset() and seeds the request's
    re-admission, as a supervised restart re-admits it."""
    jm, tm = models
    p = np.random.default_rng(11).integers(1, V, size=(9,)).astype(np.int32)
    ref, eng = JEngine(jm, **_kw(spec_k=5, max_batch=1)), \
        _engine(tm, spec_k=5, max_batch=1)
    rid = eng.add_request(p, max_new_tokens=24)
    ref.add_request(p, max_new_tokens=24)
    seen = []
    while eng.has_unfinished():
        eng.step()
        ref.step()
        assert eng.spec_ewma_for(rid) == pytest.approx(
            ref.spec_ewma_for(rid))
        seen.append(eng.spec_ewma_for(rid))
    got = [e for e in seen if e is not None]
    assert got and min(got) < 1.0
    assert rid not in eng._spec_ewma and rid not in ref._spec_ewma
    # mid-stream: reset keeps the mirror, re-admission seeds from it
    rid = eng.add_request(p, max_new_tokens=24)
    while eng.spec_ewma_for(rid) is None:
        eng.step()
    learned = eng.spec_ewma_for(rid)
    streamed = list(eng.slots[0].generated)
    eng.reset()
    assert eng.spec_ewma_for(rid) == learned
    eng.add_request(p, max_new_tokens=24 - len(streamed), request_id=rid,
                    committed_tokens=streamed)
    assert eng.waiting[0].spec_ewma == learned
    while eng.has_unfinished():
        eng.step()
    assert rid not in eng._spec_ewma
    # an explicit seed wins over the mirror
    eng.add_request(p, max_new_tokens=2, spec_ewma=0.25)
    assert eng.waiting[0].spec_ewma == 0.25


def test_spec_k1_is_plain_fused(models):
    """speculative_k=1 keeps the plain fused engine: no token history, no
    verify grants, the non-speculative streams and StepRecords."""
    jm, tm = models
    prompts = _prompts(23)
    eng = _engine(tm, spec_k=1)
    assert eng._tokens is None and eng.max_pipeline_depth() == 3
    rec = FlightRecorder(capacity=1024)
    eng.flight_recorder = rec
    assert _tokens(eng.generate(prompts, max_new_tokens=8)) == \
        _plain(jm, prompts, 8)
    assert eng.stats["spec_proposed_tokens"] == 0
    assert eng.stats["draft_tokens_accepted"] == 0
    assert {r.kind for r in rec.records()} <= {"mixed", "decode"}
    assert all(g[2] in ("decode", "prefill") for r in rec.records()
               for g in r.grants)


def test_reentrant_cancel_keeps_the_mirror_clean(models):
    """A stream callback that cancels its request mid verify window stops
    the readout there; the finished request's EWMA is not resurrected."""
    _, tm = models
    box = {}

    def cb(rid, tok):
        box.setdefault(rid, []).append(tok)
        if rid == 0 and len(box[rid]) == 3:
            box["out"] = box["eng"].cancel(0)

    eng = _engine(tm, stream_callback=cb)
    box["eng"] = eng
    for p in _prompts(31)[:2]:
        eng.add_request(p, max_new_tokens=12)
    while eng.has_unfinished():
        eng.step()
    assert box["out"].finish_reason == "cancelled"
    assert len(box[0]) == 3 and 0 not in eng._spec_ewma
    assert eng.finished_outputs[0].finish_reason == "cancelled"


# ---------------------------------------------------------------------------
# the server: spec_ewma, the spec counters and gauge, supervised restart
# ---------------------------------------------------------------------------

def _serve_one_by_one(server_cls, eng, requests, rec=None):
    """Each request through a running server alone (submit, wait), so the
    schedule is a function of the requests only."""
    kw = dict(flight_recorder=rec) if rec is not None else {}
    server = server_cls(eng, max_queue_size=4, **kw)
    outs = []
    with server:
        for p, extra in requests:
            outs.append(list(server.submit(p, max_new_tokens=10, **extra)
                             .result(timeout=240).token_ids))
    return server, outs


def test_server_spec_ewma_counters_and_gauge(models):
    """``submit(spec_ewma=)`` seeds the request's first verify grant (0.0:
    one draft; None: the full window); the server books the engine's spec
    counters at readout and the acceptance-rate gauge, equal to the
    reference server's."""
    jm, tm = models
    p = _prompts(41)[0]
    requests = [(p, {}), (p, dict(spec_ewma=0.0))]
    res = []
    for srv_cls, eng, rec in (
            (JServer, JEngine(jm, **_kw("paged", max_batch=1)),
             jfr.FlightRecorder(capacity=256)),
            (AsyncLLMServer, _engine(tm, "paged", max_batch=1),
             FlightRecorder(capacity=256))):
        server, outs = _serve_one_by_one(srv_cls, eng, requests, rec)
        snap = server.telemetry.snapshot()
        first = {}
        for r in rec.records():
            for _, rid, kind, n in r.grants:
                if kind == "verify":
                    first.setdefault(rid, n)
        res.append((outs, {k: snap["counters"][k] for k in (
            "spec_proposed_tokens", "spec_accepted_tokens")},
            server.telemetry.get_gauges()["spec_acceptance_rate"], first,
            dict(eng.stats)))
    (w_outs, w_ctr, w_gauge, w_first, w_stats), \
        (g_outs, g_ctr, g_gauge, g_first, g_stats) = res
    assert g_outs == w_outs and g_outs[0] == g_outs[1]
    assert g_ctr == w_ctr and g_ctr["spec_proposed_tokens"] > 0
    assert g_ctr["spec_proposed_tokens"] == g_stats["spec_proposed_tokens"]
    assert g_gauge == pytest.approx(w_gauge)
    assert g_gauge == pytest.approx(g_stats["spec_accepted_tokens"]
                                    / g_stats["spec_proposed_tokens"])
    assert g_first == w_first and g_first[0] == 4 and g_first[1] == 2


@pytest.mark.parametrize("phase", ["begin", "finish"])
def test_crash_mid_verify_window_recovers_exact(models, pool_checks, phase):
    """A crash between verify dispatches (finish: a stride of windows
    unread): the supervised restart re-admits every request with its
    streamed tokens and its learned EWMA, and the greedy streams continue
    token-exactly; the pool audit holds after recovery."""
    jm, tm = models
    prompts = _prompts(17)
    eng = _engine(tm, "paged", readout_stride=4)
    fi = FaultInjector().crash_at_step(3, phase=phase)
    server = AsyncLLMServer(
        eng, max_queue_size=8, fault_injector=fi,
        supervise=RestartPolicy(max_restarts=2, backoff_s=0.01))
    with server:
        handles = [server.submit(p, max_new_tokens=10) for p in prompts]
        results = [h.result(timeout=240) for h in handles]
    assert [list(r.token_ids) for r in results] == _plain(jm, prompts, 10)
    assert fi.fired and fi.fired[0][0] == "raise"
    assert 1 <= server.restarts <= 2
    assert server.telemetry.snapshot()["counters"]["requests_resumed"] >= 1
    assert not eng._spec_ewma
    _pool_drained(eng)


# ---------------------------------------------------------------------------
# the constructor contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,exc,match", [
    (dict(scheduler="fused", chunk_size=2, max_seq_len=64), ValueError,
     "verify window"),
    (dict(scheduler="legacy", cache_impl="paged", block_size=8),
     ValueError, "dense-only"),
    (dict(scheduler="legacy", adapter_store=object()), ValueError,
     "adapter-aware"),
], ids=["chunk", "legacy_paged", "legacy_adapters"])
def test_reference_value_errors(models, kw, exc, match):
    jm, tm = models
    for cls, model, extra in ((JEngine, jm, {}),
                              (LLMEngine, tm, dict(device="cpu"))):
        with pytest.raises(exc, match=match):
            cls(model, speculative_k=4, max_batch=2,
                **{"max_seq_len": 96, "chunk_size": 16, **kw}, **extra)


@pytest.mark.parametrize("kw", [
    dict(scheduler="fused", cache_impl="paged", block_size=8,
         kv_cache_dtype="int8"),
    dict(scheduler="fused", cache_impl="paged", block_size=8,
         kv_cache_dtype="int4"),
], ids=["int8_pool", "int4_pool"])
def test_second_half_raises(models, kw):
    _, tm = models
    with pytest.raises(NotImplementedError,
                       match="A8\\(e\\), second half"):
        LLMEngine(tm, device="cpu", speculative_k=4, max_batch=2,
                  max_seq_len=96, chunk_size=16, **kw)


def test_sampling_raises_naming_a7(models):
    """Sampling (A7) is ported and no longer raises: a temperature > 0
    request on the speculative engine is the reference speculative
    engine's stream token for token, from one generator state."""
    jm, tm = models
    eng = _engine(tm)
    p = np.array([1, 2, 3], np.int32)
    _seed_both((8, 0))
    want = _tokens(JEngine(jm, **_kw()).generate(
        [p], max_new_tokens=8, temperature=0.8))
    assert _tokens(eng.generate([p], max_new_tokens=8,
                                temperature=0.8)) == want
    assert eng.lookup_ngram == 3 and eng._tokens.shape == (2, 96)
    with pytest.raises(ValueError, match="no room"):
        eng.add_request(np.ones((92,), np.int32))


# ---------------------------------------------------------------------------
# sampled streams: the coupled acceptance rule
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_p=0.9)


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_sampled_token_exact(models, cache_impl):
    """SAMPLED streams of the speculative engine equal the reference's
    NON-speculative fused engine's token for token (reference
    tests/test_fused_spec.py:149): a draft is accepted iff it equals the
    token sampled under its own position's key, so speculation changes
    how tokens are produced, never which. The port's plain fused engine
    gives them too."""
    jm, tm = models
    prompts = _prompts(5)
    _seed_both((123, 0))
    want = _tokens(JEngine(jm, **_kw(cache_impl, 1)).generate(
        prompts, max_new_tokens=10, **SAMPLED))
    _seed_both((123, 0))
    spec = _engine(tm, cache_impl)
    assert _tokens(spec.generate(prompts, max_new_tokens=10,
                                 **SAMPLED)) == want
    assert spec.stats["spec_proposed_tokens"] > 0
    _seed_both((123, 0))
    assert _tokens(_engine(tm, cache_impl, 1).generate(
        prompts, max_new_tokens=10, **SAMPLED)) == want


def test_chaos_crash_mid_verify_window_sampled(models, pool_checks):
    """A crash between verify dispatches under ``RestartPolicy``: the
    supervised restart re-admits every request and the SAMPLED streams
    continue token-exactly (reference tests/test_fused_spec.py:295; the
    coupled rule has no acceptance randomness to replay and the base key
    survives ``reset``), equal to the reference server's uninterrupted
    run; the pool audit holds after recovery."""
    jm, tm = models
    prompts = _prompts(17)

    def run(server_cls, eng, fi):
        server = server_cls(
            eng, max_queue_size=8, fault_injector=fi,
            supervise=RestartPolicy(max_restarts=2, backoff_s=0.01))
        with server:
            hs = [server.submit(p, max_new_tokens=10, **SAMPLED)
                  for p in prompts]
            return [list(h.result(timeout=240).token_ids) for h in hs]

    _seed_both((17, 0))
    eng = _engine(tm, "paged")
    want = run(AsyncLLMServer, eng, FaultInjector())
    fi = FaultInjector().crash_at_step(3)
    got = run(AsyncLLMServer, eng, fi)
    assert fi.fired and fi.fired[0][0] == "raise"
    _seed_both((17, 0))
    from paddle_tpu.serving import FaultInjector as JFaultInjector
    from paddle_tpu.serving import RestartPolicy as JRestartPolicy

    jserver = JServer(JEngine(jm, **_kw("paged")), max_queue_size=8,
                      fault_injector=JFaultInjector(),
                      supervise=JRestartPolicy(max_restarts=2,
                                               backoff_s=0.01))
    with jserver:
        hs = [jserver.submit(p, max_new_tokens=10, **SAMPLED)
              for p in prompts]
        jwant = [list(h.result(timeout=240).token_ids) for h in hs]
    assert got == want == jwant
    _pool_drained(eng)
