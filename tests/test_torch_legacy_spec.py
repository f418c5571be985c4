"""paddle_tpu_torch LLMEngine(model, speculative_k=k) at the reference's
defaults (legacy scheduler, dense cache): the legacy speculative scan
(A8(e), second half, item (i)), held TOKEN-EXACT against paddle_tpu's
engine at the same settings on bridged weights, and against the port's
own non-speculative engine.

The parity matrix speculative_k {2, 4, 6} x horizon {1, 3} x max_batch
{1, 3} (pairwise), driven in lockstep with the reference (``stats`` and the
acceptance EWMA after every step, then streams, StepRecords and token
joins), over repetitive and random prompts, an eos, a budget shorter
than a window and a prompt at the capacity margin, then the port alone at
depth 2; the cases where an eos and a budget end inside a window; a
pipelined run near capacity in lockstep at depth 2 (a slot the device
stopped is dispatched again and writes clamped into its row; streams and
K/V below each live length equal the reference's); the twins of
tests/test_llm_engine.py's ``TestSpeculativeDecoding`` and
tests/test_serving.py's ``test_speculative_engine_serves_exact`` (the
server's spec counters and gauge against the reference server's);
``speculative_k=1`` as the plain legacy engine bit for bit; a weight-only
int4 model under the scan; fault C4 (drafting at a length past the
history buffer) and a capacity at the rope table's end; sampled streams
under the coupled acceptance rule (a sampling slot beside a greedy one,
and the sampled speculative stream equal to the plain sampled engine's and
the reference's). CPU, float32, 2 layers, hidden 64, vocab 96."""
import collections
import copy
import functools
import warnings

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
from paddle_tpu.nn import quant as JQ
from paddle_tpu.profiler import flight_recorder as jfr
from paddle_tpu.serving import AsyncLLMServer as JServer

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference import llm_engine as tle
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.profiler import FlightRecorder
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
               "kv_pool_bytes", "kv_cache_dtype", "spec_accepted",
               "spec_rejected", "scheduler")

#: the stats keys the speculative readout books
SPEC_STATS = ("steps", "draft_tokens_accepted", "spec_proposed_tokens",
              "spec_accepted_tokens")


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLlama(JConfig(**KW))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**KW), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


def _kw(spec_k, horizon=1, max_batch=3, **kw):
    """The reference's defaults (legacy, dense) at a small size."""
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("chunk_size", 16)
    return dict(max_batch=max_batch, speculative_k=spec_k, horizon=horizon,
                **kw)


def _tokens(outs):
    return [list(o.token_ids) for o in outs]


def _counters(eng):
    return {k: v for k, v in eng.stats.items() if not k.endswith("_s")}


def _events(rec):
    return {rid: [(e["kind"], e["step_id"],
                   None if e["kind"] == "token" else e["value"])
                  for e in tl["events"]]
            for rid, tl in rec.timelines().items()}


def _records_equal(jrec, rec):
    w_recs, g_recs = jrec.records(), rec.records()
    assert [r.kind for r in g_recs] == [r.kind for r in w_recs]
    for w, g in zip(w_recs, g_recs):
        wd, gd = w.to_dict(), g.to_dict()
        assert {k: gd[k] for k in STEP_FIELDS} == \
            {k: wd[k] for k in STEP_FIELDS}, f"step {w.step_id}"
    assert _events(rec) == _events(jrec)
    return g_recs


def _plain_streams(tm, requests, spec_k=1, cap=96):
    """The port's plain legacy engine (already held to the reference's)
    on ``requests``, each budget capped first to what a
    ``speculative_k=spec_k`` engine of capacity ``cap`` leaves it: the
    streams every speculative run must reproduce."""
    eng = LLMEngine(tm, device="cpu", max_batch=3, max_seq_len=cap,
                    chunk_size=16)
    rids = [eng.add_request(p, max_new_tokens=min(n, cap - len(p) - spec_k),
                            eos_token_id=eos)
            for p, n, eos in requests]
    while eng.has_unfinished():
        eng.step()
    return [list(eng.finished_outputs[r].token_ids) for r in rids]


@functools.lru_cache(maxsize=None)
def _request_set(tm, spec_k, cap=96):
    """A repetitive prompt (drafts accept), a random one (drafts reject),
    a long repetitive one with a 5-token budget (shorter than most
    windows), a repetitive one whose eos is the first new token of its
    plain stream at position >= 3, and a prompt ``speculative_k + 5``
    short of capacity (its budget capped to the margin)."""
    rng = np.random.default_rng(14)
    base = rng.integers(1, V, size=(6,)).astype(np.int32)
    other = rng.integers(1, V, size=(5,)).astype(np.int32)
    eos_prompt = np.tile(other[::-1].copy(), 4)[:17]
    (plain,) = _plain_streams(tm, [(eos_prompt, 16, None)])
    j = next(i for i in range(3, len(plain)) if plain[i] not in plain[:i])
    return ((np.concatenate([base, base, base[:3]]), 14, None),
            (rng.integers(1, V, size=(9,)).astype(np.int32), 8, None),
            (np.tile(other, 8)[:37], 5, None),
            (eos_prompt, 16, int(plain[j])),
            (np.tile(base[::-1].copy(), 20)[:cap - spec_k - 5], 30, None))


def _watch_scan(eng, log):
    """Record each legacy scan's inputs and outputs (eos ids, budgets,
    windows, counts, activity) as numpy."""
    scan = eng._spec_scan

    def watched(active, eos_ids, budgets, n_win):
        toks, counts, act = scan(active, eos_ids, budgets, n_win)
        log.append((np.array(eos_ids), np.array(budgets), toks.numpy().copy(),
                    counts.numpy().copy(), act.numpy().copy()))
        return toks, counts, act

    eng._spec_scan = watched


def _ends_inside_a_window(log):
    """(an eos at a window row after the committed token, a budget that
    ran out before a window's last committed row) in any scan."""
    eos_in = budget_in = False
    for eos_ids, budgets, toks, counts, act in log:
        emitted = np.zeros_like(budgets)
        for w in range(toks.shape[0]):
            for b in np.nonzero(act[w])[0]:
                c = int(counts[w, b])
                eos_in |= eos_ids[b] >= 0 and bool(
                    (toks[w, b, 1:c] == eos_ids[b]).any())
                budget_in |= emitted[b] < budgets[b] < emitted[b] + c
            emitted = emitted + np.where(act[w], counts[w], 0)
    return eos_in, budget_in


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


def _lockstep(jm, tm, kw, requests):
    """Both engines at depth 1, step for step: equal counters and EWMAs
    after every step. Returns (reference, port, their recorders, the
    port's scan log, the capping warnings)."""
    ref, eng = JEngine(jm, **kw), LLMEngine(tm, device="cpu", **kw)
    jrec, rec = jfr.FlightRecorder(capacity=1024), FlightRecorder(
        capacity=1024)
    ref.flight_recorder, eng.flight_recorder = jrec, rec
    log = []
    _watch_scan(eng, log)
    for p, n, eos in requests:
        ref.add_request(p, max_new_tokens=n, eos_token_id=eos)
        eng.add_request(p, max_new_tokens=n, eos_token_id=eos)
    step = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        while ref.has_unfinished():
            ref.step()
            eng.step()
            step += 1
            got, want = _counters(eng), _counters(ref)
            assert got == {k: want[k] for k in got}, f"step {step}"
            assert eng._spec_ewma == pytest.approx(ref._spec_ewma), step
    assert not eng.has_unfinished()
    capped = [str(w.message) for w in caught if "capping" in str(w.message)]
    return ref, eng, jrec, rec, log, capped


# ---------------------------------------------------------------------------
# the parity matrix, in lockstep with the reference
# ---------------------------------------------------------------------------

#: speculative_k {2, 4, 6} x horizon {1, 3} x max_batch {1, 3}, pruned to
#: pairwise cover (every pair of values of two of the three meets) so the
#: file stays near a minute on one core
PAIRWISE = [(2, 1, 1), (2, 3, 3), (4, 1, 3), (4, 3, 1), (6, 1, 1), (6, 3, 3)]


@pytest.mark.parametrize("spec_k,horizon,max_batch", PAIRWISE)
def test_parity_matrix(models, spec_k, horizon, max_batch):
    """Step for step at depth 1 the port and the reference take the same
    windows: equal counters and acceptance EWMAs after every step, equal
    streams and finish reasons, StepRecords (kind "spec", grants of
    ``horizon * k``, spec acceptance) and token joins; the streams are
    the plain engine's; the capped budget warns in both. Then the port
    alone at depth 2, the legacy dense contract: the same streams."""
    jm, tm = models
    requests = _request_set(tm, spec_k)
    kw = _kw(spec_k, horizon, max_batch)
    ref, eng, jrec, rec, _, capped = _lockstep(jm, tm, kw, requests)
    n = len(requests)
    want = [ref.finished_outputs[r] for r in range(n)]
    got = [eng.finished_outputs[r] for r in range(n)]
    assert _tokens(got) == _tokens(want) == _plain_streams(
        tm, requests, spec_k)
    assert [o.finish_reason for o in got] == \
        [o.finish_reason for o in want] == \
        ["length", "length", "length", "eos", "length"]
    assert capped == [f"request 4: capping max_new_tokens 30 -> 5 (engine "
                      f"capacity 96)"] * 2
    assert {k: eng.stats[k] for k in SPEC_STATS} == \
        {k: ref.stats[k] for k in SPEC_STATS}
    assert eng.stats["spec_proposed_tokens"] > 0
    assert eng.stats["fused_steps"] == eng.stats["multi_steps"] == 0
    recs = _records_equal(jrec, rec)
    assert {r.kind for r in recs} == {"spec"}
    assert {r.readout_stride for r in recs} == {horizon * spec_k}
    # depth 2, the legacy dense contract
    eng2 = LLMEngine(tm, device="cpu", **kw)
    assert eng2.max_pipeline_depth() == 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rids = [eng2.add_request(p, max_new_tokens=n, eos_token_id=eos)
                for p, n, eos in requests]
        outs = _drain_at_depth(eng2, 2)
    assert [list(outs[r].token_ids) for r in rids] == _tokens(want)


def _window_stream(log, b=0):
    """Slot ``b``'s committed stream from a scan log, as (token, window
    row) pairs."""
    out = []
    for _, _, toks, counts, act in log:
        for w in range(toks.shape[0]):
            if act[w, b]:
                out += [(int(t), r) for r, t in
                        enumerate(toks[w, b, :counts[w, b]])]
    return out


def _inside_window_requests(tm, spec_k):
    """Search, as the reference's own acceptance test searches, tiled
    prompts until one's stream (port engine at ``spec_k``, B 1) takes its
    first occurrence of some token at a window row after the committed
    token: that token becomes the request's eos. The same prompt with a
    budget that stops one token into a window of two or more committed
    tokens is the budget case. Drafts continue the history's match of the
    tail, which predicts the committed token's own position but is
    verified one row later, so a new token lands on a draft row only
    where the stream skips one (the history's "a b c x" against the
    stream's "a b c y x"): hence the search."""
    rng = np.random.default_rng(14)
    for _ in range(60):
        base = rng.integers(1, V, size=(int(rng.integers(2, 7)),)) \
            .astype(np.int32)
        p = np.tile(base, 4)[:int(rng.integers(8, 24))]
        eng = LLMEngine(tm, device="cpu", max_batch=1, max_seq_len=96,
                        chunk_size=16, speculative_k=spec_k)
        log = []
        _watch_scan(eng, log)
        eng.generate([p], max_new_tokens=24)
        stream = _window_stream(log)
        toks = [t for t, _ in stream]
        eos = next((t for i, (t, r) in enumerate(stream)
                    if r >= 1 and t not in toks[:i]), None)
        budget = next((i for i, (_, r) in enumerate(stream) if r == 1),
                      None)
        if eos is not None and budget is not None:
            return [(p, 24, eos), (p, budget, None)]
    raise AssertionError("no prompt puts a new token on a draft row "
                         "(model changed?): pick a new search seed")


@pytest.mark.parametrize("spec_k,horizon", [(2, 1), (4, 3), (6, 3)])
def test_eos_and_budget_end_inside_a_window(models, spec_k, horizon):
    """An eos the device commits at a window row after the committed
    token, and a budget that runs out one token into a window: the device
    stops the slot there, the readout stops at it, and the streams, stats
    and StepRecords equal the reference's, step for step."""
    jm, tm = models
    requests = _inside_window_requests(tm, spec_k)
    ref, eng, jrec, rec, log, _ = _lockstep(
        jm, tm, _kw(spec_k, horizon, 2), requests)
    assert _ends_inside_a_window(log) == (True, True)
    got = _tokens(eng.finished_outputs[r] for r in range(2))
    assert got == _tokens(ref.finished_outputs[r] for r in range(2)) == \
        _plain_streams(tm, requests, spec_k)
    assert got[0][-1] == requests[0][2] and len(got[1]) == requests[1][1]
    assert [eng.finished_outputs[r].finish_reason for r in range(2)] == \
        ["eos", "length"]
    _records_equal(jrec, rec)


# ---------------------------------------------------------------------------
# pipelined over-dispatch near capacity (depth 2, in lockstep)
# ---------------------------------------------------------------------------

def _ref_kv(ref, b, n):
    return [np.asarray(t)[b, :n] for t in (*ref._k, *ref._v)]


def _port_kv(eng, b, n):
    return [t[b, :n].numpy() for t in (*eng._k, *eng._v)]


def _crossing_prompt(tm, k):
    """A tiled prompt whose stream (port engine, B 1, ``speculative_k=k``)
    commits two or more tokens in one window after its first token, and
    the capacity whose ``capacity - k`` margin that window crosses by one
    position: (prompt, capacity)."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        base = rng.integers(1, V, size=(int(rng.integers(2, 6)),)) \
            .astype(np.int32)
        p = np.tile(base, 4)[:int(rng.integers(6, 14))]
        eng = LLMEngine(tm, device="cpu", max_batch=1, max_seq_len=96,
                        chunk_size=16, speculative_k=k)
        log = []
        _watch_scan(eng, log)
        eng.generate([p], max_new_tokens=24)
        stream = _window_stream(log)
        for g, (_, r) in enumerate(stream):
            if g >= 2 and r == 0 and g + 1 < len(stream) and \
                    stream[g + 1][1] == 1:
                c = next(i for i in range(1, k + 1) if g + i == len(stream)
                         or stream[g + i][1] == 0)
                return p, len(p) + g + c - 1 + k
    raise AssertionError("no window commits two tokens: pick a new seed")


@pytest.mark.filterwarnings("ignore:request .* capping max_new_tokens")
def test_pipelined_over_dispatch_near_capacity(models):
    """Two slots at depth 2, horizon 2: the near-capacity slot's last
    window crosses the ``capacity - k`` margin, so its device deactivates
    while the host, one readout behind, dispatches it again at a length
    past the margin: that window writes its K/V and history clamped into
    the slot's own row end. Both engines run the same begin/finish
    schedule: the outputs, counters, EWMAs and device lengths equal after
    every readout, and so do the K/V rows below each resident slot's
    length, the third request's included after it is admitted into the
    overwritten row."""
    jm, tm = models
    k = 4
    near, cap = _crossing_prompt(tm, k)
    rng = np.random.default_rng(4)
    requests = [(near, 24)] + [
        (rng.integers(1, V, size=(n,)).astype(np.int32), 24) for n in (5, 7)]
    kw = _kw(k, 2, 2, max_seq_len=cap)
    ref, eng = JEngine(jm, **kw), LLMEngine(tm, device="cpu", **kw)
    starts = []
    scan = eng._spec_scan

    def watched(active, *a):
        starts.append((eng._lens.numpy().copy(), np.array(active)))
        return scan(active, *a)

    eng._spec_scan = watched
    for p, n in requests:
        ref.add_request(p, max_new_tokens=n)
        eng.add_request(p, max_new_tokens=n)
    pend = collections.deque()
    outs = {}
    while ref.has_unfinished() or pend:
        while len(pend) < 2 and ref.has_unfinished():
            pr, pg = ref.step_begin(), eng.step_begin()
            assert (pr is None) == (pg is None)
            if pr is None:
                break
            pend.append((pr, pg))
        if not pend:
            break
        pr, pg = pend.popleft()
        done_r, done_g = ref.step_finish(pr), eng.step_finish(pg)
        assert [(o.request_id, o.token_ids, o.finish_reason)
                for o in done_g] == [(o.request_id, o.token_ids,
                                      o.finish_reason) for o in done_r]
        outs.update({o.request_id: o for o in done_g})
        got, want = _counters(eng), _counters(ref)
        assert got == {k_: want[k_] for k_ in got}
        assert eng._spec_ewma == pytest.approx(ref._spec_ewma)
        # the device state includes every dispatch in flight
        ref_lens = np.asarray(ref._lens)
        assert ref_lens.tolist() == eng._lens.tolist()
        for b, s in enumerate(eng.slots):
            if s is not None:
                n = min(int(ref_lens[b]), cap)
                for w, g in zip(_ref_kv(ref, b, n), _port_kv(eng, b, n)):
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert sorted(outs) == [0, 1, 2]
    assert _tokens(outs[r] for r in range(3)) == _plain_streams(
        tm, [(p, n, None) for p, n in requests], k, cap)
    # the over-dispatch happened: a slot the host sent as active started a
    # scan at a length past the capacity margin
    assert any(act[b] and lens[b] > cap - k
               for lens, act in starts for b in range(2))


# ---------------------------------------------------------------------------
# the reference's own speculative tests, against the reference engine
# ---------------------------------------------------------------------------

def _spec_pair(jm, tm, prompt, n, **kw):
    """One request through the reference's and the port's speculative
    engines at the same settings: (port output, port engine, reference
    output, reference engine)."""
    ref, eng = JEngine(jm, **kw), LLMEngine(tm, device="cpu", **kw)
    (want,) = ref.generate([prompt], max_new_tokens=n)
    (got,) = eng.generate([prompt], max_new_tokens=n)
    return got, eng, want, ref


def _greedy_ref(model, prompt, n):
    out = model.generate(paddle.to_tensor(np.asarray(prompt)[None]),
                         max_new_tokens=n, temperature=0.0)
    return np.asarray(out.numpy())[0].tolist()


def test_exact_on_repetitive_and_random(models):
    """Twin of TestSpeculativeDecoding::test_exact_on_repetitive_and_random
    (tests/test_llm_engine.py:233): B 1, speculative_k 5, a repetitive and
    a random prompt, equal to the reference engine's stream and to the
    reference model's greedy generate."""
    jm, tm = models
    rng = np.random.default_rng(14)
    base = rng.integers(1, 96, size=(6,)).astype(np.int32)
    rep = np.concatenate([base, base, base[:3]])
    rand = rng.integers(1, 96, size=(9,)).astype(np.int32)
    for p, n in ((rep, 16), (rand, 8)):
        got, eng, want, ref = _spec_pair(jm, tm, p, n, max_batch=1,
                                         max_seq_len=96, chunk_size=16,
                                         speculative_k=5)
        assert got.token_ids == want.token_ids == _greedy_ref(jm, p, n)
        assert {k: eng.stats[k] for k in SPEC_STATS} == \
            {k: ref.stats[k] for k in SPEC_STATS}


def test_acceptance_compresses_steps(models):
    """Twin of ::test_acceptance_compresses_steps (:244): the reference
    test's search (its seed) for a prompt whose greedy stream loops, run
    on the port's plain engine; then speculative_k 6 must accept drafts
    and take fewer steps than tokens, as the reference engine does."""
    jm, tm = models
    rng = np.random.default_rng(15)
    plain = LLMEngine(tm, device="cpu", max_batch=1, max_seq_len=128,
                      chunk_size=16)
    p = None
    for _ in range(12):
        cand = rng.integers(1, 96, size=(6,)).astype(np.int32)
        (ref,) = plain.generate([cand], max_new_tokens=24)
        toks = ref.token_ids
        if any(toks[i] == toks[i + 1] == toks[i + 2]
               for i in range(len(toks) - 2)):
            p = cand
            break
    assert p is not None, "no looping greedy stream found"
    n = 24
    got, eng, want, jeng = _spec_pair(jm, tm, p, n, max_batch=1,
                                      max_seq_len=128, chunk_size=16,
                                      speculative_k=6)
    assert got.token_ids == want.token_ids == toks
    assert eng.stats["draft_tokens_accepted"] > 0
    assert eng.stats["steps"] < n
    assert {k: eng.stats[k] for k in SPEC_STATS} == \
        {k: jeng.stats[k] for k in SPEC_STATS}


def test_composes_with_horizon(models):
    """Twin of ::test_composes_with_horizon (:285): speculative_k 4 with
    horizon 3, one step a scan of 3 windows, token-exact, fewer than 8
    steps for 24 tokens, drafts accepted; the counters and the request's
    EWMA trail equal the reference engine's."""
    jm, tm = models
    rng = np.random.default_rng(21)
    base = rng.integers(1, 96, size=(5,)).astype(np.int32)
    p = np.concatenate([base, base, base])
    n = 24
    kw = dict(max_batch=1, max_seq_len=128, chunk_size=16, speculative_k=4,
              horizon=3)
    ref, eng = JEngine(jm, **kw), LLMEngine(tm, device="cpu", **kw)
    rid = eng.add_request(p, max_new_tokens=n)
    ref.add_request(p, max_new_tokens=n)
    trail = []
    while ref.has_unfinished():
        ref.step()
        eng.step()
        assert eng.spec_ewma_for(rid) == pytest.approx(ref.spec_ewma_for(rid))
        trail.append(eng.spec_ewma_for(rid))
    assert eng.finished_outputs[rid].token_ids == \
        ref.finished_outputs[rid].token_ids == _plain_streams(
            tm, [(p, n, None)], 4, 128)[0]
    assert eng.stats["steps"] < 8
    assert eng.stats["draft_tokens_accepted"] > 0
    assert {k: eng.stats[k] for k in SPEC_STATS} == \
        {k: ref.stats[k] for k in SPEC_STATS}
    # the readout updates the EWMA; the finish drops the mirror entry
    assert any(e is not None for e in trail)
    assert rid not in eng._spec_ewma


def test_speculative_engine_serves_exact(models):
    """Twin of tests/test_serving.py::test_speculative_engine_serves_exact
    (:106): speculative_k 3, horizon 2 behind AsyncLLMServer at depth 2,
    streamed token by token, equal to the plain dense engine's and to the
    reference server's stream; the server's spec counters and acceptance
    gauge read what the reference server's read."""
    jm, tm = models
    base = np.random.default_rng(2).integers(1, 96, size=(6,)) \
        .astype(np.int32)
    p = np.tile(base, 5)[:28]
    kw = dict(max_batch=1, max_seq_len=64, chunk_size=16, speculative_k=3,
              horizon=2)
    (plain,) = JEngine(jm, max_batch=2, max_seq_len=64,
                       chunk_size=16).generate([p], max_new_tokens=8)
    res = []
    for srv_cls, eng in ((JServer, JEngine(jm, **kw)),
                         (AsyncLLMServer, LLMEngine(tm, device="cpu", **kw))):
        with srv_cls(eng) as server:
            assert server.pipeline_depth == 2
            h = server.submit(p, max_new_tokens=8)
            toks = list(h.tokens(timeout=120))
            assert h.result().finish_reason == "length"
        snap = server.telemetry.snapshot()
        res.append((toks, {k: snap["counters"][k] for k in (
            "spec_proposed_tokens", "spec_accepted_tokens")},
            server.telemetry.get_gauges()["spec_acceptance_rate"],
            {k: eng.stats[k] for k in SPEC_STATS[1:]}))
    (w_toks, w_ctr, w_gauge, w_stats), (g_toks, g_ctr, g_gauge, g_stats) = res
    assert g_toks == w_toks == plain.token_ids
    assert g_ctr == w_ctr and g_ctr["spec_proposed_tokens"] > 0
    assert g_stats == w_stats
    assert g_ctr["spec_proposed_tokens"] == g_stats["spec_proposed_tokens"]
    assert g_gauge == pytest.approx(w_gauge)


# ---------------------------------------------------------------------------
# speculative_k=1, the weight-only int4 model, the constructor
# ---------------------------------------------------------------------------

def test_spec_k1_is_the_plain_legacy_engine(models):
    """speculative_k=1 keeps the plain legacy engine bit for bit: no token
    history, the same streams, counters, StepRecords, carried logits,
    lens and K/V buffers as an engine built without the argument."""
    _, tm = models
    requests = _request_set(tm, 1)
    engines = []
    for extra in ({}, dict(speculative_k=1)):
        eng = LLMEngine(tm, device="cpu", max_batch=3, max_seq_len=96,
                        chunk_size=16, horizon=3, **extra)
        eng.flight_recorder = FlightRecorder(capacity=1024)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            outs = eng.generate([p for p, _, _ in requests[:3]],
                                max_new_tokens=9)
        engines.append((eng, _tokens(outs)))
    (plain, want), (k1, got) = engines
    assert k1._tokens is None and plain._tokens is None
    assert got == want
    assert _counters(k1) == _counters(plain)
    assert [r.to_dict()[f] for r in k1.flight_recorder.records()
            for f in STEP_FIELDS] == \
        [r.to_dict()[f] for r in plain.flight_recorder.records()
         for f in STEP_FIELDS]
    assert {r.kind for r in k1.flight_recorder.records()} == {"decode"}
    for a, b in zip((k1._logits, k1._lens, *k1._k, *k1._v),
                    (plain._logits, plain._lens, *plain._k, *plain._v)):
        assert torch.equal(a, b)


def test_int4_weight_only_model_under_the_scan(models):
    """A weight-only int4 model (``nn/quant``, the plain route on the CPU)
    under the legacy scan: token-exact against the reference's int4 model
    in its legacy speculative engine, with equal counters, and against the
    port's non-speculative engine over the same int4 model."""
    jm, tm = models
    jq, tq = copy.deepcopy(jm), copy.deepcopy(tm)
    JQ.quantize_linears_for_inference(jq, weight_dtype="int4")
    TQ.quantize_linears_for_inference(tq, weight_dtype="int4")
    requests = _request_set(tm, 4)[:4]
    prompts = [p for p, _, _ in requests]
    kw = _kw(4, 2, 3)
    ref, eng = JEngine(jq, **kw), LLMEngine(tq, device="cpu", **kw)
    want = _tokens(ref.generate(prompts, max_new_tokens=12))
    got = _tokens(eng.generate(prompts, max_new_tokens=12))
    plain = _tokens(LLMEngine(tq, device="cpu", max_batch=3, max_seq_len=96,
                              chunk_size=16).generate(prompts,
                                                      max_new_tokens=12))
    assert got == want == plain
    assert {k: eng.stats[k] for k in SPEC_STATS} == \
        {k: ref.stats[k] for k in SPEC_STATS}
    assert eng.stats["spec_proposed_tokens"] > 0


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "int4"])
def test_quantized_pools_still_raise(models, kv_cache_dtype):
    """Verify windows over int8/int4 pools are item (ii) of A8(e)'s second
    half: still NotImplementedError, while the dense legacy default now
    constructs with a token history and the legacy contract's depth."""
    _, tm = models
    with pytest.raises(NotImplementedError, match="A8\\(e\\), second half"):
        LLMEngine(tm, device="cpu", speculative_k=4, max_batch=2,
                  max_seq_len=96, chunk_size=16, scheduler="fused",
                  cache_impl="paged", block_size=8,
                  kv_cache_dtype=kv_cache_dtype)
    eng = LLMEngine(tm, device="cpu", speculative_k=4)
    assert (eng.scheduler, eng.cache_impl) == ("legacy", "dense")
    assert eng._tokens.shape == (4, 128) and eng.max_pipeline_depth() == 2


# ---------------------------------------------------------------------------
# C4: lengths past the buffer, and a capacity at the rope table's end
# ---------------------------------------------------------------------------

def test_c4_lookup_draft_reads_clamped_past_capacity():
    """Fault C4: a pipelined over-dispatch of the legacy scan drafts at a
    length past the history buffer, where the reference's ``buf[L - 1]``
    clamps the index (JAX's rule for an out-of-range read) and the port
    indexed past the buffer. Held against the reference's helper at
    lengths up to ``cap + k``."""
    cap, rng = 24, np.random.default_rng(8)
    buf = rng.integers(0, 4, size=(7, cap)).astype(np.int32)
    lens = np.array([cap - 2, cap - 1, cap, cap + 1, cap + 3, cap + 5, 0],
                    np.int32)
    for ngram, k_draft in ((3, 5), (1, 3), (2, 4)):
        want = np.asarray(jle._lookup_draft(jnp.asarray(buf),
                                            jnp.asarray(lens), k_draft,
                                            ngram))
        got = tle._lookup_draft(torch.from_numpy(buf),
                                torch.from_numpy(lens), k_draft, ngram)
        np.testing.assert_array_equal(got.numpy(), want)


def _rope_edge_requests(rng):
    base = rng.integers(1, V, size=(int(rng.integers(1, 4)),)) \
        .astype(np.int32)
    near = np.tile(base, 200)[:int(rng.integers(100, 118))]
    return [(near, 50, None),
            (rng.integers(1, V, size=(5,)).astype(np.int32), 40, None),
            (rng.integers(1, V, size=(7,)).astype(np.int32), 30, None)]


@pytest.mark.filterwarnings("ignore:request .* capping max_new_tokens")
@pytest.mark.parametrize("depth", [1, 2])
def test_capacity_at_the_rope_table_keeps_the_plain_stream(models, depth):
    """At the default ``max_seq_len`` (the rope table's 128 positions) a
    near-capacity slot's windows reach past the table: an inactive row's
    windows and, at depth 2, a stale over-dispatch. The port clamps the
    rope index as it clamps the cache writes, so the request re-admitted
    into that row streams what the plain engine streams (the reference's
    ``jnp.take`` reads NaN there instead: ROADMAP C, reference caveats).
    At depth 2 the scan also drafts past the history buffer (C4)."""
    _, tm = models
    k, cap = 4, KW["max_position_embeddings"]
    rng = np.random.default_rng(0)
    requests = [_rope_edge_requests(rng) for _ in range(2)][1]
    eng = LLMEngine(tm, device="cpu", max_batch=2, chunk_size=16,
                    speculative_k=k, horizon=2)
    assert eng.capacity == cap
    starts = []     # every row's length at each window's start
    scan = eng._spec_scan

    def watched(*a):
        lens = eng._lens.numpy().copy()
        toks, counts, act = scan(*a)
        starts.extend(lens + np.cumsum(counts.numpy(), axis=0)
                      - counts.numpy())
        return toks, counts, act

    eng._spec_scan = watched
    rids = [eng.add_request(p, max_new_tokens=n) for p, n, _ in requests]
    outs = _drain_at_depth(eng, depth)
    assert [list(outs[r].token_ids) for r in rids] == _plain_streams(
        tm, requests, k, cap)
    top = int(np.max(starts))
    assert top + k > cap            # windows reached past the rope table
    if depth == 2:
        assert top > cap            # the C4 path: drafts past the buffer


# ---------------------------------------------------------------------------
# sampled streams under the scan: the coupled acceptance rule
# ---------------------------------------------------------------------------

def _seed_both(state):
    """Both packages' global generators at one (seed, counter) state."""
    jrandom.default_generator.set_state(state)
    trandom.default_generator.set_state(state)


def _serve_rids(eng, requests):
    rids = [eng.add_request(p, **kw) for p, kw in requests]
    while eng.has_unfinished():
        eng.step()
    return [list(eng.finished_outputs[r].token_ids) for r in rids]


def test_sampling_slot_decodes_beside_greedy(models):
    """A temperature-1.0 slot decodes beside a greedy one under the scan
    (reference tests/test_llm_engine.py:270): the greedy stream is the
    plain engine's, and both are the reference speculative engine's
    token for token."""
    jm, tm = models
    rng = np.random.default_rng(16)
    pg = rng.integers(1, V, size=(7,)).astype(np.int32)
    ps = rng.integers(1, V, size=(6,)).astype(np.int32)
    reqs = [(pg, dict(max_new_tokens=6, temperature=0.0)),
            (ps, dict(max_new_tokens=6, temperature=1.0))]
    kw = _kw(4, max_batch=2)
    _seed_both((4, 0))
    want = _serve_rids(JEngine(jm, **kw), reqs)
    _seed_both((4, 0))
    got = _serve_rids(LLMEngine(tm, device="cpu", **kw), reqs)
    assert got == want
    assert got[0] == _plain_streams(tm, [(pg, 6, None)], spec_k=4)[0]
    assert len(got[1]) == 6


def test_spec_coupled_acceptance_sampled_token_exact(models):
    """The coupled rule makes a SAMPLED speculative stream token-identical
    to the plain sampled engine's (reference
    tests/test_llm_engine.py:321), here also to the reference's plain
    engine; acceptance is booked as the reference books it."""
    jm, tm = models
    rng = np.random.default_rng(20)
    base = rng.integers(1, V, size=(6,)).astype(np.int32)
    prompts = [np.tile(base, 3)[:15],
               rng.integers(1, V, size=(9,)).astype(np.int32)]
    sampling = dict(max_new_tokens=8, temperature=0.8, top_p=0.9)
    _seed_both((321, 0))
    want = _tokens(JEngine(jm, max_batch=2, max_seq_len=96,
                           chunk_size=16).generate(prompts, **sampling))
    _seed_both((321, 0))
    plain = LLMEngine(tm, device="cpu", max_batch=2, max_seq_len=96,
                      chunk_size=16)
    assert _tokens(plain.generate(prompts, **sampling)) == want
    _seed_both((321, 0))
    spec = LLMEngine(tm, device="cpu", max_batch=2, max_seq_len=96,
                     chunk_size=16, speculative_k=4)
    assert _tokens(spec.generate(prompts, **sampling)) == want
    assert spec.stats["spec_proposed_tokens"] > 0
    assert spec.stats["spec_accepted_tokens"] == \
        spec.stats["draft_tokens_accepted"]
