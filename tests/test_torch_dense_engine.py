"""paddle_tpu_torch's dense engine, ``LLMEngine(model)`` (the reference's
default, ``cache_impl="dense"``), against paddle_tpu's dense engine with
the same arguments on bridged weights: greedy streams TOKEN-EXACT, with
the same finish reasons, under the legacy and the fused scheduler, at
``horizon`` 1, 4 and 8 and pipelined to the depth contract (legacy 2,
fused 3); the model-level ``ChunkKVCache`` and ``SlotKVCache`` branches
through one ``LlamaAttention`` of both packages within 1e-5 of the largest
magnitude; and the reference's request surface of ``add_request`` (its six
keyword arguments and ``throughput()``). CPU, float32, the models of
tests/test_torch_engine.py (2 layers, hidden 64, vocab 96) in MHA and GQA
form. Reference engines are built once per argument set and reused."""
import collections
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.llm_engine import LLMEngine as JEngine
from paddle_tpu.models.llama import (ChunkKVCache as JChunkKVCache,
                                     LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama,
                                     SlotKVCache as JSlotKVCache)
from paddle_tpu.nn import quant as JQ

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import (ChunkKVCache, LlamaConfig,
                                           LlamaForCausalLM, SlotKVCache)
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.serving import AsyncLLMServer

torch.set_num_threads(1)

SCHEDULERS = ["legacy", "fused"]


def _models(kvh):
    kw = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=kvh, max_position_embeddings=128)
    paddle.seed(7)
    jm = JLlama(JConfig(**kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    tm.eval()
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def mha():
    return _models(4)


@pytest.fixture(scope="module")
def gqa():
    return _models(2)


@pytest.fixture(scope="module")
def int8_models(mha):
    jq, tq = copy.deepcopy(mha[0]), copy.deepcopy(mha[1])
    JQ.quantize_linears_for_inference(jq, weight_dtype="int8")
    TQ.quantize_linears_for_inference(tq, weight_dtype="int8")
    return jq, tq


#: reference engines by (model, arguments): each compiles its programs
#: once, and a drained engine serves the next workload
_REF_ENGINES = {}


def _kw(**over):
    """The engine arguments: no ``cache_impl``, so both engines are dense
    by default (the scheduler and horizon named, so equal argument sets
    share one reference engine)."""
    kw = dict(max_batch=2, max_seq_len=64, chunk_size=16, scheduler="legacy",
              horizon=1)
    kw.update(over)
    return kw


def _ref_engine(jm, **kw):
    key = (id(jm), tuple(sorted(kw.items())))
    if key not in _REF_ENGINES:
        _REF_ENGINES[key] = JEngine(jm, **kw)
    return _REF_ENGINES[key]


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, size=(n,)).astype(np.int32) for n in lens]


def _serve(engine, requests):
    """Submit ``(prompt, kwargs)`` pairs, drain, return [(tokens, reason)]."""
    rids = [engine.add_request(p, **kw) for p, kw in requests]
    while engine.has_unfinished():
        engine.step()
    return [(list(engine.finished_outputs[r].token_ids),
             engine.finished_outputs[r].finish_reason) for r in rids]


def _both(models, requests, **engine_kw):
    jm, tm = models
    ref_eng = _ref_engine(jm, **_kw(**engine_kw))
    eng = LLMEngine(tm, device="cpu", **_kw(**engine_kw))
    return _serve(ref_eng, requests), _serve(eng, requests), ref_eng, eng


def _drain_depth(eng, depth):
    """Keep up to ``depth`` dispatched steps in flight (step_begin of the
    next steps before step_finish of the oldest), as a pipelined server
    does; return {request id: (tokens, reason)}."""
    pend, outs = collections.deque(), {}
    while eng.has_unfinished() or pend:
        while len(pend) < depth and eng.has_unfinished():
            pending = eng.step_begin()
            if pending is None:
                break
            pend.append(pending)
        for o in eng.step_finish(pend.popleft()):
            outs[o.request_id] = (list(o.token_ids), o.finish_reason)
    return outs


RAGGED = (15, 16, 17, 5, 3, 9, 33)     # chunk 16: chunk - 1, chunk, + 1


@pytest.mark.parametrize("which", ["mha", "gqa"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_ragged_streams_match_reference(which, scheduler, request):
    """Prompts at chunk - 1, chunk and chunk + 1, short ones and one of
    three windows, 7 requests through 2 slots, every stream seen by the
    stream callback in order."""
    models = request.getfixturevalue(which)
    reqs = [(p, dict(max_new_tokens=8)) for p in _prompts(31, RAGGED)]
    ref, out, ref_eng, eng = _both(models, reqs, scheduler=scheduler)
    assert out == ref
    assert all(r == "length" for _, r in out)
    assert eng.cache_impl == "dense" and not hasattr(eng, "_tables")
    for key in ("prefill_chunks", "prefill_tokens", "fused_steps",
                "tokens_generated"):
        assert eng.stats[key] == ref_eng.stats[key], key
    seen = collections.defaultdict(list)
    streamer = LLMEngine(models[1], device="cpu",
                         stream_callback=lambda rid, tok: seen[rid].append(
                             tok), **_kw(scheduler=scheduler))
    outs = streamer.generate([p for p, _ in reqs[:3]], max_new_tokens=8)
    assert [seen[o.request_id] for o in outs] == [t for t, _ in ref[:3]]


@pytest.mark.parametrize("horizon", [4, 8])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_horizon_eos_and_budget_inside_a_window(mha, scheduler, horizon):
    """``horizon`` decode iterations a dispatch: an eos inside a window,
    a budget (3) that ends mid-horizon, and streams equal to horizon 1."""
    prompts = _prompts(10, (6, 9, 4))
    (plain, _), = _serve(_ref_engine(mha[0], **_kw(scheduler=scheduler)),
                         [(prompts[0], dict(max_new_tokens=7))])
    eos = plain[3]
    reqs = [(prompts[0], dict(max_new_tokens=7, eos_token_id=eos)),
            (prompts[1], dict(max_new_tokens=7)),
            (prompts[2], dict(max_new_tokens=3))]
    ref, out, _, _ = _both(mha, reqs, scheduler=scheduler, horizon=horizon)
    assert out == ref
    assert out[0] == (plain[:plain.index(eos) + 1], "eos")
    assert len(out[2][0]) == 3 and out[2][1] == "length"
    h1 = LLMEngine(mha[1], device="cpu", **_kw(scheduler=scheduler))
    assert _serve(h1, reqs) == out


#: one slot, capacity 48, chunk 32: a 40-token prompt's second window
#: crosses the buffer's end
SHORT = dict(max_batch=1, max_seq_len=48, chunk_size=32)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_capacity_not_a_multiple_of_chunk(mha, scheduler):
    """40 tokens, capacity 48, chunk 32: the legacy admission's second
    window slides back to position 16 (a torch slice does not clamp as a
    dynamic slice does), the fused grants write exact positions."""
    (p,) = _prompts(11, (40,))
    ref, out, _, eng = _both(mha, [(p, dict(max_new_tokens=4))],
                             scheduler=scheduler, **SHORT)
    assert out == ref and len(out[0][0]) == 4
    assert eng.stats["prefill_chunks"] == 2
    assert eng.stats["prefill_tokens"] == 40


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_budget_clamp_warns_and_no_room_raises(mha, scheduler):
    """A budget past the capacity is capped with a warning (40 + 7 + 1 =
    48), the stream ends at the cap as the reference's does; a prompt with
    no room is rejected up front."""
    (p,) = _prompts(13, (40,))
    kw = _kw(scheduler=scheduler, **SHORT)
    (ref,) = _serve(_ref_engine(mha[0], **kw), [(p, dict(
        max_new_tokens=50))])
    eng = LLMEngine(mha[1], device="cpu", **kw)
    eng.add_request(p, max_new_tokens=50)
    with pytest.warns(RuntimeWarning, match="capping max_new_tokens"):
        while eng.has_unfinished():
            eng.step()
    (out,) = eng.finished_outputs.values()
    assert (list(out.token_ids), out.finish_reason) == ref
    assert len(out.token_ids) == 7
    with pytest.raises(ValueError, match="no room"):
        eng.add_request(_prompts(14, (47,))[0], max_new_tokens=4)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_int8_weight_only_projections(int8_models, scheduler):
    reqs = [(p, dict(max_new_tokens=6)) for p in _prompts(15, (17, 6))]
    ref, out, _, _ = _both(int8_models, reqs, scheduler=scheduler)
    assert out == ref


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_mid_stream_admission(mha, scheduler):
    """A request joins while another decodes: both streams exact."""
    p1, p2 = _prompts(2, (9, 4))
    runs = []
    for eng in (_ref_engine(mha[0], **_kw(scheduler=scheduler)),
                LLMEngine(mha[1], device="cpu", **_kw(scheduler=scheduler))):
        r1 = eng.add_request(p1, max_new_tokens=10)
        for _ in range(3):
            eng.step()
        r2 = eng.add_request(p2, max_new_tokens=5)
        while eng.has_unfinished():
            eng.step()
        runs.append([list(eng.finished_outputs[r].token_ids)
                     for r in (r1, r2)])
    assert runs[0] == runs[1]
    assert [len(t) for t in runs[1]] == [10, 5]


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_cancel_running_request(mha, scheduler):
    """Cancelling the running request frees its slot for the waiting one,
    whose stream is unchanged; a second cancel is a no-op."""
    p1, p2 = _prompts(18, (6, 5))
    kw = _kw(scheduler=scheduler, max_batch=1, chunk_size=8)
    (want,) = LLMEngine(mha[1], device="cpu", **kw).generate(
        [p2], max_new_tokens=8)
    eng = LLMEngine(mha[1], device="cpu", **kw)
    r1 = eng.add_request(p1, max_new_tokens=8)
    r2 = eng.add_request(p2, max_new_tokens=8)
    while eng.slots[0] is None or not eng.slots[0].generated:
        eng.step()
    out = eng.cancel(r1)
    assert out.finish_reason == "cancelled" and len(out.token_ids) >= 1
    while eng.has_unfinished():
        eng.step()
    assert eng.finished_outputs[r2].token_ids == want.token_ids
    assert eng.cancel(r1) is None and eng.cancel(12345) is None


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_cancel_from_stream_callback(mha, scheduler):
    """A cancel inside the stream callback stops the stream mid-window
    (horizon 4) and keeps the 'cancelled' output."""
    (p,) = _prompts(19, (5,))
    seen = []
    eng = None

    def cb(rid, tok):
        seen.append(tok)
        if len(seen) == 2:
            eng.cancel(rid)

    eng = LLMEngine(mha[1], device="cpu", stream_callback=cb,
                    **_kw(scheduler=scheduler, max_batch=1, chunk_size=8,
                          horizon=4))
    rid = eng.add_request(p, max_new_tokens=4)
    while eng.has_unfinished():
        eng.step()
    out = eng.finished_outputs[rid]
    assert out.finish_reason == "cancelled"
    assert len(seen) == 2 and list(out.token_ids) == seen


@pytest.mark.parametrize("scheduler,depth", [("legacy", 2), ("fused", 3)])
def test_depth_contract(mha, scheduler, depth):
    """Dense legacy 2, dense fused 3 (paged unchanged); one step_begin
    past the depth raises, naming it and the cache."""
    eng = LLMEngine(mha[1], device="cpu", **_kw(scheduler=scheduler))
    ref = _ref_engine(mha[0], **_kw(scheduler=scheduler))
    assert eng.max_pipeline_depth() == ref.max_pipeline_depth() == depth
    paged = LLMEngine(mha[1], device="cpu", cache_impl="paged",
                      block_size=8, **_kw(scheduler=scheduler))
    assert paged.max_pipeline_depth() == (3 if scheduler == "fused" else 1)
    for p in _prompts(3, (9, 20)):
        eng.add_request(p, max_new_tokens=12)
    pend = [eng.step_begin() for _ in range(depth)]
    assert all(p is not None and p.toks is not None for p in pend)
    with pytest.raises(RuntimeError, match=f"{scheduler} dense engine "
                       f".*deeper than {depth}"):
        eng.step_begin()
    for p in pend:
        eng.step_finish(p)
    while eng.has_unfinished():
        eng.step()


@pytest.mark.parametrize("scheduler,depth,horizon", [
    ("legacy", 2, 1), ("legacy", 2, 4), ("fused", 2, 1), ("fused", 3, 1),
    ("fused", 3, 4)])
def test_pipelined_token_exact(mha, scheduler, depth, horizon):
    """step_begin/step_finish pipelined to ``depth``: host state up to
    depth - 1 steps stale, streams equal to unpipelined and the
    reference's; slots finishing in flight dispatch on until their first
    readout."""
    prompts = _prompts(31, RAGGED)
    reqs = [(p, dict(max_new_tokens=8)) for p in prompts]
    ref = _serve(_ref_engine(mha[0], **_kw(scheduler=scheduler,
                                           horizon=horizon)), reqs)
    ekw = _kw(scheduler=scheduler, horizon=horizon)
    assert _serve(LLMEngine(mha[1], device="cpu", **ekw), reqs) == ref
    eng = LLMEngine(mha[1], device="cpu", **ekw)
    rids = [eng.add_request(p, **kw) for p, kw in reqs]
    outs = _drain_depth(eng, depth)
    assert [outs[r] for r in rids] == ref
    assert eng._inflight == 0


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_server_streams_match_generate(mha, scheduler):
    """AsyncLLMServer over the dense engine at its default depth (2):
    streams equal ``generate``'s and the reference's."""
    prompts = _prompts(12, (5, 17, 16, 8))
    want = [o.token_ids for o in LLMEngine(
        mha[1], device="cpu", **_kw(scheduler=scheduler)).generate(
            prompts, max_new_tokens=6)]
    ref = [t for t, _ in _serve(_ref_engine(mha[0], **_kw(
        scheduler=scheduler)), [(p, dict(max_new_tokens=6))
                                for p in prompts])]
    server = AsyncLLMServer(
        LLMEngine(mha[1], device="cpu", **_kw(scheduler=scheduler)),
        max_queue_size=8)
    assert server.pipeline_depth == 2
    with server:
        handles = [server.submit(p, max_new_tokens=6) for p in prompts]
        streams = [list(h.tokens(timeout=120)) for h in handles]
        assert server.health()["healthy"]
    assert streams == want == ref
    snap = server.telemetry.snapshot()
    assert snap["counters"]["prefill_tokens"] == sum(map(len, prompts))
    assert snap["latency"]["admission_stall"]["count"] >= 1


def _val(t):
    return np.asarray(getattr(t, "_value", t))


def _attention_pair(models, x, cache_pair, lens):
    """One LlamaAttention of each package on the same input and cache
    (the reference's functional, the port's in place): (reference out,
    k, v), (port out, k, v)."""
    jm, tm = models
    ja, ta = jm.llama.layers[0].self_attn, tm.llama.layers[0].self_attn
    jcache, tcache = cache_pair
    out, jc = ja(paddle.to_tensor(x), (jm.llama.rope_cos._value,
                                       jm.llama.rope_sin._value),
                 None, jcache, position_offset=paddle.to_tensor(lens))
    with torch.no_grad():
        tout, tc = ta(torch.from_numpy(x), (tm.llama.rope_cos,
                                            tm.llama.rope_sin),
                      None, tcache, position_offset=torch.from_numpy(lens))
    assert tc is tcache
    return ((_val(out), _val(jc.k), _val(jc.v)),
            (tout.numpy(), tc.k.numpy(), tc.v.numpy()))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_chunk_cache_branch(which, request):
    """ChunkKVCache on random buffers: a full chunk from 0, a short grant,
    a window crossing the buffer end (rows past capacity drop) and an idle
    slot (every row drops): outputs and buffers within 1e-5; rows outside
    each grant keep their bytes."""
    models = request.getfixturevalue(which)
    rng = np.random.default_rng(0)
    Hkv = models[1].config.num_key_value_heads
    B, S, T = 4, 8, 24
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv, 16)).astype(np.float32)
            for _ in range(2))
    lens = np.array([0, 5, 20, 23], np.int32)
    q_lens = np.array([8, 3, 8, 0], np.int32)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ref, got = _attention_pair(
        models, x, (JChunkKVCache(jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(lens), jnp.asarray(q_lens)),
                    ChunkKVCache(tk, tv, torch.from_numpy(lens),
                                 torch.from_numpy(q_lens))), lens)
    _close(got, ref)
    for b in range(B):
        kept = np.ones(T, bool)
        kept[lens[b]:min(lens[b] + q_lens[b], T)] = False
        np.testing.assert_array_equal(got[1][b, kept], k[b, kept])


@pytest.mark.parametrize("s", [1, 3])
def test_slot_cache_branch(gqa, s):
    """SlotKVCache: a decode step (s 1) and a small window (s 3), one
    slot's start clamped at the buffer end as the reference's dynamic
    update clamps it."""
    rng = np.random.default_rng(1)
    B, T = 4, 24
    x = rng.standard_normal((B, s, 64)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, 2, 16)).astype(np.float32)
            for _ in range(2))
    lens = np.array([0, 5, 23, 22], np.int32)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ref, got = _attention_pair(
        gqa, x, (JSlotKVCache(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens)),
                 SlotKVCache(tk, tv, torch.from_numpy(lens))), lens)
    _close(got, ref)


#: the reference's keyword arguments of add_request at their defaults
C3_DEFAULTS = dict(readout_stride=None, adapter_id=0, kind="generate",
                   spec_ewma=None, export_kv=False, trace_ctx=None)


@pytest.mark.parametrize("arg", sorted(C3_DEFAULTS))
def test_c3_argument_at_default_keeps_the_stream(mha, arg):
    (p,) = _prompts(21, (7,))
    extra = {arg: C3_DEFAULTS[arg]}
    runs = []
    for eng in (_ref_engine(mha[0], **_kw()),
                LLMEngine(mha[1], device="cpu", **_kw())):
        runs.append(_serve(eng, [(p, dict(max_new_tokens=5)),
                                 (p, dict(max_new_tokens=5, **extra))]))
    assert runs[0] == runs[1] and runs[1][0] == runs[1][1]


def test_c3_inert_values_are_accepted_and_stored(mha):
    """A readout_stride pin on a stride-1 engine, spec_ewma without
    speculation and trace_ctx without a flight recorder: accepted as the
    reference accepts them, stored on the request, the stream unchanged."""
    (p,) = _prompts(22, (7,))
    inert = dict(readout_stride=3, spec_ewma=0.4,
                 trace_ctx={"trace_id": "t-1", "span_id": "s-1"})
    eng = LLMEngine(mha[1], device="cpu", **_kw())
    eng.add_request(p, max_new_tokens=5, **inert)
    req = eng.waiting[0]
    assert (req.readout_stride, req.spec_ewma, req.trace_ctx) == (
        3, 0.4, inert["trace_ctx"])
    assert (req.adapter_id, req.kind, req.export_kv) == (0, "generate",
                                                        False)
    while eng.has_unfinished():
        eng.step()
    (got,) = eng.finished_outputs.values()
    runs = _serve(_ref_engine(mha[0], **_kw()),
                  [(p, dict(max_new_tokens=5)),
                   (p, dict(max_new_tokens=5, **inert))])
    assert runs[0] == runs[1] == (list(got.token_ids), got.finish_reason)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(readout_stride=0), ValueError, "readout_stride must be >= 1"),
    (dict(adapter_id=2), ValueError, "without an adapter_store"),
    (dict(kind="bogus"), ValueError, "unknown request kind"),
    (dict(kind="embed"), NotImplementedError, r"ROADMAP A10")])
def test_c3_rejections(mha, kw, exc, match):
    """The reference's validation errors, and the value this port cannot
    serve yet naming its ROADMAP item."""
    (p,) = _prompts(23, (5,))
    for scheduler in SCHEDULERS:
        eng = LLMEngine(mha[1], device="cpu", **_kw(scheduler=scheduler))
        with pytest.raises(exc, match=match):
            eng.add_request(p, **kw)
        assert not eng.waiting
    if exc is ValueError:
        with pytest.raises(ValueError, match=match):
            _ref_engine(mha[0], **_kw()).add_request(p, **kw)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_export_kv_is_inert_on_a_dense_engine(mha, scheduler):
    """``export_kv=True`` is accepted and stored, the stream is the plain
    one, and ``export_kv()`` returns None (no pool to stage from), as on
    the reference's dense engine; ``import_kv`` refuses."""
    (p,) = _prompts(23, (5,))
    eng = LLMEngine(mha[1], device="cpu", **_kw(scheduler=scheduler))
    rid = eng.add_request(p, max_new_tokens=5, export_kv=True)
    assert eng.waiting[0].export_kv is True
    while eng.has_unfinished():
        eng.step()
    got = eng.finished_outputs.pop(rid)
    ref = _ref_engine(mha[0], **_kw(scheduler=scheduler))
    jrid = ref.add_request(p, max_new_tokens=5, export_kv=True)
    while ref.has_unfinished():
        ref.step()
    assert list(got.token_ids) == list(
        ref.finished_outputs.pop(jrid).token_ids)
    assert eng.export_kv(rid) is None and ref.export_kv(jrid) is None
    assert eng.stats["kv_ship_out_blocks"] == 0
    assert eng.import_kv({"ready": True, "n_blocks": 1}) is False


def test_throughput(mha):
    (p,) = _prompts(8, (4,))
    eng = LLMEngine(mha[1], device="cpu", **_kw(max_seq_len=32, chunk_size=8))
    assert eng.throughput() == 0.0
    eng.generate([p], max_new_tokens=4)
    assert eng.stats["tokens_generated"] == 4
    assert eng.stats["decode_time_s"] > 0 and eng.throughput() > 0
    eng.reset_stats()
    assert eng.throughput() == 0.0


def test_dense_construction(mha):
    """No pool on a dense engine: the capacity accessors answer 0 as the
    reference's do; the paged-only options keep the reference's
    ValueErrors; the card is the default device and is never replaced by
    the CPU."""
    jm, tm = mha
    eng = LLMEngine(tm, device="cpu", **_kw())
    ref = _ref_engine(jm, **_kw())
    for name in ("kv_pool_nbytes", "kv_bytes_per_block",
                 "kv_pool_effective_blocks"):
        assert getattr(eng, name)() == getattr(ref, name)() == 0, name
    assert eng.prefill_blocks_needed(40) == 0
    assert [tuple(k.shape) for k in eng._k] == [(2, 64, 4, 16)] * 2
    with pytest.raises(ValueError, match="cache_impl='paged'"):
        LLMEngine(tm, device="cpu", kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(tm, device="cpu", enable_prefix_cache=True)
    with pytest.raises(ValueError, match="cache_impl"):
        LLMEngine(tm, device="cpu", cache_impl="ring")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LLMEngine(tm)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_committed_tokens_and_reset(mha, scheduler):
    """Re-admission with committed tokens (a supervised restart) continues
    the stream; reset() empties the engine and zeroes its buffers."""
    (p,) = _prompts(24, (11,))
    eng = LLMEngine(mha[1], device="cpu", **_kw(scheduler=scheduler))
    (full,) = eng.generate([p], max_new_tokens=8)
    rid = eng.add_request(p, max_new_tokens=5,
                          committed_tokens=full.token_ids[:3])
    eng.step()
    eng.reset()
    assert not eng.has_unfinished() and rid not in eng.finished_outputs
    assert all(not k.any() for k in eng._k) and not eng._lens.any()
    eng.add_request(p, max_new_tokens=5, committed_tokens=full.token_ids[:3])
    while eng.has_unfinished():
        eng.step()
    (out,) = eng.finished_outputs.values()
    assert out.token_ids == full.token_ids and out.finish_reason == "length"
