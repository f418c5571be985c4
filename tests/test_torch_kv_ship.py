"""paddle_tpu_torch cross-replica KV shipping (serving/kv_transport.py, the
engine's export/import and prefix pulls, the router's disaggregated
prefill/decode) held against the reference package: the cases of
tests/test_kv_ship.py and the ship case of tests/test_tracing.py at their
shapes (2 layers, hidden 64, vocab 96, seed 7; engines of ``max_batch=2,
max_seq_len=64, chunk_size=16, block_size=8``, paged, fused), on the CPU
over bridged weights, float32 and bf16, with ``PADDLE_TPU_POOL_CHECKS=1``.

The wire is PTKV v1 byte for byte: for one staged entry in each package's
layout (bf16, int8 and int4 pools, and prefix blocks) the two
``serialize_entry`` return the same bytes and each ``deserialize_entry``
reads the other's. A stream the reference exports continues on the port
token for token against the reference's uninterrupted greedy stream, and
the other way round; the restored blocks are the shipped bytes, bit for
bit. Sampled legs continue too: every engine shares ``sampling_seed``
and a migration keeps its rid, so the per-(rid, position) keys continue
the reference's uninterrupted sampled stream. The router cases take their
expected streams from the REFERENCE's ``generate`` and its counters from
the reference's router run beside the port's. Adapters in entries wait
for A10, the TP export for A14 and a port bench script for A15.

Timing: the router cases run threads; every ``result()`` has a generous
timeout (the reference's end-to-end case is timing-dependent, ROADMAP
C)."""
import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.serving import (AsyncLLMServer as JServer,
                                ReplicaRouter as JRouter)
from paddle_tpu.serving import kv_transport as jkv
from paddle_tpu.serving.cluster import FLEET_TAIL_CAUSES as J_FLEET_CAUSES

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler import FlightRecorder
from paddle_tpu_torch.profiler.flight_recorder import (FLOW_EVENT_NAME,
                                                       TAIL_CAUSES)
from paddle_tpu_torch.serving import (AsyncLLMServer, FaultInjector,
                                      InProcessTransport, KVTransport,
                                      ReplicaRouter, TransportError,
                                      deserialize_entry, serialize_entry)
from paddle_tpu_torch.serving import kv_transport as tkv
from paddle_tpu_torch.serving.cluster import FLEET_TAIL_CAUSES

torch.set_num_threads(1)

V = 96
CFG = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=128)
SEED = 11          # the reference file's sampling_seed
T = 300            # seconds a result() may take before the case fails

#: the router counters a cross-package case holds equal
ROUTER_STATS = ("submitted", "resubmitted", "replica_lost", "kv_shipped",
                "kv_ship_fallback", "kv_ship_abandoned",
                "pull_on_miss_blocks")


def _models(dtype):
    paddle.seed(7)
    jm = JLlama(JConfig(**CFG))
    if dtype == "bfloat16":
        jm = jm.bfloat16()
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG, dtype=dtype), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _models("float32")


@pytest.fixture(scope="module")
def models_bf16():
    return _models("bfloat16")


@pytest.fixture(autouse=True)
def pool_checks(monkeypatch):
    """The allocator audit after every alloc, free and unfence."""
    monkeypatch.setenv("PADDLE_TPU_POOL_CHECKS", "1")


@pytest.fixture(scope="module")
def prompt():
    rng = np.random.default_rng(0)
    return rng.integers(1, V, size=(25,)).astype(np.int32)


def _kw(**over):
    kw = dict(max_batch=2, max_seq_len=64, chunk_size=16,
              cache_impl="paged", block_size=8, scheduler="fused",
              sampling_seed=SEED)
    kw.update(over)
    return kw


def _port(tm, **over):
    return LLMEngine(tm, device="cpu", **_kw(**over))


@pytest.fixture(scope="module")
def greedy_ref(models, prompt):
    """The reference's uninterrupted greedy 10-token stream."""
    eng = JEngine(models[0], **_kw())
    return list(eng.generate([prompt], max_new_tokens=10)[0].token_ids)


#: the reference file's sampled legs
SAMPLED = dict(temperature=0.8, top_p=0.9)


@pytest.fixture(scope="module")
def sampled_ref(models, prompt):
    """The reference's uninterrupted SAMPLED 10-token stream per rid: under
    ``sampling_seed`` the stream is a function of the rid, which is why a
    migration keeps it."""
    eng = JEngine(models[0], **_kw())
    cache = {}

    def get(rid):
        if rid not in cache:
            eng.add_request(prompt, max_new_tokens=10, request_id=rid,
                            **SAMPLED)
            while eng.has_unfinished():
                eng.step()
            cache[rid] = list(eng.finished_outputs.pop(rid).token_ids)
        return cache[rid]

    return get


def _leg(eng, prompt, rid, **sampling):
    """The one-token prefill leg with export staging (either package's
    engine): its token and the materialized staged entry."""
    assert eng.add_request(prompt, max_new_tokens=1, request_id=rid,
                           export_kv=True, **sampling) == rid
    while eng.has_unfinished():
        eng.step()
    tok = eng.finished_outputs.pop(rid).token_ids[0]
    entry = eng.export_kv(rid)
    assert entry is not None and entry["ready"]
    return tok, entry


def _resume(eng, prompt, rid, tok, n=9, **sampling):
    eng.add_request(prompt, max_new_tokens=n, request_id=rid,
                    committed_tokens=[tok], **sampling)
    while eng.has_unfinished():
        eng.step()
    return list(eng.finished_outputs.pop(rid).token_ids)


def _jdefs(eng):
    return (jax.tree_util.tree_structure(eng._k),
            jax.tree_util.tree_structure(eng._v))


def _bits(t):
    """A host tensor as integers of its width (bit equality)."""
    t = t.contiguous()
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


def _watch_restores(eng):
    """Wrap ``eng._restore_blocks``: after each call, whether the restored
    pool blocks (payload and scales) equal the host rows bit for bit."""
    seen = []
    orig = eng._restore_blocks

    def watched(entry, lo, dst):
        orig(entry, lo, dst)
        pools, scales = eng._tier_pools()
        idx = torch.as_tensor(dst, dtype=torch.long)
        ok = torch.equal(_bits(torch.stack(
            [p.index_select(0, idx) for p in pools], dim=1)),
            _bits(entry["kv"][lo:lo + len(dst)]))
        if scales is not None:
            ok = ok and torch.equal(_bits(torch.stack(
                [t.index_select(0, idx) for t in scales], dim=1)),
                _bits(entry["scale"][lo:lo + len(dst)]))
        seen.append(ok)

    eng._restore_blocks = watched
    return seen


def _ref_leaves(entry):
    """A reference staged entry's k and v leaves as numpy arrays."""
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(entry["k"])
            + jax.tree_util.tree_leaves(entry["v"])]


def _port_leaves(entry):
    """A port staged entry's leaves in the reference's order."""
    return [a for a in tkv._leaves(entry)[0]]


def _same_leaf(ref_np, port_t):
    if ref_np.dtype.name == "bfloat16":
        return np.array_equal(ref_np.view(np.int16),
                              port_t.contiguous().view(torch.int16).numpy())
    return ref_np.dtype == port_t.numpy().dtype and \
        ref_np.tobytes() == port_t.contiguous().numpy().tobytes()


# ---------------------------------------------------------------------------
# the wire: PTKV v1, byte for byte
# ---------------------------------------------------------------------------

def _twin_entries(kind, L=2, n=3, hkv=4, bs=8, d=16):
    """One staged entry in both layouts from one seed: the reference's
    (lists of layers, or (payload, scale) pairs) and the port's
    (``kv [n, 2L, Hkv, bs, Dp]``, ``scale [n, 2L, Hkv]``)."""
    rng = np.random.default_rng(4)
    quant = kind in ("int8", "int4")
    dp = d // 2 if kind == "int4" else d
    if quant:
        kv = rng.integers(-128, 128, (n, 2 * L, hkv, bs, dp)).astype(np.int8)
        sc = rng.random((n, 2 * L, hkv)).astype(np.float32)
        side = [[(kv[:, j], sc[:, j]) for j in range(s * L, (s + 1) * L)]
                for s in (0, 1)]
        port = {"kv": torch.from_numpy(kv.copy()),
                "scale": torch.from_numpy(sc.copy())}
    else:
        kv = rng.standard_normal((n, 2 * L, hkv, bs, dp)).astype(
            ml_dtypes.bfloat16)
        side = [[kv[:, j] for j in range(s * L, (s + 1) * L)]
                for s in (0, 1)]
        port = {"kv": torch.from_numpy(kv.view(np.int16).copy()).view(
            torch.bfloat16), "scale": None}
    common = {"adapter_id": 0, "n_blocks": n, "block_size": bs,
              "kv_quant": kind if quant else None, "ready": True,
              "nbytes": int(kv.nbytes + (sc.nbytes if quant else 0))}
    if kind == "prefix_block":
        common.update(hash=bytes(range(16)), parent=bytes(range(16, 32)),
                      tokens=np.arange(bs, dtype=np.int32).tobytes())
    else:
        common.update(rid=7, tokens=np.arange(25, dtype=np.int32),
                      chain=[bytes([i] * 16) for i in range(3)])
    return {**common, "k": side[0], "v": side[1]}, {**common, **port}


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "prefix_block"])
def test_wire_bytes_equal_the_reference(kind):
    """For the same staged entry the port's PTKV bytes are the
    reference's, and each package's deserialize_entry reads the other's
    into its own layout bit for bit, against its own pool structure
    (the structure strings the port writes from L and the quantization)."""
    ref, port = _twin_entries(kind)
    wire = serialize_entry(port)
    assert wire == jkv.serialize_entry(ref)
    quant = port["scale"] is not None
    pdefs = (tkv._treedef(2, quant),) * 2
    assert pdefs == tuple(str(t) for t in (
        jax.tree_util.tree_structure(ref["k"]),
        jax.tree_util.tree_structure(ref["v"])))
    # the reference's bytes into the port's layout
    back = deserialize_entry(jkv.serialize_entry(ref), pdefs)
    assert torch.equal(_bits(back["kv"]), _bits(port["kv"]))
    assert (back["scale"] is None) == (not quant)
    if quant:
        assert torch.equal(back["scale"], port["scale"])
    # the port's bytes into the reference's layout
    jback = jkv.deserialize_entry(wire, (
        jax.tree_util.tree_structure(ref["k"]),
        jax.tree_util.tree_structure(ref["v"])))
    for a, b in zip(_ref_leaves(jback), _port_leaves(port)):
        assert _same_leaf(a, b)
    for e in (back, jback):
        assert e["n_blocks"] == 3 and e["ready"] is True
        assert e["nbytes"] == port["nbytes"]
        if kind == "prefix_block":
            assert e["hash"] == port["hash"] and \
                e["parent"] == port["parent"] and \
                e["tokens"] == port["tokens"]
        else:
            assert e["rid"] == 7 and e["chain"] == port["chain"]
            assert np.array_equal(e["tokens"], port["tokens"])
    # with no structure given, the header's own is read
    assert torch.equal(_bits(deserialize_entry(wire)["kv"]),
                       _bits(port["kv"]))


def test_wire_rejects_corruption_and_mismatch():
    """The reference's rejections (tests/test_kv_ship.py:170-188), and a
    destination of another pool structure refuses the reference's bytes
    as the port's."""
    ref, port = _twin_entries("bf16")
    wire = serialize_entry(port)
    with pytest.raises(TransportError, match="magic"):
        deserialize_entry(b"XXXX" + wire[4:])
    with pytest.raises(TransportError, match="trailing"):
        deserialize_entry(wire + b"\x00")
    for bad in ((tkv._treedef(1, False),) * 2, (tkv._treedef(2, True),) * 2):
        for data in (wire, jkv.serialize_entry(ref)):
            with pytest.raises(TransportError, match="structure"):
                deserialize_entry(data, bad)
    with pytest.raises(TransportError, match="ready"):
        serialize_entry(dict(port, ready=False))
    # a structure that is no pool's (a leaf triple a layer) is refused
    rng = np.random.default_rng(5)
    odd = [(rng.integers(-128, 128, (3, 8, 4, 16)).astype(np.int8),
            rng.standard_normal((3, 8, 4)).astype(np.float32),
            rng.standard_normal((3, 8)).astype(np.float32))]
    with pytest.raises(TransportError, match="no pool's"):
        deserialize_entry(jkv.serialize_entry(dict(ref, k=odd, v=odd)))


# ---------------------------------------------------------------------------
# staged export / import across the two packages
# ---------------------------------------------------------------------------

def test_reference_export_continues_on_the_port(models, prompt, greedy_ref):
    """The reference's one-token leg exports, its PTKV bytes import into
    the port's engine, and the port continues the stream token for token
    against the reference's uninterrupted one, restoring the shipped
    bytes bit for bit, prefilling one position and booking kv_ship_in_*
    (the kv_swap_* classifier signal untouched)."""
    jm, tm = models
    src = JEngine(jm, **_kw())
    tok, entry = _leg(src, prompt, rid=100)
    assert [tok] == greedy_ref[:1]
    dst = _port(tm)
    restores = _watch_restores(dst)
    staged = deserialize_entry(jkv.serialize_entry(entry),
                               tkv.pool_treedefs(dst))
    assert dst.import_kv(staged)
    assert _resume(dst, prompt, 100, tok) == greedy_ref
    assert restores == [True]
    st = dst.stats
    assert st["prefill_tokens"] == 1
    assert st["kv_swap_saved_tokens"] == len(prompt)
    assert st["kv_ship_in_blocks"] == entry["n_blocks"] >= 1
    assert st["kv_ship_in_bytes"] == entry["nbytes"]
    assert st["kv_swap_in_bytes"] == st["kv_swap_in_blocks"] == 0
    assert not dst._swap_store and 100 in dst._stitch_s
    dst._check_pool_invariants()


def test_port_export_continues_on_the_reference(models, prompt, greedy_ref):
    """The other way round: the port's leg exports (its stats booked as
    the reference's source books them), the reference imports the port's
    bytes and continues token for token with one prefill position."""
    jm, tm = models
    src = _port(tm)
    tok, entry = _leg(src, prompt, rid=100)
    assert [tok] == greedy_ref[:1]
    jsrc = JEngine(jm, **_kw())
    _, jentry = _leg(jsrc, prompt, rid=100)
    for k in ("kv_ship_out_blocks", "kv_ship_out_bytes",
              "kv_swap_out_bytes"):
        assert src.stats[k] == jsrc.stats[k], k
    assert src.stats["kv_ship_out_bytes"] == entry["nbytes"]
    assert (entry["n_blocks"], list(entry["tokens"]), entry["chain"]) == \
        (jentry["n_blocks"], list(jentry["tokens"]), jentry["chain"])
    dst = JEngine(jm, **_kw())
    assert dst.import_kv(jkv.deserialize_entry(serialize_entry(entry),
                                               _jdefs(dst)))
    assert _resume(dst, prompt, 100, tok) == greedy_ref
    assert dst.stats["prefill_tokens"] == 1
    assert dst.stats["kv_ship_in_bytes"] == entry["nbytes"]
    assert not dst._swap_store
    src._check_pool_invariants()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_ship_token_exact(models, models_bf16, prompt, greedy_ref,
                               dtype):
    """Port to port through the wire: the stitched resume continues the
    port's own uninterrupted stream (in float32 also the reference's),
    restores the shipped bytes bit for bit, and in bf16 the reference's
    own bf16 export restores on the port bit for bit too (its bytes are
    raw 2-byte words on both sides)."""
    jm, tm = models if dtype == "float32" else models_bf16
    full = list(_port(tm).generate([prompt], max_new_tokens=10)[0]
                .token_ids)
    if dtype == "float32":
        assert full == greedy_ref
    src, dst = _port(tm), _port(tm)
    restores = _watch_restores(dst)
    tok, entry = _leg(src, prompt, rid=300)
    assert entry["kv"].dtype == getattr(torch, dtype)
    wire = serialize_entry(entry)
    assert InProcessTransport().ship(entry, dst)[0] == len(wire)
    assert _resume(dst, prompt, 300, tok) == full
    assert dst.stats["prefill_tokens"] == 1
    jentry = _leg(JEngine(jm, **_kw()), prompt, rid=301)[1]
    dst2 = _port(tm)
    restores2 = _watch_restores(dst2)
    assert dst2.import_kv(deserialize_entry(jkv.serialize_entry(jentry),
                                            tkv.pool_treedefs(dst2)))
    dst2.add_request(prompt, max_new_tokens=2, request_id=301,
                     committed_tokens=[tok])
    while dst2.has_unfinished():
        dst2.step()
    assert restores == restores2 == [True]
    for e in (src, dst, dst2):
        e._check_pool_invariants()


def test_ship_token_exact_greedy_and_sampled(models, prompt, greedy_ref,
                                             sampled_ref):
    """The migration acceptance (reference tests/test_kv_ship.py:191): a
    one-token prefill leg's export rides the wire into a fresh engine and
    the stitched resume continues token for token, greedy AND sampled
    (same rid, same ``sampling_seed``), with one stitch token of prefill
    a leg and the traffic on ``kv_ship_*``; a reference sampled leg
    continues on the port the same way."""
    jm, tm = models
    src, dst = _port(tm), _port(tm)
    tok, entry = _leg(src, prompt, rid=100)
    assert [tok] == greedy_ref[:1]
    assert dst.import_kv(deserialize_entry(serialize_entry(entry),
                                           tkv.pool_treedefs(dst)))
    assert _resume(dst, prompt, 100, tok) == greedy_ref
    assert dst.stats["prefill_tokens"] == 1
    tok_s, entry_s = _leg(src, prompt, rid=200, **SAMPLED)
    assert [tok_s] == sampled_ref(200)[:1]
    assert dst.import_kv(deserialize_entry(serialize_entry(entry_s),
                                           tkv.pool_treedefs(dst)))
    assert _resume(dst, prompt, 200, tok_s, **SAMPLED) == sampled_ref(200)
    assert dst.stats["prefill_tokens"] == 2
    assert dst.stats["kv_ship_in_bytes"] == \
        entry["nbytes"] + entry_s["nbytes"]
    assert dst.stats["kv_swap_in_bytes"] == 0
    jtok, jentry = _leg(JEngine(jm, **_kw()), prompt, rid=201, **SAMPLED)
    dst2 = _port(tm)
    assert dst2.import_kv(deserialize_entry(jkv.serialize_entry(jentry),
                                            tkv.pool_treedefs(dst2)))
    assert _resume(dst2, prompt, 201, jtok, **SAMPLED) == sampled_ref(201)
    for e in (src, dst, dst2):
        assert not e._swap_store
        e._check_pool_invariants()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantized_ship_bit_exact(models, prompt, dtype):
    """Quantized pools ship token-exactly in both directions: the
    (payload, scale) pairs cross the wire bit for bit, so the imported
    blocks dequantize to what the uninterrupted quantized engine reads
    (tests/test_kv_ship.py:234-262, held to the reference's quantized
    stream)."""
    jm, tm = models
    ref = list(JEngine(jm, **_kw(kv_cache_dtype=dtype)).generate(
        [prompt], max_new_tokens=10)[0].token_ids)
    src = _port(tm, kv_cache_dtype=dtype)
    tok, entry = _leg(src, prompt, rid=300)
    assert [tok] == ref[:1] and entry["scale"] is not None
    dst = _port(tm, kv_cache_dtype=dtype)
    restores = _watch_restores(dst)
    assert dst.import_kv(deserialize_entry(serialize_entry(entry),
                                           tkv.pool_treedefs(dst)))
    assert _resume(dst, prompt, 300, tok) == ref
    assert dst.stats["kv_ship_in_blocks"] >= 1
    assert dst.stats["prefill_tokens"] == 1
    # the reference's quantized export, restored on the port
    jtok, jentry = _leg(JEngine(jm, **_kw(kv_cache_dtype=dtype)), prompt,
                        rid=301)
    dst2 = _port(tm, kv_cache_dtype=dtype)
    restores2 = _watch_restores(dst2)
    assert dst2.import_kv(deserialize_entry(jkv.serialize_entry(jentry),
                                            tkv.pool_treedefs(dst2)))
    assert _resume(dst2, prompt, 301, jtok) == ref
    # and the port's bytes on the reference
    jdst = JEngine(jm, **_kw(kv_cache_dtype=dtype))
    assert jdst.import_kv(jkv.deserialize_entry(serialize_entry(entry),
                                                _jdefs(jdst)))
    assert _resume(jdst, prompt, 300, tok) == ref
    assert restores == restores2 == [True]
    dst._check_pool_invariants()


def test_import_rejects_geometry_mismatch(models, prompt):
    """import_kv refuses what the destination pool cannot hold (block
    size, quantization, layers, an unmaterialized entry, a dense or
    legacy engine) by returning False, never by raising or scattering;
    the reference's engine refuses the same entries."""
    jm, tm = models
    src = _port(tm)
    _, entry = _leg(src, prompt, rid=400)
    jentry = _leg(JEngine(jm, **_kw()), prompt, rid=400)[1]
    cases = [(dict(block_size=4), entry), (dict(kv_cache_dtype="int8"),
                                           entry),
             ({}, dict(entry, ready=False)), (dict(scheduler="legacy"),
                                              entry)]
    for over, e in cases:
        assert _port(tm, **over).import_kv(e) is False, over
        assert JEngine(jm, **_kw(**over)).import_kv(
            dict(jentry, ready=e["ready"])) is False, over
    dense = LLMEngine(tm, device="cpu", max_batch=2, max_seq_len=64,
                      chunk_size=16, scheduler="fused")
    assert dense.import_kv(entry) is False
    # another layer count: same block size and dtype, other geometry
    thin = LlamaForCausalLM(LlamaConfig(**dict(CFG, num_hidden_layers=1)),
                            device="cpu")
    assert LLMEngine(thin, device="cpu", **_kw()).import_kv(entry) is False
    eng = _port(tm)
    assert eng.import_kv(dict(entry, kv=entry["kv"][:, :, :2])) is False
    assert not eng._swap_store
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        eng.import_kv(dict(entry, adapter_id=1))


def test_export_is_bounded_and_popped_once(models, prompt):
    """The export store keeps the newest 2 * max_batch entries (the
    oldest drop when no router collects), export_kv() pops an entry once,
    and an engine reset drops the rest."""
    tm = models[1]
    eng = _port(tm)
    for rid in range(5):
        eng.add_request(prompt[:9], max_new_tokens=1, request_id=rid,
                        export_kv=True)
    while eng.has_unfinished():
        eng.step()
    assert list(eng._export_store) == [1, 2, 3, 4]
    assert eng.export_kv(0) is None
    assert eng.export_kv(4)["ready"] and eng.export_kv(4) is None
    assert eng.stats["kv_ship_out_blocks"] == 5 * 2
    eng.reset()
    assert not eng._export_store and eng.export_kv(3) is None


# ---------------------------------------------------------------------------
# the disaggregated router
# ---------------------------------------------------------------------------

def _servers(make, n=2, recorders=(), **kw):
    return [make(i, i in recorders, **kw) for i in range(n)]


def _port_server(tm):
    def make(i, rec, fault_injector=None, **over):
        return AsyncLLMServer(_port(tm, **over), replica=i,
                              flight_recorder=FlightRecorder() if rec
                              else None, fault_injector=fault_injector)
    return make


def _ref_server(jm):
    def make(i, rec, fault_injector=None, **over):
        from paddle_tpu.profiler.flight_recorder import \
            FlightRecorder as JRecorder
        return JServer(JEngine(jm, **_kw(**over)), replica=i,
                       flight_recorder=JRecorder() if rec else None,
                       fault_injector=fault_injector)
    return make


def _router_stats(router):
    return {k: router.stats[k] for k in ROUTER_STATS}


def _disagg_run(router_cls, servers, prompts, n=10, **router_kw):
    router = router_cls(servers, roles={"prefill": [0], "decode": [1]},
                        **router_kw)
    router.start()
    try:
        outs = []
        for p in prompts:
            h = router.submit(p, max_new_tokens=n)
            res = h.result(timeout=T)
            outs.append((list(res.token_ids), res.finish_reason, list(h)))
        snap = router.snapshot()
    finally:
        router.stop(timeout=120)
    return router, outs, snap


def test_disagg_router_end_to_end(models, prompt, greedy_ref):
    """1 prefill + 1 decode replica, the reference's router over
    reference servers beside the port's: prompts place on the prefill
    replica, the prefill-complete hook ships and resubmits on the decode
    replica, each caller's stream equals the reference's ``generate``
    (the iterator sees every token once), the decode replica prefills one
    stitch token a migration, and the counters, snapshot, transport,
    telemetry and StepRecord surfaces carry the migration as the
    reference's do. The sampled legs are
    ``test_disagg_router_sampled_legs``."""
    jm, tm = models
    p2 = np.random.default_rng(3).integers(1, V, size=(19,)).astype(np.int32)
    want = [list(o.token_ids) for o in JEngine(jm, **_kw()).generate(
        [prompt, p2], max_new_tokens=10)]
    assert want[0] == greedy_ref
    runs = {}
    for name, make in (("port", _port_server(tm)), ("ref", _ref_server(jm))):
        servers = _servers(make, recorders=(1,))
        cls = ReplicaRouter if name == "port" else JRouter
        runs[name] = (servers,) + _disagg_run(cls, servers, [prompt, p2])
    servers, router, outs, snap = runs["port"]
    jservers, jrouter, jouts, jsnap = runs["ref"]
    assert outs == jouts == [(w, "length", w) for w in want]
    assert _router_stats(router) == _router_stats(jrouter)
    assert router.stats["kv_shipped"] == 2
    assert router.stats["kv_ship_fallback"] == 0
    srv0, srv1 = servers
    for k in ("kv_ship_out_blocks", "kv_ship_out_bytes"):
        assert srv0.engine.stats[k] == jservers[0].engine.stats[k] > 0, k
    for k in ("kv_ship_in_blocks", "kv_ship_in_bytes", "prefill_tokens",
              "kv_swap_saved_tokens"):
        assert srv1.engine.stats[k] == jservers[1].engine.stats[k], k
    # zero re-prefill on the decode replica: stitches only
    assert srv1.engine.stats["prefill_tokens"] == 2
    assert set(snap) == set(jsnap)
    assert snap["roles"] == jsnap["roles"] == {"prefill": [0],
                                               "decode": [1]}
    assert snap["migration_latency"]["count"] == 2
    assert snap["migrations_recorded"] == jsnap["migrations_recorded"] == 2
    assert set(snap["migration_phases"]) == set(jsnap["migration_phases"])
    assert all(h["count"] == 2 for h in snap["migration_phases"].values())
    assert snap["transport"]["ship_count"] == 2
    assert snap["transport"]["ship_bytes"] == \
        jsnap["transport"]["ship_bytes"] > 0
    assert snap["transport"]["fail_count"] == 0
    assert snap["replicas"][0]["kv_tier"]["ship_out_bytes"] > 0
    assert snap["replicas"][1]["kv_tier"]["ship_in_bytes"] > 0
    assert snap["replicas"][1]["kv_tier"]["spill_bytes"] == 0
    c = srv1.telemetry.counters
    assert c["kv_ship_in_blocks"] >= 1 and c["kv_ship_in_bytes"] > 0
    assert srv1.telemetry.get_gauges()["kv_host_spill_bytes"] == 0
    text = srv1.telemetry.prometheus_text()
    assert "kv_ship_in_bytes" in text and "kv_host_spill_bytes" in text
    recs = srv1.flight_recorder.records()
    assert sum((r.kv_ship_in_bytes or 0) for r in recs) == \
        srv1.engine.stats["kv_ship_in_bytes"]
    d = recs[-1].to_dict()
    assert "kv_ship_in_bytes" in d and "kv_ship_out_bytes" in d
    # each migration's stitch landed on the decode replica's timeline
    tls = srv1.flight_recorder.timelines()
    kinds = [ev["kind"] for tl in tls.values() for ev in tl["events"]]
    assert kinds.count("kv_shipped_in") == kinds.count("kv_stitch") == 2
    for srv in servers:
        srv.engine._check_pool_invariants()


def test_disagg_router_sampled_legs(models, prompt, greedy_ref,
                                    sampled_ref):
    """The sampled legs of the reference's end-to-end case
    (tests/test_kv_ship.py:283): the second submit lands rid 1 on the
    prefill replica, the migration carries that rid to the decode
    replica, whose engine shares ``sampling_seed``, so the caller's
    stream (and its iterator) is the reference's uninterrupted sampled
    stream for rid 1, through the port's router and the reference's
    alike; both legs ship and the decode replica prefills stitches only."""
    jm, tm = models
    for make, cls in ((_port_server(tm), ReplicaRouter),
                      (_ref_server(jm), JRouter)):
        servers = _servers(make)
        router = cls(servers, roles={"prefill": [0], "decode": [1]})
        router.start()
        try:
            h = router.submit(prompt, max_new_tokens=10)
            assert list(h.result(timeout=T).token_ids) == greedy_ref
            hs = router.submit(prompt, max_new_tokens=10, **SAMPLED)
            assert list(hs.result(timeout=T).token_ids) == \
                sampled_ref(1), cls
            assert list(hs) == sampled_ref(1)
            assert router.stats["kv_shipped"] == 2
            assert router.stats["kv_ship_fallback"] == 0
            assert servers[1].engine.stats["prefill_tokens"] == 2
        finally:
            router.stop(timeout=120)


def test_roles_validate_and_place_as_the_reference(models):
    """The constructor's checks and the rid bases, beside the
    reference's: an empty or out-of-range role set raises ValueError, each
    replica's ids start at ``i * 2**26``, and a transport defaults to the
    in-process loopback only with roles or pulls."""
    jm, tm = models
    for bad in ({"prefill": [0]}, {"prefill": [0], "decode": []},
                {"prefill": [0], "decode": [2]}):
        for cls, make in ((ReplicaRouter, _port_server(tm)),
                          (JRouter, _ref_server(jm))):
            with pytest.raises(ValueError, match="roles"):
                cls(_servers(make), roles=bad)
    servers = _servers(_port_server(tm))
    router = ReplicaRouter(servers, roles={"decode": [1], "prefill": [0]})
    assert [s._next_id for s in servers] == [0, 1 << 26]
    assert isinstance(router.transport, InProcessTransport)
    assert router.roles == {"prefill": [0], "decode": [1]}
    assert ReplicaRouter(servers).transport is None
    assert isinstance(ReplicaRouter(servers, pull_on_miss=True).transport,
                      InProcessTransport)


def test_explain_tail_names_kv_ship_cause(models, prompt, greedy_ref):
    """A resident decode stream's token on the stitch step joins to the
    ``kv_ship`` tail cause (checked before interfering_prefill).
    Engine-driven, so the import lands mid-decode deterministically."""
    tm = models[1]
    src = _port(tm)
    tok, entry = _leg(src, prompt, rid=600)
    eng = _port(tm)
    eng.flight_recorder = FlightRecorder()
    eng.add_request(np.arange(1, 10, dtype=np.int32), max_new_tokens=30)
    for _ in range(8):
        eng.step()
    assert eng.import_kv(deserialize_entry(serialize_entry(entry),
                                           tkv.pool_treedefs(eng)))
    eng.add_request(prompt, max_new_tokens=9, request_id=600,
                    committed_tokens=[tok])
    while eng.has_unfinished():
        eng.step()
    assert list(eng.finished_outputs.pop(600).token_ids) == greedy_ref
    assert any((r.kv_ship_in_bytes or 0) > 0
               for r in eng.flight_recorder.records())
    tail = eng.flight_recorder.explain_tail(0.0)
    assert any(e["cause"] == "kv_ship" for e in tail)


class _BrokenTransport(KVTransport):
    """Every ship fails after the bytes were 'sent'."""

    def __init__(self):
        self.attempts = 0

    def ship(self, entry, dst_engine):
        self.attempts += 1
        raise TransportError("wire down")

    def ship_prefix_blocks(self, entries, dst_engine):
        return 0, 0


def test_transport_failure_falls_back_to_reprefill(models, prompt,
                                                   greedy_ref):
    """A dead transport books kv_ship_fallback, the decode replica
    re-prefills the full span, and the stream is the reference's; the
    counters equal the reference's router over the same dead wire."""
    jm, tm = models
    got = {}
    for name, make, cls in (("port", _port_server(tm), ReplicaRouter),
                            ("ref", _ref_server(jm), JRouter)):
        t = _BrokenTransport()
        servers = _servers(make)
        router, outs, _ = _disagg_run(cls, servers, [prompt], transport=t)
        assert outs[0][0] == greedy_ref and t.attempts == 1
        got[name] = (_router_stats(router),
                     {k: servers[1].engine.stats[k] for k in (
                         "prefill_tokens", "kv_ship_in_blocks")})
        servers[1].engine._check_pool_invariants()
    assert got["port"] == got["ref"]
    stats, dst = got["port"]
    assert stats["kv_ship_fallback"] == 1 and stats["kv_shipped"] == 0
    assert dst["prefill_tokens"] >= len(prompt)
    assert dst["kv_ship_in_blocks"] == 0


def test_pull_on_miss_fetches_peer_prefix(models, prompt, greedy_ref):
    """A pinned placement whose prefix probe misses pulls the covering
    blocks from the peer that holds them: they land in the target's spill
    store (drained ahead of admission) and its spill -> promote path
    serves them instead of recomputing; counters equal the reference's
    router in the same case."""
    jm, tm = models
    kw = dict(kv_pool_blocks=8, enable_prefix_cache=True,
              kv_host_spill_bytes=4 << 20)
    keys = ("kv_ship_in_blocks", "kv_promote_blocks", "prefix_hit_tokens",
            "prefill_tokens")
    got = {}
    for name, make, cls in (("port", _port_server(tm), ReplicaRouter),
                            ("ref", _ref_server(jm), JRouter)):
        servers = _servers(make, **kw)
        # warm replica 0's content store with the prompt's blocks
        servers[0].engine.generate([prompt], max_new_tokens=4)
        router = cls(servers, pull_on_miss=True)
        router.start()
        try:
            res = router.submit(prompt, max_new_tokens=10,
                                replica=1).result(timeout=T)
        finally:
            router.stop(timeout=120)
        assert list(res.token_ids) == greedy_ref
        got[name] = (_router_stats(router),
                     {k: servers[1].engine.stats[k] for k in keys},
                     servers[0].engine.stats["kv_ship_out_blocks"])
        for srv in servers:
            srv.engine._check_pool_invariants()
    assert got["port"] == got["ref"]
    stats, dst, out_blocks = got["port"]
    assert stats["pull_on_miss_blocks"] >= 1
    assert dst["kv_ship_in_blocks"] >= 1 and dst["kv_promote_blocks"] >= 1
    assert dst["prefix_hit_tokens"] >= 8 and out_blocks >= 1


def test_peer_export_stops_at_a_block_reused_mid_gather(models, prompt):
    """export_prefix_blocks re-checks hash -> block after its gather: a
    block evicted and handed to another owner meanwhile ends the span,
    and its content never ships under the old hash."""
    tm = models[1]
    eng = _port(tm, enable_prefix_cache=True)
    eng.generate([prompt], max_new_tokens=2)
    hashes = eng.prefix_chain_hashes(prompt)
    assert len(eng.export_prefix_blocks(hashes)) == len(hashes) == 3
    orig = eng._peer_gather

    def gather_then_evict(phys):
        staged = orig(phys)
        if phys == eng._store[hashes[1]]:
            eng._unregister(phys)        # evicted while the copy ran
        return staged

    eng._peer_gather = gather_then_evict
    out = eng.export_prefix_blocks(hashes)
    assert [e["hash"] for e in out] == hashes[:1]


def test_prefill_replica_killed_mid_ship(models, prompt, greedy_ref):
    """Kill the prefill replica during the leg: the staged KV dies with
    it (kv_ship_abandoned), and the request re-prefills on the survivor
    token for token, which as the only replica left also takes the decode
    leg; the reference's router books the same."""
    jm, tm = models
    got = {}
    for name, make, cls in (("port", _port_server(tm), ReplicaRouter),
                            ("ref", _ref_server(jm), JRouter)):
        fi0 = FaultInjector() if name == "port" else None
        if fi0 is None:
            from paddle_tpu.serving import FaultInjector as JFault
            fi0 = JFault()
        servers = [make(0, False, fault_injector=fi0), make(1, False)]
        router = cls(servers, roles={"prefill": [0], "decode": [1]})
        router.start()
        try:
            fi0.crash_at_step(1)
            res = router.submit(prompt, max_new_tokens=10).result(timeout=T)
        finally:
            router.stop(timeout=120)
        assert list(res.token_ids) == greedy_ref
        assert res.finish_reason == "length"
        got[name] = _router_stats(router)
        servers[1].engine._check_pool_invariants()
    assert got["port"] == got["ref"]
    assert got["port"]["kv_ship_abandoned"] == 1
    assert got["port"]["resubmitted"] >= 2


# ---------------------------------------------------------------------------
# tracing (tests/test_tracing.py's ship case)
# ---------------------------------------------------------------------------

def test_fleet_tail_causes_lockstep_with_migration_phases():
    """FLEET_TAIL_CAUSES is failover_resubmit plus one kv_ship:<phase> per
    MIGRATION_PHASES entry, both the reference's tuples."""
    assert tkv.MIGRATION_PHASES == jkv.MIGRATION_PHASES
    assert FLEET_TAIL_CAUSES == J_FLEET_CAUSES
    assert set(FLEET_TAIL_CAUSES) == {"failover_resubmit"} | \
        {f"kv_ship:{p}" for p in tkv.MIGRATION_PHASES}


def _flow_events(events):
    return ([e for e in events if e.get("ph") == "s"],
            [e for e in events if e.get("ph") == "f"])


def test_ship_renders_one_connected_chain(models, prompt, greedy_ref,
                                          tmp_path):
    """The migrated request's trace is one causal chain: the same
    trace_id on both replicas, the hop bumped once via kv_ship, spans on
    two pids joined by a matched s/f flow pair, the router lane carrying
    the kv_ship:<phase> sub-spans (stitch on the decode lane), and
    explain_tail attributing from the registered causes. The fleet
    postmortem bundle waits for A11."""
    tm = models[1]
    servers = _servers(_port_server(tm), recorders=(0, 1))
    router = ReplicaRouter(servers, roles={"prefill": [0], "decode": [1]})
    router.start()
    try:
        res = router.submit(prompt, max_new_tokens=10).result(timeout=T)
        assert list(res.token_ids) == greedy_ref
        tc = res.trace_ctx
        assert tc is not None and tc.hop == 1 and tc.via == "kv_ship"
        assert tc.parent == f"{tc.trace_id}/0"
        ctx = [[t["trace_ctx"] for t in srv.flight_recorder.timelines()
                .values() if t.get("trace_ctx")] for srv in servers]
        assert all(ctx)
        assert {c["trace_id"] for cs in ctx for c in cs} == {tc.trace_id}
        assert [{c["hop"] for c in cs} for cs in ctx] == [{0}, {1}]

        path = str(tmp_path / "merged.json")
        router.export_merged_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        starts, finishes = _flow_events(events)
        assert starts and len(finishes) == len(starts)
        for s in starts:
            assert s["name"] == FLOW_EVENT_NAME and s["cat"] == "trace"
            match = [f for f in finishes
                     if (f["id"], f["name"], f["cat"]) ==
                     (s["id"], s["name"], s["cat"])]
            assert len(match) == 1
            f = match[0]
            assert f["bp"] == "e" and f["ts"] >= s["ts"]
            assert (f["pid"], f["tid"]) != (s["pid"], s["tid"])
        req_pids = {e["pid"] for e in events
                    if e.get("ph") == "X" and e.get("cat") == "request"
                    and (e.get("args") or {}).get("trace_id")
                    == tc.trace_id}
        assert len(req_pids) == 2
        assert req_pids == {s["pid"] for s in starts} | \
            {f["pid"] for f in finishes}
        mig = [e for e in events if e.get("cat") == "migration"]
        assert {e["name"] for e in mig} == \
            {f"kv_ship:{p}" for p in tkv.MIGRATION_PHASES if p != "stitch"}
        assert {(e.get("args") or {}).get("trace_id") for e in mig} == \
            {tc.trace_id}
        lanes = [e for e in events if e.get("ph") == "M"
                 and e["name"] == "process_name"
                 and e["args"]["name"] == "router:migrations"]
        assert len(lanes) == 1 and lanes[0]["pid"] == 2
        # the sub-spans tile the migration window in phase order
        spans = sorted(mig, key=lambda e: e["ts"])
        assert [e["name"] for e in spans] == [
            f"kv_ship:{p}" for p in ("serialize", "transport", "import",
                                     "place")]
        for a, b in zip(spans, spans[1:]):
            assert b["ts"] == pytest.approx(a["ts"] + a["dur"])

        tail = router.explain_tail(0.0)
        assert tail
        assert {e["cause"] for e in tail} <= \
            set(TAIL_CAUSES) | set(FLEET_TAIL_CAUSES)
        assert any(e.get("trace_id") == tc.trace_id for e in tail)
        for e in tail:
            if e["cause"].startswith("kv_ship:"):
                assert set(e["migration"]["phases"]) <= \
                    set(tkv.MIGRATION_PHASES)
                assert e["migration"]["src"] == 0 and \
                    e["migration"]["dst"] == 1
        assert router.snapshot()["migration_phases"]["stitch"]["count"] == 1
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            router.dump_debug_bundle(str(tmp_path / "post"))
    finally:
        router.stop(timeout=120)
