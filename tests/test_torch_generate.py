"""paddle_tpu_torch LlamaForCausalLM.generate, greedy and sampled, held
TOKEN-EXACT against the reference's compiled generate on bridged weights:
the static and the paged cache, GQA with a block size that divides
neither the prompt nor the total, batch 1 and 3, eos with rows finishing
at different steps (the same n as the reference's while_loop), the
rope-table cap, the argument edges, and int8/int4 weight-only models
quantized in both packages. Sampled cases (temperature, top-k, top-p)
set both packages' ``default_generator`` to one state first; every
decoding call advances it once, greedy or not, in both. The windowed
decode reads the device once a window with an eos id and never without
one, sampled too. Ports tests/test_jit_amp_io.py:744,801,
tests/test_paged_attention.py:336 and tests/test_quantization.py:242,283.
CPU, float32, 2 layers, hidden 64, vocab 96."""
import copy
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random as jrandom
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.nn import quant as JQ

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import quant as TQ

torch.set_num_threads(1)

MAXPOS = 32


def _models(kvh, seed):
    kw = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=kvh, max_position_embeddings=MAXPOS)
    paddle.seed(seed)
    jm = JLlama(JConfig(**kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def mha():
    return _models(4, 7)


@pytest.fixture(scope="module")
def gqa():
    return _models(2, 11)


def _ids(seed, B, P):
    return np.random.default_rng(seed).integers(1, 96, size=(B, P)) \
        .astype(np.int32)


def _ref(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


def _seed_both(state):
    """Both packages' global generators at one (seed, counter) state."""
    jrandom.default_generator.set_state(state)
    trandom.default_generator.set_state(state)


def _port(tm, ids, **kw):
    out = tm.generate(torch.from_numpy(ids), **kw)
    assert out.dtype == torch.int64
    return out.numpy()


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("cache_impl,block_size", [("static", 64),
                                                   ("paged", 4),
                                                   ("paged", 8)])
def test_token_exact_against_reference(mha, B, cache_impl, block_size):
    jm, tm = mha
    ids = _ids(1, B, 9)
    kw = dict(max_new_tokens=8, cache_impl=cache_impl, block_size=block_size)
    want = _ref(jm, ids, **kw)
    got = _port(tm, ids, **kw)
    assert want.dtype == np.int64 and got.shape == want.shape == (B, 8)
    np.testing.assert_array_equal(got, want)


def test_static_equals_a_full_forward_argmax(mha):
    """tests/test_jit_amp_io.py:744: greedy decode through the cache is
    the argmax of a no-cache forward over the grown prefix."""
    _, tm = mha
    ids = _ids(2, 2, 8)
    out = _port(tm, ids, max_new_tokens=6)
    cur = torch.from_numpy(ids).long()
    with torch.no_grad():
        for t in range(6):
            nxt = tm(cur)[:, -1].float().argmax(-1)
            np.testing.assert_array_equal(out[:, t], nxt.numpy())
            cur = torch.cat([cur, nxt[:, None]], 1)


@pytest.mark.parametrize("block_size", [4, 5])
def test_gqa_paged_against_reference_and_static(gqa, block_size):
    """tests/test_paged_attention.py:336: GQA through the paged cache.
    9 + 6 = 15 positions: block 4 divides neither, block 5 divides the
    total only."""
    jm, tm = gqa
    ids = _ids(5, 3, 9)
    kw = dict(max_new_tokens=6, cache_impl="paged", block_size=block_size)
    want = _ref(jm, ids, **kw)
    got = _port(tm, ids, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port(tm, ids, max_new_tokens=6))


def _eos_cases(jm, ids, limit):
    """From the unconstrained reference run: a token every row emits, at
    different first steps (all rows finish before ``limit``), and a token
    only some rows emit (n stays ``limit``)."""
    free = _ref(jm, ids, max_new_tokens=limit)
    first = [{int(t): int(np.argmax(row == t)) for t in set(row.tolist())}
             for row in free]
    common = [t for t in first[0] if all(t in f for f in first)]
    every = [t for t in common
             if len({f[t] for f in first}) > 1
             and max(f[t] for f in first) < limit - 1]
    some = [t for t in first[0] if not all(t in f for f in first)]
    return every, some


@pytest.mark.parametrize("cache_impl", ["static", "paged"])
@pytest.mark.parametrize("window", [16, 3])
def test_eos_same_n_as_reference(mha, monkeypatch, cache_impl, window):
    """Rows finish at different steps; with every row finished before the
    limit the port returns the reference's n (windows of 3 cut across the
    finishing step, 16 holds it inside the first window)."""
    monkeypatch.setattr(tllama, "GEN_WINDOW", window)
    jm, tm = mha
    limit = 14
    for seed in range(20):
        ids = _ids(100 + seed, 3, 6)
        every, some = _eos_cases(jm, ids, limit)
        if every and some:
            break
    assert every and some, "no prompt seed gives both eos cases"
    for eos in (every[0], some[0]):
        kw = dict(max_new_tokens=limit, eos_token_id=eos,
                  cache_impl=cache_impl, block_size=4)
        want = _ref(jm, ids, **kw)
        got = _port(tm, ids, **kw)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if eos == every[0]:
            assert want.shape[1] < limit
            assert (want[:, -1] == eos).all()
        else:
            assert want.shape[1] == limit


def test_rope_cap_warns_and_matches(mha):
    jm, tm = mha
    ids = _ids(6, 2, 9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = _ref(jm, ids, max_new_tokens=100)
    with pytest.warns(RuntimeWarning, match="capping max_new_tokens"):
        got = _port(tm, ids, max_new_tokens=100)
    assert got.shape == (2, MAXPOS - 9)
    np.testing.assert_array_equal(got, want)


def test_argument_edges(mha):
    _, tm = mha
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(torch.from_numpy(_ids(7, 1, MAXPOS)))
    with pytest.raises(ValueError, match="cache_impl"):
        tm.generate(torch.from_numpy(_ids(7, 1, 4)), cache_impl="dense")
    empty = tm.generate(torch.from_numpy(_ids(7, 2, 4)), max_new_tokens=0)
    assert empty.shape == (2, 0) and empty.dtype == torch.int64
    # sampling is ported: temperature > 0 is the reference's draw
    jm, _ = mha
    ids = _ids(7, 1, 4)
    _seed_both((3, 0))
    np.testing.assert_array_equal(
        _port(tm, ids, max_new_tokens=5, temperature=0.8),
        _ref(jm, ids, max_new_tokens=5, temperature=0.8))
    # numpy ids, and the model is back in training mode after
    tm.train()
    out = tm.generate(_ids(7, 1, 4), max_new_tokens=2)
    assert tm.training and out.shape == (1, 2)
    tm.eval()


@pytest.fixture(scope="module")
def quant_models(mha):
    jm, tm = mha
    out = {}
    for wd in ("int8", "int4"):
        jq = copy.deepcopy(jm)
        JQ.quantize_linears_for_inference(jq, weight_dtype=wd)
        tq = copy.deepcopy(tm)
        TQ.quantize_linears_for_inference(tq, weight_dtype=wd)
        out[wd] = (jq, tq)
    return out


@pytest.mark.parametrize("cache_impl", ["static", "paged"])
@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_weight_only_models_against_reference(quant_models, wd, cache_impl):
    """tests/test_quantization.py:242,283: weight-only int8/int4 models
    generate the reference's tokens, static and paged."""
    jq, tq = quant_models[wd]
    ids = _ids(8, 2, 8)
    kw = dict(max_new_tokens=6, cache_impl=cache_impl, block_size=4)
    np.testing.assert_array_equal(_port(tq, ids, **kw), _ref(jq, ids, **kw))


def test_programs_cached_by_key(mha):
    _, tm = mha
    a = tm._gen_programs(2, 8, 5, 13, 0.0, 0, 1.0, None, "paged", 4)
    assert tm._gen_programs(2, 8, 5, 13, 0.0, 0, 1.0, None, "paged", 4) is a
    assert tm._gen_programs(2, 8, 5, 13, 0.0, 0, 1.0, 3, "paged", 4) is not a


READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__",
         "__index__")


@pytest.mark.parametrize("cache_impl", ["static", "paged"])
def test_decode_reads_the_device_once_a_window(mha, monkeypatch,
                                               cache_impl):
    """Every tensor read the host could block on is counted through the
    decode: none without an eos id, one per window with one."""
    _, tm = mha
    monkeypatch.setattr(tllama, "GEN_WINDOW", 4)
    ids = torch.from_numpy(_ids(9, 2, 6))
    limit = 18
    counts = {"n": 0}

    def count(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            counts["n"] += 1
            return orig(self, *a, **k)
        return wrapped

    free = _port(tm, ids.numpy(), max_new_tokens=limit,
                 cache_impl=cache_impl, block_size=4)
    # an eos id no row emits: every window is read and none ends the loop
    unused = min(set(range(96)) - set(free.ravel().tolist()))
    for eos, want in ((None, 0), (unused, -(-limit // 4))):
        prefill, decode = tm._gen_programs(2, 6, limit, 6 + limit, 0.0, 0,
                                           1.0, eos, cache_impl, 4)
        logits, kb, vb = prefill(ids)
        with monkeypatch.context() as m:
            for name in READS:
                m.setattr(torch.Tensor, name, count(name))
            counts["n"] = 0
            buf, n = decode(kb, vb, logits)
            reads = counts["n"]
        assert n == limit and reads == want, (eos, n, reads)
        np.testing.assert_array_equal(buf.numpy(), free)


#: (temperature, top_k, top_p): the nucleus alone, top-k alone, both, and
#: a hot unfiltered draw
SAMPLINGS = [(0.8, 0, 0.9), (1.3, 8, 1.0), (0.5, 8, 0.9), (1.0, 0, 1.0)]


@pytest.mark.parametrize("cache_impl,block_size", [("static", 64),
                                                   ("paged", 4)])
@pytest.mark.parametrize("temperature,top_k,top_p", SAMPLINGS)
def test_sampled_token_exact_against_reference(mha, cache_impl, block_size,
                                               temperature, top_k, top_p):
    """Sampled generate at batch 3: one ``fold_in(PRNGKey(seed),
    counter)`` key, split once a step, one categorical draw over the whole
    batch from the filtered logits, token for token the reference's; both
    generators advance by one."""
    jm, tm = mha
    ids = _ids(3, 3, 7)
    kw = dict(max_new_tokens=12, temperature=temperature, top_k=top_k,
              top_p=top_p, cache_impl=cache_impl, block_size=block_size)
    _seed_both((5, 2))
    want = _ref(jm, ids, **kw)
    got = _port(tm, ids, **kw)
    np.testing.assert_array_equal(got, want)
    assert trandom.default_generator.get_state() == \
        jrandom.default_generator.get_state() == (5, 3)


def test_sampled_eos_same_n_as_reference(mha):
    """Two sampled rows finish at an eos at different steps: the same tokens
    and the same n as the reference's while_loop."""
    jm, tm = mha
    ids = _ids(4, 2, 5)
    kw = dict(max_new_tokens=20, temperature=1.0, cache_impl="paged",
              block_size=4)
    _seed_both((6, 0))
    free = _ref(jm, ids, **kw)
    # a token every row emits, the one whose last first-occurrence comes
    # soonest, so every row finishes and the loop ends early
    common = set.intersection(*(set(r.tolist()) for r in free))
    eos = min(common, key=lambda t: max(list(r).index(t) for r in free))
    _seed_both((6, 0))
    want = _ref(jm, ids, eos_token_id=eos, **kw)
    _seed_both((6, 0))
    np.testing.assert_array_equal(_port(tm, ids, eos_token_id=eos, **kw),
                                  want)
    assert want.shape[1] < 20


def test_generate_advances_default_generator(mha):
    """Every decoding ``generate`` call draws once from
    ``default_generator``, greedy or sampled, as the reference's does
    (``llama.py:824``); a call with nothing to decode draws nothing. So
    an engine made after a ``generate`` derives the reference's base
    key."""
    jm, tm = mha
    ids = _ids(2, 1, 4)
    _seed_both((11, 7))
    for kw in (dict(), dict(temperature=0.7), dict(max_new_tokens=0)):
        _port(tm, ids, **{"max_new_tokens": 3, **kw})
        _ref(jm, ids, **{"max_new_tokens": 3, **kw})
        assert trandom.default_generator.get_state() == \
            jrandom.default_generator.get_state()
    assert trandom.default_generator.get_state() == (11, 9)
    assert trandom.seed(4) is trandom.default_generator
    assert trandom.default_generator.get_state() == (4, 0)
    assert trandom.default_generator.initial_seed() == 4


@pytest.mark.parametrize("cache_impl", ["static", "paged"])
def test_sampled_decode_reads_nothing_without_eos(mha, monkeypatch,
                                                  cache_impl):
    """The sampled decode (the key splits and the draws) reads nothing
    back to the host: no host-blocking tensor read through a whole
    decode without an eos id."""
    _, tm = mha
    ids = torch.from_numpy(_ids(9, 2, 6))
    prefill, decode = tm._gen_programs(2, 6, 10, 16, 0.8, 8, 0.9, None,
                                       cache_impl, 4)
    logits, kb, vb = prefill(ids)
    key = prng.fold_in(prng.PRNGKey(1), 1)
    temp, top_p = torch.tensor(0.8), torch.tensor(0.9)
    reads = {"n": 0}
    with monkeypatch.context() as m:
        for name in READS:
            orig = getattr(torch.Tensor, name)

            def wrapped(self, *a, _orig=orig, **k):
                reads["n"] += 1
                return _orig(self, *a, **k)
            m.setattr(torch.Tensor, name, wrapped)
        buf, n = decode(kb, vb, logits, key, temp, top_p)
    assert n == 10 and reads["n"] == 0
    assert buf.shape == (2, 10) and int(buf.max()) < 96
