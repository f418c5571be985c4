"""Weight-only int8/int4 serving in paddle_tpu_torch (``nn/quant``, kernel
B8's plain version) held against the JAX package on the CPU, on inputs made
by numpy from a seed.

- ``weight_quantize`` packed bytes and scales bit-identical to the
  reference's (float32 and bf16 weights, odd ``n_in``, an all-zero
  column); ``_nibbles`` on all 256 bytes and ``weight_dequantize``
  bit-identical.
- ``int4_matmul_plain`` (and the wrapper's CPU route) against the
  reference's Pallas ``int4_matmul`` in interpret mode: float32 within
  1e-5 of the largest magnitude (two float32 sums in other orders); bf16
  within one bf16 step of it (each side rounds its float32 result once).
- ``weight_only_linear``'s split-nibble path against the reference's:
  float32 within 1e-5 of the largest magnitude; bf16 within two bf16 steps
  (each of the two products and their sum rounds to bf16).
- The routing rule at Llama-2-7B widths; B8's autograd route against the
  reference's gradient.
- The swap: counts, names, bridged bytes; the tiny Llama (2 layers, hidden
  64) with int8 and int4 weights token-exact against the reference's
  ``LLMEngine`` under both schedulers, and through ``AsyncLLMServer``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     LlamaForCausalLM as JLlama)
from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.kernels.int4_matmul import int4_matmul as j_int4_matmul

from paddle_tpu_torch.bridge import load_reference_params
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.ops.kernels.int4_matmul import (int4_matmul,
                                                      int4_matmul_plain)
from paddle_tpu_torch.serving import AsyncLLMServer

torch.set_num_threads(1)
ALGOS = ("weight_only_int8", "weight_only_int4")
KW = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
          max_position_embeddings=128)


def _np(t):
    return np.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                      else t.numpy())


def _bf16_step(ref):
    """One bf16 rounding step (8 significant bits) at the magnitude of
    ``ref``'s largest element."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _weights(shape, dtype, seed=0, zero_col=None):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    jw = paddle.to_tensor(w)
    tw = torch.from_numpy(w)
    if dtype == "bfloat16":
        jw, tw = jw.astype("bfloat16"), tw.to(torch.bfloat16)
    return jw, tw


def _quant(shape, algo, seed=0):
    """One quantized weight in both packages (the reference's bytes)."""
    jw, _ = _weights(shape, "float32", seed)
    jq, js = JQ.weight_quantize(jw, algo=algo)
    return (jq, js), (torch.from_numpy(np.asarray(jq.numpy())),
                      torch.from_numpy(np.asarray(js.numpy())))


# ---------------------------------------------------------------------------
# quantize / unpack / dequantize, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 48), (33, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_quantize_bit_identical(algo, dtype, shape):
    jw, tw = _weights(shape, dtype, seed=1, zero_col=5)
    jq, js = JQ.weight_quantize(jw, algo=algo)
    tq, ts = TQ.weight_quantize(tw, algo=algo)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.numpy()))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js.numpy()).view(np.uint32))


def test_nibbles_all_bytes():
    p = np.arange(-128, 128, dtype=np.int8)
    jlo, jhi = JQ._nibbles(jnp.asarray(p))
    tlo, thi = TQ._nibbles(torch.from_numpy(p))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    assert tlo.dtype == thi.dtype == torch.int8


@pytest.mark.parametrize("algo", ALGOS)
def test_weight_dequantize_bit_identical(algo):
    (jq, js), (tq, ts) = _quant((33, 40), algo, seed=2)
    kw = dict(in_features=33) if algo == "weight_only_int4" else {}
    want = np.asarray(JQ.weight_dequantize(jq, js, algo=algo, **kw).numpy())
    got = TQ.weight_dequantize(tq, ts, algo=algo, **kw).numpy()
    assert got.shape == (33, 40)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# B8's plain version against the reference's Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mm_case():
    (jq, js), (tq, ts) = _quant((2048, 512), "weight_only_int4", seed=3)
    x = np.random.default_rng(4).standard_normal((16, 2048)) \
        .astype(np.float32)
    return np.asarray(jq.numpy()), np.asarray(js.numpy()), tq, ts, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 5, 8, 16])
def test_int4_matmul_plain_matches_reference_kernel(mm_case, rows, dtype):
    jq, js, tq, ts, x = mm_case
    jx = jnp.asarray(x[:rows]).astype(dtype)
    tx = torch.from_numpy(x[:rows]).to(getattr(torch, dtype))
    want = np.asarray(j_int4_matmul(jx, jnp.asarray(jq), jnp.asarray(js))
                      .astype(jnp.float32))
    for got in (int4_matmul_plain(tx, tq, ts), int4_matmul(tx, tq, ts)):
        assert got.dtype == tx.dtype and got.shape == (rows, 512)
        err = np.abs(_np(got) - want).max()
        tol = (1e-5 * np.abs(want).max() if dtype == "float32"
               else _bf16_step(want))
        assert err <= tol, (rows, dtype, err, tol)


def test_int4_matmul_contract_raises(mm_case):
    _, _, tq, ts, x = mm_case
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="at most 128 rows"):
        int4_matmul(torch.zeros((129, 2048)), tq, ts)
    with pytest.raises(ValueError, match="n_in % 1024"):
        int4_matmul(tx[:, :1000], tq[:500], ts)
    with pytest.raises(ValueError, match="n_in == 2"):
        int4_matmul(tx[:, :1024], tq, ts)


# ---------------------------------------------------------------------------
# weight_only_linear's split path, routing, gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_in", [1000, 37, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_only_linear_matches_reference(algo, dtype, n_in):
    (jq, js), (tq, ts) = _quant((n_in, 96), algo, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, n_in)).astype(np.float32)
    b = rng.standard_normal((96,)).astype(np.float32)
    wd = algo[-4:]
    jx, jb = paddle.to_tensor(x).astype(dtype), paddle.to_tensor(b)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JQ.weight_only_linear(jx, jq, jb, js, wd).astype("float32")
    got = TQ.weight_only_linear(tx, tq, torch.from_numpy(b), ts, wd)
    want = np.asarray(want.numpy())
    assert got.shape == (2, 3, 96)
    err = np.abs(_np(got) - want).max()
    tol = (1e-5 * np.abs(want).max() if dtype == "float32"
           else 2 * _bf16_step(want))
    assert err <= tol, (algo, dtype, n_in, err, tol)


def test_routing_rule_at_llama2_7b_widths():
    """q/k/v/o (4096 -> 4096) take B8 for decode rows; gate/up (ff 11008
    out), down (11008 in) and lm_head (vocab 32000) never do, nor do more
    than 128 rows or a CPU tensor; the bench's ff 11264 tiles."""
    h, ff, vocab = 4096, 11008, 32000
    route = TQ.int4_routes_to_kernel
    assert route(8, h, h, "cuda") and route(128, h, h, "cuda")
    assert not route(129, h, h, "cuda")
    assert not route(2048, h, h, "cuda")
    for n_in, n_out in ((h, ff), (ff, h), (h, vocab)):
        assert not route(8, n_in, n_out, "cuda"), (n_in, n_out)
    assert route(8, h, 11264, "cuda") and route(8, 11264, h, "cuda")
    assert not route(8, h, h, "cpu")


def test_flag_turns_the_kernel_route_off():
    prev = get_flags("FLAGS_use_pallas_int4")
    assert prev == {"FLAGS_use_pallas_int4": True}
    try:
        set_flags({"FLAGS_use_pallas_int4": False})
        assert not TQ.int4_routes_to_kernel(8, 4096, 4096, "cuda")
    finally:
        set_flags(prev)
    assert TQ.int4_routes_to_kernel(8, 4096, 4096, "cuda")


def test_kernel_route_backward_matches_reference_grad(mm_case):
    """The autograd route's x-gradient (the reference's ``_mm_bwd``)
    against the reference's gradient through its split path, float32,
    within 1e-5 of the largest magnitude."""
    jq, js, tq, ts, x = mm_case
    g = np.random.default_rng(7).standard_normal((5, 512)).astype(np.float32)
    jx = paddle.to_tensor(x[:5], stop_gradient=False)
    y = JQ.weight_only_linear(jx, paddle.to_tensor(jq), None,
                              paddle.to_tensor(js), "int4")
    (y * paddle.to_tensor(g)).sum().backward()
    want = np.asarray(jx.grad.numpy())
    tx = torch.from_numpy(x[:5]).requires_grad_(True)
    out = TQ._Int4Matmul.apply(tx, tq, ts)
    (out * torch.from_numpy(g)).sum().backward()
    fwd = np.asarray(y.numpy())
    assert np.abs(out.detach().numpy() - fwd).max() <= \
        1e-5 * np.abs(fwd).max()
    err = np.abs(tx.grad.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# the swap, the bridge, the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def float_models():
    paddle.seed(11)
    jm = JLlama(JConfig(**KW))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**KW), device="cpu")
    load_reference_params(tm, {n: np.asarray(p.numpy())
                               for n, p in jm.named_parameters()})
    return jm, tm


def _named(m):
    return {n: np.asarray(p.numpy()) for n, p in m.named_parameters()}


@pytest.fixture(scope="module")
def quant_models(float_models):
    """Per weight dtype: the reference model quantized in place, and the
    port's quantized from the same float weights."""
    import copy
    jm, tm = float_models
    out = {}
    for wd in ("int8", "int4"):
        jq = copy.deepcopy(jm)
        _, jn = JQ.quantize_linears_for_inference(jq, weight_dtype=wd)
        tq = copy.deepcopy(tm)
        _, tn = TQ.quantize_linears_for_inference(tq, weight_dtype=wd)
        out[wd] = (jq, tq, jn, tn)
    return out


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_swap_counts_names_and_bytes(quant_models, wd):
    jq, tq, jn, tn = quant_models[wd]
    L = KW["num_hidden_layers"]
    assert jn == tn == 7 * L + 1
    assert isinstance(tq.lm_head, TQ.WeightOnlyLinear)
    jp, tp = _named(jq), {n: p.detach() for n, p in tq.named_parameters()}
    assert sorted(jp) == sorted(tp)
    for name, arr in jp.items():
        got = tp[name]
        if name.endswith("weight_scale"):
            assert got.dtype == torch.float32 and not got.requires_grad
        if name.endswith("quant_weight"):
            assert got.dtype == torch.int8 and not got.requires_grad
        np.testing.assert_array_equal(_np(got), arr.astype(_np(got).dtype),
                                      err_msg=name)


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_bridge_carries_quantized_reference_bit_for_bit(quant_models, wd):
    jq = quant_models[wd][0]
    tm = LlamaForCausalLM(LlamaConfig(**KW), device="cpu", seed=3)
    TQ.quantize_linears_for_inference(tm, weight_dtype=wd)
    load_reference_params(tm, _named(jq))
    for name, p in tm.named_parameters():
        ref = _named(jq)[name]
        if p.dtype in (torch.int8, torch.float32):
            np.testing.assert_array_equal(
                p.detach().numpy().view(np.uint8), ref.view(np.uint8),
                err_msg=name)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 96, size=(n,)).astype(np.int32)
            for n in (13, 9)]


def _ekw(**over):
    kw = dict(max_batch=2, max_seq_len=64, chunk_size=16,
              cache_impl="paged", block_size=8, scheduler="fused")
    kw.update(over)
    return kw


def _toks(eng, prompts, n=12):
    return [o.token_ids for o in eng.generate(prompts, max_new_tokens=n)]


@pytest.mark.parametrize("scheduler", ["fused", "legacy"])
@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_engine_token_exact_against_reference(quant_models, prompts, wd,
                                              scheduler):
    jq, tq, _, _ = quant_models[wd]
    want = _toks(JEngine(jq, **_ekw(scheduler=scheduler)), prompts)
    got = _toks(LLMEngine(tq, device="cpu", **_ekw(scheduler=scheduler)),
                prompts)
    assert got == want


def test_int4_server_streams_match_the_engine(quant_models, prompts):
    tq = quant_models["int4"][1]
    ref = _toks(LLMEngine(tq, device="cpu", **_ekw()), prompts, 6)
    with AsyncLLMServer(LLMEngine(tq, device="cpu", **_ekw())) as server:
        handles = [server.submit(p, max_new_tokens=6) for p in prompts]
        streams = [list(h.tokens(timeout=60)) for h in handles]
    assert streams == ref
