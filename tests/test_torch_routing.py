"""The attention routing flags of paddle_tpu_torch against the reference's,
on the CPU.

``use_pallas_flash_attention`` and ``use_paged_attention`` carry the
reference's names and defaults and go through ``set_flags``/``get_flags``
and the ``FLAGS_*`` environment form. With either flag off the port takes
the plain math, as the reference takes its XLA path: the scaled dot-product
attention through ``_sdpa_reference``, paged attention through the plain
paged versions (the reference's dense-gather fallback). The rules that keep
a CUDA call off a kernel that would refuse it (``kernel_takes``) are
checked on their inputs. Inputs are float32 from numpy with fixed seeds;
tolerance atol 1e-5 (both sides float32, different summation orders), the
pools bit for bit."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops.kernels import flash_attention as tflash
from paddle_tpu_torch.ops.kernels import paged_attention as tpaged

torch.set_num_threads(1)
ATOL = 1e-5
FLAGS = ("use_pallas_flash_attention", "use_paged_attention")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def flag_off():
    """Turns a routing flag off for one test and restores it after."""
    saved = get_flags(list(FLAGS))

    def off(name):
        set_flags({name: False})
    yield off
    set_flags(saved)


@pytest.mark.parametrize("name", FLAGS)
def test_routing_flags_round_trip(name):
    """Defined with the reference's default (True); set and read back by
    name and with the ``FLAGS_`` prefix."""
    want = jflags.get_flags(name)[name]
    assert want is True and get_flags(name) == {name: want}
    try:
        set_flags({f"FLAGS_{name}": False})
        assert get_flags([name]) == {name: False}
        assert get_flags(f"FLAGS_{name}") == {f"FLAGS_{name}": False}
        set_flags({name: 1})
        assert get_flags(name)[name] is True
    finally:
        set_flags({name: want})


@pytest.mark.parametrize("value,want", [("0", False), ("1", True)])
@pytest.mark.parametrize("name", FLAGS)
def test_routing_flags_from_environment(name, value, want):
    """``FLAGS_<name>`` in the environment sets the flag at its first read,
    in a fresh process."""
    env = dict(os.environ, **{f"FLAGS_{name}": value})
    code = ("from paddle_tpu_torch.core.flags import get_flags; "
            f"print(get_flags('{name}')['{name}'])")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == str(want)


@pytest.mark.parametrize("causal,Hkv", [(True, 2), (False, 2), (True, 4)])
def test_sdpa_flag_off_takes_reference_math(causal, Hkv, flag_off,
                                            monkeypatch):
    """With ``use_pallas_flash_attention`` off a call that flash would take
    goes to ``_sdpa_reference`` and matches the reference's XLA path."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, Hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, Hkv, 8)).astype(np.float32)
    flash, plain = [], []
    real = tattn._sdpa_reference
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: flash.append(1))
    monkeypatch.setattr(tattn, "_sdpa_reference",
                        lambda *a, **kw: plain.append(1) or real(*a, **kw))
    flag_off("use_pallas_flash_attention")
    out = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=causal)
    assert not flash and len(plain) == 1
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        is_causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._value),
                               atol=ATOL, rtol=0)


def _paged_case(rng, lens, Hq, Hkv, D=16, BS=8, MB=4):
    B = len(lens)
    NB = B * MB + 1
    perm = rng.permutation(NB - 1).astype(np.int32)
    tables = np.full((B, MB), -1, np.int32)
    for b, n in enumerate(lens):
        need = -(-(n + 1) // BS)
        tables[b, :need] = perm[b * MB:b * MB + need]
    f = np.float32
    return dict(q=rng.standard_normal((B, Hq, D)).astype(f),
                kc=rng.standard_normal((NB, Hkv, BS, D)).astype(f),
                vc=rng.standard_normal((NB, Hkv, BS, D)).astype(f),
                tables=tables, lens=np.array(lens, np.int32),
                knew=rng.standard_normal((B, Hkv, D)).astype(f),
                vnew=rng.standard_normal((B, Hkv, D)).astype(f))


@pytest.mark.parametrize("form", ["decode", "append"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (2, 2)])
def test_block_mha_flag_off_takes_plain_versions(form, Hq, Hkv, flag_off,
                                                 monkeypatch):
    """With ``use_paged_attention`` off ``block_multihead_attention`` calls
    the plain paged versions, never the kernels' wrappers, and matches the
    reference op (its dense-gather fallback): output within atol, the pools
    bit for bit. The append form runs one row per slot."""
    rng = np.random.default_rng(Hq + Hkv)
    c = _paged_case(rng, [8, 13, 1], Hq, Hkv)
    B, _, D = c["q"].shape
    qkv = np.concatenate([c["q"].reshape(B, Hq * D),
                          c["knew"].reshape(B, Hkv * D),
                          c["vnew"].reshape(B, Hkv * D)], axis=-1)
    calls = []

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper ran with the flag off")
    for fn in ("decode", "append"):
        real = getattr(tpaged, f"paged_attention_{fn}_plain")
        monkeypatch.setattr(TIF, f"paged_attention_{fn}", refuse)
        monkeypatch.setattr(
            TIF, f"paged_attention_{fn}_plain",
            lambda *a, _r=real, _n=fn, **kw: calls.append(_n) or _r(*a, **kw))
    flag_off("use_paged_attention")
    kc, vc = torch.from_numpy(c["kc"].copy()), torch.from_numpy(c["vc"].copy())
    x = torch.from_numpy(qkv)
    q_lens = None
    if form == "append":
        x, q_lens = x[:, None], torch.ones(B, dtype=torch.int32)
    out, kc2, vc2 = TIF.block_multihead_attention(
        x, kc, vc, None, torch.from_numpy(c["lens"]), q_lens,
        block_tables=torch.from_numpy(c["tables"]))
    assert calls == [form] and kc2 is kc and vc2 is vc
    ref, rkc, rvc = JIF.block_multihead_attention(
        paddle.to_tensor(qkv), paddle.to_tensor(c["kc"]),
        paddle.to_tensor(c["vc"]), None, paddle.to_tensor(c["lens"]), None,
        block_tables=paddle.to_tensor(c["tables"]))
    np.testing.assert_allclose(out.numpy().reshape(B, Hq * D),
                               np.asarray(ref._value), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(rkc._value))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(rvc._value))


def test_block_mha_flag_off_quantized_takes_plain_versions(flag_off,
                                                           monkeypatch):
    """The int8 pool form with the flag off: the plain decode version, the
    reference op's five-tuple, payload and scales bit for bit outside the
    scratch block."""
    rng = np.random.default_rng(9)
    c = _paged_case(rng, [8, 13, 1], Hq=4, Hkv=2)
    B, Hq, D = c["q"].shape
    Hkv = c["kc"].shape[1]
    NB = c["kc"].shape[0]
    qkv = np.concatenate([c["q"].reshape(B, Hq * D),
                          c["knew"].reshape(B, Hkv * D),
                          c["vnew"].reshape(B, Hkv * D)], axis=-1)
    monkeypatch.setattr(TIF, "paged_attention_decode", None)
    flag_off("use_paged_attention")
    qpools = []
    for f in (c["kc"], c["vc"]):
        sc = tpaged.kv_block_scale(torch.from_numpy(f), "int8", (2, 3))
        qpools += [tpaged.kv_quantize(torch.from_numpy(f),
                                      sc[..., None, None], "int8"), sc]
    ref = JIF.block_multihead_attention(
        paddle.to_tensor(qkv), *[paddle.to_tensor(t.numpy().copy())
                                 for t in qpools[::2]],
        None, paddle.to_tensor(c["lens"]), None,
        block_tables=paddle.to_tensor(c["tables"]),
        cache_k_quant_scales=paddle.to_tensor(qpools[1].numpy().copy()),
        cache_v_quant_scales=paddle.to_tensor(qpools[3].numpy().copy()),
        cache_quant_type="int8")
    outs = TIF.block_multihead_attention(
        torch.from_numpy(qkv), qpools[0], qpools[2], None,
        torch.from_numpy(c["lens"]), None,
        block_tables=torch.from_numpy(c["tables"]),
        cache_k_quant_scales=qpools[1], cache_v_quant_scales=qpools[3],
        cache_quant_type="int8")
    assert len(outs) == 5
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref[0]._value),
                               atol=ATOL, rtol=0)
    for got, want in zip(outs[1:], ref[1:]):
        np.testing.assert_array_equal(got.numpy()[:NB - 1],
                                      np.asarray(want._value)[:NB - 1])


@pytest.mark.parametrize("dtype,D,takes", [
    (torch.bfloat16, 128, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 32, False), (torch.bfloat16, 96, False),
    (torch.float32, 128, False), (torch.float16, 64, False)])
def test_flash_kernel_takes(dtype, D, takes):
    """The flash kernels take bf16 at head dim 64 or 128; the rest of the
    card's calls take the plain math (the rule is decided from these before
    anything launches)."""
    assert tflash.kernel_takes(dtype, D) is takes


@pytest.mark.parametrize("rows,pool,quant,D,G,bs,takes", [
    (torch.bfloat16, torch.bfloat16, None, 128, 4, 64, True),
    (torch.bfloat16, torch.int8, "int8", 64, 8, 128, True),
    (torch.bfloat16, torch.int8, "int4", 128, 1, 16, True),
    (torch.float32, torch.float32, None, 128, 4, 64, False),
    (torch.bfloat16, torch.bfloat16, None, 32, 1, 64, False),
    (torch.bfloat16, torch.bfloat16, None, 128, 3, 64, False),
    (torch.bfloat16, torch.bfloat16, None, 128, 16, 64, False),
    (torch.bfloat16, torch.bfloat16, None, 128, 4, 256, False),
    (torch.bfloat16, torch.bfloat16, "int8", 128, 4, 64, False)])
def test_paged_kernel_takes(rows, pool, quant, D, G, bs, takes):
    """The paged kernels take bf16 rows over a bf16 (or int8 payload)
    pool, head dim 64 or 128, 1, 2, 4 or 8 query heads per kv head and
    block size <= 128, as their wrappers check."""
    assert tpaged.kernel_takes(rows, pool, D, G, bs, quant) is takes
