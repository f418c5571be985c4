"""paddle_tpu_torch CUDA kernels vs their plain PyTorch versions, on the card.

These need an NVIDIA Hopper card and ``nvcc``; they skip elsewhere. They
import nothing of JAX, so they run on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
Inputs are unit-normal bf16 made with numpy from a fixed seed. Tolerances:
bf16 rounding of the output (~4e-3 relative) plus a different fp32
summation order, against values of magnitude ~1; the flash backward's
grads within 2e-2 of their largest magnitude; the AdamW kernels bit for
bit; the quantized paged kernels' payload and scales bit for bit (their
outputs within the unquantized forms' tolerances); the int4 GEMM within one
bf16 step of its output's magnitude (bf16) or 1e-5 of it (float32), the
same bits on every run, and weights quantized on the card bit for bit as on
the CPU."""
import collections

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels.flash_attention import (
    attention_delta, flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
    flash_attention_fwd, flash_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.fused_adamw import (
    fused_adamw_sr_update, fused_adamw_sr_update_plain, fused_adamw_update,
    fused_adamw_update_plain, sr_seed)
from paddle_tpu_torch.nn.quant import (WeightOnlyLinear, weight_only_linear,
                                       weight_quantize)
from paddle_tpu_torch.ops.kernels import int4_matmul as i4_mod
from paddle_tpu_torch.ops.kernels.int4_matmul import (int4_matmul,
                                                      int4_matmul_plain)
from paddle_tpu_torch.ops.kernels.paged_attention import (
    kv_block_scale, kv_quantize, paged_attention_append,
    paged_attention_append_plain, paged_attention_decode,
    paged_attention_decode_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev).to(torch.bfloat16)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
    (1, 128, 128, 2, 2, 128, True), (2, 200, 200, 4, 2, 128, False),
    (1, 77, 77, 8, 2, 64, True), (2, 256, 256, 4, 4, 64, False),
    (1, 1, 1, 4, 4, 128, True), (2, 17, 17, 4, 2, 128, True),
    (1, 129, 129, 4, 4, 128, False), (1, 1000, 1000, 4, 1, 128, True),
    (1, 2048, 2048, 8, 8, 128, True), (1, 2048, 2048, 4, 1, 64, True),
    (2, 129, 1000, 4, 2, 128, False), (1, 1000, 17, 2, 1, 64, False)])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal):
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, Hq, D), cuda)
    k = _randn(rng, (B, Sk, Hkv, D), cuda)
    v = _randn(rng, (B, Sk, Hkv, D), cuda)
    n0 = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-2


@pytest.mark.parametrize("S,Hkv,D,causal", [(200, 2, 128, True),
                                            (129, 1, 64, False)])
def test_flash_kernel_dropout_matches_plain(cuda, S, Hkv, D, causal):
    """p = 0.1: the kernel's mask is the plain version's position hash, so
    out agrees within the dropout-free tolerance and lse, dropout-free by
    construction, within 1e-2."""
    rng = np.random.default_rng(4)
    q = _randn(rng, (2, S, 4, D), cuda)
    k = _randn(rng, (2, S, Hkv, D), cuda)
    v = _randn(rng, (2, S, Hkv, D), cuda)
    out, lse = flash_attention_fwd(q, k, v, causal, None, 0.1, 1234)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal, None, 0.1, 1234)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-2
    nodrop, _ = flash_attention_fwd(q, k, v, causal)
    assert not torch.equal(out, nodrop)


def test_flash_kernel_checks_launch_geometry(cuda):
    """The kernel holds the wrapper's launch geometry against its own
    constants: the wrapper's numbers pass, any other block size, stage
    count, head group or shared-memory size is refused."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        KERNEL, fwd_launch_config)
    chk = _build.load(KERNEL).pt_flash_attention_fwd_check_launch
    chk.argtypes = [ctypes.c_int] * 15
    chk.restype = ctypes.c_int
    for D in (64, 128):
        cfg = fwd_launch_config(2, 1000, 1000, 32, 8, D, True)
        args = [2, 1000, 1000, 32, D, 1, cfg.block_q, cfg.block_k,
                cfg.stages, cfg.threads, cfg.smem_bytes, cfg.grid[0],
                cfg.grid[1], cfg.head_group, cfg.kv_tiles[-1]]
        assert chk(*args) == 0
        for i in range(6, 15):
            bad = list(args)
            bad[i] += 1
            assert chk(*bad) != 0


def test_flash_kernel_same_bits_twice(cuda):
    rng = np.random.default_rng(6)
    q = _randn(rng, (2, 1000, 8, 128), cuda)
    k = _randn(rng, (2, 1000, 2, 128), cuda)
    v = _randn(rng, (2, 1000, 2, 128), cuda)
    a, la = flash_attention_fwd(q, k, v, True, None, 0.1, 9)
    b, lb = flash_attention_fwd(q, k, v, True, None, 0.1, 9)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(la, lb)


@pytest.mark.parametrize("Hq,Hkv,D,bs", [(4, 4, 128, 64), (8, 2, 128, 16),
                                         (4, 1, 64, 32)])
def test_paged_decode_kernel_matches_plain(cuda, Hq, Hkv, D, bs):
    rng = np.random.default_rng(1)
    lens = np.array([0, bs - 1, bs, 3 * bs + 5, 2 * bs, 1], np.int32)
    B, MB = len(lens), int(lens.max()) // bs + 2
    need = [int(L) // bs + 1 for L in lens]
    NB = sum(need) + 3
    order = rng.permutation(NB - 1)
    tables = np.full((B, MB), -1, np.int32)
    it = iter(order)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(it)
    tables[5, :] = -1            # a freed slot: stale lens, wiped table
    kp = _randn(rng, (NB, Hkv, bs, D), cuda)
    vp = _randn(rng, (NB, Hkv, bs, D), cuda)
    q = _randn(rng, (B, Hq, D), cuda)
    nk = _randn(rng, (B, Hkv, D), cuda)
    nv = _randn(rng, (B, Hkv, D), cuda)
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    kp2, vp2 = kp.clone(), vp.clone()
    out = paged_attention_decode(q, kp, vp, t, ln, nk, nv)
    torch.cuda.synchronize()
    ref = paged_attention_decode_plain(q, kp2, vp2, t, ln, nk, nv)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert torch.equal(kp[:NB - 1], kp2[:NB - 1])
    assert torch.equal(vp[:NB - 1], vp2[:NB - 1])


@pytest.mark.parametrize("Hq,Hkv,D,bs,S", [(4, 4, 128, 64, 80),
                                           (8, 2, 128, 16, 40),
                                           (4, 1, 64, 32, 33)])
def test_paged_append_kernel_matches_plain(cuda, Hq, Hkv, D, bs, S):
    """Per-slot (lens, q_lens): a first chunk, a mid-block window crossing
    blocks, a short chunk, decode rows on either side of a block boundary,
    an idle slot with a wiped table, and a window running into a -1 entry
    (its rows land in the scratch block). Real rows within 2e-2; pools
    bit-identical outside the scratch block; padding rows zero."""
    rng = np.random.default_rng(2)
    specs = [(0, S), (bs + 5, S), (3 * bs, S // 3), (bs - 1, 1), (bs, 1),
             (2 * bs + 7, 0), (bs // 2, S)]
    B = len(specs)
    need = [(L + max(q, 1) - 1) // bs + 1 for L, q in specs]
    MB = max(need) + 1
    NB = sum(need) + 2
    it = iter(rng.permutation(NB - 1))
    tables = np.full((B, MB), -1, np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(it)
    tables[5, :] = -1                    # idle slot, wiped row
    tables[6, need[6] - 1] = -1          # the window's last block is -1
    kp = _randn(rng, (NB, Hkv, bs, D), cuda)
    vp = _randn(rng, (NB, Hkv, bs, D), cuda)
    q = _randn(rng, (B, S, Hq, D), cuda)
    nk = _randn(rng, (B, S, Hkv, D), cuda)
    nv = _randn(rng, (B, S, Hkv, D), cuda)
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.tensor([L for L, _ in specs], dtype=torch.int32, device=cuda)
    ql = torch.tensor([n for _, n in specs], dtype=torch.int32, device=cuda)
    kp2, vp2 = kp.clone(), vp.clone()
    n0 = paged_attention_append.launches
    out = paged_attention_append(q, kp, vp, t, ln, ql, nk, nv)
    torch.cuda.synchronize()
    assert paged_attention_append.launches == n0 + 1
    ref = paged_attention_append_plain(q, kp2, vp2, t, ln, ql, nk, nv)
    for b, (_, n) in enumerate(specs):
        if n:
            err = (out[b, :n].float() - ref[b, :n].float()).abs().max()
            assert err.item() <= 2e-2
        assert not out[b, n:].any()
    assert torch.equal(kp[:NB - 1], kp2[:NB - 1])
    assert torch.equal(vp[:NB - 1], vp2[:NB - 1])


LONG_BLOCKS = (16, 32, 48, 64, 100, 128)


def _run_twice(fn, pools):
    """``fn`` on two copies of the pools: outputs and pools bit for bit."""
    a = [p.clone() for p in pools]
    b = [p.clone() for p in pools]
    out_a, out_b = fn(*a), fn(*b)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    return out_a, a


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("bs", LONG_BLOCKS)
def test_paged_decode_kernel_long_context(cuda, G, bs):
    """B2 over long histories (MB 128, lens up to 8,192 where the table
    reaches): sequences split across many CTAs, a span of -1 entries, a
    wiped slot, a length past the table, D 64, block sizes that are one
    box or two (and 48, 100: box slots TMA leaves empty). Out within 1e-2
    of the plain version, pools bit-exact outside the scratch block, the
    same bits on two calls."""
    rng = np.random.default_rng(40 + G + bs)
    D, Hkv, MB = 64, 2, 128
    cap = MB * bs
    lens = np.array([min(8191, cap - 1), cap // 2 + 3, 1, 0, cap + 5,
                     777 % cap, cap // 3], np.int32)
    B = len(lens)
    need = [min(int(L) // bs, MB - 1) + 1 for L in lens]
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    tables[3, :] = -1                       # a freed slot
    tables[0, 40:60] = -1                   # -1 entries inside a long walk
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    kp = _randn(rng, (NB, Hkv, bs, D), cuda)
    vp = _randn(rng, (NB, Hkv, bs, D), cuda)
    q = _randn(rng, (B, G * Hkv, D), cuda)
    nk = _randn(rng, (B, Hkv, D), cuda)
    nv = _randn(rng, (B, Hkv, D), cuda)
    n0 = paged_attention_decode.launches
    out, (kk, vk) = _run_twice(
        lambda k, v: paged_attention_decode(q, k, v, t, ln, nk, nv), (kp, vp))
    assert paged_attention_decode.launches == n0 + 2
    kr, vr = kp.clone(), vp.clone()
    ref = paged_attention_decode_plain(q, kr, vr, t, ln, nk, nv)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    assert torch.equal(kk[:NB - 1], kr[:NB - 1])
    assert torch.equal(vk[:NB - 1], vr[:NB - 1])


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("bs", LONG_BLOCKS)
def test_paged_append_kernel_long_context(cuda, G, bs):
    """B3 over long histories (MB 128): decode rows that split across the
    padding tiles' CTAs, one of them over -1 entries, a chunk and a short
    chunk tail after long histories, an idle slot, D 64. Real rows within
    2e-2, padding rows zero, pools bit-exact outside the scratch block, the
    same bits on two calls."""
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        append_tile_splits)
    rng = np.random.default_rng(50 + G + bs)
    D, Hkv, MB, S = 64, 2, 128, 128
    cap = MB * bs
    specs = [(min(8000, cap - 1), 1), (cap // 2, 1), (cap // 3, S),
             (cap - 40, 9), (100, 0), (cap // 4, 3)]
    B = len(specs)
    assert any(append_tile_splits(L, n, S, G, bs, MB)[2] > 1
               for L, n in specs)
    need = [0 if n == 0 else min((L + n - 1) // bs, MB - 1) + 1
            for L, n in specs]
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    tables[1, 10:30] = -1
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.tensor([L for L, _ in specs], dtype=torch.int32, device=cuda)
    ql = torch.tensor([n for _, n in specs], dtype=torch.int32, device=cuda)
    kp = _randn(rng, (NB, Hkv, bs, D), cuda)
    vp = _randn(rng, (NB, Hkv, bs, D), cuda)
    q = _randn(rng, (B, S, G * Hkv, D), cuda)
    nk = _randn(rng, (B, S, Hkv, D), cuda)
    nv = _randn(rng, (B, S, Hkv, D), cuda)
    out, (kk, vk) = _run_twice(
        lambda k, v: paged_attention_append(q, k, v, t, ln, ql, nk, nv),
        (kp, vp))
    kr, vr = kp.clone(), vp.clone()
    ref = paged_attention_append_plain(q, kr, vr, t, ln, ql, nk, nv)
    for b, (_, n) in enumerate(specs):
        if n:
            err = (out[b, :n].float() - ref[b, :n].float()).abs().max()
            assert err.item() <= 2e-2
        assert not out[b, n:].any()
    assert torch.equal(kk[:NB - 1], kr[:NB - 1])
    assert torch.equal(vk[:NB - 1], vr[:NB - 1])


def test_paged_split_rules_match_the_kernels(cuda):
    """The wrappers' launch geometry against the kernels' own numbers
    (their check entry points; one off in any number is refused), and
    B3's split rule against the kernel's for lengths around every edge."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    for quant in (None, "int8", "int4"):
        bits = pa.POOL_BITS[quant]
        for D in (64, 128):
            for B, Hq, Hkv, bs, MB in ((8, 32, 32, 64, 32),
                                       (32, 32, 8, 16, 128),
                                       (1, 8, 1, 128, 64)):
                pa._check_decode_launch(B, Hq, Hkv, D, bs, MB, quant)
                pa._check_append_launch(B, 256, Hq, Hkv, D, bs, MB, quant)
                c = pa.decode_launch_config(B, Hq, Hkv, D, bs, MB, quant)
                lib, chk = pa._entry(pa.KERNEL,
                                     "pt_paged_attention_decode_check_launch")
                args = [B, Hq, Hkv, D, bs, MB, bits, *c.grid, c.span,
                        c.splits, c.smem_bytes, c.stages, c.threads,
                        c.scratch_rows]
                assert chk(*args) == 0
                for i in range(7, len(args)):
                    bad = list(args)
                    bad[i] += 1
                    assert chk(*bad) != 0
    _, rule = pa._entry(pa.APPEND_KERNEL, "pt_paged_attention_append_splits")
    for S, G, bs, MB in ((256, 1, 64, 32), (64, 4, 16, 128), (40, 8, 128, 8)):
        for L in (0, 1, 63, 64, 255, 256, 511, 1999, 4096, MB * bs):
            for QL in (0, 1, 2, 7, 8, 9, 31, 32, 33, S):
                assert rule(L, QL, S, G, bs, MB) == \
                    pa.append_tile_splits(L, QL, S, G, bs, MB)[2]


def _quant_pool(rng, shape, quant, dev):
    """A quantized pool (int8 payload, float32 scales) made by quantizing
    unit-normal blocks; block 1 holds rows 100x larger, as a reused block
    holds stale content (the tests hand it out as a block whose write
    leaves those rows past the live end)."""
    f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    f[1] *= 100.0
    sc = kv_block_scale(f, quant, (2, 3))
    return kv_quantize(f, sc[..., None, None], quant).to(dev), sc.to(dev)


def _tables(rng, need, MB, NB):
    it = iter(rng.permutation(NB - 1))
    tables = np.full((len(need), MB), -1, np.int32)
    for b in range(len(need)):
        for j in range(need[b]):
            tables[b, j] = next(it)
    return tables


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("Hq,Hkv,D,bs", [(4, 4, 128, 64), (8, 2, 128, 16),
                                         (4, 1, 64, 32)])
def test_paged_decode_quant_kernel_matches_plain(cuda, quant, Hq, Hkv, D, bs):
    """B4-decode against its plain version: payload and scales bit for bit
    outside the scratch block (a wiped slot parks there), out within 1e-2."""
    rng = np.random.default_rng(3)
    lens = np.array([0, bs - 1, bs, 3 * bs + 5, 2 * bs, 1], np.int32)
    B, MB = len(lens), int(lens.max()) // bs + 2
    need = [int(L) // bs + 1 for L in lens]
    NB = sum(need) + 3
    tables = _tables(rng, need, MB, NB)
    tables[5, :] = -1            # a freed slot: stale lens, wiped table
    # slot 2's new token opens block 1, the dirty one
    tables[tables == 1], tables[2, 1] = tables[2, 1], 1
    kp, ks = _quant_pool(rng, (NB, Hkv, bs, D), quant, cuda)
    vp, vs = _quant_pool(rng, (NB, Hkv, bs, D), quant, cuda)
    q = _randn(rng, (B, Hq, D), cuda)
    nk = _randn(rng, (B, Hkv, D), cuda)
    nv = _randn(rng, (B, Hkv, D), cuda)
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    ref_pools = [x.clone() for x in (kp, vp, ks, vs)]
    n0 = paged_attention_decode.quant_launches[quant]
    out, *_ = paged_attention_decode(q, kp, vp, t, ln, nk, nv, k_scale=ks,
                                     v_scale=vs, quant=quant)
    torch.cuda.synchronize()
    assert paged_attention_decode.quant_launches[quant] == n0 + 1
    ref, *_ = paged_attention_decode_plain(q, *ref_pools[:2], t, ln, nk, nv,
                                           None, *ref_pools[2:], quant)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    for got, want in zip((kp, vp, ks, vs), ref_pools):
        assert torch.equal(got[:NB - 1], want[:NB - 1])
    # the dirty block's scale follows its live rows only
    assert ks[1].max().item() < 10 * ks[0].max().item()


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("Hq,Hkv,D,bs,S", [(4, 4, 128, 64, 80),
                                           (8, 2, 128, 16, 40),
                                           (4, 1, 64, 32, 33)])
def test_paged_append_quant_kernel_matches_plain(cuda, quant, Hq, Hkv, D, bs,
                                                 S):
    """B4-append against its plain version on the specs of the unquantized
    case plus an idle slot with a live table: payload and scales bit for
    bit outside the scratch block, the idle slot's blocks unchanged byte
    for byte, real rows within 2e-2, padding rows zero."""
    rng = np.random.default_rng(4)
    specs = [(0, S), (bs + 5, S), (3 * bs, S // 3), (bs - 1, 1), (bs, 1),
             (2 * bs + 7, 0), (bs // 2, S), (bs + 3, 0)]
    B = len(specs)
    need = [(L + max(q, 1) - 1) // bs + 1 for L, q in specs]
    MB = max(need) + 1
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    tables[5, :] = -1                    # idle slot, wiped row
    tables[6, need[6] - 1] = -1          # the window's last block is -1
    # slot 2's window starts block 3 and ends inside it: the dirty block 1
    # goes there, its stale rows past the window's end
    tables[tables == 1], tables[2, 3] = tables[2, 3], 1
    kp, ks = _quant_pool(rng, (NB, Hkv, bs, D), quant, cuda)
    vp, vs = _quant_pool(rng, (NB, Hkv, bs, D), quant, cuda)
    q = _randn(rng, (B, S, Hq, D), cuda)
    nk = _randn(rng, (B, S, Hkv, D), cuda)
    nv = _randn(rng, (B, S, Hkv, D), cuda)
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.tensor([L for L, _ in specs], dtype=torch.int32, device=cuda)
    ql = torch.tensor([n for _, n in specs], dtype=torch.int32, device=cuda)
    before = [x.clone() for x in (kp, vp, ks, vs)]
    ref_pools = [x.clone() for x in (kp, vp, ks, vs)]
    n0 = paged_attention_append.quant_launches[quant]
    out, *_ = paged_attention_append(q, kp, vp, t, ln, ql, nk, nv,
                                     k_scale=ks, v_scale=vs, quant=quant)
    torch.cuda.synchronize()
    assert paged_attention_append.quant_launches[quant] == n0 + 1
    ref, *_ = paged_attention_append_plain(q, *ref_pools[:2], t, ln, ql, nk,
                                           nv, None, *ref_pools[2:], quant)
    for b, (_, n) in enumerate(specs):
        if n:
            err = (out[b, :n].float() - ref[b, :n].float()).abs().max()
            assert err.item() <= 2e-2
        assert not out[b, n:].any()
    for got, want in zip((kp, vp, ks, vs), ref_pools):
        assert torch.equal(got[:NB - 1], want[:NB - 1])
    idle = [int(x) for x in tables[7, :need[7]]]
    for got, old in zip((kp, vp, ks, vs), before):
        assert torch.equal(got[idle], old[idle])
    # the dirty block's scale follows its live rows only
    assert ks[1].max().item() < 10 * ks[0].max().item()


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("form", ["decode", "append"])
@pytest.mark.parametrize("pool", ["k", "v"])
def test_paged_quant_kernel_outlier_block_in_history(cuda, quant, form,
                                                     pool):
    """A block of K (or V) 100x larger than the rest, in the live history
    every row attends: the kernels dequantize no value into a rounded
    tile, so the large logits (or values) keep the plain version's
    softmax. Out within the form's tolerance of the output's own scale
    (the bf16 output rounds at ~4e-3 of it)."""
    rng = np.random.default_rng(5)
    D, bs, Hq, Hkv, S = 128, 64, 4, 2, 40
    lens = np.array([3 * bs + 5, 2 * bs + 9, bs + 1], np.int32)
    B = len(lens)
    need = [(int(L) + S) // bs + 1 for L in lens]
    MB, NB = max(need) + 1, sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    # every slot's block 1 (live history; slot 2's window opens in it) is
    # the outlier
    outlier = [int(x) for x in tables[:, 1]]
    pools = {}
    for name in ("k", "v"):
        f = torch.from_numpy(
            rng.standard_normal((NB, Hkv, bs, D)).astype(np.float32))
        if name == pool:
            f[outlier] *= 100.0
        sc = kv_block_scale(f, quant, (2, 3))
        pools[name] = [kv_quantize(f, sc[..., None, None], quant).to(cuda),
                       sc.to(cuda)]
    kp, ks = pools["k"]
    vp, vs = pools["v"]
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    ref_pools = [x.clone() for x in (kp, vp, ks, vs)]
    if form == "decode":
        q = _randn(rng, (B, Hq, D), cuda)
        nk = _randn(rng, (B, Hkv, D), cuda)
        nv = _randn(rng, (B, Hkv, D), cuda)
        out, *_ = paged_attention_decode(q, kp, vp, t, ln, nk, nv,
                                         k_scale=ks, v_scale=vs, quant=quant)
        ref, *_ = paged_attention_decode_plain(
            q, *ref_pools[:2], t, ln, nk, nv, None, *ref_pools[2:], quant)
        tol = 1e-2
    else:
        q = _randn(rng, (B, S, Hq, D), cuda)
        nk = _randn(rng, (B, S, Hkv, D), cuda)
        nv = _randn(rng, (B, S, Hkv, D), cuda)
        ql = torch.full((B,), S, dtype=torch.int32, device=cuda)
        out, *_ = paged_attention_append(q, kp, vp, t, ln, ql, nk, nv,
                                         k_scale=ks, v_scale=vs, quant=quant)
        ref, *_ = paged_attention_append_plain(
            q, *ref_pools[:2], t, ln, ql, nk, nv, None, *ref_pools[2:],
            quant)
        tol = 2e-2
    torch.cuda.synchronize()
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item())
    for got, want in zip((kp, vp, ks, vs), ref_pools):
        assert torch.equal(got[:NB - 1], want[:NB - 1])


QUANT_LONG_BLOCKS = (16, 32, 48, 64, 100, 128)


def _quant_pools(rng, shape, quant, dev, dirty=None):
    """K and V payload pools and scales from unit-normal blocks;
    ``dirty = (block, row)``: that block's rows from ``row`` on are 100x
    larger (stale rows past a written slot)."""
    out = []
    for _ in range(2):
        f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if dirty is not None:
            f[dirty[0], :, dirty[1]:] *= 100.0
        sc = kv_block_scale(f, quant, (2, 3))
        out += [kv_quantize(f, sc[..., None, None], quant).to(dev),
                sc.to(dev)]
    return [out[0], out[2], out[1], out[3]]      # k, v, k_scale, v_scale


def _quant_twice(fn, pools):
    """``fn`` on two copies of the quantized pools: outputs, payload and
    scales bit for bit outside the scratch block (a -1 target's write
    parks there, and several CTAs may write it)."""
    a = [p.clone() for p in pools]
    b = [p.clone() for p in pools]
    out_a, out_b = fn(a), fn(b)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_b)
    nb = pools[0].shape[0]
    assert all(torch.equal(x[:nb - 1], y[:nb - 1]) for x, y in zip(a, b))
    return out_a, a


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("bs", QUANT_LONG_BLOCKS)
def test_paged_decode_quant_kernel_long_context(cuda, quant, G, bs):
    """B4-decode over long histories (MB 128): history spans split many
    ways and the last block's own split merged in order, a span of -1
    entries, a -1 entry at j_last (block 0 requantized into scratch, not
    attended), a wiped slot, a length past the table, a dirty last block,
    D 64 and block sizes 16-128 (48 and 100: box slots rounded up to 8
    rows; 100 and 128: two boxes in two stages). Out
    within 1e-2 of the plain version, payload and scales bit for bit
    outside scratch, the same bits on two calls."""
    rng = np.random.default_rng(60 + G + bs + len(quant))
    D, Hkv, MB = 64, 2, 128
    cap = MB * bs
    lens = np.array([min(8191, cap - 1), cap // 2 + 3, 1, 0, cap + 5,
                     777 % cap, cap // 3, 5 * bs + 2], np.int32)
    B = len(lens)
    need = [min(int(L) // bs, MB - 1) + 1 for L in lens]
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    tables[3, :] = -1                       # a freed slot
    tables[0, 40:60] = -1                   # -1 entries inside a long walk
    tables[7, 5] = -1                       # -1 at j_last
    slot1 = int(lens[1]) % bs
    pools = _quant_pools(rng, (NB, Hkv, bs, D), quant, cuda,
                         (int(tables[1, need[1] - 1]), slot1 + 1))
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    q = _randn(rng, (B, G * Hkv, D), cuda)
    nk = _randn(rng, (B, Hkv, D), cuda)
    nv = _randn(rng, (B, Hkv, D), cuda)
    n0 = paged_attention_decode.quant_launches[quant]
    out, got = _quant_twice(
        lambda p: paged_attention_decode(q, p[0], p[1], t, ln, nk, nv,
                                         k_scale=p[2], v_scale=p[3],
                                         quant=quant)[0], pools)
    assert paged_attention_decode.quant_launches[quant] == n0 + 2
    want = [p.clone() for p in pools]
    ref, *_ = paged_attention_decode_plain(q, want[0], want[1], t, ln, nk,
                                           nv, None, want[2], want[3], quant)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    for g_, w_ in zip(got, want):
        assert torch.equal(g_[:NB - 1], w_[:NB - 1])
    assert not out[3].any()


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("bs", QUANT_LONG_BLOCKS)
def test_paged_append_quant_kernel_long_context(cuda, quant, G, bs):
    """B4-append over long histories (MB 128): decode rows whose walks
    split across the padding tiles' CTAs and merge in order, one over -1
    entries, a chunk and a short tail after long histories, an idle slot,
    D 64, block sizes 16-128. Real rows within 2e-2, padding rows
    zero, payload and scales bit for bit outside scratch, the same bits
    on two calls."""
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        append_tile_splits)
    rng = np.random.default_rng(70 + G + bs + len(quant))
    D, Hkv, MB, S = 64, 2, 128, 128
    cap = MB * bs
    specs = [(min(8000, cap - 1), 1), (cap // 2, 1), (cap // 3, S),
             (cap - 40, 9), (100, 0), (cap // 4, 3)]
    B = len(specs)
    assert any(append_tile_splits(L, n, S, G, bs, MB)[2] > 1
               for L, n in specs)
    need = [0 if n == 0 else min((L + n - 1) // bs, MB - 1) + 1
            for L, n in specs]
    NB = sum(need) + 2
    tables = _tables(rng, need, MB, NB)
    tables[1, 10:30] = -1
    pools = _quant_pools(rng, (NB, Hkv, bs, D), quant, cuda)
    t = torch.from_numpy(tables).to(cuda)
    ln = torch.tensor([L for L, _ in specs], dtype=torch.int32, device=cuda)
    ql = torch.tensor([n for _, n in specs], dtype=torch.int32, device=cuda)
    q = _randn(rng, (B, S, G * Hkv, D), cuda)
    nk = _randn(rng, (B, S, Hkv, D), cuda)
    nv = _randn(rng, (B, S, Hkv, D), cuda)
    out, got = _quant_twice(
        lambda p: paged_attention_append(q, p[0], p[1], t, ln, ql, nk, nv,
                                         k_scale=p[2], v_scale=p[3],
                                         quant=quant)[0], pools)
    want = [p.clone() for p in pools]
    ref, *_ = paged_attention_append_plain(q, want[0], want[1], t, ln, ql,
                                           nk, nv, None, want[2], want[3],
                                           quant)
    for b, (_, n) in enumerate(specs):
        if n:
            err = (out[b, :n].float() - ref[b, :n].float()).abs().max()
            assert err.item() <= 2e-2
        assert not out[b, n:].any()
    for g_, w_ in zip(got, want):
        assert torch.equal(g_[:NB - 1], w_[:NB - 1])


def test_quant_kernels_raise_on_untaken_head_dims(cuda):
    """Head dims other than 64 and 128 (odd int4 dims among them) stay with
    the plain version and the CPU: on the card the kernels raise."""
    rng = np.random.default_rng(5)
    kp, ks = _quant_pool(rng, (4, 1, 16, 32), "int4", cuda)
    vp, vs = _quant_pool(rng, (4, 1, 16, 32), "int4", cuda)
    t = torch.tensor([[0, 2]], dtype=torch.int32, device=cuda)
    ln = torch.tensor([3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_decode(_randn(rng, (1, 1, 32), cuda), kp, vp, t, ln,
                               _randn(rng, (1, 1, 32), cuda),
                               _randn(rng, (1, 1, 32), cuda), k_scale=ks,
                               v_scale=vs, quant="int4")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() /
            b.float().abs().max()).item()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,p", [
    (1, 128, 128, 2, 2, 128, True, 0.0), (2, 200, 200, 4, 2, 128, False, 0.0),
    (1, 77, 77, 8, 2, 64, True, 0.0), (2, 256, 256, 4, 4, 64, False, 0.0),
    (1, 256, 256, 4, 2, 128, True, 0.1), (1, 130, 130, 2, 1, 64, False, 0.2),
    (2, 17, 17, 4, 2, 128, True, 0.0), (1, 1000, 1000, 8, 1, 128, True, 0.0),
    (1, 200, 200, 4, 2, 64, True, 0.1), (2, 129, 1000, 4, 2, 128, False, 0.0)])
def test_flash_bwd_kernels_match_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal,
                                       p):
    """The forward (with dropout where p > 0), then the dK/dV and dQ
    kernels against their plain versions on the same lse and delta: ragged
    lengths (17, 77, 130, 200, 1000), one kv head under a group of 8,
    dropout at both head dims, unequal non-causal lengths."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (B, Sq, Hq, D), cuda)
    k = _randn(rng, (B, Sk, Hkv, D), cuda)
    v = _randn(rng, (B, Sk, Hkv, D), cuda)
    do = _randn(rng, (B, Sq, Hq, D), cuda)
    seed = 1234567
    out, lse = flash_attention_fwd(q, k, v, causal, None, p, seed)
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal, None, p, seed)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-2
    delta = attention_delta(out, do)
    n0 = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, None,
                                     p, seed)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, None, p,
                                seed)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == (n0[0] + 1, n0[1] + 1)
    rk, rv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                           None, p, seed)
    rq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal, None,
                                      p, seed)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert _rel(got, want) <= 2e-2


def test_flash_bwd_same_bits_twice(cuda):
    """Every sum of both kernels runs in one fixed order (no atomics): two
    runs give the same bits, here with dropout, GQA and a ragged length."""
    rng = np.random.default_rng(7)
    q = _randn(rng, (2, 1000, 8, 128), cuda)
    k = _randn(rng, (2, 1000, 2, 128), cuda)
    v = _randn(rng, (2, 1000, 2, 128), cuda)
    do = _randn(rng, (2, 1000, 8, 128), cuda)
    out, lse = flash_attention_fwd(q, k, v, True, None, 0.1, 9)
    delta = attention_delta(out, do)
    runs = [(*flash_attention_bwd_dkv(q, k, v, do, lse, delta, True, None,
                                      0.1, 9),
             flash_attention_bwd_dq(q, k, v, do, lse, delta, True, None, 0.1,
                                    9)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_flash_bwd_checks_launch_geometry(cuda):
    """The backward kernels hold the wrapper's launch geometry against
    their own constants: the wrapper's numbers pass, any other thread
    count, stage count, head group, tile size, shared-memory size, grid or
    walk is refused."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        BWD_KERNEL, bwd_check_args)
    chk = _build.load(BWD_KERNEL).pt_flash_attention_bwd_check_launch
    chk.argtypes = [ctypes.c_int] * 23
    chk.restype = ctypes.c_int
    for D in (64, 128):
        for causal in (True, False):
            args = bwd_check_args(2, 1000, 1000, 32, 8, D, causal)
            assert chk(*args) == 0
            for i in range(7, 23):
                bad = list(args)
                bad[i] += 1
                assert chk(*bad) != 0, i


@pytest.mark.parametrize("n", [4096 * 37, 1000 * 37 + 5, 3])
@pytest.mark.parametrize("step,decay", [(1, True), (7, False)])
def test_adamw_kernel_bit_identical_to_plain(cuda, n, step, decay):
    """Moments, master and the bf16 param equal the plain version's bit
    for bit, over the vector body and the scalar tail."""
    rng = np.random.default_rng(n)

    def state():
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 1e-2).to(cuda).to(torch.bfloat16)
        m = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 1e-3).to(cuda)
        v = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-5).to(cuda)
        mw = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                              * 0.05).to(cuda)
        return mw.to(torch.bfloat16), g, m, v, mw
    a = state()
    b = tuple(t.clone() for t in a)
    n0 = fused_adamw_update.launches
    fused_adamw_update(*a, 3e-4, step, weight_decay=0.01, apply_decay=decay)
    torch.cuda.synchronize()
    assert fused_adamw_update.launches == n0 + 1
    fused_adamw_update_plain(*b, 3e-4, step, weight_decay=0.01,
                             apply_decay=decay)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [4096 * 37, 1000 * 37 + 5, 3])
@pytest.mark.parametrize("step,decay", [(1, True), (7, False)])
def test_adamw_kernel_f32_grad_bit_identical_to_plain(cuda, n, step, decay):
    """The AdamW kernel's float32-grad form (an accumulated mean) against
    the plain version, bit for bit."""
    rng = np.random.default_rng(n + 1)

    def state():
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 1e-2).to(cuda)
        m = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 1e-3).to(cuda)
        v = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-5).to(cuda)
        mw = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                              * 0.05).to(cuda)
        return mw.to(torch.bfloat16), g, m, v, mw
    a = state()
    b = tuple(t.clone() for t in a)
    n0 = fused_adamw_update.launches
    fused_adamw_update(*a, 3e-4, step, weight_decay=0.01, apply_decay=decay)
    torch.cuda.synchronize()
    assert fused_adamw_update.launches == n0 + 1
    fused_adamw_update_plain(*b, 3e-4, step, weight_decay=0.01,
                             apply_decay=decay)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [4096 * 37, 1000 * 37 + 5, 3])
@pytest.mark.parametrize("step,decay", [(1, True), (7, False)])
def test_adamw_sr_kernel_bit_identical_to_plain(cuda, g_dtype, n, step,
                                                decay):
    """The stochastic-rounding AdamW kernel against its plain version:
    param and moments bit for bit, over the vector body and the scalar
    tail, and the param moved."""
    rng = np.random.default_rng(n + 2)

    def state():
        p = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 0.05).to(cuda).to(torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 1e-2).to(cuda).to(g_dtype)
        m = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 1e-3 * (step > 1)).to(cuda).to(torch.bfloat16)
        v = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-5
                             * (step > 1)).to(cuda).to(torch.bfloat16)
        return p, g, m, v
    a = state()
    b = tuple(t.clone() for t in a)
    before = a[0].clone()
    seed = sr_seed(step, 5)
    n0 = fused_adamw_sr_update.launches
    fused_adamw_sr_update(*a, 3e-3, step, seed, weight_decay=0.01,
                          apply_decay=decay)
    torch.cuda.synchronize()
    assert fused_adamw_sr_update.launches == n0 + 1
    fused_adamw_sr_update_plain(*b, 3e-3, step, seed, weight_decay=0.01,
                                apply_decay=decay)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], before)


# ---------------------------------------------------------------------------
# B8: the weight-only int4 GEMM
# ---------------------------------------------------------------------------

INT4_SHAPES = [(2048, 512), (4096, 4096), (4096, 12288), (4096, 11264),
               (11264, 4096)]


def _int4_case(rng, n_in, n_out, dev):
    packed = torch.from_numpy(rng.integers(-128, 128, (n_in // 2, n_out),
                                           dtype=np.int8)).to(dev)
    scales = torch.from_numpy(rng.uniform(1e-3, 2e-2, n_out)
                              .astype(np.float32)).to(dev)
    return packed, scales


def _int4_tol(ref, dtype):
    top = ref.float().abs().max().item()
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(top)) - 7)
    return 1e-5 * top


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_in,n_out", INT4_SHAPES)
def test_int4_matmul_kernel_matches_plain(cuda, n_in, n_out, dtype):
    rng = np.random.default_rng(n_in + n_out)
    packed, scales = _int4_case(rng, n_in, n_out, cuda)
    x_all = torch.from_numpy(rng.standard_normal((128, n_in))
                             .astype(np.float32)).to(cuda).to(dtype)
    for rows in (1, 5, 8, 16, 127, 128):
        x = x_all[:rows]
        n0 = int4_matmul.launches
        out = int4_matmul(x, packed, scales)
        again = int4_matmul(x, packed, scales)
        torch.cuda.synchronize()
        assert int4_matmul.launches == n0 + 2
        assert out.dtype == dtype and out.shape == (rows, n_out)
        assert torch.equal(out, again), rows            # deterministic
        ref = int4_matmul_plain(x, packed, scales)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= _int4_tol(ref, dtype), (rows, err)


def test_int4_matmul_kernel_out_dtype(cuda):
    rng = np.random.default_rng(3)
    packed, scales = _int4_case(rng, 4096, 4096, cuda)
    x = torch.from_numpy(rng.standard_normal((8, 4096)).astype(np.float32)) \
        .to(cuda).to(torch.bfloat16)
    out = int4_matmul(x, packed, scales, out_dtype=torch.float32)
    ref = int4_matmul_plain(x, packed, scales, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= _int4_tol(ref, torch.float32)


def test_int4_matmul_wrapper_raises(cuda):
    rng = np.random.default_rng(4)
    packed, scales = _int4_case(rng, 2048, 512, cuda)
    x = torch.zeros((129, 2048), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 128 rows"):
        int4_matmul(x, packed, scales)
    with pytest.raises(ValueError, match="n_out % 512"):
        int4_matmul(x[:8], packed[:, :500].contiguous(), scales[:500])
    with pytest.raises(ValueError, match="n_in == 2"):
        int4_matmul(x[:8, :2047], packed, scales)
    with pytest.raises(TypeError, match="scales"):
        int4_matmul(x[:8], packed, scales.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_matmul_kernel_every_row_count(cuda, dtype):
    """[4096, 4096] at every row count 1-128 (each row tile, its padding,
    the K splits): within tolerance and the same bits twice."""
    rng = np.random.default_rng(11)
    packed, scales = _int4_case(rng, 4096, 4096, cuda)
    x_all = torch.from_numpy(rng.standard_normal((128, 4096))
                             .astype(np.float32)).to(cuda).to(dtype)
    for rows in range(1, 129):
        x = x_all[:rows]
        out = int4_matmul(x, packed, scales)
        again = int4_matmul(x, packed, scales)
        ref = int4_matmul_plain(x, packed, scales)
        torch.cuda.synchronize()
        assert torch.equal(out, again), rows
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= _int4_tol(ref, dtype), (rows, err)


def test_int4_matmul_kernel_launch_geometry(cuda):
    """launch_config against the kernel's constants at every shape and row
    count, bf16 and float32 x (pt_int4_matmul_check_launch)."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n_in, n_out in INT4_SHAPES:
        for rows in range(1, 129):
            for x_bf16 in (True, False):
                i4_mod._check_launch(rows, n_in, n_out, x_bf16, n_sm)


def test_int4_matmul_kernel_packed_view_at_an_offset(cuda):
    """A packed weight that is a 16-byte-aligned view into a larger buffer
    (and strided, misaligned x) gives the plain version's result."""
    rng = np.random.default_rng(12)
    big, scales = _int4_case(rng, 4096 + 64, 4096, cuda)
    packed = big[16:16 + 2048]
    assert packed.data_ptr() % 16 == 0 and packed.data_ptr() != \
        big.data_ptr()
    x = torch.from_numpy(rng.standard_normal((8, 4097)).astype(np.float32)) \
        .to(cuda).to(torch.bfloat16)
    for xv in (x[:, :4096], x.reshape(-1)[1:1 + 8 * 4096].view(8, 4096)):
        out = int4_matmul(xv, packed, scales)
        ref = int4_matmul_plain(xv, packed, scales)
        assert (out.float() - ref.float()).abs().max().item() <= \
            _int4_tol(ref, torch.bfloat16)


def test_int4_matmul_kernel_scratch_per_stream(cuda):
    """Calls interleaved on two streams (each with its own scratch and
    counters) give each stream's inputs their own result, bit for bit as
    on the default stream."""
    rng = np.random.default_rng(13)
    packed, scales = _int4_case(rng, 11264, 4096, cuda)
    xs = [torch.from_numpy(rng.standard_normal((rows, 11264))
                           .astype(np.float32)).to(cuda).to(torch.bfloat16)
          for rows in (8, 8, 32, 1)]
    want = [int4_matmul(x, packed, scales) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for _ in range(3):
        for i, x in enumerate(xs):
            with torch.cuda.stream(streams[i % 2]):
                got.append((i, int4_matmul(x, packed, scales)))
    torch.cuda.synchronize()
    for i, out in got:
        assert torch.equal(out, want[i]), i


def test_int4_linear_routes_decode_rows_to_the_kernel(cuda):
    """A tileable int4 layer takes B8 for <= 128 rows and the split path
    above, each within its own tolerance of the dequantized product."""
    lin = torch.nn.Module()
    lin.weight = torch.nn.Parameter(torch.from_numpy(
        np.random.default_rng(5).standard_normal((4096, 1024))
        .astype(np.float32)).to(cuda).to(torch.bfloat16))
    lin.bias = None
    layer = WeightOnlyLinear(lin, "int4")
    for rows, launched in ((8, 1), (127, 1), (128, 1), (129, 0)):
        x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
            (rows, 4096)).astype(np.float32)).to(cuda).to(torch.bfloat16)
        n0 = int4_matmul.launches
        y = layer(x)
        assert int4_matmul.launches == n0 + launched, rows
        ref = int4_matmul_plain(x, layer.quant_weight, layer.weight_scale)
        # the split path rounds each dequantized weight to bf16 first
        assert (y.float() - ref.float()).abs().max().item() <= \
            4 * _int4_tol(ref, torch.bfloat16), rows


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 4096), (1001, 512)])
def test_weight_quantize_on_card_matches_cpu(cuda, algo, dtype, shape):
    w = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    w[:, 7] = 0.0
    cpu = torch.from_numpy(w).to(dtype)
    q_cpu, s_cpu = weight_quantize(cpu, algo=algo)
    q_gpu, s_gpu = weight_quantize(cpu.to(cuda), algo=algo)
    assert torch.equal(q_gpu.cpu(), q_cpu)
    assert torch.equal(s_gpu.cpu().view(torch.int32), s_cpu.view(torch.int32))


def test_int8_linear_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(8)
    q, s = weight_quantize(torch.from_numpy(
        rng.standard_normal((512, 256)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32))
    want = weight_only_linear(x, q, None, s, "int8")
    got = weight_only_linear(x.to(cuda), q.to(cuda), None, s.to(cuda), "int8")
    assert (got.cpu() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


def _card_and_cpu(cfg, cuda, seed=3):
    """The same seeded weights on the CPU and, copied, on the card."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed).eval()
    card = LlamaForCausalLM(cfg, device=cuda, seed=seed).eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _flash_launches():
    return (flash_attention_fwd.launches, flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches)


def _paged_launches():
    return (paged_attention_decode.launches, paged_attention_append.launches,
            dict(paged_attention_decode.quant_launches),
            dict(paged_attention_append.quant_launches))


# (dtype, heads): float32 at D 64 and D 32 (LlamaConfig.tiny), bf16 at D 32;
# float32 within 1e-4 of the logits' magnitude (both sides full float32
# products, different summation orders), bf16 within 3e-2 (two layers of
# bf16 rounding at different places)
C2_MODELS = [("float32", 2, 1e-4), ("float32", 4, 1e-4),
             ("bfloat16", 4, 3e-2)]


@pytest.mark.parametrize("dtype,heads,tol", C2_MODELS)
def test_llama_forward_outside_kernel_shapes_on_card(cuda, dtype, heads, tol):
    """A float32 model and a D-32 model (the flash kernels take neither)
    run their forward on the card through the plain attention math, launch
    no flash kernel, and match the CPU run of the same weights."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.tiny(dtype=dtype, num_attention_heads=heads,
                           num_key_value_heads=heads // 2)
    cpu, card = _card_and_cpu(cfg, cuda)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 48))
    n0 = _flash_launches()
    with torch.no_grad():
        got = card(torch.from_numpy(ids).to(cuda))
        want = cpu(torch.from_numpy(ids))
    torch.cuda.synchronize()
    assert _flash_launches() == n0
    assert torch.isfinite(got).all()
    assert _rel(got.cpu(), want) <= tol


@pytest.mark.parametrize("scheduler", ["legacy", "fused"])
def test_llm_engine_outside_kernel_shapes_on_card(cuda, scheduler):
    """A float32 D-32 model (LlamaConfig.tiny) served greedily by LLMEngine
    on the card: the paged kernels take neither its dtype nor its head dim,
    so the plain paged versions run, no kernel launches, and the tokens
    equal the CPU engine's on the same weights."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.tiny()
    cpu, card = _card_and_cpu(cfg, cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 23, 40)]
    kw = dict(cache_impl="paged", scheduler=scheduler, max_batch=2,
              max_seq_len=96, chunk_size=16, block_size=8)
    n0 = (_flash_launches(), _paged_launches())
    got = LLMEngine(card, device=cuda, **kw).generate(prompts,
                                                      max_new_tokens=12)
    torch.cuda.synchronize()
    assert (_flash_launches(), _paged_launches()) == n0
    want = LLMEngine(cpu, device="cpu", **kw).generate(prompts,
                                                       max_new_tokens=12)
    assert [list(o.token_ids) for o in got] == \
        [list(o.token_ids) for o in want]
    assert all(len(o.token_ids) == 12 for o in got)


@pytest.mark.parametrize("scheduler", ["legacy", "fused"])
def test_dense_llm_engine_on_card(cuda, scheduler, monkeypatch):
    """The dense engine, ``LLMEngine(model)`` (the reference's default),
    on the card over LlamaConfig.tiny: its masked attention launches no
    flash or paged kernel and reaches no kernel's plain version, and the
    tokens equal the CPU engine's on the same weights."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.ops.kernels import flash_attention as fa_mod
    from paddle_tpu_torch.ops.kernels import paged_attention as pa_mod
    plain = []
    for mod, name in ((pa_mod, "paged_attention_decode_plain"),
                      (pa_mod, "paged_attention_append_plain"),
                      (IF, "paged_attention_decode_plain"),
                      (IF, "paged_attention_append_plain"),
                      (fa_mod, "flash_attention_fwd_plain")):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                                plain.append(_n))
    cfg = LlamaConfig.tiny()
    cpu, card = _card_and_cpu(cfg, cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 23, 40)]
    kw = dict(scheduler=scheduler, max_batch=2, max_seq_len=96,
              chunk_size=16, horizon=4)
    n0 = (_flash_launches(), _paged_launches())
    eng = LLMEngine(card, **kw)
    assert eng.cache_impl == "dense" and eng.device == card.device
    got = eng.generate(prompts, max_new_tokens=12)
    torch.cuda.synchronize()
    assert (_flash_launches(), _paged_launches()) == n0
    assert not plain, plain
    monkeypatch.undo()
    want = LLMEngine(cpu, device="cpu", **kw).generate(prompts,
                                                       max_new_tokens=12)
    assert [list(o.token_ids) for o in got] == \
        [list(o.token_ids) for o in want]
    assert all(len(o.token_ids) == 12 for o in got)


def test_attention_routing_flags_on_card(cuda):
    """A bf16 D-128 call the kernels take launches them while the flags are
    on; with ``use_pallas_flash_attention`` or ``use_paged_attention`` off
    the same call takes the plain math and launches nothing."""
    from paddle_tpu_torch.core.flags import get_flags, set_flags
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(4)
    q = _randn(rng, (1, 64, 2, 128), cuda)
    NB, Hkv, bs, D = 5, 1, 16, 128
    qkv = _randn(rng, (2, (2 + 2 * Hkv) * D), cuda)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    saved = get_flags(["use_pallas_flash_attention", "use_paged_attention"])
    try:
        outs = {}
        for on in (True, False):
            set_flags({"use_pallas_flash_attention": on,
                       "use_paged_attention": on})
            n0 = (flash_attention_fwd.launches,
                  paged_attention_decode.launches)
            sdpa = F.scaled_dot_product_attention(q, q, q, is_causal=True)
            pools = [_randn(np.random.default_rng(5), (NB, Hkv, bs, D), cuda)
                     for _ in range(2)]
            dec = IF.block_multihead_attention(qkv, *pools, None, lens, None,
                                               block_tables=tables)[0]
            torch.cuda.synchronize()
            n1 = (flash_attention_fwd.launches,
                  paged_attention_decode.launches)
            assert n1 == ((n0[0] + 1, n0[1] + 1) if on else n0)
            outs[on] = (sdpa, dec, pools)
        for got, want in zip(outs[True][:2], outs[False][:2]):
            assert (got.float() - want.float()).abs().max().item() <= 2e-2
        for got, want in zip(outs[True][2], outs[False][2]):
            assert torch.equal(got, want)
    finally:
        set_flags(saved)


@pytest.mark.parametrize("cache_impl", ["static", "paged"])
def test_generate_float32_on_card_matches_cpu(cuda, cache_impl):
    """A float32 D-32 model (LlamaConfig.tiny: the kernels take neither)
    generates on the card through the plain attention math, launches no
    kernel, and emits the CPU run's tokens on the same weights, with an
    eos id that ends some rows early."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.tiny()
    cpu, card = _card_and_cpu(cfg, cuda)
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (3, 21)))
    kw = dict(max_new_tokens=24, cache_impl=cache_impl, block_size=16)
    want = cpu.generate(ids, **kw)
    n0 = (_flash_launches(), _paged_launches())
    got = card.generate(ids.to(cuda), **kw)
    torch.cuda.synchronize()
    assert (_flash_launches(), _paged_launches()) == n0
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert torch.equal(got.cpu(), want)
    eos = int(want[0, 5])
    want = cpu.generate(ids, eos_token_id=eos, **kw)
    assert torch.equal(card.generate(ids.to(cuda), eos_token_id=eos,
                                     **kw).cpu(), want)


def _bf16_d128(cuda, layers=2, kvh=1):
    """A bf16 model at head dim 128 (the kernels' shapes), seeded."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=layers, num_attention_heads=2,
                      num_key_value_heads=kvh, max_position_embeddings=512,
                      dtype="bfloat16")
    return LlamaForCausalLM(cfg, device=cuda, seed=5).eval()


def _greedy_misses(model, prompts, streams, margin=0.05):
    """Tokens that differ from a no-cache forward's argmax over their
    prefix where its top-1/top-2 margin exceeds ``margin``."""
    bad = 0
    with torch.no_grad():
        for p, toks in zip(prompts, streams):
            p, toks = list(p), list(toks)
            seq = torch.tensor([p + toks[:-1]], device=model.device)
            rows = model(seq)[0, len(p) - 1:].float()
            top2 = torch.topk(rows, 2, dim=-1)
            gap = (top2.values[:, 0] - top2.values[:, 1]).cpu()
            arg = top2.indices[:, 0].cpu()
            bad += sum(int(arg[i]) != t and float(gap[i]) > margin
                       for i, t in enumerate(toks))
    return bad


def test_generate_bf16_launches_b1_and_b2(cuda):
    """At the kernels' shapes generate's prefill launches B1 once a layer
    and its paged decode B2 once a layer a step (no step after the last
    token); static and paged tokens pass the margin check against a
    no-cache forward."""
    model = _bf16_d128(cuda)
    L = model.config.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, 512, (4, 100))).to(cuda)
    limit = 20
    out = {}
    for cache_impl in ("static", "paged"):
        f0, p0 = flash_attention_fwd.launches, paged_attention_decode.launches
        out[cache_impl] = model.generate(ids, max_new_tokens=limit,
                                         cache_impl=cache_impl, block_size=64)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches - f0 == L
        assert paged_attention_decode.launches - p0 == \
            (L * (limit - 1) if cache_impl == "paged" else 0)
        assert out[cache_impl].shape == (4, limit)
        assert _greedy_misses(model, ids.tolist(),
                              out[cache_impl].tolist()) == 0


@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefix_cache_cow_on_card(cuda, monkeypatch, quant):
    """The fused engine with the prefix cache over bf16 and int8 pools at
    the kernels' shapes: a shared prompt served twice in turn hits in
    whole blocks and through a COW tail; every step launches the paged
    kernels of its pool (B3/B2, or B4's append and decode), once a layer;
    the pool audit holds after every operation; bf16 streams pass the
    margin check against a no-cache forward."""
    from paddle_tpu_torch.inference import LLMEngine
    monkeypatch.setenv("PADDLE_TPU_POOL_CHECKS", "1")
    model = _bf16_d128(cuda, kvh=2)
    L = model.config.num_hidden_layers
    rng = np.random.default_rng(8)
    sys_p = rng.integers(0, 512, 40).tolist()       # 40 % 16: a COW tail
    prompts = [sys_p + rng.integers(0, 512, n).tolist() for n in (9, 13)]
    eng = LLMEngine(model, device=cuda, cache_impl="paged",
                    scheduler="fused", max_batch=2, max_seq_len=128,
                    chunk_size=32, block_size=16, enable_prefix_cache=True,
                    kv_cache_dtype=quant)
    assert eng._debug_pool
    n0 = _paged_launches()
    streams = []
    for p in prompts:
        rid = eng.add_request(p, max_new_tokens=10)
        while eng.has_unfinished():
            eng.step()
        streams.append(list(eng.finished_outputs[rid].token_ids))
    torch.cuda.synchronize()
    n1 = _paged_launches()
    mixed = eng.stats["fused_steps"]
    decode = eng.stats["steps"] - mixed
    if quant is None:
        got = (n1[0] - n0[0], n1[1] - n0[1])
        assert got == (decode * L, mixed * L)
    else:
        got = (n1[2][quant] - n0[2][quant], n1[3][quant] - n0[3][quant])
        assert got == (decode * L, mixed * L)
        assert (n1[0], n1[1]) == (n0[0], n0[1])
    assert eng.stats["prefix_cow_blocks"] >= 1
    assert eng.stats["prefix_hit_tokens"] >= 40
    assert all(len(s) == 10 for s in streams)
    eng._check_pool_invariants()
    assert len(eng._free_blocks) + len(eng._lru) == eng.n_blocks
    if quant is None:
        assert _greedy_misses(model, prompts, streams) == 0


@pytest.mark.parametrize("quant", [None, "int8"])
def test_multi_step_paged_engine_on_card(cuda, monkeypatch, quant):
    """A paged fused engine at ``readout_stride=4`` over bf16 and int8
    pools at the kernels' shapes, a flight recorder attached: its tokens
    equal the stride-1 engine's on the card; every decode iteration of a
    stride launches the decode kernel of its pool once a layer (B2, or
    B4-decode) and every mixed step the append kernel; no plain version
    runs; the stride dispatches' records carry ``readout_stride == 4``."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.ops.kernels import paged_attention as pa_mod
    from paddle_tpu_torch.profiler import FlightRecorder
    model = _bf16_d128(cuda, kvh=2)
    L = model.config.num_hidden_layers
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).tolist() for n in (37, 5, 60)]
    kw = dict(device=cuda, cache_impl="paged", scheduler="fused",
              max_batch=2, max_seq_len=128, chunk_size=32, block_size=16,
              kv_cache_dtype=quant)
    want = [list(o.token_ids) for o in LLMEngine(model, **kw).generate(
        prompts, max_new_tokens=14)]
    plain = []
    for mod in (pa_mod, IF):
        for name in ("paged_attention_decode_plain",
                     "paged_attention_append_plain"):
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                                plain.append(_n))
    eng = LLMEngine(model, readout_stride=4, **kw)
    rec = FlightRecorder()
    eng.flight_recorder = rec
    iters = []
    decode = eng._decode

    def counted(active, eos_ids, budgets, n_iter):
        iters.append(n_iter)
        return decode(active, eos_ids, budgets, n_iter)

    eng._decode = counted
    n0 = _paged_launches()
    got = [list(o.token_ids) for o in eng.generate(prompts,
                                                   max_new_tokens=14)]
    torch.cuda.synchronize()
    n1 = _paged_launches()
    assert not plain, plain
    assert got == want and all(len(s) == 14 for s in got)
    assert eng.stats["multi_steps"] > 0 and max(iters) == 4
    mixed = eng.stats["fused_steps"]
    if quant is None:
        launched = (n1[0] - n0[0], n1[1] - n0[1])
    else:
        launched = (n1[2][quant] - n0[2][quant],
                    n1[3][quant] - n0[3][quant])
        assert (n1[0], n1[1]) == (n0[0], n0[1])
    assert launched == (sum(iters) * L, mixed * L)
    strides = [r.readout_stride for r in rec.records() if r.kind == "decode"]
    assert strides and set(strides) == {4}
    assert all(r.readout_stride == 1 for r in rec.records()
               if r.kind == "mixed")


@pytest.mark.parametrize("stride", [1, 4])
def test_fused_spec_paged_engine_on_card(cuda, monkeypatch, stride):
    """A speculative paged fused engine (``speculative_k=4``) at the
    kernels' shapes, bf16 pool, a flight recorder attached: every verify
    window the host dispatches and every mixed step launches B3 once a
    layer, B2 never, no plain version runs; the streams pass the margin
    check against a no-cache forward (a window's products round apart from
    a one-row step's in bf16, so exactness is held up to near-ties); the
    pool drains; spec records carry ``readout_stride == 4 * stride``."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.ops.kernels import paged_attention as pa_mod
    from paddle_tpu_torch.profiler import FlightRecorder
    monkeypatch.setenv("PADDLE_TPU_POOL_CHECKS", "1")
    model = _bf16_d128(cuda, kvh=2)
    L = model.config.num_hidden_layers
    rng = np.random.default_rng(10)
    base = rng.integers(0, 512, 7).tolist()
    prompts = [(base * 8)[:37], rng.integers(0, 512, 5).tolist(),
               (base * 9)[:60]]
    plain = []
    for mod in (pa_mod, IF):
        for name in ("paged_attention_decode_plain",
                     "paged_attention_append_plain"):
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                                plain.append(_n))
    eng = LLMEngine(model, device=cuda, cache_impl="paged",
                    scheduler="fused", max_batch=2, max_seq_len=128,
                    chunk_size=32, block_size=16, speculative_k=4,
                    readout_stride=stride)
    rec = FlightRecorder()
    eng.flight_recorder = rec
    windows = []
    multi = eng._multi_spec

    def counted(n_win, *a):
        windows.append(n_win)
        return multi(n_win, *a)

    eng._multi_spec = counted
    n0 = _paged_launches()
    got = [list(o.token_ids) for o in eng.generate(prompts,
                                                   max_new_tokens=14)]
    torch.cuda.synchronize()
    n1 = _paged_launches()
    assert not plain, plain
    assert all(len(s) == 14 for s in got)
    assert eng.stats["spec_proposed_tokens"] > 0 and windows
    assert max(windows) <= stride
    mixed = sum(r.kind == "mixed" for r in rec.records())
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (0, (sum(windows) + mixed) * L)
    assert {r.readout_stride for r in rec.records()
            if r.kind == "spec"} == {4 * stride}
    assert all(r.readout_stride == 4 for r in rec.records()
               if r.kind == "mixed")
    eng._check_pool_invariants()
    assert len(eng._free_blocks) == eng.n_blocks
    assert _greedy_misses(model, prompts, got) == 0


def _first_parting_margin(model, prompts, want, got):
    """Per stream pair that differs: the top-1/top-2 margin of a no-cache
    forward at the first differing step, over the prompt and the common
    prefix."""
    margins = []
    with torch.no_grad():
        for p, a, b in zip(prompts, want, got):
            if a == b:
                continue
            n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            seq = torch.tensor([list(p) + list(a[:n])], device=model.device)
            top2 = torch.topk(model(seq)[0, -1].float(), 2).values
            margins.append(float(top2[0] - top2[1]))
    return margins


@pytest.mark.parametrize("weights", ["bf16", "int4"])
def test_legacy_spec_engine_on_card(cuda, monkeypatch, weights):
    """The legacy dense speculative scan, ``LLMEngine(model,
    speculative_k=4, horizon=2)`` (the reference's default speculation),
    over bf16 weights and over a model quantized to weight-only int4 at
    B8's shapes: its masked attention launches no flash or paged kernel,
    no plain version runs (B8's included), drafts are proposed, and the
    streams equal the spec-off engine's up to a near-tie (a window's
    products round apart from a one-row step's in bf16), both passing the
    margin check against a no-cache forward. The int4 model launches B8
    once for each of its 7 projections a layer per verify window, every
    call at B x k rows (the admission windows' 256 rows take the split
    route), and none in the spec-off engine's prefill."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import quant as quant_mod
    from paddle_tpu_torch.ops.kernels import paged_attention as pa_mod
    if weights == "bf16":
        model = _bf16_d128(cuda)
    else:
        # hidden 1024 and ff 2048 tile for B8; vocab 1000 does not, so
        # lm_head takes the split route
        cfg = LlamaConfig(vocab_size=1000, hidden_size=1024,
                          intermediate_size=2048, num_hidden_layers=2,
                          num_attention_heads=8, num_key_value_heads=8,
                          max_position_embeddings=512, dtype="bfloat16")
        model = LlamaForCausalLM(cfg, device=cuda, seed=6).eval()
        quant_mod.quantize_linears_for_inference(model, weight_dtype="int4")
    L = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    rng = np.random.default_rng(12)
    base = rng.integers(0, vocab, 6).tolist()
    prompts = [(base * 9)[:41], rng.integers(0, vocab, 9).tolist(),
               (base[::-1] * 5)[:23]]
    plain, rows = [], collections.Counter()
    for mod, name in ((pa_mod, "paged_attention_decode_plain"),
                      (pa_mod, "paged_attention_append_plain"),
                      (IF, "paged_attention_decode_plain"),
                      (IF, "paged_attention_append_plain"),
                      (i4_mod, "int4_matmul_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            plain.append(_n))
    route = quant_mod.int4_matmul

    def logged(x2d, *a, **k):
        rows[int(x2d.shape[0])] += 1
        return route(x2d, *a, **k)

    monkeypatch.setattr(quant_mod, "int4_matmul", logged)
    kw = dict(max_batch=2, max_seq_len=256, chunk_size=256, horizon=2)
    streams, b8 = {}, {}
    for k in (4, 1):
        eng = LLMEngine(model, device=cuda, speculative_k=k, **kw)
        assert (eng.scheduler, eng.cache_impl) == ("legacy", "dense")
        windows = []
        if k > 1:
            scan = eng._spec_scan

            def counted(active, eos_ids, budgets, n_win, _scan=scan):
                windows.append(n_win)
                return _scan(active, eos_ids, budgets, n_win)

            eng._spec_scan = counted
        n0 = (_flash_launches(), _paged_launches(), int4_matmul.launches)
        streams[k] = [list(o.token_ids) for o in eng.generate(
            prompts, max_new_tokens=16)]
        torch.cuda.synchronize()
        assert (_flash_launches(), _paged_launches()) == n0[:2]
        b8[k] = (int4_matmul.launches - n0[2], sum(windows))
        if k > 1:
            assert eng.stats["spec_proposed_tokens"] > 0 and windows
    assert not plain, plain
    assert all(len(s) == 16 for s in streams[4])
    margin = 0.05
    if weights == "int4":
        n_on, n_win = b8[4]
        assert n_on == 7 * L * n_win and n_win > 0
        # the spec-off engine's decode steps take B8 at B rows
        assert b8[1][0] > 0 and set(rows) == {2 * 4, 2}
        # B8 and the split route round apart: widen the margin by four
        # times their largest logit gap on 32 rows, as the smoke does
        from paddle_tpu_torch.core.flags import get_flags, set_flags
        ids = torch.tensor([prompts[0][:16], prompts[2][:16]], device=cuda)
        saved = get_flags("FLAGS_use_pallas_int4")
        try:
            with torch.no_grad():
                on = model(ids).float()
                set_flags({"FLAGS_use_pallas_int4": False})
                off = model(ids).float()
        finally:
            set_flags(saved)
        margin += 4 * (on - off).abs().max().item()
    else:
        assert b8 == {4: (0, b8[4][1]), 1: (0, 0)} and not rows
    assert all(m <= margin for m in _first_parting_margin(
        model, prompts, streams[1], streams[4]))
    for k in (4, 1):
        assert _greedy_misses(model, prompts, streams[k], margin) == 0
