// Paged-attention decode step for Hopper (sm_90a), fp32 math, over bf16
// pools (kernel B2) or quantized int8/int4 pools (kernel B4, decode form).
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `_decode_kernel`
// (:370), the Pallas TPU kernel launched through `paged_attention_decode`
// (:481), in its unquantized form with the fused new-token write and its
// quant="int8"|"int4" form (:401-447).
//
// What it computes: for each sequence b and kv head, the G = Hq / Hkv query
// heads of one new token attend positions <= lens[b] of the sequence's
// blocks in pools [NB, Hkv, bs, D], found through tables [B, MB]. The new
// K/V row is written at position lens[b] into block
// tables[b, min(lens[b] / bs, MB - 1)]; a -1 entry there routes the write
// to the pool's last block (the engine's scratch block), never to a real
// one, and a position past the table drops. The walk covers blocks
// 0 .. lens[b] / bs only and skips -1 entries, so the dead tail is never
// read. fp32 online softmax, out = acc / max(l, 1e-30), P rounded to bf16
// before the P@V product as the reference rounds it.
// Quantized pools (payload [NB, Hkv, bs, Dp], int8: Dp = D, int4: Dp =
// D / 2 in split-half nibbles; scales [NB, Hkv], csrc/kv_quant.cuh): the
// last live block j_last = min(lens[b] / bs, MB - 1) is rewritten under
// the quantized write rule (dequantized, the new row merged at its slot,
// rows past it zeroed, the absmax scale recomputed, requantized; stored at
// tables[b, j_last], or in the scratch block for a -1 entry, whose content
// is then block 0's and is not attended) and attended from its
// round-tripped values; every other block is dequantized with its scales.
// P times each key's V scale enters the tensor-core product as three bf16
// terms whose sum is that float32 exactly, so P keeps the reference's
// float32 precision, as the first B4-decode kept it on the CUDA cores:
// one bf16 term (B2's and B4-append's rounding) moves the output of a
// sequence of one or two positions by up to 2^-9 of itself, which at
// magnitudes in [2, 4) is a step of the output's own bf16 rounding,
// 0.0156, beyond the decode tolerance of 1e-2 (measured: PERF.md §6).
//
// Bound on the H100: bytes. One step reads each live K and V row once: at
// the smoke's timing shape (B=8, Hkv=32, D=128, lens up to 2000, 5,926
// visible positions) that is ~97 MB for bf16, ~0.027 ms at 3.35 TB/s,
// against ~1 operation per byte, far below the ~295 operations per byte
// where the products would matter. int8 moves half the K/V bytes, int4 a
// quarter, plus one scale per block and the rewritten last blocks.
//
// Design (csrc/paged_split.cuh, shared with B3 and B4-append): the TPU
// kernel walks a sequence's blocks as the sequential third axis of its
// grid, (m, l, acc) carried in scratch; here that walk is split across
// CTAs (flash-decoding). The grid is (split, kv head, sequence), sized on
// the host from B, Hkv and MB alone (no read of lens, so a serving step
// stays free of synchronizing calls): each CTA takes a span of `span`
// whole pool blocks, and one whose span lies past its sequence's last live
// block exits at once. The span is at least 512 positions and grows so
// that the grid holds about 1,056 CTAs (8 per SM); `decode_launch_config`
// in ops/kernels/paged_attention.py states the same rule and
// `pt_paged_attention_decode_check_launch` holds it against this one. A
// sequence of one span writes `out` directly; the others write float32
// partials and the last CTA to finish merges them in split order, found by
// a per-(sequence, kv head) counter: one launch, since decode steps are
// host-bound and a second launch would cost host time 32 times a step.
// Pool blocks arrive by TMA (one 2-D box per block and 64 columns; a byte
// pool's whole row) through an mbarrier ring (bf16: 3 stages at D 128, 4
// at D 64; bytes: as deep as the same shared memory holds, at most 8) fed
// by one producer warp, so two CTAs per SM keep up to 96 KB each in
// flight. The G heads of the token are the rows of a 16-row mma.sync tile
// (the products are cheap: the bound is bytes) and the four consumer warps
// each take 16 of a stage's 64 positions, merging their (m, l, acc) at the
// end. B2: the CTA that owns block j_last reads the block's rows, patches
// the new K/V row into its shared-memory copy at `slot`, and writes the
// pool row after its last read: no CTA reads a row that another CTA
// writes. B4: the spans cover blocks 0 .. j_last - 1 and one more split
// owns j_last alone (grid x = ceil((MB - 1) / span) + 1), so the
// requantization, a CTA reduction and a correctly rounded division per
// element, runs beside the history walks and not ahead of them; the owner
// works on the block as TMA landed it, writes payload and scale back, then
// attends it.
//
// Measured (chip_smoke.py, tools/ab_paged.py, tools/paged_sweep.py on an
// H100 80GB HBM3 at 700 W): PERF.md, kernel table rows 4 and 4q. B2's
// first design (one CTA per (kv head, sequence), a 2-stage cp.async
// buffer) took 0.1007 ms at the timing shape; this one 0.0477 ms, 1.8x its
// bound. B4-decode's first design (the same first form over bytes, scores
// on the CUDA cores, the last block requantized by every CTA ahead of its
// walk) took 0.1306 ms (int8) and 0.1109 ms (int4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "paged_split.cuh"

namespace {

constexpr int MAXBS = 128;   // block size

// The span rule's two numbers; tools/paged_sweep.py varies them through
// pt_paged_attention_decode_set_tuning.
int g_span_pos = 512;       // positions a span covers at least
int g_target_ctas = 1056;   // CTAs the grid aims at (8 per SM)

int decode_span(int B, int Hkv, int bs, int MB) {
  const long long want =
      ((long long)MB * B * Hkv + g_target_ctas - 1) / g_target_ctas;
  int span = (g_span_pos + bs - 1) / bs;
  if (want > span) span = (int)want;
  return span < MB ? span : MB;
}

// Splits per sequence: B2's spans of 0 .. MB - 1; B4's spans of
// 0 .. MB - 2 and the owner of j_last.
int decode_splits(int MB, int span, int bits) {
  return bits == 16 ? (MB + span - 1) / span : (MB + span - 2) / span + 1;
}

template <int D, int BITS>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
paged_decode_kernel(const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const SplitParams p) {
  split_walk<D, true, BITS>(&tmk, &tmv, p);
}

template <int BITS>
int launch_decode(const void* q, long long q_bstride, void* k_pool,
                  void* v_pool, void* k_scale, void* v_scale,
                  const void* tables, const void* lens, const void* new_k,
                  long long nk_bstride, const void* new_v,
                  long long nv_bstride, void* out, int B, int Hq, int Hkv,
                  int D, int bs, int MB, int NB, float scale, void* scratch,
                  void* counters, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv ||
      Hq / Hkv > 8 || bs <= 0 || bs > MAXBS || MB <= 0 || NB <= 0 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  if (!split_pool_maps<BITS>(&tk, &tv, k_pool, v_pool, NB, Hkv, bs, D))
    return (int)cudaErrorInvalidValue;
  const int span = decode_span(B, Hkv, bs, MB);
  const int splits = decode_splits(MB, span, BITS);
  SplitParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.q_b = q_bstride;
  p.q_s = 0;
  if (BITS == 16) {
    p.k_pool = static_cast<__nv_bfloat16*>(k_pool);
    p.v_pool = static_cast<__nv_bfloat16*>(v_pool);
  } else {
    p.kq = static_cast<uint8_t*>(k_pool);
    p.vq = static_cast<uint8_t*>(v_pool);
    p.k_scale = static_cast<float*>(k_scale);
    p.v_scale = static_cast<float*>(v_scale);
  }
  p.tables = static_cast<const int*>(tables);
  p.lens = static_cast<const int*>(lens);
  p.new_k = static_cast<const __nv_bfloat16*>(new_k);
  p.nk_b = nk_bstride;
  p.new_v = static_cast<const __nv_bfloat16*>(new_v);
  p.nv_b = nv_bstride;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.counters = static_cast<int*>(counters);
  p.S = 1;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.bs = bs;
  p.MB = MB;
  p.NB = NB;
  p.span = span;
  p.krows = splits * (Hq / Hkv);
  p.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(splits, Hkv, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_split<128, BITS>(paged_decode_kernel<128, BITS>, grid,
                                        s, tk, tv, p);
  return (int)launch_split<64, BITS>(paged_decode_kernel<64, BITS>, grid, s,
                                     tk, tv, p);
}

}  // namespace

extern "C" int pt_paged_attention_decode_bf16(
    const void* q, long long q_bstride, void* k_pool, void* v_pool,
    const void* tables, const void* lens, const void* new_k,
    long long nk_bstride, const void* new_v, long long nv_bstride, void* out,
    int B, int Hq, int Hkv, int D, int bs, int MB, int NB, float scale,
    void* scratch, void* counters, void* stream) {
  return launch_decode<16>(q, q_bstride, k_pool, v_pool, nullptr, nullptr,
                           tables, lens, new_k, nk_bstride, new_v, nv_bstride,
                           out, B, Hq, Hkv, D, bs, MB, NB, scale, scratch,
                           counters, stream);
}

#define PT_ENTRY(NAME, BITS)                                                 \
  extern "C" int NAME(const void* q, long long q_bstride, void* k_pool,      \
                      void* v_pool, void* k_scale, void* v_scale,            \
                      const void* tables, const void* lens,                  \
                      const void* new_k, long long nk_bstride,               \
                      const void* new_v, long long nv_bstride, void* out,    \
                      int B, int Hq, int Hkv, int D, int bs, int MB, int NB, \
                      float scale, void* scratch, void* counters,            \
                      void* stream) {                                        \
    return launch_decode<BITS>(q, q_bstride, k_pool, v_pool, k_scale,        \
                               v_scale, tables, lens, new_k, nk_bstride,     \
                               new_v, nv_bstride, out, B, Hq, Hkv, D, bs,    \
                               MB, NB, scale, scratch, counters, stream);    \
  }
PT_ENTRY(pt_paged_attention_decode_int8, 8)
PT_ENTRY(pt_paged_attention_decode_int4, 4)
#undef PT_ENTRY

// Holds the wrapper's launch geometry (decode_launch_config) against the
// rule and constants here for pools of `bits` (16, 8 or 4); 0 when every
// number agrees.
extern "C" int pt_paged_attention_decode_check_launch(
    int B, int Hq, int Hkv, int D, int bs, int MB, int bits, int grid_x,
    int grid_y, int grid_z, int span, int splits, int smem_bytes, int stages,
    int threads, int krows) {
  if (B <= 0 || Hkv <= 0 || bs <= 0 || MB <= 0 || (D != 64 && D != 128) ||
      (bits != 16 && bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const int sp = decode_span(B, Hkv, bs, MB);
  const int n = decode_splits(MB, sp, bits);
  const int smem =
      bits == 16 ? (D == 128 ? SplitSmem<128>::kBytes : SplitSmem<64>::kBytes)
      : bits == 8
          ? (D == 128 ? SplitSmem<128, 8>::kBytes : SplitSmem<64, 8>::kBytes)
          : (D == 128 ? SplitSmem<128, 4>::kBytes : SplitSmem<64, 4>::kBytes);
  const bool ok = span == sp && splits == n && grid_x == n &&
                  grid_y == Hkv && grid_z == B && smem_bytes == smem &&
                  stages == split_stages(D, bits) &&
                  threads == SPLIT_THREADS && krows == n * (Hq / Hkv);
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// The span rule's numbers, for tools/paged_sweep.py (the wrapper's
// set_decode_tuning sets its own copy to match).
extern "C" void pt_paged_attention_decode_set_tuning(int span_pos,
                                                     int target_ctas) {
  g_span_pos = span_pos;
  g_target_ctas = target_ctas;
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
