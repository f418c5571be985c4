// Paged-attention decode step for Hopper (sm_90a), bf16 pools, fp32 math
// (kernel B2).
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `_decode_kernel`
// (:370), the Pallas TPU kernel launched through `paged_attention_decode`
// (:481), in its unquantized form with the fused new-token write.
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
//
// Bound on the H100: bytes. One step reads each live K and V row once: at
// the smoke's timing shape (B=8, Hkv=32, D=128, lens up to 2000, 5,926
// visible positions) that is ~97 MB, ~0.027 ms at 3.35 TB/s, against ~1
// operation per byte, far below the ~295 operations per byte where the
// products would matter.
//
// Design (csrc/paged_split.cuh, shared with B3): the TPU kernel walks a
// sequence's blocks as the sequential third axis of its grid, (m, l, acc)
// carried in scratch; here that walk is split across CTAs
// (flash-decoding). The grid is (split, kv head, sequence), sized on the
// host from B, Hkv and MB alone (no read of lens, so a serving step stays
// free of synchronizing calls): each CTA takes a span of `span` whole pool
// blocks, and one whose span lies past its sequence's last live block
// exits at once. The span is at least 512 positions and grows so that the
// grid holds about 1,056 CTAs (8 per SM); `decode_launch_config` in
// ops/kernels/paged_attention.py states the same rule and
// `pt_paged_attention_decode_check_launch` holds it against this one. A
// sequence of one span writes `out` directly; the others write float32
// partials and the last CTA to finish merges them in split order, found by
// a per-(sequence, kv head) counter: one launch, since decode steps are
// host-bound and a second launch would cost host time 32 times a step.
// Pool blocks arrive by TMA (one 2-D box per block and 64 columns) through
// a 3-stage (D 128; 4 at D 64) mbarrier ring fed by one producer warp, so
// up to 96 KB per CTA and two CTAs per SM are in flight. The G heads of
// the token are the rows of a 16-row mma.sync tile (the products are
// cheap: the bound is bytes) and the four consumer warps each take 16 of a
// stage's 64 positions, merging their (m, l, acc) at the end. The CTA that
// owns block j_last reads the block's rows, patches the new K/V row into
// its shared-memory copy at `slot`, and writes the pool row after its last
// read: no CTA reads a row that another CTA writes.
//
// Measured (chip_smoke.py, tools/ab_paged.py, tools/paged_sweep.py on an
// H100 80GB HBM3 at 700 W): PERF.md, kernel table row 4. The first design
// (one CTA per (kv head, sequence), a 2-stage cp.async buffer) took
// 0.1007 ms at the timing shape; this one 0.0477 ms, 1.8x its bound.
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

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
paged_decode_kernel(const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const SplitParams p) {
  split_walk<D, true>(&tmk, &tmv, p);
}

}  // namespace

extern "C" int pt_paged_attention_decode_bf16(
    const void* q, long long q_bstride, void* k_pool, void* v_pool,
    const void* tables, const void* lens, const void* new_k,
    long long nk_bstride, const void* new_v, long long nv_bstride, void* out,
    int B, int Hq, int Hkv, int D, int bs, int MB, int NB, float scale,
    void* scratch, void* counters, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv ||
      Hq / Hkv > 8 || bs <= 0 || bs > MAXBS || MB <= 0 || NB <= 0 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  if (!split_pool_maps(&tk, &tv, k_pool, v_pool, NB, Hkv, bs, D))
    return (int)cudaErrorInvalidValue;
  const int span = decode_span(B, Hkv, bs, MB);
  const int splits = (MB + span - 1) / span;
  SplitParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.q_b = q_bstride;
  p.q_s = 0;
  p.k_pool = static_cast<__nv_bfloat16*>(k_pool);
  p.v_pool = static_cast<__nv_bfloat16*>(v_pool);
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
    return (int)launch_split<128>(paged_decode_kernel<128>, grid, s, tk, tv,
                                  p);
  return (int)launch_split<64>(paged_decode_kernel<64>, grid, s, tk, tv, p);
}

// Holds the wrapper's launch geometry (decode_launch_config) against the
// rule and constants here; 0 when every number agrees.
extern "C" int pt_paged_attention_decode_check_launch(
    int B, int Hq, int Hkv, int D, int bs, int MB, int grid_x, int grid_y,
    int grid_z, int span, int splits, int smem_bytes, int stages,
    int threads, int krows) {
  if (B <= 0 || Hkv <= 0 || bs <= 0 || MB <= 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const int sp = decode_span(B, Hkv, bs, MB);
  const int n = (MB + sp - 1) / sp;
  const int smem =
      D == 128 ? SplitSmem<128>::kBytes : SplitSmem<64>::kBytes;
  const bool ok = span == sp && splits == n && grid_x == n &&
                  grid_y == Hkv && grid_z == B && smem_bytes == smem &&
                  stages == split_stages(D) && threads == SPLIT_THREADS &&
                  krows == n * (Hq / Hkv);
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
