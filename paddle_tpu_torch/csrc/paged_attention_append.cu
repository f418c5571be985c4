// Paged-attention append step for Hopper (sm_90a), fp32 math, over bf16
// pools (kernel B3) or quantized int8/int4 pools (kernel B4, append form).
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py `_append_kernel`
// (:662), the Pallas TPU kernel launched through `paged_attention_append`
// (:784, pallas_call at :868): its unquantized form with the fused
// multi-block write, and its quant="int8"|"int4" form (:689-750). It is the
// attention of the fused scheduler's mixed step: per sequence b, up to S
// new positions (q_lens[b] of them real) attend the pooled history plus
// their own chunk prefix.
//
// What it computes, for pools [NB, Hkv, bs, D], tables [B, MB] (-1 =
// unallocated), lens [B] (tokens already cached) and q_lens [B]:
// - bf16 pools: row i < q_lens[b] writes its new K/V at position
//   lens[b] + i into block tables[b, (lens[b] + i) / bs]; a -1 entry routes
//   the write to the pool's last block (the engine's scratch block), a
//   logical block >= MB drops; padding rows and q_lens == 0 slots write
//   nothing;
// - quantized pools (payload [NB, Hkv, bs, Dp], int8: Dp = D, int4:
//   Dp = D / 2 in split-half nibbles; scales [NB, Hkv]): every window block
//   w0 <= j <= j_last of a sequence with q_lens > 0 (w0 = min(lens / bs,
//   MB - 1), j_last = min((lens + q_lens - 1) / bs, MB - 1)) is rewritten
//   under the quantized write rule (csrc/kv_quant.cuh): the chunk rows that
//   land in it merged, its rows at or past lens + q_lens zeroed, older rows
//   re-rounded under the new absmax scale; payload and scale are stored at
//   tables[b, j], or in the scratch block for a -1 entry. A q_lens == 0
//   slot writes nothing;
// - row i attends positions <= lens[b] + i of blocks
//   0 .. (lens[b] + q_lens[b] - 1) / bs, skipping -1 entries (quantized:
//   each key dequantized with its block's scales, the window blocks read
//   from their round-tripped values, since the write pass runs first);
//   fp32 online softmax, out = acc / max(l, 1e-30). P is rounded to bf16
//   before P@V as the reference rounds it for bf16 pools; for quantized
//   pools the rounded factor is P * (the key's V scale), where the
//   reference keeps float32 (the one rounding this kernel adds to the
//   reference's math). Padding rows (i >= q_lens) and idle slots get zeros.
//
// Bound on the H100: bytes. At the smoke's parity shape (B=8, S=256,
// Hq=Hkv=32, D=128, block 64, 808 real rows over lens up to 1999) the
// bf16 function reads ~62 MB of cached K/V (3,762 positions), ~13 MB of new
// K/V and ~6.6 MB of q, and writes ~13 MB of K/V and ~6.6 MB of out:
// ~101 MB, ~0.030 ms at 3.35 TB/s, against ~6.7 GFLOP of products over
// 408,208 visible (query, key) pairs, ~0.007 ms at 989 TFLOP/s. So K/V
// must be read from device memory about once per (sequence, kv head) and
// the products must not be the limit: they run on the tensor cores
// (mma.sync is enough at ~4 operations per byte; wgmma's 64-row tiles
// would not fit the decode rows of a mixed step, which B3 also serves).
// Quantized pools move half the cached bytes (a quarter for int4) plus one
// scale per block. The two passes below read the new K/V a second time,
// out of the pool: that is this design's cost, not the function's.
//
// Two launches on one stream, so that no CTA races another CTA's write:
// - write pass, bf16: one CTA per (b, row i) copies the row's Hkv x D new
//   K and V values with 16-byte loads and stores into their block slots;
// - write pass, quantized: one CTA per (window block, kv head, sequence)
//   of 256 threads, K's 128 and V's side by side: each half loads its
//   block's stored payload into shared memory, requantizes it there with
//   the chunk rows merged (kv_requant: old rows through a byte table built
//   with the rule's operations, new rows element by element), and stores
//   payload and scale. The CTA owns its block, so no other CTA races its
//   write;
// - attention pass, bf16 (B3, `append_split_kernel`, csrc/paged_split.cuh,
//   the walk B2 shares): one CTA per (64-row query tile, kv head,
//   sequence); the tile runs over the G*S rows of the head group ordered
//   position-major (row r = i * G + g), so every K/V stage it reads serves
//   all G query heads. Pool blocks arrive by TMA through a 3-stage (D 128;
//   4 at D 64) mbarrier ring fed by a producer warp; S = Q K^T and
//   O += P V run on mma.sync.m16n8k16 with K and V fragments read by
//   ldmatrix from 128-byte-swizzled tiles. A tile whose rows are all
//   padding writes zeros. Long walks are split, not all walks: the last
//   real tile of a sequence, if it holds at most 32 real rows (a decode
//   row, a chunk's short tail), is split over kv into k <= 8 spans of at
//   least 256 positions (k * rows <= 64), walked by its own CTA and the
//   padding tiles' CTAs after it, its float32 partials merged in split
//   order by the last to finish (append_splits, mirrored by
//   `append_launch_config` and `append_tile_splits` in
//   ops/kernels/paged_attention.py). So the partials are at most a quarter
//   of the split tile's walk, and 0.1% of the function's bytes at the
//   timing shape (only the decode row over 2,000 positions splits, 4
//   ways). A chunk's 64-row tiles are not split: their partials would cost
//   up to half of their walk, and a chunk's tiles already run side by side.
// - attention pass, quantized (B4, `append_split_kernel<D, 8|4>`): B3's
//   walk over byte stages (csrc/paged_split.cuh): each pool read as a 2-D
//   byte tensor [NB*Hkv*bs, Dp], whole-row TMA boxes swizzled at the row's
//   width, a deeper ring, each tile row's K factor and V scale beside its
//   position, and mma.sync fragments taken straight from the byte tiles
//   and converted to bf16 grid values in registers (exact: |grid| <= 127);
//   the key's K scale multiplies its column of S in fp32 and its V scale
//   its column of P before P is rounded, so no dequantized value is
//   rounded. The same tiles, splits, merge and padding zeros as B3.
//
// Measured (chip_smoke.py, tools/ab_paged.py, tools/paged_sweep.py on an
// H100 80GB HBM3 at 700 W): PERF.md, kernel table rows 5 and 5q. B3 takes
// 0.0850 ms at the timing shape, 2.8x its bound (the first design, one
// non-split walk per tile through a 2-stage cp.async buffer: 0.1883 ms);
// its chunk tiles are bound by L2, each re-reading its sequence's history.
// B4-append's first design (that walk over byte tiles, unpacked in shared
// memory between two barriers a stage) took 0.4050 ms (int8) and 0.3396 ms
// (int4).
#include <math.h>

#include "flash_common.cuh"
#include "kv_quant.cuh"
#include "paged_split.cuh"

namespace {

constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXBS = 128;   // block size
constexpr int PADB = 16;     // bytes of padding per shared row

// ---- write pass, bf16: one CTA per (row i, sequence b) ---------------------
__global__ void __launch_bounds__(NTHREADS)
append_write_kernel(__nv_bfloat16* k_pool, __nv_bfloat16* v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    const int* __restrict__ qlens,
                    const __nv_bfloat16* __restrict__ new_k, long long nk_b,
                    long long nk_s, const __nv_bfloat16* __restrict__ new_v,
                    long long nv_b, long long nv_s, int Hkv, int D, int bs,
                    int MB, int NB) {
  const int i = blockIdx.x, b = blockIdx.y;
  if (i >= qlens[b]) return;
  const int pos = lens[b] + i;
  const int blk = pos / bs;
  if (blk >= MB) return;                     // past the table: dropped
  const int phys = tables[(long)b * MB + blk];
  const int tgt = phys < 0 ? NB - 1 : phys;  // -1 -> the scratch block
  const int slot = pos - blk * bs;
  const int ch = D / 8;                      // 16-byte chunks per head row
  const __nv_bfloat16* ks = new_k + (long)b * nk_b + (long)i * nk_s;
  const __nv_bfloat16* vs = new_v + (long)b * nv_b + (long)i * nv_s;
  for (int c = threadIdx.x; c < Hkv * ch; c += NTHREADS) {
    const int h = c / ch, d = (c % ch) * 8;
    const long dst = (((long)tgt * Hkv + h) * bs + slot) * D + d;
    *reinterpret_cast<uint4*>(k_pool + dst) =
        *reinterpret_cast<const uint4*>(ks + (long)h * D + d);
    *reinterpret_cast<uint4*>(v_pool + dst) =
        *reinterpret_cast<const uint4*>(vs + (long)h * D + d);
  }
}

// ---- write pass, quantized: one CTA per (window block, kv head, sequence);
// warps 0-3 rewrite K, warps 4-7 V, side by side ---------------------------
template <int BITS>
__global__ void __launch_bounds__(2 * NTHREADS)
append_quant_write_kernel(uint8_t* k_pool, uint8_t* v_pool, float* k_scale,
                          float* v_scale, const int* __restrict__ tables,
                          const int* __restrict__ lens,
                          const int* __restrict__ qlens,
                          const __nv_bfloat16* __restrict__ new_k,
                          long long nk_b, long long nk_s,
                          const __nv_bfloat16* __restrict__ new_v,
                          long long nv_b, long long nv_s, int Hkv, int D,
                          int bs, int MB, int NB) {
  __shared__ __align__(16) uint8_t buf_s[2][MAXBS * (128 + PADB)];
  __shared__ float red_s[2][2 * NWARPS];
  __shared__ uint8_t table_s[2][256];
  const int w = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int QL = qlens[b];
  if (QL <= 0) return;                       // idle slot: writes nothing
  const int L = lens[b];
  const int w0 = min(L / bs, MB - 1);
  const int j_last = min((L + QL - 1) / bs, MB - 1);
  const int j = w0 + w;
  if (j > j_last) return;
  const int pass = threadIdx.x / NTHREADS, tid = threadIdx.x % NTHREADS;
  const int phys = tables[(long)b * MB + j];
  const int src = max(phys, 0);              // -1: block 0's content ...
  const int tgt = phys < 0 ? NB - 1 : phys;  // ... parked in scratch
  const int Dp = D / kv_pack_factor<BITS>();
  const int ld = Dp + PADB;
  const int ch = Dp / 16;
  const int first = j * bs - L;              // chunk index of block row 0
  const int live_end = L + QL - j * bs;      // rows >= this are zeroed
  const long sbase = ((long)src * Hkv + kvh) * bs * Dp;
  const long obase = ((long)tgt * Hkv + kvh) * bs * Dp;
  uint8_t* const buf = buf_s[pass];
  uint8_t* const pool = pass ? v_pool : k_pool;
  float* const scales = pass ? v_scale : k_scale;
  const __nv_bfloat16* nw = pass ? new_v : new_k;
  const long nb_ = pass ? nv_b : nk_b, ns_ = pass ? nv_s : nk_s;
  // constant barrier ids (K's 1, V's 2), so ptxas reserves two
  auto sync = [pass] {
    if (pass) named_barrier_sync(2, NTHREADS);
    else named_barrier_sync(1, NTHREADS);
  };
  for (int i = tid; i < bs * ch; i += NTHREADS) {
    const int r = i / ch, c = (i % ch) * 16;
    *reinterpret_cast<uint4*>(buf + r * ld + c) =
        *reinterpret_cast<const uint4*>(pool + sbase + (long)r * Dp + c);
  }
  const float s_old = scales[(long)src * Hkv + kvh];
  sync();
  const float s_new = kv_requant<BITS, NTHREADS>(
      [=](int r, int c) { return buf + r * ld + c; }, s_old, bs, Dp,
      live_end,
      [&](int r) -> const __nv_bfloat16* {
        const int ci = first + r;
        return (ci >= 0 && ci < QL)
                   ? nw + (long)b * nb_ + (long)ci * ns_ + (long)kvh * D
                   : nullptr;
      },
      red_s[pass], table_s[pass], tid, sync);
  for (int i = tid; i < bs * ch; i += NTHREADS) {
    const int r = i / ch, c = (i % ch) * 16;
    *reinterpret_cast<uint4*>(pool + obase + (long)r * Dp + c) =
        *reinterpret_cast<const uint4*>(buf + r * ld + c);
  }
  if (tid == 0) scales[(long)tgt * Hkv + kvh] = s_new;
}

// ---- attention pass (B3 over bf16 pools, B4 over bytes): the split walk
// of paged_split.cuh -------------------------------------------------------
template <int D, int BITS>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
append_split_kernel(const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const SplitParams p) {
  split_walk<D, false, BITS>(&tmk, &tmv, p);
}

// the q tiles of a head group: S*G rows in 64-row tiles
int append_tiles(int S, int G) { return (S * G + SPLIT_ROWS - 1) / SPLIT_ROWS; }

// The attention pass on pools of BITS through their maps (after the
// write pass).
template <int BITS>
int launch_attention(const CUtensorMap& tk, const CUtensorMap& tv,
                     const void* q, long long q_b, long long q_s,
                     void* k_pool, void* v_pool, void* k_scale,
                     void* v_scale, const int* tables, const int* lens,
                     const int* qlens, void* out, int B, int S, int Hq,
                     int Hkv, int D, int bs, int MB, int NB, float scale,
                     void* scratch, void* counters, cudaStream_t s) {
  SplitParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.q_b = q_b;
  p.q_s = q_s;
  if (BITS == 16) {
    p.k_pool = static_cast<__nv_bfloat16*>(k_pool);
    p.v_pool = static_cast<__nv_bfloat16*>(v_pool);
  } else {
    p.kq = static_cast<uint8_t*>(k_pool);
    p.vq = static_cast<uint8_t*>(v_pool);
    p.k_scale = static_cast<float*>(k_scale);
    p.v_scale = static_cast<float*>(v_scale);
  }
  p.tables = tables;
  p.lens = lens;
  p.qlens = qlens;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.scratch = static_cast<float*>(scratch);
  p.counters = static_cast<int*>(counters);
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.bs = bs;
  p.MB = MB;
  p.NB = NB;
  p.krows = SPLIT_ROWS;
  p.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(append_tiles(S, Hq / Hkv), Hkv, B);
  if (D == 128)
    return (int)launch_split<128, BITS>(append_split_kernel<128, BITS>, grid,
                                        s, tk, tv, p);
  return (int)launch_split<64, BITS>(append_split_kernel<64, BITS>, grid, s,
                                     tk, tv, p);
}

bool append_args_ok(int B, int S, int Hq, int Hkv, int D, int bs, int MB,
                    int NB) {
  return B > 0 && S > 0 && Hkv > 0 && Hq % Hkv == 0 && bs > 0 &&
         bs <= MAXBS && MB > 0 && NB > 0 && B <= 65535 && Hkv <= 65535 &&
         (D == 64 || D == 128);
}

}  // namespace

extern "C" int pt_paged_attention_append_bf16(
    const void* q, long long q_b, long long q_s, void* k_pool, void* v_pool,
    const void* tables, const void* lens, const void* qlens,
    const void* new_k, long long nk_b, long long nk_s, const void* new_v,
    long long nv_b, long long nv_s, void* out, int B, int S, int Hq, int Hkv,
    int D, int bs, int MB, int NB, float scale, void* scratch,
    void* counters, void* stream) {
  CUtensorMap tk, tv;
  if (!append_args_ok(B, S, Hq, Hkv, D, bs, MB, NB) ||
      !split_pool_maps(&tk, &tv, k_pool, v_pool, NB, Hkv, bs, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  const auto* qlp = static_cast<const int*>(qlens);
  append_write_kernel<<<dim3(S, B), NTHREADS, 0, s>>>(
      static_cast<__nv_bfloat16*>(k_pool), static_cast<__nv_bfloat16*>(v_pool),
      tp, lp, qlp, static_cast<const __nv_bfloat16*>(new_k), nk_b, nk_s,
      static_cast<const __nv_bfloat16*>(new_v), nv_b, nv_s, Hkv, D, bs, MB,
      NB);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_attention<16>(tk, tv, q, q_b, q_s, k_pool, v_pool, nullptr,
                              nullptr, tp, lp, qlp, out, B, S, Hq, Hkv, D, bs,
                              MB, NB, scale, scratch, counters, s);
}

// Holds the wrapper's launch geometry (append_launch_config) against the
// constants and the split rule's numbers here for pools of `bits` (16, 8
// or 4); 0 when every number agrees.
extern "C" int pt_paged_attention_append_check_launch(
    int B, int S, int Hq, int Hkv, int D, int bs, int MB, int bits,
    int grid_x, int grid_y, int grid_z, int smem_bytes, int stages,
    int threads, int krows, int max_splits, int split_max_rows,
    int split_min_pos) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || bs <= 0 || MB <= 0 ||
      (D != 64 && D != 128) || (bits != 16 && bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const int smem =
      bits == 16 ? (D == 128 ? SplitSmem<128>::kBytes : SplitSmem<64>::kBytes)
      : bits == 8
          ? (D == 128 ? SplitSmem<128, 8>::kBytes : SplitSmem<64, 8>::kBytes)
          : (D == 128 ? SplitSmem<128, 4>::kBytes : SplitSmem<64, 4>::kBytes);
  const bool ok = grid_x == append_tiles(S, Hq / Hkv) && grid_y == Hkv &&
                  grid_z == B && smem_bytes == smem &&
                  stages == split_stages(D, bits) &&
                  threads == SPLIT_THREADS && krows == SPLIT_ROWS &&
                  max_splits == APPEND_MAX_SPLITS &&
                  split_max_rows == APPEND_SPLIT_MAX_ROWS &&
                  split_min_pos == APPEND_SPLIT_MIN_POS;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// B3's split rule for one sequence, as the kernel applies it (for the card
// tests, which hold it against append_tile_splits).
extern "C" int pt_paged_attention_append_splits(int L, int QL, int S, int G,
                                                int bs, int MB) {
  return append_splits(L, QL, S, G, bs, MB, append_tiles(S, G));
}

// Both passes over quantized pools of BITS (8 or 4) with their scales:
// the write pass (one CTA per (window block, kv head, sequence); a window
// covers at most ceil(S / bs) + 1 blocks), then the attention.
#define PT_ENTRY(NAME, BITS)                                                  \
  extern "C" int NAME(const void* q, long long q_b, long long q_s,            \
                      void* k_pool, void* v_pool, void* k_scale,              \
                      void* v_scale, const void* tables, const void* lens,    \
                      const void* qlens, const void* new_k, long long nk_b,   \
                      long long nk_s, const void* new_v, long long nv_b,      \
                      long long nv_s, void* out, int B, int S, int Hq,        \
                      int Hkv, int D, int bs, int MB, int NB, float scale,    \
                      void* scratch, void* counters, void* stream) {          \
    CUtensorMap tk, tv;                                                       \
    if (!append_args_ok(B, S, Hq, Hkv, D, bs, MB, NB) ||                      \
        !split_pool_maps<BITS>(&tk, &tv, k_pool, v_pool, NB, Hkv, bs, D))     \
      return (int)cudaErrorInvalidValue;                                      \
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);                  \
    const auto* tp = static_cast<const int*>(tables);                         \
    const auto* lp = static_cast<const int*>(lens);                           \
    const auto* qlp = static_cast<const int*>(qlens);                         \
    const int NW = (S + bs - 1) / bs + 1;                                     \
    append_quant_write_kernel<BITS>                                           \
        <<<dim3(NW, Hkv, B), 2 * NTHREADS, 0, s>>>(                           \
        static_cast<uint8_t*>(k_pool), static_cast<uint8_t*>(v_pool),         \
        static_cast<float*>(k_scale), static_cast<float*>(v_scale), tp, lp,   \
        qlp, static_cast<const __nv_bfloat16*>(new_k), nk_b, nk_s,           \
        static_cast<const __nv_bfloat16*>(new_v), nv_b, nv_s, Hkv, D, bs, MB, \
        NB);                                                                  \
    const cudaError_t err = cudaGetLastError();                               \
    if (err != cudaSuccess) return (int)err;                                  \
    return launch_attention<BITS>(tk, tv, q, q_b, q_s, k_pool, v_pool,        \
                                  k_scale, v_scale, tp, lp, qlp, out, B, S,   \
                                  Hq, Hkv, D, bs, MB, NB, scale, scratch,     \
                                  counters, s);                               \
  }
PT_ENTRY(pt_paged_attention_append_int8, 8)
PT_ENTRY(pt_paged_attention_append_int4, 4)
#undef PT_ENTRY

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
