// Weight-only int4 GEMM for Hopper (sm_90a): kernel B8.
//
// Replaces: paddle_tpu/ops/kernels/int4_matmul.py `_int4_mm_kernel` (:43),
// the Pallas TPU kernel launched through `int4_matmul` (:72).
//
// What it computes: y[r, n] = (sum_i x[r, 2i] * lo[i, n]
//                              + x[r, 2i+1] * hi[i, n]) * s[n]
// for x [rows <= 128, n_in] (bf16 or float32), packed int8
// [n_in / 2, n_out] whose byte (i, n) holds weight row 2i in its low nibble
// and row 2i+1 in its high nibble (both signed 4-bit), and float32 scales
// [n_out]. The sum accumulates in float32, is scaled once, and is cast to
// the output type (bf16 or float32). n_in % 1024 == 0 and n_out % 512 == 0
// (the reference's `int4_matmul_tileable`); the wrapper checks them.
//
// Bound on the H100. At decode's 8 rows, bytes: the packed weight is read
// once, 8.39 MB at [4096, 4096] (2.50 us at 3.35 TB/s), 0.104 GB for one
// Llama-2-7B decoder layer's seven projections (31.1 us); x, the scales
// and y are < 1% of it. At 128 rows, operations: [4096, 11264] is 11.8
// GFLOP, 11.9 us at 989 TFLOP/s, against 6.9 us of bytes. The first form
// of this kernel did every product as an fp32 FMA on the CUDA cores (1.64
// G FMAs a layer at 8 rows, 1.6x the whole byte time, and 16 times that
// at 128 rows, re-walking the weight per 8-row tile), kept 8 KB in
// flight per CTA, and took a second launch to add its K splits.
//
// Design:
//  - Tensor cores on nibbles unpacked in registers: mma.sync.m16n8k16,
//    bf16 in, fp32 out, with the operands swapped: A is the weight (16
//    output columns as M, k as K), B is x^T (8 rows of x as N). An A
//    register of lane (g, t) holds k = 2t, 2t + 1 of one column, which is
//    one packed byte: its low and high nibble. So the reference's layout
//    feeds the fragments as it is: packed row t (k-step base + 0..3) gives
//    registers a0, a1, packed row t + 4 gives a2, a3.
//  - Each lane loads whole 32-bit words of the staged byte tile: lane g of
//    warp w reads word g >> 1 of 16-byte chunk 4 (g & 1) + w of a packed
//    row, four columns; bytes 0 and 1 are M rows g and g + 8 of the first
//    m16 tile, bytes 2 and 3 those of the second. With TMA's 128-byte
//    swizzle (chunk ^ row) the 32 lanes hit 32 banks. The epilogue puts
//    each accumulator back at its column: a lane holds four consecutive
//    columns of each of its rows.
//  - The unpack is exact and has no int-to-float conversion: one byte_perm
//    puts the byte's low nibble at bit 0 and its high nibble at bit 16,
//    one lop3 masks them, flips each nibble's sign bit (nibble + 8) and
//    ORs in 0x4300, so each half is the bf16 128 + 8 + v; one bf16x2
//    subtraction of 136 leaves v. Int4 values and bf16 x multiply exactly
//    in the tensor core; the sum is fp32.
//  - float32 x keeps float32 precision: each x pair is split into three
//    exact bf16 terms (hi + mid + lo, split3_bf16) and the three products
//    go into one zero-started fp32 tile that is then added to the
//    accumulator with a rounded fp32 add (the tensor core's own
//    accumulation is not rounded to nearest). A float32 output of bf16 x
//    takes this path too: the wrapper passes x as float32, whose split is
//    (x, 0, 0), so each k-step adds the one product. bf16 x with a bf16
//    output accumulates in the product's C operand.
//  - A deep weight ring: one producer warp issues TMA loads of 2-D boxes of
//    the [n_in / 2, n_out] byte tensor (128 columns x 64 packed rows, 8 KB)
//    and of x (64 bf16 or 32 float32 of a row x the row tile, zero-filled
//    past `rows`) into a ring with full/empty mbarriers, as deep as the
//    CTA's share of the SM holds (two CTAs an SM while each keeps >= 4
//    stages: 11 stages, 88 KB of weight per CTA at 8 rows, so a decode
//    split's whole walk is in flight at once); the maps are cached per
//    tensor (tensor_map_2d). Four consumer warps each own 32 of the CTA's
//    128 columns; B fragments come from the x tile by ldmatrix (float32 x:
//    8-byte loads, then the split). From 8 row tiles on, one k-step's A
//    fragments are held at a time (ldmatrix.x4 then covers two row tiles)
//    to keep 128 accumulators and no spill.
//  - The row tile is a template (1, 2, 4, 8 or 16 n8 tiles); the wrapper
//    picks the smallest that holds `rows`, so the weight is read once from
//    device memory at every row count from 1 to 128.
//  - One launch per call: K splits across CTAs (grid: 128-column blocks x
//    splits of the 64-row stages) so that [4096, 4096] fills the 132 SMs
//    (i4_splits). A split writes its float32 partial; the CTA whose
//    atomicAdd on its column block's counter completes the count copies
//    the k partial tiles into its free ring (cp.async), adds them in split
//    order 0, 1, ..., applies the scale, casts, writes y and resets the
//    counter. The same inputs give the same bits on every run; no float
//    atomics. `pt_int4_matmul_check_launch` holds the wrapper's geometry
//    (ops/kernels/int4_matmul.py launch_config) against the constants here.
//
// Where the time goes (chip_smoke.py's B8 timing and its `fit`, the
// times of the four 7B shapes over their weight bytes as a line, on an
// H100 80GB HBM3 at 700 W; PERF.md row 8): at 8 rows a call pays ~7.1 us
// beside a stream at ~2.4 TB/s, the launch and the last CTA's merge chain
// (fence, counter, copy, sum); at 128 rows the products on one wave of
// CTAs and the merge of the float32 partials hold it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"   // mma16816, ldsm_x4, split3_bf16
#include "sm90_common.cuh"    // mbarriers, TMA, named barriers, tensor maps

namespace {

constexpr int I4_CWARPS = 4;                      // consumer warps
constexpr int I4_CONSUMERS = 32 * I4_CWARPS;
constexpr int I4_THREADS = I4_CONSUMERS + 32;     // + the producer warp
constexpr int I4_BAR = 1;                         // the consumers' barrier
constexpr int I4_COLS = 128;   // output columns of a CTA: one box row
constexpr int I4_KS = 64;      // packed rows of a stage (128 k)
constexpr int I4_WBYTES = I4_KS * I4_COLS;        // weight tile: 8 KB
constexpr int I4_MAX_STAGES = 16;
constexpr int I4_MIN_SPLIT_STAGES = 2;            // stages a split walks
// dynamic shared memory of a CTA when two share an SM (each of the SM's
// 228 KB reserves 1 KB a CTA), and when one has it alone (227 KB)
constexpr int I4_SMEM_TWO = 233472 / 2 - 1024;
constexpr int I4_SMEM_ONE = 232448;
constexpr int I4_MIN_STAGES_TWO = 4;   // the shallowest ring two CTAs keep
static_assert(I4_COLS == 128, "a column block is one 128-byte box row");

// x bytes of a stage: 8 * nt rows of 128 k, xs bytes an element
__host__ __device__ constexpr int i4_x_bytes(int nt, int xs) {
  return 8 * nt * 2 * I4_KS * xs;
}
__host__ __device__ constexpr int i4_stage_bytes(int nt, int xs) {
  return I4_WBYTES + i4_x_bytes(nt, xs);
}
// stages that fit `budget` bytes beside 1024 bytes of alignment slack, a
// full and an empty mbarrier per stage and the last-CTA flag (16 bytes)
__host__ __device__ constexpr int i4_stages_in(int budget, int sb) {
  return (budget - 1040) / (sb + 16) < I4_MAX_STAGES
             ? (budget - 1040) / (sb + 16)
             : I4_MAX_STAGES;
}
// Two CTAs an SM when each still holds a ring of I4_MIN_STAGES_TWO stages
__host__ __device__ constexpr bool i4_two_per_sm(int nt, int xs) {
  return i4_stages_in(I4_SMEM_TWO, i4_stage_bytes(nt, xs)) >=
         I4_MIN_STAGES_TWO;
}
// the ring: as deep as the CTA's share of the SM holds, at most 16 stages
__host__ __device__ constexpr int i4_stages(int nt, int xs) {
  return i4_stages_in(i4_two_per_sm(nt, xs) ? I4_SMEM_TWO : I4_SMEM_ONE,
                      i4_stage_bytes(nt, xs));
}
__host__ __device__ constexpr int i4_smem_bytes(int nt, int xs) {
  return 1040 + i4_stages(nt, xs) * (i4_stage_bytes(nt, xs) + 16);
}

// n8 tiles of x rows: the smallest power of two with 8 * nt >= rows
inline int i4_row_tiles(int rows) {
  int nt = 1;
  while (8 * nt < rows) nt *= 2;
  return nt;
}

// K splits: as many as one wave of CTAs holds (ctas_per_sm * n_sm over the
// column blocks), each at least I4_MIN_SPLIT_STAGES stages long.
inline int i4_splits(int n_in, int n_out, int n_sm, int per_sm) {
  const int blocks = n_out / I4_COLS, stages = n_in / 2 / I4_KS;
  int k = per_sm * n_sm / blocks;
  if (k > stages / I4_MIN_SPLIT_STAGES) k = stages / I4_MIN_SPLIT_STAGES;
  return k > 1 ? k : 1;
}

struct I4Params {
  const float* scales;
  void* out;            // [rows, n_out], bf16 if out_bf16 else float32
  float* scratch;       // partials [splits, rows, n_out] (splits > 1)
  int* counters;        // one per column block, 0 between launches
  int rows, n_out, n_stages, out_bf16;
};

// The exact bf16x2 (low nibble, high nibble) of byte B of w; w4 = w >> 4.
template <int B>
__device__ __forceinline__ uint32_t nib_bf16x2(uint32_t w, uint32_t w4) {
  uint32_t y = __byte_perm(w, w4, B | ((4 + B) << 8));
  y = (y & 0x000F000Fu) ^ 0x43084308u;   // 128 + (v + 8), v the nibble
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y),
              __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// 16 bytes from global memory (L2, past L1) into shared memory at dst.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// Four consecutive outputs at element e of out: v * scale, cast.
__device__ __forceinline__ void store4(void* out, int out_bf16, long e,
                                       float4 v, float4 sc) {
  v.x = __fmul_rn(v.x, sc.x);
  v.y = __fmul_rn(v.y, sc.y);
  v.z = __fmul_rn(v.z, sc.z);
  v.w = __fmul_rn(v.w, sc.w);
  if (out_bf16)
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + e) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  else
    *reinterpret_cast<float4*>(static_cast<float*>(out) + e) = v;
}

// grid (n_out / I4_COLS, splits); I4_THREADS threads. NT: n8 tiles of x
// rows; XBF16: x in bf16 and a bf16 output (else float32 x, either
// output).
template <int NT, bool XBF16>
__global__ void __launch_bounds__(I4_THREADS,
                                  i4_two_per_sm(NT, XBF16 ? 2 : 4) ? 2 : 1)
int4_mm_kernel(const __grid_constant__ CUtensorMap tmw,
               const __grid_constant__ CUtensorMap tmx, const I4Params p) {
  constexpr int XS = XBF16 ? 2 : 4;
  constexpr int STAGES = i4_stages(NT, XS);
  constexpr int SB = i4_stage_bytes(NT, XS);
  constexpr int R8 = 8 * NT;          // rows of the x tile
  constexpr int XBOX = 128 / XS;      // x elements of a box row
  constexpr int NXB = 2 * I4_KS / XBOX;   // x boxes of a stage
  // k-steps whose A fragments are held at once: 2 (one ldmatrix.x4 gives
  // both k-steps' B of a row tile), 1 from 8 row tiles on (one x4 gives
  // two row tiles' B of a k-step; fewer registers beside a thread's 8 NT
  // sums)
  constexpr int KG = NT >= 8 ? 1 : 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (ring - raw);
  const uint32_t bars = ring + STAGES * SB;
  int* const misc = reinterpret_cast<int*>(smem + STAGES * (SB + 16));
  static_assert(i4_smem_bytes(NT, XS) <= I4_SMEM_ONE, "shared memory");
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cb = blockIdx.x, split = blockIdx.y, k = gridDim.y;
  const int col0 = cb * I4_COLS;
  const int st0 = (int)((long long)p.n_stages * split / k);
  const int n_st = (int)((long long)p.n_stages * (split + 1) / k) - st0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), I4_CWARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == I4_CWARPS) {   // the producer
    if (lane == 0) {
      tma_prefetch(&tmw);
      tma_prefetch(&tmx);
      for (int i = 0; i < n_st; ++i) {
        const int s = i % STAGES, st = st0 + i;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(full(s), SB);
        const uint32_t dst = ring + s * SB;
        tma_load_2d(dst, &tmw, full(s), col0, st * I4_KS);
#pragma unroll
        for (int b = 0; b < NXB; ++b)
          tma_load_2d(dst + I4_WBYTES + b * R8 * 128, &tmx, full(s),
                      st * 2 * I4_KS + b * XBOX, 0);
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  const int g = lane >> 2, t = lane & 3;
  // this lane's 16-byte chunk of a packed row (before the swizzle), its
  // word in the chunk, and its byte offsets in packed rows t and t + 4 of
  // a k-step (8 packed rows, 1024 bytes)
  const int chunk = 4 * (g & 1) + warp, word = g >> 1;
  const uint32_t off0 = t * 128 + ((chunk ^ t) << 4) + 4 * word;
  const uint32_t off1 = (t + 4) * 128 + ((chunk ^ t ^ 4) << 4) + 4 * word;
  float acc[NT][2][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][j][e] = 0.f;

  for (int i = 0; i < n_st; ++i) {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    const uint8_t* const wt = smem + s * SB;
    const uint32_t xt = ring + s * SB + I4_WBYTES;
#pragma unroll
    // KG k-steps at a time: their A fragments, then every row tile's B
#pragma unroll
    for (int ks0 = 0; ks0 < I4_KS / 8; ks0 += KG) {
      // a[h][j]: k-step ks0 + h, m16 tile j (bytes 2j, 2j + 1)
      uint32_t a[KG][2][4];
#pragma unroll
      for (int h = 0; h < KG; ++h) {
        const int ks = ks0 + h;
        const uint32_t w0 =
            *reinterpret_cast<const uint32_t*>(wt + ks * 1024 + off0);
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(wt + ks * 1024 + off1);
        const uint32_t w04 = w0 >> 4, w14 = w1 >> 4;
        a[h][0][0] = nib_bf16x2<0>(w0, w04);
        a[h][0][1] = nib_bf16x2<1>(w0, w04);
        a[h][0][2] = nib_bf16x2<0>(w1, w14);
        a[h][0][3] = nib_bf16x2<1>(w1, w14);
        a[h][1][0] = nib_bf16x2<2>(w0, w04);
        a[h][1][1] = nib_bf16x2<3>(w0, w04);
        a[h][1][2] = nib_bf16x2<2>(w1, w14);
        a[h][1][3] = nib_bf16x2<3>(w1, w14);
      }
      if constexpr (XBF16) {
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += 2 / KG) {
          // KG 2: matrices (k-step ks0, k 0-7), (ks0, 8-15), (ks0 + 1,
          // 0-7), (ks0 + 1, 8-15) of rows 8 n0 ..; KG 1: (ks0, 0-7),
          // (ks0, 8-15) of row tiles n0 and n0 + 1
          const int n = KG == 2 ? n0 : n0 + (lane >> 4);
          const int row = 8 * n + (lane & 7);
          const int c = KG == 2 ? 2 * (ks0 & 3) + (lane >> 3)
                                : 2 * (ks0 & 3) + ((lane >> 3) & 1);
          uint32_t b[4];
          ldsm_x4(b, xt + (ks0 >> 2) * R8 * 128 + row * 128 +
                         ((c ^ (lane & 7)) << 4));
#pragma unroll
          for (int q = 0; q < 2; ++q)   // (k-step ks0 + h, row tile n0 + m)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int h = KG == 2 ? q : 0, m = KG == 2 ? 0 : q;
              const uint32_t bb[2] = {b[2 * q], b[2 * q + 1]};
              mma16816(acc[n0 + m][j], a[h][j], bb);
            }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int h = 0; h < KG; ++h) {
            // x[8n + g][16 ks + 2t, +1] and [.. + 8, + 9], split in three
            const int ks = ks0 + h;
            const int c = 4 * (ks & 1) + (t >> 1);
            const uint8_t* const xr = smem + s * SB + I4_WBYTES +
                                      (ks >> 1) * R8 * 128 +
                                      (8 * n + g) * 128 + 8 * (t & 1);
            const float2 v0 =
                *reinterpret_cast<const float2*>(xr + ((c ^ g) << 4));
            const float2 v1 =
                *reinterpret_cast<const float2*>(xr + (((c + 2) ^ g) << 4));
            uint32_t t0[3], t1[3];
            split3_bf16(v0.x, v0.y, t0);
            split3_bf16(v1.x, v1.y, t1);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                const uint32_t bb[2] = {t0[e], t1[e]};
                mma16816(d, a[h][j], bb);
              }
              add4(acc[n][j], d);
            }
          }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // ---- epilogue: columns c .. c + 3 of rows 8n + 2t and 8n + 2t + 1 --------
  const int c = col0 + 16 * chunk + 4 * word;
  auto vals = [&](int n, int e) {   // e: row 8n + 2t + e
    return make_float4(acc[n][0][e], acc[n][0][2 + e], acc[n][1][e],
                       acc[n][1][2 + e]);
  };
  if (k == 1) {
    const float4 sc = __ldg(reinterpret_cast<const float4*>(p.scales + c));
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * n + 2 * t + e;
        if (r < p.rows)
          store4(p.out, p.out_bf16, (long)r * p.n_out + c, vals(n, e), sc);
      }
    return;
  }
  float* const part = p.scratch + (long)split * p.rows * p.n_out;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * n + 2 * t + e;
      if (r < p.rows)
        *reinterpret_cast<float4*>(part + (long)r * p.n_out + c) =
            vals(n, e);
    }
  // the last of the k CTAs of this column block adds the partials, split 0
  // first
  __threadfence();
  named_barrier_sync(I4_BAR, I4_CONSUMERS);
  if (tid == 0) misc[0] = atomicAdd(p.counters + cb, 1) == k - 1;
  named_barrier_sync(I4_BAR, I4_CONSUMERS);
  if (!misc[0]) return;
  __threadfence();
  // the k partial tiles are copied into the ring (free now: every stage
  // was consumed) by cp.async, as many rows at a time as fit; then each
  // float4 is summed in split order, four float4s a thread at a time
  const int mrows = min(p.rows, STAGES * SB / (k * I4_COLS * 4));
  const float4* const sm = reinterpret_cast<const float4*>(smem);
  for (int r0 = 0; r0 < p.rows; r0 += mrows) {
    const int ne = min(mrows, p.rows - r0) * (I4_COLS / 4);
    for (int i = tid; i < k * ne; i += I4_CONSUMERS) {
      const int sp = i / ne, e = i - sp * ne;
      cp_async16(ring + 16 * i,
                 p.scratch + (long)(sp * p.rows + r0 + (e >> 5)) * p.n_out +
                     col0 + 4 * (e & 31));
    }
    cp_async_wait_all();
    named_barrier_sync(I4_BAR, I4_CONSUMERS);
    for (int e0 = tid; e0 < ne; e0 += 4 * I4_CONSUMERS) {
      float4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = sm[min(e0 + q * I4_CONSUMERS, ne - 1)];
      for (int sp = 1; sp < k; ++sp)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 u = sm[sp * ne + min(e0 + q * I4_CONSUMERS, ne - 1)];
          v[q].x = __fadd_rn(v[q].x, u.x);
          v[q].y = __fadd_rn(v[q].y, u.y);
          v[q].z = __fadd_rn(v[q].z, u.z);
          v[q].w = __fadd_rn(v[q].w, u.w);
        }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = e0 + q * I4_CONSUMERS;
        if (e < ne) {
          const int cc = col0 + 4 * (e & 31);
          store4(p.out, p.out_bf16, (long)(r0 + (e >> 5)) * p.n_out + cc,
                 v[q], __ldg(reinterpret_cast<const float4*>(p.scales + cc)));
        }
      }
    }
    named_barrier_sync(I4_BAR, I4_CONSUMERS);   // the ring is rewritten
  }
  if (tid == 0) p.counters[cb] = 0;
}

template <int NT, bool XBF16>
cudaError_t launch(dim3 grid, cudaStream_t s, const CUtensorMap& tw,
                   const CUtensorMap& tx, const I4Params& p) {
  constexpr int smem = i4_smem_bytes(NT, XBF16 ? 2 : 4);
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_mm_kernel<NT, XBF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  int4_mm_kernel<NT, XBF16><<<grid, I4_THREADS, smem, s>>>(tw, tx, p);
  return cudaGetLastError();
}

template <bool XBF16>
cudaError_t launch_rows(int nt, dim3 grid, cudaStream_t s,
                        const CUtensorMap& tw, const CUtensorMap& tx,
                        const I4Params& p) {
  switch (nt) {
    case 1: return launch<1, XBF16>(grid, s, tw, tx, p);
    case 2: return launch<2, XBF16>(grid, s, tw, tx, p);
    case 4: return launch<4, XBF16>(grid, s, tw, tx, p);
    case 8: return launch<8, XBF16>(grid, s, tw, tx, p);
    default: return launch<16, XBF16>(grid, s, tw, tx, p);
  }
}

}  // namespace

// x [rows, n_in] (bf16 when x_bf16, else float32), packed int8
// [n_in / 2, n_out], scales float32 [n_out], out [rows, n_out] (bf16 when
// out_bf16, else float32; bf16 x takes a bf16 out), all contiguous and
// 16-byte aligned; scratch
// float32 [splits * rows * n_out] and counters int32 [n_out / 128], zero,
// with splits = i4_splits(...) (the wrapper's launch_config).
extern "C" int pt_int4_matmul(const void* x, int x_bf16, const void* packed,
                              const void* scales, void* out, int out_bf16,
                              int rows, int n_in, int n_out, int n_sm,
                              void* scratch, void* counters, void* stream) {
  if (rows < 1 || rows > 128 || n_in % 1024 != 0 || n_out % 512 != 0 ||
      n_sm < 1 || (x_bf16 && !out_bf16) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(packed) |
       reinterpret_cast<uintptr_t>(scales) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = i4_row_tiles(rows), xs = x_bf16 ? 2 : 4;
  const int k = i4_splits(n_in, n_out, n_sm, i4_two_per_sm(nt, xs) ? 2 : 1);
  CUtensorMap tw, tx;
  if (!tensor_map_2d(&tw, packed, n_in / 2, n_out, I4_KS,
                     CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, I4_COLS,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&tx, x, rows, n_in, 8 * nt,
                     x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     xs, 128 / xs, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  I4Params p;
  p.scales = static_cast<const float*>(scales);
  p.out = out;
  p.scratch = static_cast<float*>(scratch);
  p.counters = static_cast<int*>(counters);
  p.rows = rows;
  p.n_out = n_out;
  p.n_stages = n_in / 2 / I4_KS;
  p.out_bf16 = out_bf16;
  const dim3 grid(n_out / I4_COLS, k);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = x_bf16
                              ? launch_rows<true>(nt, grid, s, tw, tx, p)
                              : launch_rows<false>(nt, grid, s, tw, tx, p);
  return static_cast<int>(err);
}

// 0 when the wrapper's launch geometry for (rows, n_in, n_out, x dtype,
// n_sm) is the one pt_int4_matmul launches: row tiles, grid, shared
// memory, stages, threads, CTAs per SM, scratch floats and counters.
extern "C" int pt_int4_matmul_check_launch(int rows, int n_in, int n_out,
                                           int x_bf16, int n_sm, int nt,
                                           int grid_x, int grid_y,
                                           int smem_bytes, int stages,
                                           int threads, int per_sm,
                                           long long scratch_floats,
                                           int counters) {
  if (rows < 1 || rows > 128 || n_in % 1024 != 0 || n_out % 512 != 0 ||
      n_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int want_nt = i4_row_tiles(rows), xs = x_bf16 ? 2 : 4;
  const int smem = i4_smem_bytes(want_nt, xs);
  const int ps = i4_two_per_sm(want_nt, xs) ? 2 : 1;
  const int k = i4_splits(n_in, n_out, n_sm, ps);
  const bool ok =
      nt == want_nt && grid_x == n_out / I4_COLS && grid_y == k &&
      smem_bytes == smem && stages == i4_stages(want_nt, xs) &&
      threads == I4_THREADS && per_sm == ps &&
      scratch_floats == (k > 1 ? (long long)k * rows * n_out : 0) &&
      counters == n_out / I4_COLS;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
