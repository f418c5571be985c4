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
// Bound on the H100: bytes. The packed weight is read once: 8.39 MB at
// [4096, 4096], 2.50 us at 3.35 TB/s; x and y are < 1% of it at 8 rows.
// At 8 rows the function does 2 * 8 operations per weight, 16 per packed
// byte: far below the ~295 per byte where the tensor cores would matter.
// This simple form does them as fp32 FMAs on the CUDA cores, and those,
// with each warp's wait for its loads, bound it at several times the byte
// time, not memory; `mma.sync` on unpacked bf16 fragments is the later
// fix.
//
// Design (simple: no TMA, no tensor cores):
//  - No even/odd copy of x (the reference splits x in two outside its
//    kernel): a CTA stages (x[r, 2i], x[r, 2i+1]) pairs of 8 rows for a
//    piece of 128 packed rows in shared memory as float2, read by every
//    lane of a warp at once (a broadcast).
//  - A CTA of 4 warps owns 256 output columns: lane l streams 8 bytes of a
//    packed row (columns 8l .. 8l+7), so a warp reads 256 contiguous bytes
//    per row, and the 4 warps take interleaved packed rows. Each warp
//    keeps the loads of 8 rows in flight.
//  - Nibbles are unpacked in registers without an int-to-float conversion
//    (a quarter-rate instruction): the word is XORed with 0x88888888, which
//    offsets each signed nibble by 8, the nibble is OR-ed into the mantissa
//    of 2^23, and one subtraction of 2^23 + 8 gives the value exactly.
//  - Each thread holds 8 rows x 8 columns of float32 sums; more rows loop
//    over row tiles of 8, reading the CTA's packed rows again (from L2).
//  - K is split across CTAs (gridDim.y splits of n_in / 2 / splits packed
//    rows) so the card's 132 SMs fill at n_out = 4096. Each CTA sums its 4
//    warps in a fixed order through shared memory and writes a float32
//    partial; a second kernel adds the partials in split order, multiplies
//    by the scale and casts. No atomics: repeated runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int COLS = 8;                  // output columns per thread
constexpr int CTA_COLS = 32 * COLS;      // 256 output columns per CTA
constexpr int RT = 8;                    // rows per tile
constexpr int XK = 128;                  // packed rows of x staged per piece
constexpr int AHEAD = 8;                 // packed rows loaded ahead per warp
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Nibble j (0..7) of a word already XORed with 0x88888888, as the float
// value of the signed nibble it came from: nibble 2b is byte b's low
// nibble (weight row 2i), nibble 2b+1 its high one (row 2i+1).
__device__ __forceinline__ float nibble(unsigned w, int j) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((w >> (4 * j)) & 0xFu)),
                   8388616.0f);
}

// One packed row's 8 bytes (columns 8l .. 8l+7) into the 8 x 8 sums.
__device__ __forceinline__ void accumulate(float (&acc)[RT][COLS], int2 w,
                                           const float2* xrow) {
  const unsigned w0 = static_cast<unsigned>(w.x) ^ 0x88888888u;
  const unsigned w1 = static_cast<unsigned>(w.y) ^ 0x88888888u;
  float lo[COLS], hi[COLS];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo[c] = nibble(w0, 2 * c);
    hi[c] = nibble(w0, 2 * c + 1);
    lo[c + 4] = nibble(w1, 2 * c);
    hi[c + 4] = nibble(w1, 2 * c + 1);
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float2 xv = xrow[r * XK];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      acc[r][c] = __fmaf_rn(xv.x, lo[c], acc[r][c]);
      acc[r][c] = __fmaf_rn(xv.y, hi[c], acc[r][c]);
    }
  }
}

// grid (n_out / CTA_COLS, splits); partial [splits, rows, n_out] float32
template <typename TX>
__global__ void __launch_bounds__(NTHREADS)
int4_mm_partial_kernel(const TX* __restrict__ x,
                       const int8_t* __restrict__ packed,
                       float* __restrict__ partial, int rows, int n_in,
                       int n_out, int kc) {
  __shared__ float2 xs[RT][XK];                     // 8 KB
  __shared__ __align__(16) float red[NWARPS][RT][CTA_COLS];   // 32 KB
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * CTA_COLS;
  const int k_begin = blockIdx.y * kc, k_end = k_begin + kc;
  const int8_t* wcol = packed + col0 + lane * COLS;

  for (int r0 = 0; r0 < rows; r0 += RT) {
    float acc[RT][COLS];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

    for (int kk = k_begin; kk < k_end; kk += XK) {
      const int piece = min(XK, k_end - kk);
      __syncthreads();   // the previous piece's readers are done
      for (int e = threadIdx.x; e < RT * piece; e += NTHREADS) {
        const int r = e / piece, i = e % piece;
        float2 v = make_float2(0.f, 0.f);
        if (r0 + r < rows) {
          const TX* xr = x + static_cast<size_t>(r0 + r) * n_in + 2 * (kk + i);
          v = make_float2(to_f32(xr[0]), to_f32(xr[1]));
        }
        xs[r][i] = v;
      }
      __syncthreads();
      int i = warp;
      for (; i + (AHEAD - 1) * NWARPS < piece; i += AHEAD * NWARPS) {
        int2 w[AHEAD];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u)
          w[u] = __ldg(reinterpret_cast<const int2*>(
              wcol + static_cast<size_t>(kk + i + u * NWARPS) * n_out));
#pragma unroll
        for (int u = 0; u < AHEAD; ++u)
          accumulate(acc, w[u], &xs[0][i + u * NWARPS]);
      }
      for (; i < piece; i += NWARPS)
        accumulate(acc,
                   __ldg(reinterpret_cast<const int2*>(
                       wcol + static_cast<size_t>(kk + i) * n_out)),
                   &xs[0][i]);
    }

    // the 4 warps' sums, added in warp order
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float4* dst = reinterpret_cast<float4*>(&red[warp][r][lane * COLS]);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < RT * CTA_COLS; e += NTHREADS) {
      const int r = e / CTA_COLS, c = e % CTA_COLS;
      if (r0 + r < rows) {
        float s = red[0][r][c];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) s = __fadd_rn(s, red[w][r][c]);
        partial[(static_cast<size_t>(blockIdx.y) * rows + r0 + r) * n_out +
                col0 + c] = s;
      }
    }
    __syncthreads();   // red is rewritten by the next row tile
  }
}

// out[r, n] = (sum over splits, in order) * s[n], cast to TO
template <typename TO>
__global__ void __launch_bounds__(REDUCE_THREADS)
int4_mm_reduce_kernel(const float* __restrict__ partial,
                      const float* __restrict__ scales, TO* __restrict__ out,
                      int rows, int n_out, int splits) {
  const size_t total = static_cast<size_t>(rows) * n_out;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = partial[e];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, partial[k * total + e]);
    store_out(out + e, __fmul_rn(s, scales[e % n_out]));
  }
}

template <typename TX, typename TO>
int launch(const void* x, const void* packed, const void* scales,
           void* partial, void* out, int rows, int n_in, int n_out,
           int splits, int n_sm, cudaStream_t stream) {
  const int kc = n_in / 2 / splits;
  const dim3 grid(n_out / CTA_COLS, splits);
  int4_mm_partial_kernel<TX><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(packed),
      static_cast<float*>(partial), rows, n_in, n_out, kc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(rows) * n_out;
  const long long want = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const int blocks = static_cast<int>(want < 4LL * n_sm ? want : 4LL * n_sm);
  int4_mm_reduce_kernel<TO><<<blocks, REDUCE_THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scales),
      static_cast<TO*>(out), rows, n_out, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, n_in] (bf16 when x_bf16, else float32), packed int8
// [n_in / 2, n_out], scales float32 [n_out], partial float32
// [splits, rows, n_out] (scratch), out [rows, n_out] (bf16 when out_bf16,
// else float32). All contiguous; packed 8-byte aligned.
extern "C" int pt_int4_matmul(const void* x, int x_bf16, const void* packed,
                              const void* scales, void* partial, void* out,
                              int out_bf16, int rows, int n_in, int n_out,
                              int splits, int n_sm, void* stream) {
  if (rows < 1 || rows > 128 || n_in % 1024 != 0 || n_out % 512 != 0 ||
      splits < 1 || (n_in / 2) % splits != 0 || n_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16)
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                          x, packed, scales, partial, out, rows, n_in, n_out,
                          splits, n_sm, s)
                    : launch<__nv_bfloat16, float>(x, packed, scales, partial,
                                                   out, rows, n_in, n_out,
                                                   splits, n_sm, s);
  return out_bf16 ? launch<float, __nv_bfloat16>(x, packed, scales, partial,
                                                 out, rows, n_in, n_out,
                                                 splits, n_sm, s)
                  : launch<float, float>(x, packed, scales, partial, out,
                                         rows, n_in, n_out, splits, n_sm, s);
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
